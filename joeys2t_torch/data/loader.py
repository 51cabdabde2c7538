# coding: utf-8
"""
``load_data``: tokenizers, vocabularies and datasets from the config's
`data` section (counterpart of joeys2t_tpu/data/loader.py:18).
"""
from functools import partial
from typing import Dict, List, Optional, Tuple

from joeys2t_torch.data.audio_io import pad_features
from joeys2t_torch.data.datasets import BaseDataset, build_dataset
from joeys2t_torch.tokenizers import build_tokenizer
from joeys2t_torch.utils.logging import get_logger
from joeys2t_torch.vocabulary import Vocabulary, build_vocab

logger = get_logger(__name__)


def load_data(cfg: Dict, datasets: List[str], task: str = "MT"
              ) -> Tuple[Optional[Vocabulary], Vocabulary, Optional[BaseDataset],
                         Optional[BaseDataset], Optional[BaseDataset]]:
    """(src_vocab, trg_vocab, train, dev, test) for the splits named in
    ``datasets`` ("train", "dev", "test", "stream")."""
    if not datasets:
        raise ValueError("no datasets requested")
    src_cfg, trg_cfg = cfg["src"], cfg["trg"]
    src_lang = src_cfg["lang"] if task == "MT" else "src"
    trg_lang = trg_cfg["lang"] if task == "MT" else "trg"
    train_path, dev_path, test_path = cfg.get("train"), cfg.get("dev"), cfg.get("test")
    if train_path is None and dev_path is None and test_path is None:
        raise ValueError("Please specify at least one data source path.")

    logger.info("Building tokenizer...")
    tokenizer = build_tokenizer(cfg, task)
    dataset_type = cfg.get("dataset_type", "plain")
    if task == "S2T" and dataset_type != "speech":
        raise ValueError(f"S2T data needs dataset_type speech, got {dataset_type}")
    dataset_cfg = dict(cfg.get("dataset_cfg", {}))
    # a Huggingface dataset's own split name, kept apart from the positional split
    hf_split = dataset_cfg.pop("split", None)
    if dataset_type == "huggingface" and hf_split is not None:
        dataset_cfg["hf_split"] = hf_split
    has_prompt = {src_lang: src_cfg.get("has_prompt", False),
                  trg_lang: trg_cfg.get("has_prompt", False)}
    common = dict(dataset_type=dataset_type, src_lang=src_lang, trg_lang=trg_lang,
                  tokenizer=tokenizer, has_prompt=has_prompt, task=task, **dataset_cfg)

    train_data = None
    if "train" in datasets and train_path is not None:
        train_subset = cfg.get("sample_train_subset", -1)
        if "random_train_subset" in cfg:
            logger.warning("`random_train_subset` option is obsolete. "
                           "Please use `sample_train_subset` instead.")
            train_subset = cfg.get("random_train_subset", train_subset)
        logger.info("Loading train set...")
        train_data = build_dataset(path=train_path, split="train",
                                   random_subset=train_subset, **common)

    logger.info("Building vocabulary...")
    src_vocab, trg_vocab = build_vocab(cfg, task=task, dataset=train_data)
    if task == "MT":
        tokenizer[src_lang].set_vocab(src_vocab)
        sequence_encoder = {src_lang: partial(src_vocab.sentences_to_ids, bos=False,
                                              eos=True),
                            trg_lang: trg_vocab.sentences_to_ids}
    else:
        sequence_encoder = {"src": partial(pad_features,
                                           embed_size=tokenizer["src"].num_freq),
                            "trg": trg_vocab.sentences_to_ids}
    tokenizer[trg_lang].set_vocab(trg_vocab)
    if train_data is not None:
        train_data.sequence_encoder = sequence_encoder

    dev_data = None
    if "dev" in datasets and dev_path is not None:
        dev_subset = cfg.get("sample_dev_subset", -1)
        if "random_dev_subset" in cfg:
            logger.warning("`random_dev_subset` option is obsolete. "
                           "Please use `sample_dev_subset` instead.")
            dev_subset = cfg.get("random_dev_subset", dev_subset)
        logger.info("Loading dev set...")
        dev_data = build_dataset(path=dev_path, split="dev", random_subset=dev_subset,
                                 sequence_encoder=sequence_encoder, **common)

    test_data = None
    if "test" in datasets and test_path is not None:
        logger.info("Loading test set...")
        test_data = build_dataset(path=test_path, split="test", random_subset=-1,
                                  sequence_encoder=sequence_encoder, **common)
    if "stream" in datasets:
        test_data = build_dataset(
            path=None, split="test", random_subset=-1, sequence_encoder=sequence_encoder,
            **dict(common, dataset_type="stream" if task == "MT" else "speech_stream"))

    for d in (train_data, dev_data, test_data):
        if d is not None:
            d.trg_vocab = trg_vocab

    logger.info("Data loaded.")
    logger.info("Train dataset: %s", train_data)
    logger.info("Valid dataset: %s", dev_data)
    logger.info(" Test dataset: %s", test_data)
    if train_data:
        src = ("\n\t[SRC] " + " ".join(train_data.get_item(
            idx=0, lang=train_data.src_lang, is_train=False))) if task == "MT" else ""
        trg = "\n\t[TRG] " + " ".join(
            train_data.get_item(idx=0, lang=train_data.trg_lang, is_train=False))
        logger.info("First training example:%s%s", src, trg)
    if src_vocab is not None:
        logger.info("First 10 Src tokens: %s", src_vocab.log_vocab(10))
        logger.info("Number of unique Src tokens (vocab_size): %d", len(src_vocab))
    logger.info("First 10 Trg tokens: %s", trg_vocab.log_vocab(10))
    logger.info("Number of unique Trg tokens (vocab_size): %d", len(trg_vocab))
    return src_vocab, trg_vocab, train_data, dev_data, test_data
