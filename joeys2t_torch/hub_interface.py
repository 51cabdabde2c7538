# coding: utf-8
"""
A trained model directory as a library object (counterpart of
joeys2t_tpu/hub_interface.py): ``load_model_dir("models/my_asr")`` gives a
``TranslatorHubInterface`` with ``generate`` and ``score``.

    from joeys2t_torch.hub_interface import load_model_dir
    hub = load_model_dir("models/my_asr")             # config.yaml + best.ckpt
    hub.generate(["feats/utt1.npy"])                  # S2T: feature or audio paths
    hub.score(["feats/utt1.npy"], trg=["a reference"])
    mt = load_model_dir("models/my_mt")               # MT: sentences, with prompts
    mt.generate(["ein satz"], src_prompt=["<de>"], trg_prompt=["<en> a"])

The model runs on the device the directory's config asks for (``use_cuda``,
``cuda`` unless it is False; pass ``use_cuda=False`` to run on the CPU).
Files the config names (vocabularies, a SentencePiece model, BPE codes,
the checkpoint) that do not exist where it says are looked up by name in
the directory. ``score`` asks for the attention, as JAX's does: a greedy
decode returns it (``attention_probs``, (steps, source positions) an
input), and ``plot_attention`` draws one (src, trg) pair's as a heatmap.
Named snapshots are fetched by ``joeys2t_torch.zoo``.
"""
from pathlib import Path
from typing import List, NamedTuple, Optional, Union

import numpy as np

from joeys2t_torch.config import (BaseConfig, TestConfig, _check_options, load_config,
                                  parse_global_args)
from joeys2t_torch.data.datasets import BaseDataset, SpeechStreamDataset, StreamDataset
from joeys2t_torch.plotting import plot_heatmap
from joeys2t_torch.prediction import predict, prepare
from joeys2t_torch.utils.logging import get_logger

logger = get_logger(__name__)


class PredictionOutput(NamedTuple):
    """One input's scored decode: surface text, tokens, and token-level or
    sequence-level probabilities."""

    translation: List[str]
    tokens: Optional[List[List[str]]]
    token_probs: Optional[List[List[float]]]
    sequence_probs: Optional[List[float]]
    attention_probs: Optional[List[List[float]]]


def _in_snapshot(path: Union[str, Path, None], model_dir: Path) -> Optional[Path]:
    """``path``, or the file of that name in ``model_dir`` when ``path`` does
    not exist (a published config names its publisher's paths)."""
    if path is None:
        return None
    candidate = Path(path)
    if not candidate.is_file():
        candidate = model_dir / candidate.name
    if not candidate.is_file():
        raise FileNotFoundError(f"{path} not found, nor {candidate}")
    return candidate


def _localize_side_files(cfg: dict, model_dir: Path, task: str) -> None:
    """Point each side's vocabulary and subword model or codes into
    ``model_dir`` where the config's paths do not exist."""
    for side in ("src", "trg"):
        if task == "S2T" and side == "src":
            if cfg["data"]["dataset_type"] != "speech":
                raise ValueError("an S2T model directory needs dataset_type speech")
            continue
        section = cfg["data"][side]
        if section.get("voc_file"):
            section["voc_file"] = _in_snapshot(section["voc_file"], model_dir).as_posix()
        tok_cfg = section.get("tokenizer_cfg", {})
        for key in ("codes", "model_file"):
            if key in tok_cfg:
                tok_cfg[key] = _in_snapshot(tok_cfg[key], model_dir).as_posix()


def _from_pretrained(model_name_or_path: Union[str, Path],
                     cfg_file: Union[str, Path] = "config.yaml", **kwargs):
    """(model, spec, loss_fn, stream dataset, parsed config) of a model
    directory; ``kwargs`` override top-level config keys, and
    ``load_model`` names the checkpoint."""
    model_dir = Path(model_name_or_path)
    if not model_dir.is_dir():
        raise FileNotFoundError(f"{model_dir} is not a directory")
    cfg = load_config(_in_snapshot(cfg_file, model_dir))
    if "load_model" in kwargs:
        cfg.setdefault("testing", {})["load_model"] = kwargs.pop("load_model")
    cfg.update(kwargs)
    cfg["model_dir"] = model_dir.as_posix()
    if "task" in cfg["data"]:
        cfg["task"] = cfg["data"]["task"]
    task = cfg.get("task", "MT").upper()
    _check_options("task", task, ["MT", "S2T"])
    _localize_side_files(cfg, model_dir, task)
    if cfg["testing"].get("load_model"):
        cfg["testing"]["load_model"] = _in_snapshot(cfg["testing"]["load_model"],
                                                    model_dir).as_posix()
    args = parse_global_args(cfg, rank=0, mode="translate")
    model, spec, loss_fn, _, _, test_data = prepare(args, rank=0, mode="translate")
    return model, spec, loss_fn, test_data, args


class TranslatorHubInterface:
    """``generate`` and ``score`` over a loaded model directory."""

    def __init__(self, model, spec, loss_fn, dataset: BaseDataset, args: BaseConfig):
        self.args = args
        self.dataset = dataset
        self.model = model
        self.spec = spec
        self.loss_fn = loss_fn

    def generate(self, src: List[str], **kwargs) -> List[str]:
        """Hypotheses for a list of sentences (MT) or feature or audio paths
        (S2T); ``kwargs`` override `testing` options."""
        if not isinstance(src, list):
            raise TypeError("Please provide a list of sentences!")
        kwargs["return_prob"] = "none"
        return self._generate(src, **kwargs)[0]

    def score(self, src: List[str], trg: Optional[List[str]] = None,
              **kwargs) -> List[PredictionOutput]:
        """Decode and score the hypotheses (``trg`` None) or score the given
        references by a forced decode."""
        if not isinstance(src, list):
            raise TypeError("Please provide a list of sentences!")
        kwargs["return_prob"] = "hyp" if trg is None else "ref"
        kwargs["return_attention"] = True
        translations, tokens, probs, attn, test_cfg = self._generate(src, trg, **kwargs)
        n_best = test_cfg.get("n_best", 1)
        greedy = test_cfg.get("beam_size", 1) == 1

        def rows(seq, i):
            return seq[i * n_best:(i + 1) * n_best]

        out = []
        for i in range(len(src)):
            p = rows(probs, i) if len(probs) else []
            out.append(PredictionOutput(
                translation=trg[i] if trg else rows(translations, i),
                tokens=rows(tokens, i),
                token_probs=list(p) if greedy and p else None,
                sequence_probs=[q[0] for q in p] if not greedy and p else None,
                attention_probs=list(rows(attn, i)) if attn else None))
        return out

    def _stage_inputs(self, src, trg, src_prompt, trg_prompt) -> None:
        """Fill the stream dataset's cache with the call's inputs."""

        def per_item(aux, what):
            if not aux:
                return [None] * len(src)
            if len(aux) != len(src):
                raise ValueError(f"src and {what} must have the same length!")
            return aux

        self.dataset.reset_cache()
        for items in zip(src, per_item(trg, "trg"), per_item(src_prompt, "src_prompt"),
                         per_item(trg_prompt, "trg_prompt")):
            self.dataset.set_item(*items)

    def _generate(self, src: List[str], trg: Optional[List[str]] = None,
                  src_prompt: Optional[List[str]] = None,
                  trg_prompt: Optional[List[str]] = None, **kwargs):
        stream_cls = StreamDataset if self.args.task == "MT" else SpeechStreamDataset
        if not isinstance(self.dataset, stream_cls):
            raise TypeError(f"expected a {stream_cls.__name__}, got {self.dataset}")
        test_cfg = dict(self.args.test.__dict__)
        test_cfg.update(kwargs)
        test_cfg.update(batch_type="sentence", batch_size=len(src))
        self.dataset.has_trg = trg is not None
        if trg is not None:  # a forced decode: no search options apply
            test_cfg.update(n_best=1, beam_size=1, return_prob="ref")
        self._stage_inputs(src, trg, src_prompt, trg_prompt)
        _, _, translations, tokens, probs, attention_probs = predict(
            self.model, self.spec, self.dataset, loss_fn=self.loss_fn,
            compute_loss=trg is not None, normalization=self.args.train.normalization,
            num_workers=self.args.num_workers,
            args=TestConfig(**{k: v for k, v in test_cfg.items()
                               if k in TestConfig.__dataclass_fields__}))
        if translations and len(translations) != len(src) * test_cfg.get("n_best", 1):
            raise RuntimeError(f"{len(translations)} hypotheses for {len(src)} inputs")
        self.dataset.reset_cache()
        return translations, tokens, probs, attention_probs, test_cfg

    def plot_attention(self, src: str, trg: str, attention_scores):
        """The attention heatmap of one (src, trg) pair, a matplotlib figure
        (joeys2t_tpu/hub_interface.py:200-222): columns the source tokens
        and eos (a speech source's: its subsampled frames' indices, as the
        attention has them), rows the target's tokens and eos."""
        self.dataset.reset_cache()
        self.dataset.has_trg = True
        self.dataset.set_item(src, trg)
        speech = self.args.task == "S2T"
        tokens, eos = {}, {}
        for axis, lang in (("col", self.dataset.src_lang), ("row", self.dataset.trg_lang)):
            if axis == "col" and speech:
                continue
            tokens[axis] = self.dataset.get_item(idx=0, lang=lang, is_train=False)
            eos[axis] = getattr(self.dataset.tokenizer[lang], "eos_token", "</s>")
        self.dataset.reset_cache()
        scores = np.asarray(attention_scores)
        columns = ([str(i) for i in range(scores.shape[1])] if speech
                   else tokens["col"] + [eos["col"]])
        return plot_heatmap(scores=scores, column_labels=columns,
                            row_labels=tokens["row"] + [eos["row"]], output_path=None)


def load_model_dir(model_dir: Union[str, Path], cfg_file: str = "config.yaml",
                   **kwargs) -> TranslatorHubInterface:
    """A model directory (its ``config.yaml``, vocabularies, subword model
    and checkpoint) as a ``TranslatorHubInterface``."""
    model, spec, loss_fn, dataset, args = _from_pretrained(model_dir, cfg_file, **kwargs)
    return TranslatorHubInterface(model, spec, loss_fn, dataset, args)
