# coding: utf-8
"""
Prediction: the validation, test and translate engine (counterpart of
joeys2t_tpu/prediction.py: ``predict`` :175, ``prepare`` :419, ``evaluate``
:475, ``test`` :573, ``translate`` :650).

``predict`` goes over a dataset in batches, optionally computes the
teacher-forced loss, perplexity and accuracy, decodes (greedy or beam
search, with ``n_best`` hypotheses an example), restores the dataset's
order, detokenizes and scores. Each batch's frames are padded
to the JAX package's bucket with the pad value, as its ``pad_to_shape``
pads them, because the last valid outputs of the conv subsampler read those
frames; rows are not padded to ``batch_size`` (eager PyTorch has no
compiled shapes to reuse, and a padding row changes no real row). The
decode side is cast to the compute dtype once per call. ``test`` and
``translate`` refuse the sacrebleu tokenizers the port lacks (``config.check_ported``)
before loading any data. Returned attention comes back in dataset order
beside the hypotheses (greedy transformer decoding with
``return_attention``, and every recurrent greedy decode, as in JAX), and
``test``'s ``save_attention`` plots it (``plotting.store_attention_plots``).

In a data-parallel run (``_eval_shard_info``, ``_merge_sharded_eval``, JAX
:59-130) every rank makes the same batches, decodes the ones it owns
(round-robin by batch index over the data ranks: the ranks of a tensor- or
pipeline-parallel group decode alike, on the whole model) and the ranks'
outputs are gathered and put back in dataset order; losses and counts are
summed. Scoring references
(``return_prob: ref``) decodes the whole set on every rank, as JAX does.
Only rank 0 writes files.
"""
import dataclasses
import math
import sys
import time
from itertools import zip_longest
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from joeys2t_torch.checkpoints import load_checkpoint
from joeys2t_torch.config import BaseConfig, TestConfig, check_ported, parse_global_args
from joeys2t_torch.data.batch import Batch
from joeys2t_torch.data.datasets import SpeechStreamDataset, StreamDataset
from joeys2t_torch.data.loader import load_data
from joeys2t_torch.helpers import (expand_reverse_index, resolve_ckpt_path, save_hypothese,
                                   set_seed, write_list_to_file)
from joeys2t_torch.losses import build_loss_function, loss_terms
from joeys2t_torch.metrics import bleu, chrf, sequence_accuracy, token_accuracy, wer
from joeys2t_torch.models import build_model
from joeys2t_torch.models.embeddings import load_pretrained_embeddings, merge_pretrained
from joeys2t_torch.parallel import distributed
from joeys2t_torch.plotting import store_attention_plots
from joeys2t_torch.search import _cast_params_to_compute_dtype, search
from joeys2t_torch.tokenizers import EvaluationTokenizer
from joeys2t_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _eval_loss(model, loss_fn, batch: Batch, device: torch.device, return_log_probs: bool):
    """Teacher-forced (summed total loss, correct tokens, log-probs or None)
    of one batch in eval mode (joeys2t_tpu/prediction.py:145)."""
    def put(x, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)

    mt = batch.task == "MT"
    prompts = [None if m is None else put(m, torch.long)
               for m in (batch.src_prompt_mask, batch.trg_prompt_mask)]
    with torch.inference_mode():
        logits, ctc_logits, out_mask = model(
            put(batch.src, torch.long if mt else getattr(model.encoder, "dtype",
                                                         torch.float32)),
            put(batch.trg_input, torch.long), put(batch.src_length, torch.long),
            put(batch.src_mask) if mt else None, put(batch.trg_mask), *prompts)
        total, _, _, n_correct, log_probs = loss_terms(
            loss_fn, logits, ctc_logits, out_mask, put(batch.trg, torch.long),
            put(batch.trg_length, torch.long), put(batch.trg_mask))
        return (float(total), int(n_correct),
                log_probs.cpu().numpy() if return_log_probs else None)


def _eval_shard_info(args: TestConfig) -> Optional[Tuple[int, int]]:
    """(world size, rank) when the ranks of a data-parallel run share the
    batches out, else None (no process group, or ``return_prob: ref``,
    which decodes nothing and scores the whole set on every rank, or
    ``return_attention``, which decodes it all too, as JAX does)."""
    if distributed.in_group() and not args.return_attention and args.return_prob != "ref":
        return distributed.data_world(), distributed.data_rank()
    return None


def _merge_sharded_eval(outputs: List, scores: List, batch_rows: List[int],
                        shard: Tuple[int, int], counts: List[float]
                        ) -> Tuple[List, List, List[float]]:
    """Gather every rank's decoded rows (``outputs``, ``scores``: those of
    the batches it owns, in batch order) and restore dataset order from
    ``batch_rows``, the rows of every batch (known on every rank); the
    ``counts`` (loss, tokens, correct tokens) are summed over the ranks.
    Returns (outputs, scores, counts)."""
    n_proc, _ = shard
    # the ranks of a tensor- or pipeline-parallel group decode alike: one each
    gathered = distributed.data_rows(distributed.all_gather_objects((outputs, scores,
                                                                     counts)))
    cursors = [0] * n_proc
    merged_o, merged_s = [], []
    for bi, rows in enumerate(batch_rows):
        owner = bi % n_proc
        o, sc, _ = gathered[owner]
        c = cursors[owner]
        merged_o.extend(o[c:c + rows])
        merged_s.extend(sc[c:c + rows])
        cursors[owner] = c + rows
    totals = [sum(g[2][i] for g in gathered) for i in range(len(counts))]
    return merged_o, merged_s, totals


def _eval_tokenizer(args: TestConfig) -> EvaluationTokenizer:
    return EvaluationTokenizer(lowercase=args.sacrebleu_cfg.get("lowercase", False),
                               tokenize=args.sacrebleu_cfg.get("tokenize", "13a"),
                               no_punc=args.sacrebleu_cfg.get("no_punc", False))


def predict(model, spec, data, loss_fn=None, compute_loss: bool = False,
            normalization: str = "batch", num_workers: int = 0,
            args: TestConfig = None, device=None, stats: Optional[Dict] = None
            ) -> Tuple[Dict[str, float], Optional[List[str]], Optional[List[str]],
                       List[List[str]], List[np.ndarray], List[np.ndarray]]:
    """Hypotheses (and with ``compute_loss`` loss, ppl and acc) for ``data``
    on ``device`` (the model's). Returns (scores, references, hypotheses,
    decoded tokens, sequence scores, attention scores). ``stats``, when
    given, gains ``batches`` and ``decode_steps``."""
    # pylint: disable=too-many-branches,too-many-statements,too-many-locals
    device = next(model.parameters()).device if device is None else torch.device(device)
    model.eval()
    decode_model = _cast_params_to_compute_dtype(model)  # once for all batches
    stats = {} if stats is None else stats
    valid_iter, batch_sampler = data.make_iter(
        batch_size=args.batch_size, batch_type=args.batch_type, shuffle=False,
        seed=data.seed, num_workers=num_workers, eos_index=spec.eos_index,
        pad_index=spec.pad_index, return_sampler=True)
    num_samples = batch_sampler.num_samples

    if args.return_prob == "ref":
        decoding_description = ""
    else:
        decoding_description = (
            " (Greedy decoding with " if args.beam_size < 2 else
            f" (Beam search with beam_size={args.beam_size}, "
            f"beam_alpha={args.beam_alpha}, n_best={args.n_best}, ")
        decoding_description += (
            f"min_output_length={args.min_output_length}, "
            f"max_output_length={args.max_output_length}, "
            f"return_prob='{args.return_prob}', generate_unk={args.generate_unk}, "
            f"repetition_penalty={args.repetition_penalty}, "
            f"no_repeat_ngram_size={args.no_repeat_ngram_size})")
    logger.info("Predicting %d example(s)...%s", num_samples, decoding_description)

    valid_scores = {"loss": float("nan"), "acc": float("nan"), "ppl": float("nan")}
    all_outputs, valid_attn_scores, valid_seq_scores = [], [], []
    total_loss, total_nseqs, total_ntokens, total_n_correct = 0.0, 0, 0, 0
    n_batches, steps_before = 0, stats.get("decode_steps", 0)
    shard = _eval_shard_info(args)
    batch_rows: List[int] = []  # rows of every batch, of all ranks
    gen_start_time = time.time()
    for bi, raw_batch in enumerate(valid_iter):
        nseqs = raw_batch.nseqs
        batch_rows.append(nseqs * args.n_best)
        if shard is not None and bi % shard[0] != shard[1]:
            total_nseqs += nseqs  # counted everywhere; another rank decodes it
            continue
        reverse_index = raw_batch.sort_by_src_length()
        sort_reverse_index = expand_reverse_index(reverse_index, args.n_best)
        batch = raw_batch.pad_to_shape(batch_size=nseqs)
        output, ref_scores, hyp_scores, attention = None, None, None, None

        if compute_loss and batch.has_trg:
            return_lp = args.return_prob == "ref"
            total, n_correct, log_probs = _eval_loss(model, loss_fn, batch, device,
                                                     return_lp)
            if return_lp:
                ref_scores = Batch.score(log_probs, batch.trg, spec.pad_index)
                output = batch.trg
            total_loss += total
            total_n_correct += n_correct
            total_ntokens += batch.ntokens

        if args.return_prob != "ref":
            output, hyp_scores, attention = search(
                model, spec, batch, max_output_length=args.max_output_length,
                beam_size=args.beam_size, beam_alpha=args.beam_alpha, n_best=args.n_best,
                device=device, decode_model=decode_model, stats=stats,
                min_output_length=args.min_output_length,
                return_attention=args.return_attention, return_prob=args.return_prob,
                generate_unk=args.generate_unk,
                repetition_penalty=args.repetition_penalty,
                no_repeat_ngram_size=args.no_repeat_ngram_size,
                beam_reorder=args.beam_reorder)

        all_outputs.extend(np.asarray(output)[sort_reverse_index])
        if attention is not None:
            valid_attn_scores.extend(attention[sort_reverse_index])
        if ref_scores is not None:
            valid_seq_scores.extend(ref_scores[reverse_index])
        elif hyp_scores is not None:
            valid_seq_scores.extend(hyp_scores[sort_reverse_index])
        total_nseqs += nseqs
        n_batches += 1

    gen_duration = time.time() - gen_start_time
    decode_steps = stats.get("decode_steps", 0) - steps_before
    stats["batches"] = stats.get("batches", 0) + n_batches
    logger.info("Generation took %.4f[sec] over %d batch(es), %d decode step(s).",
                gen_duration, n_batches, decode_steps)
    if shard is not None:
        logger.info("Sharded eval: rank %d decoded %d/%d batches.", shard[1], n_batches,
                    len(batch_rows))
        all_outputs, valid_seq_scores, (total_loss, total_ntokens, total_n_correct) = \
            _merge_sharded_eval(all_outputs, valid_seq_scores, batch_rows, shard,
                                [total_loss, total_ntokens, total_n_correct])
        valid_attn_scores = []  # a recurrent decoder's, of this rank's rows only
    if total_nseqs != num_samples or len(all_outputs) != num_samples * args.n_best:
        raise RuntimeError(f"decoded {len(all_outputs)} of {num_samples} examples")

    if compute_loss and total_ntokens > 0:
        normalizer = {"batch": total_nseqs, "tokens": total_ntokens}.get(normalization, 1)
        valid_scores["loss"] = total_loss / normalizer
        valid_scores["acc"] = total_n_correct / total_ntokens
        try:
            valid_scores["ppl"] = math.exp(total_loss / total_ntokens)
        except OverflowError:
            valid_scores["ppl"] = float("inf")

    # ids back to tokens, cut after the first eos (eos kept)
    decoded_valid = data.trg_vocab.arrays_to_sentences(arrays=all_outputs, cut_at_eos=True)
    if args.return_prob == "ref":  # scoring mode: no evaluation
        logger.info("Evaluation result (scoring) %s, duration: %.4f[sec]",
                    ", ".join(f"{m}: {valid_scores[m]:6.2f}" for m in ["loss", "ppl", "acc"]),
                    gen_duration)
        return valid_scores, None, None, decoded_valid, valid_seq_scores, valid_attn_scores

    trg_tok = data.tokenizer[data.trg_lang]
    valid_hyp = [trg_tok.post_process(s, generate_unk=args.generate_unk)
                 for s in decoded_valid]
    valid_ref = [trg_tok.post_process(s) for s in data.trg]
    if data.has_trg:
        valid_hyp_1best = (valid_hyp if args.n_best == 1 else
                           [valid_hyp[i] for i in range(0, len(valid_hyp), args.n_best)])
        eval_start_time = time.time()
        for eval_metric in args.eval_metrics:
            if eval_metric == "bleu":
                valid_scores[eval_metric] = bleu(valid_hyp_1best, valid_ref,
                                                 **args.sacrebleu_cfg)
            elif eval_metric == "chrf":
                valid_scores[eval_metric] = chrf(valid_hyp_1best, valid_ref,
                                                 **args.sacrebleu_cfg)
            elif eval_metric == "token_accuracy":
                decoded_1best = (decoded_valid if args.n_best == 1 else
                                 decoded_valid[::args.n_best])
                valid_scores[eval_metric] = token_accuracy(
                    decoded_1best, data.get_list(lang=data.trg_lang, tokenized=True),
                    tokenizer=lambda x: x if isinstance(x, list) else x.split())
            elif eval_metric == "sequence_accuracy":
                valid_scores[eval_metric] = sequence_accuracy(valid_hyp_1best, valid_ref)
            elif eval_metric == "wer":
                if "eval" not in data.tokenizer:
                    data.tokenizer["eval"] = _eval_tokenizer(args)
                valid_scores[eval_metric] = wer(valid_hyp_1best, valid_ref,
                                                data.tokenizer["eval"])
        eval_duration = time.time() - eval_start_time
        score_str = ", ".join(f"{m}: {valid_scores[m]:6.2f}"
                              for m in args.eval_metrics + ["loss", "ppl", "acc"]
                              if not math.isnan(valid_scores[m]))
        logger.info("Evaluation result (%s) %s, generation: %.4f[sec], evaluation: "
                    "%.4f[sec]", "beam search" if args.beam_size > 1 else "greedy",
                    score_str, gen_duration, eval_duration)
    else:
        logger.info("Generation took %.4f[sec]. (No references given)", gen_duration)
    return valid_scores, valid_ref, valid_hyp, decoded_valid, valid_seq_scores, \
        valid_attn_scores


def prepare(args: BaseConfig, rank: int = 0, mode: str = "train"):
    """Load the data, build the model on ``args.device`` (seeded from
    ``random_seed``) and, outside training, load its checkpoint.

    Returns (model, spec, loss_fn, train_data, dev_data, test_data)."""
    datasets = {"train": ["train", "dev", "test"], "test": ["dev", "test"],
                "translate": ["stream"]}[mode]
    if mode != "train":
        if args.task == "MT" and not args.data["src"].get("voc_file"):
            args.data["src"]["voc_file"] = (args.model_dir / "src_vocab.txt").as_posix()
        if not args.data["trg"].get("voc_file"):
            args.data["trg"]["voc_file"] = (args.model_dir / "trg_vocab.txt").as_posix()
    src_vocab, trg_vocab, train_data, dev_data, test_data = load_data(
        cfg=args.data, datasets=datasets, task=args.task)
    if mode == "train" and rank == 0:
        if args.task == "MT":
            src_vocab.to_file(args.model_dir / "src_vocab.txt")
            train_data.tokenizer[train_data.src_lang].copy_cfg_file(args.model_dir)
        trg_vocab.to_file(args.model_dir / "trg_vocab.txt")
        train_data.tokenizer[train_data.trg_lang].copy_cfg_file(args.model_dir)

    model, spec = build_model(args.model, src_vocab=src_vocab, trg_vocab=trg_vocab,
                              compute_dtype=args.compute_dtype, device=args.device,
                              generator=torch.Generator().manual_seed(args.seed))
    logger.info("Total params: %d", sum(p.numel() for p in model.parameters()))
    _load_pretrained(model, args, src_vocab, trg_vocab)
    loss_fn = build_loss_function(args.train, spec)
    if mode != "train":
        ckpt = resolve_ckpt_path(args.test.load_model, args.model_dir)
        logger.info("Loading model from %s", ckpt)
        model.load_state_dict(load_checkpoint(ckpt)["model_state"], strict=True)
    set_seed(seed=args.seed)
    return model, spec, loss_fn, train_data, dev_data, test_data


def _load_pretrained(model, args: BaseConfig, src_vocab, trg_vocab) -> None:
    """Merge the ``embeddings.load_pretrained`` tables into the freshly
    initialized model (joeys2t_tpu/prediction.py:548-570): the encoder's into
    the source table of an MT model whose tables are not tied, the
    decoder's into the target table unless ``tied_embeddings``. Rows the
    file lacks keep their initialized values."""
    emb_cfg = {side: args.model[side]["embeddings"] for side in ("encoder", "decoder")}
    tied = model.src_embed is model.trg_embed
    for side, embed, vocab, wanted in (
            ("encoder", model.src_embed, src_vocab, args.task == "MT" and not tied),
            ("decoder", model.trg_embed, trg_vocab,
             not args.model.get("tied_embeddings", False))):
        path = emb_cfg[side].get("load_pretrained")
        if path and wanted and embed is not None:
            logger.info("Loading pretrained %s embeddings...",
                        "src" if side == "encoder" else "trg")
            merge_pretrained(embed, load_pretrained_embeddings(
                Path(path), vocab, emb_cfg[side]["embedding_dim"]))


def evaluate(valid_scores: Dict, valid_hyp: List, data,
             args: TestConfig) -> Tuple[Dict[str, float], List[str]]:
    """Metrics over decoded hypotheses (joeynmt/prediction.py:384-439)."""
    valid_ref = [data.tokenizer[data.trg_lang].post_process(t) for t in data.trg]
    valid_hyp_1best = valid_hyp[::args.n_best] if args.n_best > 1 else valid_hyp
    if len(valid_hyp_1best) != len(valid_ref):
        raise ValueError("hypotheses and references differ in number")
    for eval_metric in args.eval_metrics:
        if eval_metric == "bleu":
            valid_scores[eval_metric] = bleu(valid_hyp_1best, valid_ref, **args.sacrebleu_cfg)
        elif eval_metric == "chrf":
            valid_scores[eval_metric] = chrf(valid_hyp_1best, valid_ref, **args.sacrebleu_cfg)
        elif eval_metric == "token_accuracy":
            valid_scores[eval_metric] = token_accuracy(valid_hyp_1best, valid_ref,
                                                       tokenizer=str.split)
        elif eval_metric == "sequence_accuracy":
            valid_scores[eval_metric] = sequence_accuracy(valid_hyp_1best, valid_ref)
        elif eval_metric == "wer":
            valid_scores[eval_metric] = wer(valid_hyp_1best, valid_ref,
                                            _eval_tokenizer(args))
    return valid_scores, valid_ref


def test(cfg: Dict, output_path: Optional[str] = None, prepared: Optional[Dict] = None,
         save_attention: bool = False, save_scores: bool = False) -> None:
    """Decode (or with ``return_prob: ref`` score) the dev and test sets and
    write ``<output_path>.{dev,test}`` (joeynmt/prediction.py:524-635); the
    ranks of a data-parallel run share the batches out and rank 0 writes."""
    args = parse_global_args(cfg, rank=distributed.rank(), mode="test")
    check_ported(args)
    if save_attention:
        if (args.model.get("decoder", {}).get("type", "transformer") == "transformer"
                and args.test.beam_size != 1):
            raise ValueError("Attention plots can be saved with greedy decoding only. "
                             "Please set `beam_size: 1` in the config.")
        args = dataclasses.replace(args, test=dataclasses.replace(args.test,
                                                                  return_attention=True))
    if prepared is None:
        model, spec, loss_fn, _, dev_data, test_data = prepare(
            args, rank=distributed.rank(), mode="test")
        prepared = {"model": model, "spec": spec, "loss_fn": loss_fn, "dev": dev_data,
                    "test": test_data}
    if save_scores:
        if not output_path:
            raise ValueError("Please specify --output-path for saving scores.")
        if args.test.return_prob == "none":
            logger.warning("Please specify prob type: {`ref` or `hyp`} in the config. "
                           "Scores will not be saved.")
            save_scores = False
        elif args.test.return_prob == "ref" and args.test.beam_size != 1:
            raise ValueError("Scores of given references can be computed with greedy "
                             "decoding only. Please set `beam_size: 1` in the config.")

    for data_set_name in ("dev", "test"):
        data_set = prepared[data_set_name]
        if data_set is None:
            continue
        data_set.reset_indices(random_subset=-1)  # no subsampling in evaluation
        logger.info("%s on %s set...",
                    "Scoring" if args.test.return_prob == "ref" else "Decoding",
                    data_set_name)
        _, _, hypotheses, hypotheses_raw, seq_scores, att_scores = predict(
            prepared["model"], prepared["spec"], data_set, loss_fn=prepared["loss_fn"],
            compute_loss=args.test.return_prob == "ref",
            normalization=args.train.normalization, num_workers=args.num_workers,
            args=args.test)
        if output_path is not None and distributed.is_main():
            if save_attention and att_scores:
                attention_file_name = f"{output_path}.{data_set_name}.att"
                logger.info("Saving attention plots. This might take a while..")
                store_attention_plots(
                    attentions=att_scores, targets=hypotheses_raw,
                    sources=data_set.get_list(lang=data_set.src_lang, tokenized=True),
                    indices=range(len(hypotheses) if hypotheses else 0),
                    output_prefix=attention_file_name)
                logger.info("Attention plots saved to: %s", attention_file_name)
            elif save_attention:
                logger.warning("Attention scores could not be saved. Note that attention "
                               "scores are not available when using beam search. Set "
                               "beam_size to 1 for greedy decoding.")
            if save_scores and seq_scores is not None:
                write_list_to_file(Path(f"{output_path}.{data_set_name}.scores"),
                                   seq_scores)
                write_list_to_file(Path(f"{output_path}.{data_set_name}.tokens"),
                                   hypotheses_raw)
                logger.info("Scores and corresponding tokens saved to: %s.{scores|tokens}",
                            f"{output_path}.{data_set_name}")
            if hypotheses is not None:
                output_path_set = Path(f"{output_path}.{data_set_name}")
                save_hypothese(output_path_set, hypotheses, args.test.n_best)
                logger.info("Translations saved to: %s.", output_path_set)


def translate(cfg: Dict, output_path: Optional[str] = None) -> None:
    """Decode the lines of stdin (feature or audio paths for S2T), or
    interactive input from a terminal (joeynmt/prediction.py:638-735)."""
    args = parse_global_args(cfg, rank=0, mode="test")
    check_ported(args)
    model, spec, loss_fn, _, _, test_data = prepare(args, rank=0, mode="translate")
    expected = StreamDataset if args.task == "MT" else SpeechStreamDataset
    if not isinstance(test_data, expected):
        raise TypeError(f"translate needs a {expected.__name__}")
    logger.info("Ready to decode.")

    def _translate_data(test_cfg: TestConfig):
        _, _, hypotheses, trg_tokens, trg_scores, _ = predict(
            model, spec, test_data, loss_fn=loss_fn, compute_loss=False,
            normalization="none", num_workers=args.num_workers, args=test_cfg)
        return hypotheses, trg_tokens, trg_scores

    if not sys.stdin.isatty():
        for i, line in enumerate(sys.stdin.readlines()):
            if not line.strip():
                logger.warning("The sentence in line %d is empty. Skip to load.", i)
                continue
            test_data.set_item(line.rstrip())
        all_hypotheses, _, _ = _translate_data(args.test)
        if output_path is not None:
            out_file = Path(output_path).expanduser()
            save_hypothese(out_file, all_hypotheses, args.test.n_best)
            logger.info("Translations saved to: %s.", out_file)
        else:
            for hyp in all_hypotheses:
                print(hyp)
        return

    test_cfg = dataclasses.replace(args.test, batch_size=1, batch_type="sentence")
    np.set_printoptions(linewidth=sys.maxsize)
    while True:
        try:
            src_input = input("\nPlease enter a source sentence:\n")
            if not src_input.strip():
                break
            test_data.set_item(src_input.rstrip())
            hypotheses, tokens, scores = _translate_data(test_cfg)
            print("JoeyS2T:")
            for i, (hyp, token, score) in enumerate(zip_longest(hypotheses, tokens, scores)):
                print(f"#{i + 1}: {hyp}")
                if test_cfg.return_prob == "hyp":
                    print(f"\ttokens: {token}\n\tscores: {score}")
            test_data.reset_cache()
        except (KeyboardInterrupt, EOFError):
            print("\nBye.")
            break
