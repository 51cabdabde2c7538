# coding: utf-8
"""
Greedy and beam search over the KV cache (counterpart of
joeys2t_tpu/search.py: ``_apply_token_bans`` :36,
``_cast_params_to_compute_dtype`` :106, ``_transformer_greedy_jit`` :126,
``transformer_greedy`` :266, ``greedy`` :372, ``_beam_search_jit`` :381,
``beam_search`` :706, ``search`` :795).

The JAX ``lax.while_loop`` becomes a Python loop over a cache preallocated
for ``max_output_length + 1`` positions. The stop rule is the JAX one: stop
after ``max_output_length`` steps or once every row has finished (greedy:
emitted eos, after which a row emits pad with score 0,
docs/architecture.md:129-130; beam: every utterance is done). Checking it
reads one flag from the device per step.

Beam search keeps JAX's fixed-shape state (K alive beams and a finished
store of the K best hypotheses an utterance) and its rules: the GNMT length
penalty ``((5 + step + 1) / 6) ** alpha`` in float32, selection as
``jax.lax.top_k`` makes it (ties to the lower index, through a stable
sort), the finished store merged from 2K candidates, unfilled n-best slots
as ``[unk]`` with score -1. The cross-attention cache stays at B rows,
shared by an utterance's beams; the self-attention caches, with their
scales when int8, are reordered physically after each selection (JAX's ``beam_reorder: physical``; its
default ``auto`` takes the ancestry map, the same math, which is not ported,
so ``auto`` reorders physically and ``lazy`` raises). Repetition penalty,
n-gram blocking, prompts and returned attention are not ported yet and
raise.
"""
import copy
from typing import Dict, Optional

import numpy as np
import torch

from joeys2t_torch.data.batch import Batch, round_up_to_bucket
from joeys2t_torch.helpers import resolve_device
from joeys2t_torch.models.model import ModelSpec, Seq2SeqModel

NEG_INF = -1.0e9

__all__ = ["beam_search", "greedy", "search", "transformer_greedy"]


def _apply_token_bans(log_probs: torch.Tensor, banned: torch.Tensor, eos_index: int,
                      step: int, min_output_length: int) -> torch.Tensor:
    """Forbid the ``banned`` ids (bos, sep, lang tags, and unk unless it may
    be generated), and eos before ``min_output_length`` (joeynmt/search.py:287-297)."""
    log_probs = log_probs.index_fill(1, banned, NEG_INF)
    if step < min_output_length:
        log_probs[:, eos_index] = NEG_INF
    return log_probs


def _banned_ids(spec: ModelSpec, vocab_size: int, generate_unk: bool,
                device: torch.device, also=()) -> torch.Tensor:
    ids = [t for t in spec.forbidden_at_generation + tuple(also) if t < vocab_size]
    if not generate_unk:
        ids.append(spec.unk_index)
    return torch.tensor(ids, dtype=torch.long, device=device)


def _check_search_args(device: torch.device, tensors: Dict, kwargs: Dict) -> None:
    """Raise for inputs off ``device`` and for search options not ported."""
    for name, t in tensors.items():
        if t.device.type != device.type:
            raise ValueError(f"{name} is on {t.device}, the search runs on {device}")
    unported = [k for k in ("repetition_penalty", "no_repeat_ngram_size")
                if float(kwargs.get(k, -1)) > 0]
    unported += [k for k in ("decoder_prompt", "trg_prompt_mask", "encoder_input")
                 if kwargs.get(k) is not None]
    if kwargs.get("return_attention", False):
        unported.append("return_attention")
    if kwargs.get("beam_reorder", "auto") == "lazy":
        unported.append("beam_reorder: lazy")
    if unported:
        raise NotImplementedError(f"search options not ported yet: {unported}")


def _cast_params_to_compute_dtype(model: Seq2SeqModel) -> Seq2SeqModel:
    """A model whose decode side (target embedding and decoder) holds copies
    of the float parameters in the compute dtype, so the decode loop reads
    each weight once in that dtype per step instead of re-casting float32
    masters at every use. LayerNorm still computes in float32 (from the cast
    values, as in the JAX loop). The encoder is shared, not copied, and
    ``model`` keeps its float32 masters: the JAX function likewise casts a
    copy of the parameters inside jit. A model whose decode side is already
    in the compute dtype (every float32 model) is returned unchanged."""
    dtype = model.decoder.dtype
    decode_side = (model.trg_embed, model.decoder)
    if all(p.dtype == dtype for m in decode_side for p in m.parameters()):
        return model
    # the copies share the trainer's dropout generator rather than cloning it
    memo = {id(g): g for m in decode_side for g in
            (getattr(d, "generator", None) for d in m.modules()) if g is not None}
    trg_embed, decoder = (copy.deepcopy(m, dict(memo)).to(dtype) for m in decode_side)
    return Seq2SeqModel(model.encoder, decoder, trg_embed).train(model.training)


@torch.inference_mode()
def _transformer_greedy(model: Seq2SeqModel, spec: ModelSpec,
                        encoder_output: torch.Tensor, src_mask: torch.Tensor,
                        max_output_length: int, min_output_length: int = 1,
                        generate_unk: bool = True, return_prob: bool = False):
    """Greedy loop; returns (ys incl BOS (B, L+1), scores (B, L+1), steps run)."""
    b = encoder_output.shape[0]
    device = encoder_output.device
    l1 = max_output_length + 1
    cache = model.init_cache(encoder_output, l1, src_mask)
    ys = torch.full((b, l1), spec.pad_index, dtype=torch.long, device=device)
    ys[:, 0] = spec.bos_index
    yv = torch.zeros((b, l1), dtype=torch.float32, device=device)
    finished = torch.zeros((b,), dtype=torch.bool, device=device)
    banned = _banned_ids(spec, spec.trg_vocab_size, generate_unk, device)
    pad = torch.tensor(spec.pad_index, dtype=torch.long, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)

    step = 0
    while step < max_output_length:
        logits = model.decode_step(ys[:, step:step + 1], step, cache)
        log_probs = logits[:, 0].float()
        if return_prob:
            log_probs = torch.log_softmax(log_probs, dim=-1)
        log_probs = _apply_token_bans(log_probs, banned, spec.eos_index, step,
                                      min_output_length)
        prob = log_probs.amax(dim=-1)
        next_word = log_probs.argmax(dim=-1)  # first maximum, as jnp.argmax
        # finished rows emit pad with score 0
        ys[:, step + 1] = torch.where(finished, pad, next_word)
        yv[:, step + 1] = torch.where(finished, zero, prob)
        finished |= ys[:, step + 1] == spec.eos_index
        step += 1
        if bool(finished.all()):
            break
    return ys, yv, step


def transformer_greedy(model: Seq2SeqModel, spec: ModelSpec,
                       encoder_output: torch.Tensor, src_mask: torch.Tensor,
                       max_output_length: int, device=None,
                       stats: Optional[Dict] = None, **kwargs):
    """KV-cached greedy decoding on ``device`` (``cuda`` unless given).

    A model with float32 masters and a lower compute dtype decodes from a
    copy of its decode side cast for this call; a caller that decodes many
    times casts once with ``_cast_params_to_compute_dtype`` and passes the
    result, as ``Transcriber`` does.

    :param encoder_output: (B, S, H) on ``device``
    :param src_mask: (B, 1, S) bool on ``device``
    :param stats: optional dict; ``stats["decode_steps"]`` grows by the
        number of decode steps run
    :return: (output ids (B, L) numpy, scores (B, L) numpy when
        ``return_prob="hyp"`` else None, None)
    """
    device = resolve_device(device)
    _check_search_args(device, {"encoder_output": encoder_output, "src_mask": src_mask,
                                "model": next(model.parameters())}, kwargs)
    return_prob = kwargs.get("return_prob", "none") == "hyp"
    model = _cast_params_to_compute_dtype(model)
    ys, yv, steps = _transformer_greedy(
        model, spec, encoder_output, src_mask, int(max_output_length),
        min_output_length=int(kwargs.get("min_output_length", 1)),
        generate_unk=bool(kwargs.get("generate_unk", True)), return_prob=return_prob)
    if stats is not None:
        stats["decode_steps"] = stats.get("decode_steps", 0) + steps
    output = ys[:, 1:].cpu().numpy()
    scores = yv[:, 1:].cpu().numpy() if return_prob else None
    return output, scores, None


def greedy(model: Seq2SeqModel, spec: ModelSpec, encoder_output: torch.Tensor,
           encoder_hidden, src_mask: torch.Tensor, max_output_length: int,
           device=None, **kwargs):
    """Greedy dispatch (joeynmt/search.py:21-61); only the transformer
    decoder is ported."""
    del encoder_hidden  # recurrent decoders only
    return transformer_greedy(model, spec, encoder_output, src_mask,
                              max_output_length, device=device, **kwargs)


def _stable_topk(x: torch.Tensor, k: int):
    """The ``k`` largest entries of the last dimension in descending order,
    equal values in index order, as ``jax.lax.top_k`` returns them."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@torch.inference_mode()
def _transformer_beam(model: Seq2SeqModel, spec: ModelSpec, encoder_output: torch.Tensor,
                      src_mask: torch.Tensor, beam_size: int, max_output_length: int,
                      alpha: float, min_output_length: int = 1, generate_unk: bool = True):
    """Beam loop (joeys2t_tpu/search.py:381-610 with ``lazy_reorder`` off);
    returns (finished sequences incl BOS (B, K, L+1), their scores (B, K)
    sorted best first, steps run)."""
    # pylint: disable=too-many-locals
    b = encoder_output.shape[0]
    k, v, l1 = beam_size, spec.trg_vocab_size, max_output_length + 1
    device = encoder_output.device
    cache = model.init_cache(encoder_output, l1, src_mask, beam_k=k)
    # the self-attention buffers (with their scales when int8), and a spare
    # of each to reorder into; the cross caches and their scales stay as
    # they are, shared by an utterance's beams
    buffers = [(cache[name], key) for name in cache if name.startswith("layer_")
               for key in ("self_k", "self_v", "self_k_scale", "self_v_scale")
               if key in cache[name]]
    spares = [torch.empty_like(layer[key]) for layer, key in buffers]

    alive_seq = torch.full((b * k, l1), spec.pad_index, dtype=torch.long, device=device)
    alive_seq[:, 0] = spec.bos_index
    # the first beam starts at log-prob 0, the others at NEG_INF
    topk_log_probs = torch.full((b, k), NEG_INF, device=device)
    topk_log_probs[:, 0] = 0.0
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    fin_scores = torch.full((b, k), NEG_INF, device=device)
    fin_seqs = torch.full((b, k, l1), spec.pad_index, dtype=torch.long, device=device)
    banned = _banned_ids(spec, v, generate_unk, device, also=(spec.pad_index,))
    beam_offset = (torch.arange(b, device=device) * k)[:, None]
    positions = torch.arange(1, l1, device=device)

    step = 0
    while step < max_output_length:
        logits = model.decode_step(alive_seq[:, step:step + 1], step, cache, beam_k=k)
        log_probs = torch.log_softmax(logits[:, 0].float(), dim=-1)
        log_probs = _apply_token_bans(log_probs, banned, spec.eos_index, step,
                                      min_output_length)
        log_probs = log_probs + topk_log_probs.reshape(-1)[:, None]
        curr_scores = log_probs
        if alpha > 0:  # GNMT length penalty, in float32 as the JAX loop computes it
            length_penalty = ((torch.tensor(5.0) + (step + 1.0)) / 6.0) ** alpha
            curr_scores = curr_scores / length_penalty
        topk_scores, topk_ids = _stable_topk(curr_scores.reshape(b, k * v), k)
        topk_log_probs = topk_scores * length_penalty if alpha > 0 else topk_scores
        topk_token = topk_ids % v
        select = (topk_ids // v + beam_offset).reshape(-1)
        alive_seq = alive_seq.index_select(0, select)
        alive_seq[:, step + 1] = topk_token.reshape(-1)
        for i, (layer, key) in enumerate(buffers):  # the physical reorder
            torch.index_select(layer[key], 0, select, out=spares[i])
            layer[key], spares[i] = spares[i], layer[key]

        # finished bookkeeping (joeynmt/search.py:671-717)
        seq_bk = alive_seq.reshape(b, k, l1)
        newly_eos = topk_token == spec.eos_index
        n_eos_before = ((seq_bk[:, :, 1:] == spec.eos_index) & (positions <= step)).sum(-1)
        # a candidate ends with eos now and has no earlier eos, or reaches
        # the length limit without any
        collectible = newly_eos & (n_eos_before == 0) & ~done[:, None]
        at_max = step + 1 == max_output_length
        if at_max:
            collectible |= (n_eos_before == 0) & ~newly_eos & ~done[:, None]
        cand_scores = torch.where(collectible, topk_scores, NEG_INF)
        # the store keeps the k best of its own and the new candidates
        fin_scores, best = _stable_topk(torch.cat([fin_scores, cand_scores], dim=1), k)
        fin_seqs = torch.gather(torch.cat([fin_seqs, seq_bk], dim=1), 1,
                                best[:, :, None].expand(b, k, l1))
        is_finished = newly_eos | (n_eos_before > 0) | (topk_scores < NEG_INF / 10.0)
        done |= is_finished.all(dim=1) | at_max
        step += 1
        if bool(done.all()):
            break
    return fin_seqs, fin_scores, step


def beam_search(model: Seq2SeqModel, spec: ModelSpec, encoder_output: torch.Tensor,
                encoder_hidden, src_mask: torch.Tensor, beam_size: int,
                max_output_length: int, alpha: float, n_best: int = 1, device=None,
                stats: Optional[Dict] = None, **kwargs):
    """KV-cached beam search on ``device`` (``cuda`` unless given)
    (joeynmt/search.py:345-825): the ``n_best`` best hypotheses of each
    utterance, best first, cut after their first eos.

    :param encoder_output: (B, S, H) on ``device``
    :param src_mask: (B, 1, S) bool on ``device``
    :param stats: optional dict; ``stats["decode_steps"]`` grows by the
        number of decode steps run
    :return: (output ids (B*n_best, L) numpy, scores (B*n_best, 1) numpy
        when ``return_prob="hyp"`` else None, None)
    """
    del encoder_hidden  # recurrent decoders only
    if beam_size < 1:
        raise ValueError("Beam size must be >0.")
    if n_best > beam_size:
        raise ValueError(f"Can only return {beam_size} best hypotheses. `n_best` must be "
                         f"smaller than or equal to `beam_size`.")
    device = resolve_device(device)
    _check_search_args(device, {"encoder_output": encoder_output, "src_mask": src_mask,
                                "model": next(model.parameters())}, kwargs)
    return_prob = kwargs.get("return_prob", "none") == "hyp"
    model = _cast_params_to_compute_dtype(model)
    fin_seqs, fin_scores, steps = _transformer_beam(
        model, spec, encoder_output, src_mask, int(beam_size), int(max_output_length),
        float(alpha), min_output_length=int(kwargs.get("min_output_length", 1)),
        generate_unk=bool(kwargs.get("generate_unk", True)))
    if stats is not None:
        stats["decode_steps"] = stats.get("decode_steps", 0) + steps
    fin_seqs, fin_scores = fin_seqs.cpu().numpy(), fin_scores.cpu().numpy()

    predictions, scores = [], []
    for seqs, seq_scores in zip(fin_seqs, fin_scores):
        for n in range(n_best):
            if seq_scores[n] <= NEG_INF:  # unfilled slot (joeynmt/search.py:795-804)
                predictions.append(np.array([spec.unk_index], np.int64))
                scores.append(-1.0)
                continue
            seq = seqs[n, 1:]  # drop BOS
            eos_pos = np.flatnonzero(seq == spec.eos_index)
            predictions.append(seq[:eos_pos[0] + 1] if len(eos_pos) else seq)
            scores.append(float(seq_scores[n]))
    output = np.full((len(predictions), max(len(p) for p in predictions)), spec.pad_index,
                     np.int64)
    for row, p in zip(output, predictions):
        row[:len(p)] = p
    return output, (np.array(scores, np.float32)[:, None] if return_prob else None), None


def search(model: Seq2SeqModel, spec: ModelSpec, batch: Batch, max_output_length: int,
           beam_size: int, beam_alpha: float, n_best: int = 1, device=None,
           decode_model: Optional[Seq2SeqModel] = None, stats: Optional[Dict] = None,
           **kwargs):
    """Encode ``batch`` once, then decode it greedily or, for ``beam_size``
    > 1, with beam search (joeynmt/search.py:828-912). A negative
    ``max_output_length`` becomes 1.5 times the longest source, and the
    length is rounded up to a bucket, as the JAX package rounds it for its
    compiled loops: hypotheses that never emit eos have the same length in
    both. The encoder reads ``model``'s float32 masters; the loop decodes
    from ``decode_model`` (``model`` with its decode side cast to the
    compute dtype) when the caller cast it once for many batches.

    :return: (output ids (B*n_best, L), scores or None, None), numpy
    """
    device = resolve_device(device)
    with torch.inference_mode():
        src = torch.from_numpy(np.ascontiguousarray(batch.src)).to(
            device, getattr(model.encoder, "dtype", torch.float32))
        src_length = torch.from_numpy(np.asarray(batch.src_length)).to(device, torch.long)
        encoder_output, encoder_hidden, src_mask = model.encode(src, src_length)
    if max_output_length < 0:  # adapt to the source length
        max_output_length = int(np.max(batch.src_length) * 1.5)
    max_output_length = round_up_to_bucket(max_output_length)
    decode_model = decode_model if decode_model is not None else model
    if beam_size < 2:
        kwargs.pop("beam_reorder", None)  # a beam-only option
        return greedy(decode_model, spec, encoder_output, encoder_hidden, src_mask,
                      max_output_length, device=device, stats=stats, **kwargs)
    return beam_search(decode_model, spec, encoder_output, encoder_hidden, src_mask,
                       beam_size, max_output_length, beam_alpha, n_best=n_best,
                       device=device, stats=stats, **kwargs)
