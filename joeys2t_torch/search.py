# coding: utf-8
"""
Greedy search over the KV cache (counterpart of joeys2t_tpu/search.py:
``_apply_token_bans`` :36, ``_cast_params_to_compute_dtype`` :106,
``_transformer_greedy_jit`` :126, ``transformer_greedy`` :266, ``greedy``
:372, ``search`` :795).

The JAX ``lax.while_loop`` becomes a Python loop over a cache preallocated
for ``max_output_length + 1`` positions. The stop rule is the JAX one: stop
after ``max_output_length`` steps or once every row has emitted eos; rows
that finished earlier emit pad with score 0 (docs/architecture.md:129-130).
Checking "every row finished" reads one flag from the device per step.
Repetition penalty, n-gram blocking, prompts, returned attention and beam
search are not ported yet and raise.
"""
import copy
from typing import Dict, Optional

import numpy as np
import torch

from joeys2t_torch.data.batch import Batch, round_up_to_bucket
from joeys2t_torch.helpers import resolve_device
from joeys2t_torch.models.model import ModelSpec, Seq2SeqModel

NEG_INF = -1.0e9

__all__ = ["greedy", "search", "transformer_greedy"]


def _apply_token_bans(log_probs: torch.Tensor, banned: torch.Tensor, eos_index: int,
                      step: int, min_output_length: int) -> torch.Tensor:
    """Forbid the ``banned`` ids (bos, sep, lang tags, and unk unless it may
    be generated), and eos before ``min_output_length`` (joeynmt/search.py:287-297)."""
    log_probs = log_probs.index_fill(1, banned, NEG_INF)
    if step < min_output_length:
        log_probs[:, eos_index] = NEG_INF
    return log_probs


def _banned_ids(spec: ModelSpec, vocab_size: int, generate_unk: bool,
                device: torch.device) -> torch.Tensor:
    ids = [t for t in spec.forbidden_at_generation if t < vocab_size]
    if not generate_unk:
        ids.append(spec.unk_index)
    return torch.tensor(ids, dtype=torch.long, device=device)


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
    for name, t in (("encoder_output", encoder_output), ("src_mask", src_mask),
                    ("model", next(model.parameters()))):
        if t.device.type != device.type:
            raise ValueError(f"{name} is on {t.device}, the search runs on {device}")
    unported = [k for k in ("repetition_penalty", "no_repeat_ngram_size")
                if float(kwargs.get(k, -1)) > 0]
    unported += [k for k in ("decoder_prompt", "trg_prompt_mask", "encoder_input")
                 if kwargs.get(k) is not None]
    if kwargs.get("return_attention", False):
        unported.append("return_attention")
    if unported:
        raise NotImplementedError(f"greedy search options not ported yet: {unported}")
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


def search(model: Seq2SeqModel, spec: ModelSpec, batch: Batch, max_output_length: int,
           beam_size: int, beam_alpha: float, n_best: int = 1, device=None,
           decode_model: Optional[Seq2SeqModel] = None, stats: Optional[Dict] = None,
           **kwargs):
    """Encode ``batch`` once, then decode it greedily (joeynmt/search.py:
    828-912). A negative ``max_output_length`` becomes 1.5 times the longest
    source, and the length is rounded up to a bucket, as the JAX package
    rounds it for its compiled loops: hypotheses that never emit eos have
    the same length in both. The encoder reads ``model``'s float32 masters;
    the loop decodes from ``decode_model`` (``model`` with its decode side
    cast to the compute dtype) when the caller cast it once for many
    batches. Beam search is not ported yet and raises.

    :return: (output ids (B, L), scores or None, None), numpy
    """
    del beam_alpha, n_best  # beam search only
    if beam_size > 1:
        raise NotImplementedError("beam search is not ported yet")
    device = resolve_device(device)
    with torch.inference_mode():
        src = torch.from_numpy(np.ascontiguousarray(batch.src)).to(
            device, getattr(model.encoder, "dtype", torch.float32))
        src_length = torch.from_numpy(np.asarray(batch.src_length)).to(device, torch.long)
        encoder_output, encoder_hidden, src_mask = model.encode(src, src_length)
    if max_output_length < 0:  # adapt to the source length
        max_output_length = int(np.max(batch.src_length) * 1.5)
    max_output_length = round_up_to_bucket(max_output_length)
    return greedy(decode_model if decode_model is not None else model, spec,
                  encoder_output, encoder_hidden, src_mask, max_output_length,
                  device=device, stats=stats, **kwargs)
