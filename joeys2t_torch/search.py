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
so ``auto`` reorders physically and ``lazy`` raises). Returned attention
is not ported yet and raises.

Recurrent decoders (``recurrent_greedy`` :305, ``_recurrent_beam_search``
:613) carry (state, attentional vector) from step to step on the device
and keep JAX's host rules, in float64 as JAX computes them with numpy:
greedy bans with -inf and runs on after a row's eos until every row has
one (its output is as long as the steps run; a finished row goes on
emitting, as in JAX, and the caller cuts after the first eos), and beam
search adds the length penalty to the scores ranked and takes it back out
of those kept, sets a finished beam's score to -inf, and collects each
hypothesis when it ends (or at the length limit), best first, with unfilled
n-best slots as ``[unk]`` and -1. Ties go to the lower index
(``_stable_topk``); numpy's ``argsort``, which JAX's loop calls, orders
ties its own way, which only shows among -inf candidates, when fewer than
K are finite. Like JAX's, these searches ignore the repetition penalty,
n-gram blocking and prompts.

Text models (MT) add JAX's search options, computed on the device: the
repetition penalty over the history and the source (:50-64), the fairseq
n-gram blocker over the history (:67-103) and over the source (:242-263),
and forced (prompt) decoding, where the positions of ``trg_prompt_mask``
take the tokens of ``decoder_prompt`` (:162-216, :402-470). As in JAX, the
search encodes the source without its prompt mask.
"""
import copy
from typing import Dict, Optional

import numpy as np
import torch

from joeys2t_torch.data.batch import Batch, round_up_to_bucket
from joeys2t_torch.helpers import resolve_device
from joeys2t_torch.models.model import ModelSpec, Seq2SeqModel
from joeys2t_torch.models.rnn import RecurrentDecoder

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


def _penalize_repetition(log_probs: torch.Tensor, tokens: torch.Tensor,
                         valid: torch.Tensor, penalty: float,
                         exclude: torch.Tensor) -> torch.Tensor:
    """The repetition penalty (joeynmt/search.py:972-1001) on the ids seen
    in ``tokens`` (B, L) where ``valid``, apart from ``exclude``: a negative
    log-probability times ``penalty``, a positive one divided by it."""
    seen = torch.zeros(log_probs.shape, dtype=torch.long, device=log_probs.device)
    seen = seen.scatter_add_(1, tokens, valid.long()) > 0
    seen[:, exclude] = False
    penalized = torch.where(log_probs < 0, log_probs * penalty, log_probs / penalty)
    return torch.where(seen, penalized, log_probs)


def _ban_ngram_continuations(log_probs: torch.Tensor, ys: torch.Tensor, step: int,
                             tokens: torch.Tensor, starts_ok: torch.Tensor,
                             ngram_size: int, exclude: torch.Tensor) -> torch.Tensor:
    """Ban, in each row, every token of ``tokens`` (B, L) that follows an
    (n-1)-gram equal to the row's last n-1 tokens of ``ys`` (up to
    ``step``), counting only the windows whose start ``starts_ok`` (L,)
    allows; ``exclude`` ids are never banned."""
    if step + 2 - ngram_size < 1:  # not enough history yet
        return log_probs
    l_max = tokens.shape[1]
    offset = ngram_size - 1
    device = log_probs.device
    suffix = ys[:, (step - offset + 1 + torch.arange(offset, device=device)).clamp(
        0, ys.shape[1] - 1)]  # (B, n-1)
    pos = torch.arange(l_max, device=device)
    windows = tokens[:, (pos[:, None] + torch.arange(offset, device=device)).clamp(
        0, l_max - 1)]  # (B, L, n-1)
    matches = (windows == suffix[:, None, :]).all(dim=-1) & starts_ok
    banned_tok = tokens[:, (pos + offset).clamp(0, l_max - 1)]
    ban = torch.zeros(log_probs.shape, dtype=torch.long, device=device)
    ban = ban.scatter_add_(1, banned_tok, matches.long()) > 0
    ban[:, exclude] = False
    return log_probs.masked_fill(ban, NEG_INF)


def _block_repeat_ngrams(log_probs: torch.Tensor, ys: torch.Tensor, step: int,
                         ngram_size: int, exclude: torch.Tensor) -> torch.Tensor:
    """The fairseq n-gram blocker (joeynmt/search.py:915-969) over the
    prefix ``ys[:, :step + 1]`` (position 0 is bos): windows start at 1
    and end by ``step``."""
    pos = torch.arange(ys.shape[1], device=ys.device)
    return _ban_ngram_continuations(log_probs, ys, step, ys,
                                    (pos >= 1) & (pos + ngram_size - 1 <= step),
                                    ngram_size, exclude)


def _block_src_ngrams(log_probs: torch.Tensor, ys: torch.Tensor, step: int,
                      src: torch.Tensor, ngram_size: int,
                      exclude: torch.Tensor) -> torch.Tensor:
    """Source-side blocking (joeynmt/search.py:956-963): a source token
    that follows an (n-1)-gram of the source equal to the hypothesis'
    suffix is banned."""
    pos = torch.arange(src.shape[1], device=src.device)
    return _ban_ngram_continuations(log_probs, ys, step, src,
                                    pos + ngram_size - 1 <= src.shape[1] - 1,
                                    ngram_size, exclude)


def _history_controls(log_probs: torch.Tensor, ys: torch.Tensor, step: int,
                      encoder_input: Optional[torch.Tensor], ngram_from: int,
                      no_repeat_ngram_size: int, repetition_penalty: float,
                      exclude: torch.Tensor) -> torch.Tensor:
    """n-gram blocking (from ``ngram_from``-grams up: greedy 2, beam 1) then
    the repetition penalty, each over the history and, with
    ``encoder_input``, over the source, in the JAX order."""
    if no_repeat_ngram_size >= ngram_from:
        log_probs = _block_repeat_ngrams(log_probs, ys, step, no_repeat_ngram_size,
                                         exclude)
        if encoder_input is not None:
            log_probs = _block_src_ngrams(log_probs, ys, step, encoder_input,
                                          no_repeat_ngram_size, exclude)
    if repetition_penalty > 1.0:
        hist_valid = torch.arange(ys.shape[1], device=ys.device)[None, :] <= step
        log_probs = _penalize_repetition(log_probs, ys, hist_valid.expand_as(ys),
                                         repetition_penalty, exclude)
        if encoder_input is not None:
            log_probs = _penalize_repetition(log_probs, encoder_input,
                                             torch.ones_like(encoder_input, dtype=torch.bool),
                                             repetition_penalty, exclude)
    return log_probs


def _prompt_arrays(decoder_prompt, trg_prompt_mask, rows: int, l1: int, pad: int,
                   device: torch.device, repeat: int = 1):
    """The forced tokens and the prompt mask (``rows``, ``l1``) on
    ``device``: each prompt row ``repeat`` times, cut or padded with pad and
    0 to ``l1`` positions; (None, None) without a prompt."""
    if decoder_prompt is None or trg_prompt_mask is None:
        return None, None
    dp = torch.full((rows, l1), pad, dtype=torch.long, device=device)
    pm = torch.zeros((rows, l1), dtype=torch.long, device=device)
    for out, x in ((dp, decoder_prompt), (pm, trg_prompt_mask)):
        x = torch.as_tensor(x, device=device)[:, :l1]
        out[:, :x.shape[1]] = x.repeat_interleave(repeat, dim=0)
    return dp, pm


def _check_search_args(device: torch.device, tensors: Dict, kwargs: Dict) -> None:
    """Raise for inputs off ``device`` and for search options not ported."""
    for name, t in tensors.items():
        if t.device.type != device.type:
            raise ValueError(f"{name} is on {t.device}, the search runs on {device}")
    unported = []
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
    values, as in the JAX loop). The encoder and an untied source embedding
    are shared, not copied (a tied table is copied once, with the target
    side), and
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
    # a tied table is one module: its one copy serves both sides
    src_embed = trg_embed if model.src_embed is model.trg_embed else model.src_embed
    return Seq2SeqModel(model.encoder, decoder, trg_embed, src_embed,
                        model.tied_softmax).train(model.training)


@torch.inference_mode()
def _transformer_greedy(model: Seq2SeqModel, spec: ModelSpec,
                        encoder_output: torch.Tensor, src_mask: torch.Tensor,
                        max_output_length: int, min_output_length: int = 1,
                        generate_unk: bool = True, return_prob: bool = False,
                        repetition_penalty: float = -1.0, no_repeat_ngram_size: int = -1,
                        encoder_input: Optional[torch.Tensor] = None,
                        decoder_prompt=None, trg_prompt_mask=None):
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
    exclude = _exclude_ids(spec, device)
    dp, pm = _prompt_arrays(decoder_prompt, trg_prompt_mask, b, l1, spec.pad_index, device)
    pad = torch.tensor(spec.pad_index, dtype=torch.long, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    softmax = (return_prob or repetition_penalty > 0 or no_repeat_ngram_size > 0
               or encoder_input is not None)

    step = 0
    while step < max_output_length:
        logits = model.decode_step(ys[:, step:step + 1], step, cache,
                                   trg_prompt_mask_t=None if pm is None
                                   else pm[:, step:step + 1])
        log_probs = logits[:, 0].float()
        if softmax:
            log_probs = _history_controls(torch.log_softmax(log_probs, dim=-1), ys, step,
                                          encoder_input, 2, no_repeat_ngram_size,
                                          repetition_penalty, exclude)
        log_probs = _apply_token_bans(log_probs, banned, spec.eos_index, step,
                                      min_output_length)
        prob = log_probs.amax(dim=-1)
        next_word = log_probs.argmax(dim=-1)  # first maximum, as jnp.argmax
        if pm is not None:  # forced (prompt) positions take their token, score 0
            forced = pm[:, step + 1] > 0
            next_word = torch.where(forced, dp[:, step + 1], next_word)
            prob = torch.where(forced, zero, prob)
        # finished rows emit pad with score 0
        ys[:, step + 1] = torch.where(finished, pad, next_word)
        yv[:, step + 1] = torch.where(finished, zero, prob)
        finished |= ys[:, step + 1] == spec.eos_index
        step += 1
        if bool(finished.all()):
            break
    return ys, yv, step


def _exclude_ids(spec: ModelSpec, device: torch.device) -> torch.Tensor:
    """The ids the repetition controls never touch: specials and language
    tags."""
    ids = [t for t in spec.specials + spec.lang_tags if t < spec.trg_vocab_size]
    return torch.tensor(ids, dtype=torch.long, device=device)


def _control_kwargs(kwargs: Dict, device: torch.device) -> Dict:
    """The history-control and prompt options of a search call, with the
    source ids as a tensor on ``device``."""
    encoder_input = kwargs.get("encoder_input")
    return dict(
        repetition_penalty=float(kwargs.get("repetition_penalty", -1)),
        no_repeat_ngram_size=int(kwargs.get("no_repeat_ngram_size", -1)),
        encoder_input=None if encoder_input is None else torch.as_tensor(
            encoder_input, dtype=torch.long, device=device),
        decoder_prompt=kwargs.get("decoder_prompt"),
        trg_prompt_mask=kwargs.get("trg_prompt_mask"))


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
    :param kwargs: also ``repetition_penalty``, ``no_repeat_ngram_size``,
        ``encoder_input`` (B, S) source ids, and ``decoder_prompt`` with
        ``trg_prompt_mask`` (B, P), the forced prefix from bos on
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
        generate_unk=bool(kwargs.get("generate_unk", True)), return_prob=return_prob,
        **_control_kwargs(kwargs, device))
    if stats is not None:
        stats["decode_steps"] = stats.get("decode_steps", 0) + steps
    output = ys[:, 1:].cpu().numpy()
    scores = yv[:, 1:].cpu().numpy() if return_prob else None
    return output, scores, None


@torch.inference_mode()
def _recurrent_greedy(model: Seq2SeqModel, spec: ModelSpec, encoder_output: torch.Tensor,
                      encoder_hidden: Optional[torch.Tensor], src_mask: torch.Tensor,
                      max_output_length: int, min_output_length: int = 1,
                      generate_unk: bool = True, return_prob: bool = False):
    """Greedy loop of a recurrent decoder (joeys2t_tpu/search.py:305-352);
    returns (ids (B, steps), float64 scores (B, steps), steps run)."""
    decoder = model.decoder
    encoder_output = encoder_output.float()
    b, device = encoder_output.shape[0], encoder_output.device
    carry, att_vector, proj_keys = decoder.init_state(encoder_output, encoder_hidden)
    banned = _banned_ids(spec, decoder.output_size, generate_unk, device,
                         also=(spec.pad_index,))
    ys = torch.zeros((b, max_output_length), dtype=torch.long, device=device)
    yv = torch.zeros((b, max_output_length), dtype=torch.float64, device=device)
    prev = torch.full((b, 1), spec.bos_index, dtype=torch.long, device=device)
    finished = torch.zeros((b,), dtype=torch.bool, device=device)
    step = 0
    while step < max_output_length:
        att_vector, carry, _ = decoder.step(model.trg_embed(prev), att_vector, carry,
                                            proj_keys, encoder_output, src_mask)
        out = decoder.output_layer(att_vector)[:, 0].double()
        out[:, spec.bos_index] = -np.inf
        if return_prob:
            out = out - torch.logsumexp(out, dim=1, keepdim=True)
        out = out.index_fill(1, banned, -np.inf)
        if step < min_output_length:
            out[:, spec.eos_index] = -np.inf
        ys[:, step], yv[:, step] = out.argmax(dim=1), out.amax(dim=1)
        prev = ys[:, step:step + 1]
        finished |= ys[:, step] == spec.eos_index
        step += 1
        if bool(finished.all()):
            break
    return ys[:, :step], yv[:, :step], step


def greedy(model: Seq2SeqModel, spec: ModelSpec, encoder_output: torch.Tensor,
           encoder_hidden, src_mask: torch.Tensor, max_output_length: int,
           device=None, stats: Optional[Dict] = None, **kwargs):
    """Greedy dispatch (joeynmt/search.py:21-61): a recurrent decoder's own
    loop from ``encoder_hidden``, or the transformer's KV-cached one.
    Returns (output ids (B, L) numpy, scores (B, L) numpy when
    ``return_prob="hyp"`` else None, None)."""
    if not isinstance(model.decoder, RecurrentDecoder):
        return transformer_greedy(model, spec, encoder_output, src_mask,
                                  max_output_length, device=device, stats=stats, **kwargs)
    device = resolve_device(device)
    _check_search_args(device, {"encoder_output": encoder_output, "src_mask": src_mask,
                                "model": next(model.parameters())}, kwargs)
    return_prob = kwargs.get("return_prob", "none") == "hyp"
    ys, yv, steps = _recurrent_greedy(
        model, spec, encoder_output, encoder_hidden, src_mask, int(max_output_length),
        min_output_length=int(kwargs.get("min_output_length", 1)),
        generate_unk=bool(kwargs.get("generate_unk", True)), return_prob=return_prob)
    if stats is not None:
        stats["decode_steps"] = stats.get("decode_steps", 0) + steps
    return ys.cpu().numpy(), yv.cpu().numpy() if return_prob else None, None


def _stable_topk(x: torch.Tensor, k: int):
    """The ``k`` largest entries of the last dimension in descending order,
    equal values in index order, as ``jax.lax.top_k`` returns them."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@torch.inference_mode()
def _transformer_beam(model: Seq2SeqModel, spec: ModelSpec, encoder_output: torch.Tensor,
                      src_mask: torch.Tensor, beam_size: int, max_output_length: int,
                      alpha: float, min_output_length: int = 1, generate_unk: bool = True,
                      repetition_penalty: float = -1.0, no_repeat_ngram_size: int = -1,
                      encoder_input: Optional[torch.Tensor] = None,
                      decoder_prompt=None, trg_prompt_mask=None):
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
    exclude = _exclude_ids(spec, device)
    enc_in = None if encoder_input is None else encoder_input.repeat_interleave(k, dim=0)
    dp, pm = _prompt_arrays(decoder_prompt, trg_prompt_mask, b * k, l1, spec.pad_index,
                            device, repeat=k)
    beam_offset = (torch.arange(b, device=device) * k)[:, None]
    positions = torch.arange(1, l1, device=device)

    step = 0
    while step < max_output_length:
        logits = model.decode_step(alive_seq[:, step:step + 1], step, cache, beam_k=k,
                                   trg_prompt_mask_t=None if pm is None
                                   else pm[:, step:step + 1])
        log_probs = torch.log_softmax(logits[:, 0].float(), dim=-1)
        log_probs = _history_controls(log_probs, alive_seq, step, enc_in, 1,
                                      no_repeat_ngram_size, repetition_penalty, exclude)
        log_probs = _apply_token_bans(log_probs, banned, spec.eos_index, step,
                                      min_output_length)
        if pm is not None:  # a forced position keeps only its token, at log-prob 0
            forced_row = torch.full_like(log_probs, NEG_INF).scatter_(
                1, dp[:, step + 1:step + 2], 0.0)
            log_probs = torch.where(pm[:, step + 1:step + 2] > 0, forced_row, log_probs)
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


def _sort_key(scores: torch.Tensor, collected: torch.Tensor) -> torch.Tensor:
    """Descending-order key of a hypothesis store: a collected hypothesis by
    its score, one at -inf just above every empty slot."""
    finite_floor = torch.finfo(scores.dtype).min
    return torch.where(collected, scores.clamp(min=finite_floor), -np.inf)


@torch.inference_mode()
def _recurrent_beam(model: Seq2SeqModel, spec: ModelSpec, encoder_output: torch.Tensor,
                    encoder_hidden: Optional[torch.Tensor], src_mask: torch.Tensor,
                    beam_size: int, max_output_length: int, alpha: float, n_best: int,
                    min_output_length: int = 1, generate_unk: bool = True):
    """Beam loop of a recurrent decoder (joeys2t_tpu/search.py:613-703).
    JAX appends every hypothesis that ends to a list and sorts it at the end
    (Python's stable sort, best first); the port keeps the ``n_best`` best
    in a store on the device, merged with each step's new hypotheses by a
    stable sort, which picks the same ones in the same order. Returns
    (sequences without BOS (B, n_best, L), their lengths, float64 scores,
    whether each slot was filled, steps run)."""
    # pylint: disable=too-many-locals
    decoder = model.decoder
    b, k, v, l1 = encoder_output.shape[0], beam_size, decoder.output_size, \
        max_output_length + 1
    device = encoder_output.device
    encoder_output = encoder_output.float().repeat_interleave(k, dim=0)
    src_mask = src_mask.repeat_interleave(k, dim=0)
    if encoder_hidden is not None:
        encoder_hidden = encoder_hidden.repeat_interleave(k, dim=0)
    carry, att_vector, proj_keys = decoder.init_state(encoder_output, encoder_hidden)
    banned = _banned_ids(spec, v, generate_unk, device, also=(spec.pad_index,))

    alive_seq = torch.full((b * k, l1), spec.pad_index, dtype=torch.long, device=device)
    alive_seq[:, 0] = spec.bos_index
    topk_log_probs = torch.full((b, k), -np.inf, dtype=torch.float64, device=device)
    topk_log_probs[:, 0] = 0.0
    is_finished = torch.zeros((b, k), dtype=torch.bool, device=device)
    store_seq = torch.full((b, n_best, l1 - 1), spec.pad_index, dtype=torch.long,
                           device=device)
    store_len = torch.zeros((b, n_best), dtype=torch.long, device=device)
    store_score = torch.full((b, n_best), -np.inf, dtype=torch.float64, device=device)
    store_full = torch.zeros((b, n_best), dtype=torch.bool, device=device)
    beam_offset = (torch.arange(b, device=device) * k)[:, None]

    step = 0
    while step < max_output_length:
        att_vector, carry, _ = decoder.step(model.trg_embed(alive_seq[:, step:step + 1]),
                                            att_vector, carry, proj_keys, encoder_output,
                                            src_mask)
        log_probs = torch.log_softmax(decoder.output_layer(att_vector)[:, 0].float(),
                                      dim=-1).double()
        log_probs = log_probs.index_fill(1, banned, -np.inf)
        if step < min_output_length:
            log_probs[:, spec.eos_index] = -np.inf
        log_probs = log_probs + topk_log_probs.reshape(-1)[:, None]
        length_penalty = ((5.0 + (step + 1)) / 6.0) ** alpha if alpha > 0 else 1.0
        topk_scores, topk_ids = _stable_topk((log_probs / length_penalty).reshape(b, k * v),
                                             k)
        topk_log_probs = topk_scores * length_penalty if alpha > 0 else topk_scores.clone()
        token = topk_ids % v
        select = (topk_ids // v + beam_offset).reshape(-1)
        alive_seq = alive_seq.index_select(0, select)
        alive_seq[:, step + 1] = token.reshape(-1)
        carry = tuple(tuple(t.index_select(0, select) for t in c) if isinstance(c, tuple)
                      else c.index_select(0, select) for c in carry)
        att_vector = att_vector.index_select(0, select)

        # a candidate that ends now, or reaches the length limit in a slot
        # that had not finished (JAX reads the slot's flag of the last step)
        newly_eos = token == spec.eos_index
        at_max = step + 1 == max_output_length
        ended = newly_eos | (~is_finished if at_max else torch.zeros_like(newly_eos))
        keys = torch.cat([_sort_key(store_score, store_full),
                          _sort_key(topk_scores, ended)], dim=1)
        _, best = _stable_topk(keys, n_best)
        seqs = torch.cat([store_seq, alive_seq[:, 1:].reshape(b, k, l1 - 1)], dim=1)
        store_seq = torch.gather(seqs, 1, best[:, :, None].expand(b, n_best, l1 - 1))
        store_len = torch.gather(torch.cat([store_len, torch.full_like(token, step + 1)],
                                           dim=1), 1, best)
        store_score = torch.gather(torch.cat([store_score, topk_scores], dim=1), 1, best)
        store_full = torch.gather(torch.cat([store_full, ended], dim=1), 1, best)

        is_finished = newly_eos | is_finished | ~torch.isfinite(topk_scores)
        step += 1
        if at_max or bool(is_finished.all()):
            break
        topk_log_probs = topk_log_probs.masked_fill(is_finished, -np.inf)
    return store_seq, store_len, store_score, store_full, step


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
    :param kwargs: the options of :func:`transformer_greedy`, and
        ``beam_reorder``
    :return: (output ids (B*n_best, L) numpy, scores (B*n_best, 1) numpy
        when ``return_prob="hyp"`` else None, None)

    A recurrent decoder runs its own loop from ``encoder_hidden``
    (``_recurrent_beam``), with no cache.
    """
    if beam_size < 1:
        raise ValueError("Beam size must be >0.")
    if n_best > beam_size:
        raise ValueError(f"Can only return {beam_size} best hypotheses. `n_best` must be "
                         f"smaller than or equal to `beam_size`.")
    device = resolve_device(device)
    _check_search_args(device, {"encoder_output": encoder_output, "src_mask": src_mask,
                                "model": next(model.parameters())}, kwargs)
    return_prob = kwargs.get("return_prob", "none") == "hyp"
    options = dict(min_output_length=int(kwargs.get("min_output_length", 1)),
                   generate_unk=bool(kwargs.get("generate_unk", True)))
    unk = np.array([spec.unk_index], np.int64)
    if isinstance(model.decoder, RecurrentDecoder):
        seqs, lengths, fin_scores, filled, steps = (
            t.cpu().numpy() if torch.is_tensor(t) else t for t in _recurrent_beam(
                model, spec, encoder_output, encoder_hidden, src_mask, int(beam_size),
                int(max_output_length), float(alpha), int(n_best), **options))
        # as JAX lays them out (joeys2t_tpu/search.py:690-702)
        predictions = [seq[:n] if full else unk for row in zip(seqs, lengths, filled)
                       for seq, n, full in zip(*row)]
        scores = np.where(filled, fin_scores, -1.0).reshape(-1)
    else:
        fin_seqs, fin_scores, steps = _transformer_beam(
            _cast_params_to_compute_dtype(model), spec, encoder_output, src_mask,
            int(beam_size), int(max_output_length), float(alpha), **options,
            **_control_kwargs(kwargs, device))
        predictions, scores = [], []
        for seqs, seq_scores in zip(fin_seqs.cpu().numpy(), fin_scores.cpu().numpy()):
            for n in range(n_best):
                if seq_scores[n] <= NEG_INF:  # unfilled slot (joeynmt/search.py:795-804)
                    predictions.append(unk)
                    scores.append(-1.0)
                    continue
                seq = seqs[n, 1:]  # drop BOS
                eos_pos = np.flatnonzero(seq == spec.eos_index)
                predictions.append(seq[:eos_pos[0] + 1] if len(eos_pos) else seq)
                scores.append(float(seq_scores[n]))
    if stats is not None:
        stats["decode_steps"] = stats.get("decode_steps", 0) + steps
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
    both. A text batch with the repetition controls passes its source ids
    as ``encoder_input``, and one with a target prompt forces its
    ``trg_input`` where ``trg_prompt_mask`` is set. The encoder reads ``model``'s float32 masters; the loop decodes
    from ``decode_model`` (``model`` with its decode side cast to the
    compute dtype) when the caller cast it once for many batches.

    :return: (output ids (B*n_best, L), scores or None, None), numpy
    """
    device = resolve_device(device)
    mt = batch.task == "MT"
    with torch.inference_mode():
        src = torch.from_numpy(np.ascontiguousarray(batch.src)).to(
            device, torch.long if mt else getattr(model.encoder, "dtype", torch.float32))
        src_length = torch.from_numpy(np.asarray(batch.src_length)).to(device, torch.long)
        src_mask = (None if batch.src_mask is None
                    else torch.from_numpy(batch.src_mask).to(device))
        encoder_output, encoder_hidden, src_mask = model.encode(src, src_length, src_mask)
    if max_output_length < 0:  # adapt to the source length
        max_output_length = int(np.max(batch.src_length) * 1.5)
    max_output_length = round_up_to_bucket(max_output_length)
    if mt and (kwargs.get("no_repeat_ngram_size", -1) > 1
               or kwargs.get("repetition_penalty", -1) > 1):
        kwargs["encoder_input"] = batch.src
    if batch.has_trg and batch.trg_prompt_mask is not None:
        kwargs["decoder_prompt"] = batch.trg_input
        kwargs["trg_prompt_mask"] = batch.trg_prompt_mask
    decode_model = decode_model if decode_model is not None else model
    if beam_size < 2:
        kwargs.pop("beam_reorder", None)  # a beam-only option
        return greedy(decode_model, spec, encoder_output, encoder_hidden, src_mask,
                      max_output_length, device=device, stats=stats, **kwargs)
    return beam_search(decode_model, spec, encoder_output, encoder_hidden, src_mask,
                       beam_size, max_output_length, beam_alpha, n_best=n_best,
                       device=device, stats=stats, **kwargs)
