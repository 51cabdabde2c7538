# coding: utf-8
"""The port's Transcriber (wav -> fbank + CMVN -> encoder -> greedy or
beam search -> text) against the JAX package's Transcriber on the same
weights and waveforms, on the CPU. Model size as in test_torch_model.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joeys2t_torch.ops.frontend import device_frontend
from joeys2t_torch.search import transformer_greedy
from joeys2t_torch.serving import Transcriber, split_at_low_energy
from joeys2t_tpu.serving import Transcriber as JaxTranscriber
from joeys2t_tpu.serving import split_at_low_energy as jax_split
from test_torch_model import TOKENS, jax_s2t, port_from_jax
from joeys2t_torch.config import SpecialSymbols
from joeys2t_torch.tokenizers import BasicTokenizer
from joeys2t_torch.vocabulary import Vocabulary
from joeys2t_tpu.tokenizers import BasicTokenizer as JaxBasicTokenizer


def speechlike(rng, n):
    """Loudness-modulated noise in int16 scale, with short pauses."""
    envelope = np.repeat(np.exp(rng.uniform(3, 9, size=n // 800 + 1)), 800)[:n]
    envelope[rng.rand(n // 800 + 1).repeat(800)[:n] < 0.15] = 1.0
    return (envelope * rng.randn(n)).astype(np.float32)


@pytest.fixture(scope="module")
def transcribers():
    jmodel, jspec, params, jvocab = jax_s2t(seed=0)
    tmodel, tspec = port_from_jax(params)
    port = Transcriber(tmodel, tspec, Vocabulary(TOKENS, SpecialSymbols()), device="cpu")
    return JaxTranscriber(params, jmodel, jspec, jvocab), port


def test_transcribe_matches_jax(transcribers):
    jax_asr, port_asr = transcribers
    rng = np.random.RandomState(0)
    waves = [speechlike(rng, n) for n in (16000, 24000, 31000)]
    texts = port_asr.transcribe(waves, max_output_length=16)
    assert texts == jax_asr.transcribe(waves, max_output_length=16)
    assert len(texts) == 3 and all(texts)
    assert port_asr.stats["utterances"] >= 3 and port_asr.stats["decode_steps"] > 0


def _near_ties(port, waves, max_len, margin):
    """Per utterance, the first greedy step at which the port's top-2 logit
    margin (bos banned, as in search) is below ``margin``, on the path the
    Transcriber takes."""
    batch = np.zeros((len(waves), 32000), np.float32)  # the Transcriber's bucket
    for i, w in enumerate(waves):
        batch[i, :len(w)] = w
    lengths = torch.tensor([len(w) for w in waves])
    with torch.inference_mode():
        feats, frames = device_frontend(torch.tensor(batch), lengths)
        enc, _, mask = port.model.encode(feats, frames)
        out, _, _ = transformer_greedy(port.decode_model, port.spec, enc, mask, max_len,
                                       device="cpu")
        ys = torch.cat([torch.full((len(waves), 1), port.spec.bos_index),
                        torch.tensor(out)], dim=1)
        cache = port.decode_model.init_cache(enc, max_len + 1, mask)
        margins = []
        for t in range(max_len):
            logits = port.decode_model.decode_step(ys[:, t:t + 1], t, cache)[:, 0].float()
            logits[:, port.spec.bos_index] = -1e9
            top2 = logits.topk(2, dim=-1).values
            margins.append(top2[:, 0] - top2[:, 1])
    small = torch.stack(margins, dim=1) < margin
    return [int(row.nonzero()[0]) if row.any() else max_len for row in small]


def test_bf16_transcribe_matches_jax_and_keeps_float32_masters():
    """In bf16 the port, like the JAX Transcriber, encodes from the float32
    masters and decodes from a bf16 copy of the decode side; the caller's
    model keeps its float32 weights. bf16 rounds differently in XLA and in
    PyTorch (~0.03 on logits of ~4), so transcripts must agree up to each
    utterance's first near-tie (top-2 margin under 0.125), where the paths
    may part."""
    jmodel, jspec, params, jvocab = jax_s2t(seed=0, compute_dtype=jnp.bfloat16)
    tmodel, tspec = port_from_jax(params, compute_dtype=torch.bfloat16)
    masters = {k: v.clone() for k, v in tmodel.state_dict().items()}
    port = Transcriber(tmodel, tspec, Vocabulary(TOKENS, SpecialSymbols()), device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in port.decode_model.decoder.parameters())
    assert port.decode_model.encoder is tmodel.encoder
    rng = np.random.RandomState(3)
    waves = [speechlike(rng, n) for n in (16000, 24000, 31000)]
    texts = port.transcribe(waves, max_output_length=16)
    ref = JaxTranscriber(params, jmodel, jspec, jvocab).transcribe(waves,
                                                                  max_output_length=16)
    ties = _near_ties(port, waves, 16, margin=0.125)
    for ours, theirs, k in zip(texts, ref, ties):
        ours, theirs = ours.split(), theirs.split()
        assert ours[:k] == theirs[:k]
        if k > len(ours):  # ended with a clear eos before any near-tie
            assert ours == theirs
    assert sum(ties) >= 15  # a third of the steps or more are compared
    for name, value in tmodel.state_dict().items():
        assert value.dtype == torch.float32 and torch.equal(value, masters[name]), name


def test_transcribe_long_matches_jax(transcribers):
    jax_asr, port_asr = transcribers
    wave = speechlike(np.random.RandomState(1), 56000)
    kw = dict(chunk_seconds=1.0, search_seconds=0.3, max_output_length=8)
    text = port_asr.transcribe_long(wave, **kw)
    assert text == jax_asr.transcribe_long(wave, **kw)
    assert len(split_at_low_energy(wave, 16000, 1.0, 0.3)) >= 2


def test_split_at_low_energy_matches_jax():
    rng = np.random.RandomState(2)
    wave = speechlike(rng, 97 * 16000)
    for chunk, search in ((20.0, 5.0), (10.0, 3.0), (3.0, 0.5)):
        assert split_at_low_energy(wave, 16000, chunk, search) == \
            jax_split(wave, 16000, chunk, search)


@pytest.mark.parametrize("level", [None, "char"])
def test_transcribe_beam_matches_jax(transcribers, level):
    """Beam 5 with length penalty 1 through both Transcribers; with a target
    tokenizer both detokenize with its ``post_process``."""
    jax_asr, port_asr = transcribers
    tokenizers = (None, None)
    if level is not None:
        tokenizers = (JaxBasicTokenizer(level=level), BasicTokenizer(level=level))
        tokenizers[0].set_vocab(jax_asr.trg_vocab)
        tokenizers[1].set_vocab(port_asr.trg_vocab)
    rng = np.random.RandomState(5)
    waves = [speechlike(rng, n) for n in (16000, 24000, 31000)]
    batch = np.zeros((3, 32000), np.float32)
    for i, w in enumerate(waves):
        batch[i, :len(w)] = w
    lengths = np.array([len(w) for w in waves])
    jax_asr.tokenizer, port_asr.tokenizer = tokenizers
    try:
        ours = port_asr.transcribe_batch(batch, lengths, max_output_length=12, beam_size=5,
                                         beam_alpha=1.0)
        theirs = jax_asr.transcribe_batch(batch, lengths, max_output_length=12,
                                          beam_size=5, beam_alpha=1.0)
    finally:
        jax_asr.tokenizer = port_asr.tokenizer = None
    assert ours == theirs and len(ours) == 3 and all(ours)
    if level == "char":
        assert all(" " not in t for t in ours)
