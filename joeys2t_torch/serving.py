# coding: utf-8
"""
Raw-waveform ASR serving: wav in, text out, with the whole compute path
(fbank, CMVN, encoder, KV-cached greedy or beam decode) on the device
(counterpart of joeys2t_tpu/serving.py ``Transcriber`` :80).

Usage:
    from joeys2t_torch.serving import Transcriber
    asr = Transcriber(model, spec, trg_vocab)        # runs on cuda
    texts = asr.transcribe([wave_a, "b.wav"])        # int16-scaled floats or wav files
    texts = asr.transcribe([wave_a], beam_size=5, beam_alpha=1.0)

    from joeys2t_torch.hub_interface import load_model_dir
    asr = Transcriber.from_hub(load_model_dir("models/my_asr"))  # a trained model dir

Transcripts are the target tokens after the target tokenizer's
``post_process`` when one is given, else the tokens joined by spaces.
"""
import bisect
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from joeys2t_torch import tracing
from joeys2t_torch.data.audio_io import read_wav
from joeys2t_torch.helpers import resolve_device
from joeys2t_torch.ops.frontend import device_frontend
from joeys2t_torch.search import _cast_params_to_compute_dtype, beam_search, transformer_greedy

# waveform-sample buckets: ~1s steps up to 30s at 16kHz, then exact length
_WAVE_BUCKETS = [16000 * i for i in (1, 2, 3, 4, 5, 6, 8, 10, 12, 15, 20, 30)]


def _bucket_samples(n: int) -> int:
    i = bisect.bisect_left(_WAVE_BUCKETS, n)
    return _WAVE_BUCKETS[i] if i < len(_WAVE_BUCKETS) else n


def split_at_low_energy(wave: np.ndarray, sample_rate: float,
                        chunk_seconds: float = 20.0, search_seconds: float = 5.0,
                        frame_ms: float = 25.0) -> List[int]:
    """Cut points for long-audio chunking, snapped to quiet frames.

    Nominal boundaries every ``chunk_seconds`` move to the center of the
    minimum-RMS-energy frame within +-``search_seconds``, so chunks break at
    pauses. Returns interior cut points (sample indices), excluding 0 and
    len(wave)."""
    n = len(wave)
    chunk = int(chunk_seconds * sample_rate)
    if n <= chunk:
        return []
    frame = max(1, int(frame_ms / 1e3 * sample_rate))
    n_frames = (n + frame - 1) // frame
    padded = np.zeros(n_frames * frame, np.float64)
    padded[:n] = np.asarray(wave, np.float64)
    energy = (padded.reshape(n_frames, frame) ** 2).mean(axis=1)
    search = max(1, int(search_seconds * sample_rate) // frame)

    cuts: List[int] = []
    pos = chunk
    # no cut when the remaining tail is under half a chunk: a 1-2 s final
    # chunk decodes worse than absorbing it
    while n - pos > chunk // 2:
        center = pos // frame
        lo = max(0, center - search)
        hi = min(n_frames, center + search + 1)
        best = lo + int(np.argmin(energy[lo:hi]))
        cut = min(n - 1, best * frame + frame // 2)
        if cuts and cut <= cuts[-1]:  # monotone guard for tiny chunks
            cut = min(n - 1, cuts[-1] + frame)
        cuts.append(cut)
        pos = cut + chunk
    return cuts


class Transcriber:
    """Batched wav -> text with on-device feature extraction (16 kHz audio,
    as many mel bins as the model's subsampler takes, utterance CMVN).

    The model moves to the device and into eval mode; the encoder runs on
    its float32 masters, and the decoder from a copy of the decode side in
    the compute dtype, cast once here (``decode_model``). ``tokenizer``, the
    target side's (a ``BasicTokenizer``), turns tokens into text.

    ``norm_means``/``norm_vars`` are the CMVN the model was trained with.
    ``stats`` counts what the instance served: requests (calls of
    ``transcribe_batch``), utterances, audio seconds, decode steps, and the
    host seconds of the transformer decode loops (``loop_s``) and of their
    blocking read-backs of the stop flag (``readback_s``): near 1,
    ``readback_s / loop_s`` says the card paces the service, near 0 the
    host's launches do. Under ``torch.profiler`` a request opens the spans of
    ``joeys2t_torch.tracing``, its number in ``stats["requests"]`` as the
    ``args`` of ``joeys2t.request``."""

    sample_rate = 16000.0

    def __init__(self, model, spec, trg_vocab, tokenizer=None, device=None,
                 norm_means: bool = True, norm_vars: bool = True):
        self.device = resolve_device(device)
        self.norm_means = norm_means
        self.norm_vars = norm_vars
        self.model = model.to(self.device).eval()
        self.decode_model = _cast_params_to_compute_dtype(self.model)
        self.spec = spec
        self.trg_vocab = trg_vocab
        self.tokenizer = tokenizer
        self.num_mel_bins = model.encoder.subsampler.conv_layers[0].weight.shape[1]
        self.stats = {"requests": 0, "utterances": 0, "audio_seconds": 0.0,
                      "decode_steps": 0, "loop_s": 0.0, "readback_s": 0.0}

    @classmethod
    def from_hub(cls, hub) -> "Transcriber":
        """Serve the model of a ``TranslatorHubInterface``
        (``hub_interface.load_model_dir``) on its device, with its target
        tokenizer (a SentencePiece model detokenizes the text) and its
        source side's CMVN flags."""
        if hub.args.task != "S2T":
            raise ValueError("Transcriber requires an S2T model")
        data = hub.dataset
        cmvn = getattr(data.tokenizer.get(data.src_lang), "cmvn", None)
        return cls(hub.model, hub.spec, data.trg_vocab,
                   tokenizer=data.tokenizer.get(data.trg_lang), device=hub.args.device,
                   norm_means=bool(getattr(cmvn, "norm_means", True)),
                   norm_vars=bool(getattr(cmvn, "norm_vars", True)))

    def _load(self, w) -> np.ndarray:
        if isinstance(w, (str, Path)):
            wave, sr = read_wav(w)
            if sr != self.sample_rate:
                raise ValueError(f"{w}: sample rate {sr}, the model takes "
                                 f"{self.sample_rate}")
            return wave
        return np.asarray(w, np.float32)

    def transcribe(self, wavs: Sequence[Union[str, Path, np.ndarray]],
                   max_output_length: Optional[int] = None,
                   **generate_kwargs) -> List[str]:
        """:param wavs: wav file paths or int16-scaled float waveforms
        :return: one transcript per input"""
        waves = [self._load(w) for w in wavs]
        n_pad = _bucket_samples(max(len(w) for w in waves))
        batch = np.zeros((len(waves), n_pad), np.float32)
        lengths = np.zeros((len(waves),), np.int64)
        for i, w in enumerate(waves):
            batch[i, :len(w)] = w[:n_pad]
            lengths[i] = min(len(w), n_pad)
        return self.transcribe_batch(batch, lengths, max_output_length=max_output_length,
                                     **generate_kwargs)

    def transcribe_long(self, wav: Union[str, Path, np.ndarray],
                        chunk_seconds: float = 20.0, search_seconds: float = 5.0,
                        separator: str = " ", **generate_kwargs) -> str:
        """Transcribe audio of any length: split at low-energy points near
        every ``chunk_seconds`` boundary, decode the chunks as ONE batch, and
        join the chunk transcripts."""
        wave = self._load(wav)
        cuts = split_at_low_energy(wave, self.sample_rate, chunk_seconds, search_seconds)
        bounds = [0] + cuts + [len(wave)]
        chunks = [wave[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
        texts = self.transcribe(chunks, **generate_kwargs)
        return separator.join(t for t in (s.strip() for s in texts) if t)

    @torch.inference_mode()
    def transcribe_batch(self, waveforms, lengths, max_output_length: Optional[int] = None,
                         beam_size: int = 1, beam_alpha: float = 1.0,
                         **generate_kwargs) -> List[str]:
        """Batched path: ``waveforms`` (B, N) float32 padded to a common
        length (numpy or a tensor, on the host or the device), ``lengths``
        the valid samples per row. ``beam_size`` > 1 decodes with beam search
        and the GNMT length penalty ``beam_alpha``, keeping the best
        hypothesis; the default is greedy."""
        with tracing.span("joeys2t.request", str(self.stats["requests"] + 1)):
            waveforms = torch.as_tensor(waveforms, dtype=torch.float32).to(self.device)
            lengths = torch.as_tensor(lengths).to(self.device)
            with tracing.span("joeys2t.frontend"):
                feats, frame_lengths = device_frontend(waveforms, lengths,
                                                       sample_rate=self.sample_rate,
                                                       num_mel_bins=self.num_mel_bins,
                                                       norm_means=self.norm_means,
                                                       norm_vars=self.norm_vars)
            with tracing.span("joeys2t.encode"):
                enc, _, enc_mask = self.model.encode(feats, frame_lengths)
            if max_output_length is None:
                max_output_length = int(enc.shape[1] * 1.5) + 8
            if beam_size > 1:
                out, _, _ = beam_search(self.decode_model, self.spec, enc, None, enc_mask,
                                        beam_size, max_output_length, alpha=beam_alpha,
                                        n_best=1, device=self.device, stats=self.stats,
                                        **generate_kwargs)
            else:
                out, _, _ = transformer_greedy(self.decode_model, self.spec, enc, enc_mask,
                                               max_output_length, device=self.device,
                                               stats=self.stats, **generate_kwargs)
            self.stats["requests"] += 1
            self.stats["utterances"] += len(out)
            self.stats["audio_seconds"] += float(lengths.sum()) / self.sample_rate

            with tracing.span("joeys2t.detokenize"):
                pad_tok, eos_tok = self.trg_vocab.specials[1], self.trg_vocab.specials[3]
                texts = []
                for tokens in self.trg_vocab.arrays_to_sentences(out, cut_at_eos=True):
                    tokens = [t for t in tokens if t not in (pad_tok, eos_tok)]
                    texts.append(" ".join(tokens) if self.tokenizer is None
                                 else self.tokenizer.post_process(tokens))
            return texts
