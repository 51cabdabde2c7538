"""The one traffic generator. A traffic file (``traffic/<name>.json``) gives the
laws of the lengths and the size of the set or pool; the configuration
gives the batch or request size and the search options; this module turns
them into inputs.

The sizes (lengths, batches, requests) come from the file's ``shape_seed``,
so every run does the same work; ``--seed`` draws their order and their
content (features, waveforms, token ids), so two seeds give other inputs of
the same shapes."""
import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def stream(seed: int, purpose: int) -> int:
    """A seed of its own for each use of the run's seed."""
    return (int(seed) * 6364136223846793005 + 1442695040888963407 * (purpose + 1)) % (2**63)


def draw(law: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` values of a ``normal`` (mean, sd) or ``lognormal`` (mean, sigma)
    law, redrawn until they lie in [min, max]."""
    out = np.empty(0)
    while out.size < n:
        m = 2 * (n - out.size) + 16
        if law["law"] == "normal":
            x = rng.normal(law["mean"], law["sd"], m)
        elif law["law"] == "lognormal":
            x = rng.lognormal(math.log(law["mean"]) - law["sigma"] ** 2 / 2, law["sigma"], m)
        else:
            raise ValueError(f"unknown law {law['law']!r}")
        out = np.concatenate([out, x[(x >= law["min"]) & (x <= law["max"])]])
    return out[:n]


def target_ids(seconds: float, traffic: Dict) -> int:
    """Target ids (before eos) of an utterance: its words at
    ``words_per_second``, ``ids_per_word`` each, at least one."""
    return max(1, int(round(seconds * traffic["words_per_second"] * traffic["ids_per_word"])))


def token_batches(traffic: Dict, batch_size: int) -> List[List[Tuple[int, int]]]:
    """The pool of training batches: utterances drawn in turn and cut where
    the padded count (longest source or target + 1, times rows) reaches the
    configuration's token ``batch_size``; each batch a list of (frames,
    target ids with eos). The cutting rule is a frozen copy of the port's
    ``TokenBatchSampler``'s; ``tests/test_bench_traffic.py`` holds the two
    equal."""
    rng = np.random.default_rng(traffic["shape_seed"])
    law, fps = traffic["utterance_seconds"], traffic["frames_per_second"]
    batches, batch, longest = [], [], 0
    while len(batches) < traffic["pool_batches"]:
        sec = float(draw(law, 1, rng)[0])
        frames, ids = int(round(sec * fps)), target_ids(sec, traffic) + 1
        batch.append((frames, ids))
        longest = max(longest, frames + 1, ids + 1)
        if longest * len(batch) >= batch_size:
            batches.append(batch)
            batch, longest = [], 0
    return batches


def order(n: int, seed: int) -> List[int]:
    """The run's order of ``n`` fixed units."""
    return [int(i) for i in np.random.default_rng(stream(seed, 0)).permutation(n)]


def speech_train_batch(shape: List[Tuple[int, int]], seed: int, index: int, vocab_size: int,
                       num_freq: int, device) -> Dict[str, torch.Tensor]:
    """Features (B, T, F) float32, zero past each length, smooth noise like
    CMVN-scaled filterbanks; targets bos, ids in [4, V), eos, pad (ids
    0-3 are unk, pad, bos, eos)."""
    gen = torch.Generator(device=device).manual_seed(stream(seed, 10 + index))
    frames = torch.tensor([f for f, _ in shape], device=device)
    ids = torch.tensor([n for _, n in shape], device=device)
    b, t, lt = len(shape), int(frames.max()), int(ids.max())
    x = torch.randn(b, t, num_freq, generator=gen, device=device)
    x = x + 0.05 * torch.cumsum(torch.randn(b, t, num_freq, generator=gen, device=device), 1)
    x = x * (torch.arange(t, device=device)[None, :, None] < frames[:, None, None])
    tok = torch.randint(4, vocab_size, (b, lt + 1), generator=gen, device=device)
    pos = torch.arange(lt + 1, device=device)[None]
    tok[:, 0] = 2
    tok = torch.where(pos == ids[:, None], 3, tok)
    tok = torch.where(pos > ids[:, None], 1, tok)
    return {"src": x, "src_length": frames, "trg": tok, "trg_length": ids + 1}


def speechlike(n_samples: torch.Tensor, seed: int, device, block: int = 800) -> torch.Tensor:
    """(B, max N) int16-scaled waveforms, zero past each length: noise under
    a loudness envelope that changes every ``block`` samples, with pauses."""
    gen = torch.Generator(device=device).manual_seed(stream(seed, 20))
    b, n = len(n_samples), int(n_samples.max())
    blocks = -(-n // block)
    env = torch.exp(3.0 + 6.0 * torch.rand(b, blocks, generator=gen, device=device))
    env = torch.where(torch.rand(b, blocks, generator=gen, device=device) < 0.15, 1.0, env)
    wave = torch.randn(b, n, generator=gen, device=device)
    wave *= env.repeat_interleave(block, dim=1)[:, :n]
    return wave * (torch.arange(n, device=device)[None] < n_samples[:, None])


def speech_requests(traffic: Dict, size: int) -> List[np.ndarray]:
    """The test set's utterance durations (s), sorted, cut into requests of
    ``size`` utterances."""
    rng = np.random.default_rng(traffic["shape_seed"])
    sec = np.sort(draw(traffic["utterance_seconds"], traffic["utterances"], rng))
    return [sec[i:i + size] for i in range(0, len(sec), size)]


def text_requests(traffic: Dict, size: int) -> List[np.ndarray]:
    """The test set's source lengths (ids, eos included), cut into requests
    of ``size`` sentences in the order drawn."""
    rng = np.random.default_rng(traffic["shape_seed"])
    n = np.rint(draw(traffic["source_ids"], traffic["sentences"], rng)).astype(np.int64)
    return [n[i:i + size] for i in range(0, len(n), size)]


def source_ids(lengths: np.ndarray, seed: int, index: int, vocab_size: int,
               device) -> torch.Tensor:
    """(B, S) ids in [4, V), eos last, pad after."""
    gen = torch.Generator(device=device).manual_seed(stream(seed, 30 + index))
    n = torch.as_tensor(lengths, device=device)
    s = int(n.max())
    ids = torch.randint(4, vocab_size, (len(lengths), s), generator=gen, device=device)
    pos = torch.arange(s, device=device)[None]
    ids = torch.where(pos == n[:, None] - 1, 3, ids)
    return torch.where(pos >= n[:, None], 1, ids)
