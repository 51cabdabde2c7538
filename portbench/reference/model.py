# coding: utf-8
"""Plain PyTorch reference of the benchmark's models: the JoeyS2T transformer
(pre-LN encoder and decoder, sinusoidal positions, the Conv1d/GLU speech
subsampler, the CTC head over the encoder, tied or untied output), its
training loss (label-smoothed cross entropy plus CTC), global-norm clipping
and AdamW, and the kaldi filterbank front end with utterance CMVN.

It follows the published JoeyNMT / JoeyS2T equations and reads parameters
from a dict keyed by the checkpoint names (``encoder.layers.0.src_src_att.
q_layer.weight``, ...). It imports nothing of the program. Every product
runs in float32 with TF32 off (``precision="f32"``), or with its operands
rounded to float8 e4m3 under a per-tensor scale (``precision="fp8"``), the
next precision below the bfloat16 the configurations compute in: that is
the control of the benchmark's comparisons.
"""
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

NEG_INF = -1e9
FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def no_tf32() -> None:
    """Products in true float32: TF32 is the lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under its own per-tensor scale, back in
    float32; gradients pass straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


class Ops:
    """The products of the reference in one precision."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.low = precision == "fp8"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.low else x

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).t()
        return y if b is None else y + b

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))


def sinusoid(length: int, size: int, device) -> torch.Tensor:
    """(length, size): sin on even, cos on odd dims, wavelengths 10000^(2i/d)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, size, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / size))
    pe = torch.zeros(length, size, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def layer_norm(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], 1e-6)


def attention(ops: Ops, p, name, x_q, x_kv, heads: int, mask):
    """Multi-head attention; ``mask`` bool, broadcastable to (B, 1, Tq, Tk)."""
    b, tq, d = x_q.shape
    dh = d // heads
    q = ops.linear(x_q, p[f"{name}.q_layer.weight"], p[f"{name}.q_layer.bias"])
    k = ops.linear(x_kv, p[f"{name}.k_layer.weight"], p[f"{name}.k_layer.bias"])
    v = ops.linear(x_kv, p[f"{name}.v_layer.weight"], p[f"{name}.v_layer.bias"])
    q, k, v = (t.reshape(b, t.shape[1], heads, dh) for t in (q, k, v))
    scores = ops.einsum("bqhd,bkhd->bhqk", q / math.sqrt(dh), k)
    scores = scores.masked_fill(~mask, NEG_INF)
    ctx = ops.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    return ops.linear(ctx.reshape(b, tq, d), p[f"{name}.output_layer.weight"],
                      p[f"{name}.output_layer.bias"])


def feed_forward(ops: Ops, p, name, x):
    h = layer_norm(x, p, f"{name}.layer_norm")
    h = torch.relu(ops.linear(h, p[f"{name}.pwff_layer.0.weight"],
                              p[f"{name}.pwff_layer.0.bias"]))
    return x + ops.linear(h, p[f"{name}.pwff_layer.3.weight"], p[f"{name}.pwff_layer.3.bias"])


def subsample(ops: Ops, p, feats, lengths, kernels: Sequence[int]):
    """Stride-2 Conv1d + GLU per kernel over (B, T, C); the padding frames of
    the batch enter the convolutions as they are."""
    x = feats
    for i, k in enumerate(kernels):
        w, bias = p[f"encoder.subsampler.conv_layers.{i}.weight"], \
            p[f"encoder.subsampler.conv_layers.{i}.bias"]
        y = F.conv1d(ops.q(x).transpose(1, 2), ops.q(w), bias, stride=2, padding=k // 2)
        a, g = y.transpose(1, 2).chunk(2, dim=-1)
        x = a * torch.sigmoid(g)
        lengths = torch.div(lengths + 2 * (k // 2) - k, 2, rounding_mode="floor") + 1
    return x, lengths


def encode(ops: Ops, p, cfg: Dict, src, src_length):
    """(encoder output (B, S, d), valid (B, S) bool). ``src`` is (B, T, C)
    speech features or (B, S) token ids (pad 1)."""
    enc = cfg["encoder"]
    if src.dtype in (torch.long, torch.int32):
        d = enc["hidden_size"]
        x = F.embedding(src, p["src_embed.lut.weight"] if "src_embed.lut.weight" in p
                        else p["trg_embed.lut.weight"])
        if enc["embeddings"].get("scale", False):
            x = x * math.sqrt(d)
        valid = torch.arange(src.shape[1], device=src.device)[None] < src_length[:, None]
    else:
        x, out_len = subsample(ops, p, src.float(), src_length, enc["conv_kernel_sizes"])
        valid = torch.arange(x.shape[1], device=x.device)[None] < out_len[:, None]
    x = x + sinusoid(x.shape[1], x.shape[2], x.device)[None]
    mask = valid[:, None, None, :]
    for i in range(enc["num_layers"]):
        name = f"encoder.layers.{i}"
        h = layer_norm(x, p, f"{name}.layer_norm")
        x = x + attention(ops, p, f"{name}.src_src_att", h, h, enc["num_heads"], mask)
        x = feed_forward(ops, p, f"{name}.feed_forward", x)
    return layer_norm(x, p, "encoder.layer_norm"), valid


def decode(ops: Ops, p, cfg: Dict, trg_input, enc_out, src_valid, pad_index: int = 1):
    """Teacher-forced logits (B, T, V) in float32 over ``trg_input`` (B, T)."""
    dec = cfg["decoder"]
    d = dec["hidden_size"]
    x = F.embedding(trg_input, p["trg_embed.lut.weight"])
    if dec["embeddings"].get("scale", False):
        x = x * math.sqrt(d)
    t = trg_input.shape[1]
    x = x + sinusoid(t, d, x.device)[None]
    causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    self_mask = ((trg_input != pad_index)[:, None, :] & causal)[:, None]
    cross_mask = src_valid[:, None, None, :]
    for i in range(dec["num_layers"]):
        name = f"decoder.layers.{i}"
        h = layer_norm(x, p, f"{name}.x_layer_norm")
        x = x + attention(ops, p, f"{name}.trg_trg_att", h, h, dec["num_heads"], self_mask)
        h = layer_norm(x, p, f"{name}.dec_layer_norm")
        x = x + attention(ops, p, f"{name}.src_trg_att", h, enc_out, dec["num_heads"],
                          cross_mask)
        x = feed_forward(ops, p, f"{name}.feed_forward", x)
    x = layer_norm(x, p, "decoder.layer_norm")
    out = p.get("decoder.output_layer.weight", p["trg_embed.lut.weight"])
    return ops.linear(x, out)


# ------------------------------------------------------------------ training
def xent_ctc_loss(ops: Ops, p, cfg: Dict, train: Dict, batch: Dict) -> torch.Tensor:
    """Sum over the rows of ``batch`` of (1 - w) * label-smoothed cross
    entropy (KL to the smoothed target, pad excluded) + w * CTC (blank = bos,
    infeasible rows 0), before the normalizer."""
    enc_out, valid = encode(ops, p, cfg, batch["src"], batch["src_length"])
    logits = decode(ops, p, cfg, batch["trg_input"], enc_out, valid)
    lp = torch.log_softmax(logits, dim=-1)
    trg, v = batch["trg"], lp.shape[-1]
    eps = train["label_smoothing"]
    non_pad = trg != 1
    lq = lp.gather(-1, trg[..., None])[..., 0]
    if eps > 0:
        conf, uni = 1.0 - eps, eps / (v - 2)
        cross = conf * lq + uni * (lp.sum(-1) - lq - lp[..., 1])
        ent = conf * math.log(conf) + (v - 2) * uni * math.log(uni)
        xent = torch.where(non_pad, ent - cross, 0.0).sum()
    else:
        xent = -torch.where(non_pad, lq, 0.0).sum()
    w = train.get("ctc_weight", 0.0) if train["loss"] == "crossentropy-ctc" else 0.0
    if w == 0.0:
        return xent
    ctc_lp = torch.log_softmax(ops.linear(enc_out, p["decoder.ctc_output_layer.weight"]), -1)
    tl = batch["trg_length"]
    ctc = F.ctc_loss(ctc_lp.transpose(0, 1), trg, valid.sum(1), tl, blank=2,
                     reduction="none", zero_infinity=True)
    ctc = torch.where((ctc > 1e8) | (tl == 0), 0.0, ctc).sum()
    return (1.0 - w) * xent + w * ctc


def learning_rate(train: Dict, update: int) -> float:
    """Warm-up then inverse square root (JoeyNMT's ``warmupinversesquareroot``),
    floored at ``learning_rate_min``; ``update`` counts from 1."""
    peak, warm = train["learning_rate"], train["learning_rate_warmup"]
    rate = update * peak / warm if update < warm else peak * math.sqrt(warm) / math.sqrt(update)
    return max(rate, train.get("learning_rate_min", 0.0))


def train_steps(p: Dict[str, torch.Tensor], cfg: Dict, batches: List[Dict], normalizers,
                precision: str = "f32", block_rows: int = 16):
    """AdamW updates of the float32 ``p`` (in place), one per batch, each
    clipped by the global norm first. Each batch runs in blocks of
    ``block_rows`` rows, every block at the batch's own padded lengths, its
    gradients summed. Returns (the normalized losses, the first update's
    clipped gradients, the parameters' values before the first update)."""
    ops = Ops(precision)
    train = cfg["training"]
    b1, b2 = train["adam_betas"]
    wd = train.get("weight_decay", 0.0)
    clip = train.get("clip_grad_norm")
    names = sorted(p)
    start = {n: p[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(p[n]) for n in names}
    v = {n: torch.zeros_like(p[n]) for n in names}
    losses, first_grads = [], None
    for step, (batch, normalizer) in enumerate(zip(batches, normalizers), start=1):
        leaves = {n: p[n].detach().requires_grad_(True) for n in names}
        grads = {n: torch.zeros_like(p[n]) for n in names}
        total = 0.0
        rows = batch["src"].shape[0]
        for lo in range(0, rows, block_rows):
            part = {k: t[lo:lo + block_rows] for k, t in batch.items()}
            loss = xent_ctc_loss(ops, leaves, cfg["model"], train, part) / normalizer
            got = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
            for n, g in zip(names, got):
                if g is not None:
                    grads[n] += g
            total += float(loss.detach())
        losses.append(total)
        if clip is not None:
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
            if norm >= clip:
                for g in grads.values():
                    g.mul_(clip / float(norm))
        if first_grads is None:
            first_grads = {n: g.clone() for n, g in grads.items()}
        lr = learning_rate(train, step)
        c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
        with torch.no_grad():
            for n in names:
                g = grads[n]
                m[n].mul_(b1).add_(g, alpha=1.0 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                upd = (m[n] / c1) / ((v[n] / c2).sqrt() + 1e-8)
                if wd:
                    upd = upd + wd * p[n]
                p[n] -= lr * upd
    return losses, first_grads, start


# --------------------------------------------------------------- front end
def kaldi_fbank(wave: torch.Tensor, num_mel_bins: int = 80,
                sample_rate: float = 16000.0) -> torch.Tensor:
    """(B, N) int16-scaled waveforms -> (B, m, bins) log-mel energies, in
    float64: 25 ms frames every 10 ms with snip_edges, DC removed, 0.97
    pre-emphasis, Povey window, 512-point power spectrum, kaldi mel banks
    from 20 Hz to Nyquist, log floored at float32's epsilon."""
    win, shift, nfft = int(sample_rate * 0.025), int(sample_rate * 0.010), 512
    x = wave.double().unfold(1, win, shift)
    x = x - x.mean(dim=2, keepdim=True)
    x = x - 0.97 * torch.cat([x[..., :1], x[..., :-1]], dim=2)
    n = torch.arange(win, dtype=torch.float64, device=wave.device)
    x = x * (0.5 - 0.5 * torch.cos(2 * math.pi * n / (win - 1))) ** 0.85
    power = torch.fft.rfft(x, n=nfft, dim=2).abs() ** 2

    def mel(f):
        return 1127.0 * torch.log(1.0 + f / 700.0)

    lo = mel(torch.tensor(20.0, dtype=torch.float64))
    hi = mel(torch.tensor(sample_rate / 2, dtype=torch.float64))
    delta = (hi - lo) / (num_mel_bins + 1)
    fft_mel = mel(torch.arange(nfft // 2, dtype=torch.float64) * sample_rate / nfft)
    j = torch.arange(num_mel_bins, dtype=torch.float64)[:, None]
    left, center, right = lo + j * delta, lo + (j + 1) * delta, lo + (j + 2) * delta
    banks = torch.clamp(torch.minimum((fft_mel - left) / (center - left),
                                      (right - fft_mel) / (right - center)), min=0.0)
    banks = F.pad(banks, (0, 1)).to(wave.device)  # the Nyquist bin takes no weight
    return torch.log(torch.clamp(power @ banks.t(), min=1.1920928955078125e-07))


def speech_features(wave: torch.Tensor, n_valid: torch.Tensor, num_mel_bins: int = 80):
    """Padded waveforms (B, N) and valid samples (B,) -> (features (B, m,
    bins) float32 with utterance mean and variance normalized over the
    frames that lie wholly inside the valid samples, later frames 0; their
    counts (B,))."""
    feats = kaldi_fbank(wave, num_mel_bins)
    m = feats.shape[1]
    frames = torch.clamp(1 + torch.div(n_valid - 400, 160, rounding_mode="floor"), 0, m)
    keep = (torch.arange(m, device=wave.device)[None] < frames[:, None])[..., None]
    cnt = frames.double()[:, None, None]
    mean = (feats * keep).sum(1, keepdim=True) / cnt
    var = (feats ** 2 * keep).sum(1, keepdim=True) / cnt - mean ** 2
    feats = (feats - mean) / torch.sqrt(torch.clamp(var, min=1e-10))
    return (feats * keep).float(), frames


# ----------------------------------------------------------------- decoding
def hypothesis_logits(precision: str, p, cfg: Dict, src, src_length,
                      tokens: torch.Tensor, bos: int = 2) -> torch.Tensor:
    """Teacher-forced logits (n, V) at each position of ``tokens`` (n,) given
    one source (1, ...)."""
    ops = Ops(precision)
    enc_out, valid = encode(ops, p, cfg, src, src_length)
    trg_input = torch.cat([tokens.new_tensor([bos]), tokens[:-1]])[None]
    return decode(ops, p, cfg, trg_input, enc_out, valid)[0]


def allowed_kth(logits: torch.Tensor, k: int, banned: Sequence[int], eos: int = 3):
    """Per position, the ``k``-th largest logit over the tokens search may
    emit there (bos and the other ``banned`` ids never; eos not at step 0),
    and its token; ``k`` = 1 gives the best."""
    x = logits.clone()
    x[:, list(banned)] = -math.inf
    x[0, eos] = -math.inf
    values, tokens = x.topk(k, dim=-1)
    return values[:, -1], tokens[:, -1]


def gnmt_score(logits: torch.Tensor, tokens: torch.Tensor, alpha: float) -> float:
    """Sum of the tokens' log-probabilities over the GNMT length penalty
    ((5 + n) / 6) ** alpha of their count n."""
    lp = torch.log_softmax(logits.double(), dim=-1)
    total = lp.gather(1, tokens[:, None]).sum()
    return float(total / ((5.0 + len(tokens)) / 6.0) ** alpha)
