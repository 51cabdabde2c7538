"""Operations and bytes that the inputs need, from their shapes alone, whatever
kernels the program runs: the model FLOPs of a unit of work, and the least
device time of the attention kernels' calls. Lengths are the valid ones:
padding is work the inputs do not need. A multiply-add counts as 2."""
from typing import Dict, Iterable, Sequence, Tuple

from harness.peaks import least_seconds

BF16, F32 = 2, 4


def conv_lengths(frames: int, kernels: Sequence[int]) -> Tuple[int, ...]:
    """Output frames of each stride-2 convolution of the subsampler."""
    out, n = [], frames
    for k in kernels:
        n = (n + 2 * (k // 2) - k) // 2 + 1
        out.append(n)
    return tuple(out)


def _sizes(side: Dict) -> Tuple[int, int]:
    return side["hidden_size"], side["ff_size"]


def encoder_flops(model: Dict, length: int, speech: bool) -> float:
    """Forward FLOPs of one source: the subsampler's convolutions (speech),
    each layer's projections, attention over the valid keys and
    feed-forward."""
    enc = model["encoder"]
    d, ff = _sizes(enc)
    total = 0.0
    if speech:
        kernels = enc["conv_kernel_sizes"]
        outs = conv_lengths(length, kernels)
        c_in, mid = enc["in_channels"], enc["conv_channels"]
        for i, (k, n) in enumerate(zip(kernels, outs)):
            cin = c_in if i == 0 else mid // 2
            cout = mid if i < len(kernels) - 1 else 2 * d
            total += 2.0 * n * k * cin * cout
        length = outs[-1]
    per_layer = 2.0 * length * (4 * d * d + 2 * d * ff) + 4.0 * length * length * d
    return total + enc["num_layers"] * per_layer


def speech_frames_out(model: Dict, frames: int) -> int:
    return conv_lengths(frames, model["encoder"]["conv_kernel_sizes"])[-1]


def decoder_flops(model: Dict, vocab: int, trg: int, src: int) -> float:
    """Teacher-forced forward FLOPs of ``trg`` target positions over ``src``
    encoder positions: causal self-attention, cross-attention (its keys and
    values projected from the encoder once), feed-forward, output layer."""
    dec = model["decoder"]
    d, ff = _sizes(dec)
    causal = trg * (trg + 1) / 2.0
    per_layer = (2.0 * trg * (6 * d * d + 2 * d * ff) + 2.0 * src * 2 * d * d
                 + 4.0 * causal * d + 4.0 * trg * src * d)
    return dec["num_layers"] * per_layer + 2.0 * trg * d * vocab


def decode_flops(model: Dict, vocab: int, steps: int, src: int, rows: int = 1) -> float:
    """KV-cached decoding of ``steps`` steps by ``rows`` hypotheses over one
    source of ``src`` positions: per step each row's projections,
    feed-forward, attention over its history and the source, output layer;
    the source's cross keys and values projected once."""
    dec = model["decoder"]
    d, ff = _sizes(dec)
    history = steps * (steps + 1) / 2.0
    per_layer = (rows * (2.0 * steps * (6 * d * d + 2 * d * ff) + 4.0 * history * d
                         + 4.0 * steps * src * d) + 2.0 * src * 2 * d * d)
    return dec["num_layers"] * per_layer + rows * 2.0 * steps * d * vocab


def ctc_head_flops(model: Dict, vocab: int, src: int) -> float:
    return 2.0 * src * model["decoder"]["hidden_size"] * vocab


def flash_least_s(pairs: Iterable[Tuple[int, int]], heads: int, head_dim: int,
                  backward: bool = False) -> float:
    """Least time of one flash-attention call over (valid queries, valid
    keys) per batch row. Forward: read Q, K, V once (bf16), write O (bf16)
    and the log-sum-exp (f32); 2 products of 2 FLOPs a multiply-add.
    Backward: read Q, K, V, O, dO (bf16) and the log-sum-exp (f32), write
    dQ, dK, dV (bf16); 5 products."""
    pairs = list(pairs)
    rows = heads * head_dim
    q = sum(a for a, _ in pairs)
    k = sum(b for _, b in pairs)
    mac = sum(a * b for a, b in pairs) * rows
    if backward:
        n_bytes = (3 * q + 2 * k) * rows * BF16 + q * heads * F32 + (q + 2 * k) * rows * BF16
        n_ops = 10.0 * mac
    else:
        n_bytes = (q + 2 * k) * rows * BF16 + q * rows * BF16 + q * heads * F32
        n_ops = 4.0 * mac
    return least_seconds(n_bytes, n_ops)


def decode_attention_least_s(vectors: float, queries: float, heads: int,
                             head_dim: int) -> float:
    """Least time of decode attention that must read ``vectors`` cached key
    and value vectors (bf16, one of each per position and head) and write
    ``queries`` outputs; the products are far below the chip's rate."""
    n_bytes = vectors * heads * head_dim * 2 * BF16 + 2 * queries * heads * head_dim * BF16
    return least_seconds(n_bytes, 0.0)
