"""The operation and byte counts and the least times equal hand counts."""
import pytest

from harness import flops, peaks

SPEECH = {"encoder": {"hidden_size": 4, "ff_size": 8, "num_layers": 2, "num_heads": 2,
                      "conv_kernel_sizes": [5, 5], "in_channels": 3, "conv_channels": 6},
          "decoder": {"hidden_size": 4, "ff_size": 8, "num_layers": 1, "num_heads": 2}}


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(3.35e12, 0.0) == pytest.approx(1.0)
    assert peaks.least_seconds(0.0, 989e12) == pytest.approx(1.0)
    assert peaks.least_seconds(3.35e12, 2 * 989e12) == pytest.approx(2.0)


@pytest.mark.parametrize("frames,outs", [(10, (5, 3)), (100, (50, 25))])
def test_subsampler_lengths(frames, outs):
    assert flops.conv_lengths(frames, (5, 5)) == outs


@pytest.mark.parametrize("frames", [10, 100])
def test_speech_encoder_flops(frames):
    l1, l2 = flops.conv_lengths(frames, (5, 5))
    conv = 2 * l1 * 5 * 3 * 6 + 2 * l2 * 5 * 3 * 8
    layer = 2 * l2 * (4 * 16 + 2 * 4 * 8) + 4 * l2 * l2 * 4
    assert flops.encoder_flops(SPEECH, frames, True) == conv + 2 * layer


@pytest.mark.parametrize("trg,src", [(1, 1), (3, 5)])
def test_decoder_flops(trg, src):
    d, ff, v = 4, 8, 7
    causal = trg * (trg + 1) // 2
    want = (2 * trg * (6 * d * d + 2 * d * ff) + 2 * src * 2 * d * d + 4 * causal * d
            + 4 * trg * src * d) + 2 * trg * d * v
    assert flops.decoder_flops(SPEECH, v, trg, src) == want
    # decoding the same tokens one step at a time is the same work
    assert flops.decode_flops(SPEECH, v, trg, src) == want


@pytest.mark.parametrize("pairs", [[(1, 1)], [(3, 5), (2, 7)]])
def test_flash_least_time(pairs):
    h, dh = 2, 4
    q, k = sum(a for a, _ in pairs), sum(b for _, b in pairs)
    mac = sum(a * b for a, b in pairs) * h * dh
    fwd_bytes = (q + 2 * k) * h * dh * 2 + q * h * dh * 2 + q * h * 4
    assert flops.flash_least_s(pairs, h, dh) == pytest.approx(
        max(fwd_bytes / 3.35e12, 4 * mac / 989e12))
    bwd_bytes = (3 * q + 2 * k) * h * dh * 2 + q * h * 4 + (q + 2 * k) * h * dh * 2
    assert flops.flash_least_s(pairs, h, dh, backward=True) == pytest.approx(
        max(bwd_bytes / 3.35e12, 10 * mac / 989e12))


@pytest.mark.parametrize("vectors,queries", [(1, 1), (1000, 10)])
def test_decode_attention_least_time(vectors, queries):
    assert flops.decode_attention_least_s(vectors, queries, 8, 64) == pytest.approx(
        (vectors * 8 * 64 * 2 * 2 + 2 * queries * 8 * 64 * 2) / 3.35e12)
