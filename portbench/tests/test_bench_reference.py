"""The plain reference agrees with the port at a tiny size on the CPU, in
float32, where the two compute the same mathematics."""
import copy

import pytest
import torch

from benchutil import shrink
from harness import cell as C, program, traffic as T
from reference import model as ref

ATOL = 2e-4  # float32 sums in another order, over a few layers of width 64


def tiny_config(workload):
    cell = shrink(C.make_cell(C.benchmark(), workload, 1, 0.0, False, "cpu"))
    cfg = copy.deepcopy(cell.config)
    cfg["fp16"] = False
    return cfg


@pytest.mark.parametrize("workload", ["ls960h-train", "wmt17-translate-beam5"])
def test_teacher_forced_logits(workload):
    cfg = tiny_config(workload)
    model, spec, vocab, shapes = program.build(cfg, 2**31 + 3, "cpu")
    p = {n: t.detach() for n, t in model.named_parameters()}
    gen = torch.Generator().manual_seed(0)
    if cfg["task"] == "MT":
        src = T.source_ids(torch.tensor([9, 6]).numpy(), 4, 0, 60, "cpu")
        src_length = torch.tensor([9, 6])
        src_mask = (src != 1)[:, None, :]
    else:
        src = torch.randn(2, 40, 80, generator=gen)
        src[1, 31:] = 0.0
        src_length = torch.tensor([40, 31])
        src_mask = None
    trg_input = torch.randint(4, 60, (2, 7), generator=gen)
    trg_input[:, 0] = 2
    trg_input[1, 5:] = 1
    trg_mask = (trg_input != 1)[:, None, :]
    with torch.no_grad():
        logits, ctc, out_mask = model(src, trg_input, src_length, src_mask, trg_mask)
        enc, valid = ref.encode(ref.Ops(), p, cfg["model"], src, src_length)
        want = ref.decode(ref.Ops(), p, cfg["model"], trg_input, enc, valid)
    assert torch.equal(out_mask[:, 0], valid)
    keep = trg_mask[:, 0]
    assert torch.allclose(logits.float()[keep], want[keep], atol=ATOL)
    if ctc is not None:
        want_ctc = ref.Ops().linear(enc, p["decoder.ctc_output_layer.weight"])
        assert torch.allclose(ctc.float()[valid], want_ctc[valid], atol=ATOL)


def test_front_end():
    from joeys2t_torch.ops.frontend import device_frontend

    n = torch.tensor([16000, 9000, 4410])
    wave = T.speechlike(n, 7, "cpu")
    feats, frames = device_frontend(wave, n)
    want, want_frames = ref.speech_features(wave, n)
    assert torch.equal(frames, want_frames)
    assert torch.allclose(feats, want, atol=2e-3)


def test_training_updates_in_float32(tiny):
    cell = tiny("ls960h-train", seconds=0.0)
    cell.config["fp16"] = False
    outcome = C.run_kind(cell)
    assert all(c["value"] < 1e-4 for c in outcome.checks.values()), outcome.checks


@pytest.mark.parametrize("workload", ["wmt17-translate-beam5", "ls960h-transcribe-greedy"])
def test_decoding_in_float32(tiny, workload):
    cell = tiny(workload, seconds=0.0)
    cell.config["fp16"] = False
    outcome = C.run_kind(cell)
    assert all(c["value"] < 1e-3 for c in outcome.checks.values()), outcome.checks
