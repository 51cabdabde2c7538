"""The command: it refuses to run without a card, and prints no result."""
import subprocess
import sys

import pytest

from benchutil import HERE


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "ls960h-train",
                          "--seed", str(2**31 + 99), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=HERE.parent, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_every_cell_has_its_files():
    from harness import cell as C

    spec = C.benchmark()
    for w in spec["workloads"]:
        cell = C.make_cell(spec, w["name"], 1, 1.0, False, "cpu")
        assert set(cell.limits) and cell.traffic["kind"] in ("train", "transcribe", "translate")
        for trace in (False, True):
            for m in C.cell_metrics(spec, w["name"], trace):
                assert callable(C.metric_reader(m["name"]))


def test_traced_run_on_the_cpu_reads_no_device_metric(tiny):
    """A traced run where no device operation ran: every per-layer reader
    returns nothing (no 0 for a share), and the breakdown still names the
    host's work."""
    from harness import cell as C

    cell = tiny("ls960h-train", trace=True)
    outcome = C.run_kind(cell)
    assert outcome.trace is not None and outcome.host_trace is not None
    assert C.read_metrics(C.cell_metrics(C.benchmark(), cell.name, True), cell, outcome) == {}
    line = C.result_line(cell, outcome, {}, {})
    assert list(line)[-1] == "checks" and line["breakdown"]["device_ops"] == []
    assert line["breakdown"]["idle_gaps"]
