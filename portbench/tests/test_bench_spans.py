"""The program's spans as the benchmark reads them: device time goes to a span
by launch order, a mismatch of counts gives no reading, and each reader of a
span returns nothing in a cell without its spans."""
import pytest

from harness import cell as C
from harness import spans
from harness.trace import Trace

NEW = {"launch_ms_per_step.transcribe": "transcribe", "loop_idle_share.transcribe": "transcribe",
       "encode_share.transcribe": "transcribe", "launch_ms_per_step.translate": "translate",
       "select_share.translate": "translate", "scores_share.translate": "translate",
       "optimizer_share.train": "train", "host_launch_share.train": "train"}


def reading(kind, host_trace):
    cell = C.Cell("w", {}, {"kind": kind}, 1, 1.0, True, "cpu", 1, {})
    return C.Reading(cell, C.Outcome(setup_s=0.0, host_trace=host_trace))


def unit(device=((0, 30, 35), (1, 40, 47), (2, 240, 251)), extra=()):
    """Span a holds a ``cuda*`` launch and a ``cu*`` launch, span b a memcpy
    whose call has a ``cu*`` call recorded inside it, then the host waits
    for the device; the device runs each operation later than its launch, as
    a queue does."""
    host = [("a", 0, 100), ("cudaLaunchKernel", 10, 15), ("cuLaunchKernelEx", 20, 25),
            ("aten::mm", 30, 90), ("b", 200, 300), ("cudaMemcpyAsync", 210, 260),
            ("cuLaunchKernel", 215, 220), ("cudaStreamSynchronize", 260, 290),
            *extra]
    names = ["op0", "op1", "Memcpy DtoH (Device -> Pinned)"]
    return Trace([(names[i], s, e) for i, s, e in device], host, (0, 2000))


def stretches(dropped=()):
    """20 stretches of 100 kernel launches, each closed by a read-back (a
    memcpy); the device's records of the ``dropped`` (stretch, launch) are
    lost."""
    host, device = [], []
    for k in range(20):
        t = 1000 * k
        for i in range(100):
            host.append(("cudaLaunchKernel", t + i, t + i + 0.5))
            if (k, i) not in dropped:
                device.append((f"op{k}.{i}", t + 300 + 4 * i, t + 300 + 4 * i + 1 + i % 3))
        host.append(("cudaMemcpyAsync", t + 200, t + 900))
        device.append(("Memcpy DtoH (Device -> Pinned)", t + 800, t + 801))
    host += [("half", 7000, 7049.9), ("whole", 3000, 3100), ("all", 0, 20000)]
    return Trace(device, host, (0, 20000))


def test_device_time_goes_by_launch_order():
    trace = unit()
    assert spans.launched_s(trace, "a") == pytest.approx(12e-6)
    assert spans.launched_s(trace, "b") == pytest.approx(11e-6)
    assert spans.launched_s(trace, "a", "b") == pytest.approx(23e-6)
    assert spans.launched_s(trace, "nothing") == 0.0


def test_a_count_mismatch_reads_nothing():
    assert spans.launched_s(unit(device=((0, 1010, 1015), (1, 1020, 1027))), "a") is None
    extra = (("cudaMemsetAsync", 500, 505),)
    assert spans.launched_s(unit(extra=extra), "a") is None


def test_a_lost_record_moves_its_stretch_by_one_call_at_most():
    """One lost device record among 2,020: the call it leaves without an
    operation is placed as early in its stretch between read-backs as it
    may be, every other stretch pairs one to one, and all the device time
    is still launched somewhere."""
    op = [1 + i % 3 for i in range(100)]
    lost = stretches(((7, 50),))
    assert spans.launched_s(stretches(), "whole") == pytest.approx(sum(op) * 1e-6)
    assert spans.launched_s(lost, "whole") == pytest.approx(sum(op) * 1e-6)
    assert spans.launched_s(stretches(), "half") == pytest.approx(sum(op[:50]) * 1e-6)
    # stretch 7 skips its first call: calls 1..49 hold ops 0..48
    assert spans.launched_s(lost, "half") == pytest.approx(sum(op[:49]) * 1e-6)
    assert spans.launched_s(lost, "all") == pytest.approx(
        sum(e - s for _, s, e in lost.device_ops) * 1e-6)


def test_a_copy_recorded_ahead_of_its_kernel_still_pairs():
    """A copy's record that starts before the kernel launched ahead of it,
    beside a lost record: each operation keeps its call."""
    trace = stretches(((7, 50),))
    ops = list(trace.device_ops)
    k = next(i for i, (n, s, _) in enumerate(ops) if n.startswith("Memcpy") and s > 3000)
    ops[k - 1], ops[k] = ops[k], ops[k - 1]  # the read-back of stretch 3 first
    swapped = Trace([], trace.host_ops, trace.window)
    swapped.device_ops = ops
    op = [1 + i % 3 for i in range(100)]
    assert spans.launched_s(swapped, "whole") == pytest.approx((sum(op) - op[99] + 1) * 1e-6)
    assert spans.launched_s(swapped, "half") == pytest.approx(sum(op[:49]) * 1e-6)


def test_too_many_lost_records_or_an_op_without_a_launch_read_nothing():
    assert spans.launched_s(stretches(((7, 50), (7, 51), (2, 3))), "whole") is None
    extra = Trace(stretches().device_ops + [("op.extra", 19990, 19991)],
                  stretches().host_ops, (0, 20000))
    assert spans.launched_s(extra, "whole") is None


def test_busy_within_a_span():
    trace = unit()
    assert spans.busy_s(trace, (0, 45)) == pytest.approx(10e-6)
    assert spans.busy_s(trace, (300, 900)) == 0.0


def decode_unit():
    """Two decode steps of 10 and 14 us with read-backs of 4 and 6, inside a
    loop of 40 us; a request of 100 us holding an encode; a select and a
    scores span in each step; one device operation launched in each part,
    run in launch order."""
    host, device = [], []
    host += [("joeys2t.request", 0, 100), ("joeys2t.encode", 1, 5), ("cudaLaunchKernel", 2, 3),
             ("joeys2t.decode", 10, 50)]
    device.append(("enc", 5, 35))
    for s, step, rb in ((12, 10, 4), (30, 14, 6)):
        host += [("joeys2t.decode.step", s, s + step), ("joeys2t.beam.scores", s + 1, s + 2),
                 ("cudaLaunchKernel", s + 1, s + 2), ("joeys2t.beam.select", s + 2, s + 3),
                 ("cudaLaunchKernel", s + 2, s + 3),
                 ("joeys2t.decode.readback", s + step - rb, s + step)]
    device += [("scores", 40, 42), ("select", 42, 50), ("scores", 60, 62), ("select", 62, 70)]
    return Trace(sorted(device, key=lambda d: d[1]), host, (0, 300))


def test_decode_readers():
    trace = decode_unit()
    assert spans.launch_ms_per_step(reading("translate", trace), "translate") == \
        pytest.approx((24 - 10) * 1e-3 / 2)
    # the loop's wall 10..50 us: busy 10-35 and 40-50
    assert spans.loop_idle_share(reading("translate", trace), "translate") == \
        pytest.approx(100.0 * (1 - 35 / 40))
    assert spans.launched_share(reading("translate", trace), "translate",
                                ("joeys2t.beam.select",), "joeys2t.decode") == \
        pytest.approx(100.0 * 16 / 20)
    assert spans.launched_share(reading("transcribe", trace), "transcribe",
                                ("joeys2t.frontend", "joeys2t.encode"), "joeys2t.request") == \
        pytest.approx(100.0 * 30 / 50)


def test_host_over_launched():
    host = [("joeys2t.update", 0, 90), ("cudaLaunchKernel", 1, 2),
            ("joeys2t.optimizer", 50, 80), ("cudaLaunchKernel", 60, 61)]
    trace = Trace([("fwd", 5, 65), ("adam", 70, 100)], host, (0, 100))
    assert spans.host_over_launched(reading("train", trace), "train", "joeys2t.update") == \
        pytest.approx(100.0 * 90 / 90)
    assert spans.launched_share(reading("train", trace), "train", ("joeys2t.optimizer",),
                                "joeys2t.update") == pytest.approx(100.0 * 30 / 90)


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_reader_reads_nothing_without_its_spans(name):
    read = C.metric_reader(name)
    kind = NEW[name]
    assert read(reading(kind, unit())) is None  # device work, none of the spans
    assert read(reading(kind, None)) is None
    assert read(reading(kind, Trace([], decode_unit().host_ops, (0, 300)))) is None
    other = "train" if kind != "train" else "translate"
    assert read(reading(other, decode_unit())) is None


@pytest.mark.parametrize("workload", ["ls960h-train", "wmt17-translate-beam5",
                                      "ls960h-transcribe-greedy"])
def test_the_program_opens_the_spans_its_readers_read(tiny, workload):
    """A traced CPU run of each cell: its unit traced with the host's
    operations holds every span that the cell's readers look for (the
    readers return nothing there: no device operation ran)."""
    want = {"ls960h-train": {"joeys2t.update", "joeys2t.optimizer"},
            "wmt17-translate-beam5": {"joeys2t.decode", "joeys2t.decode.step",
                                      "joeys2t.decode.readback", "joeys2t.beam.select",
                                      "joeys2t.beam.scores"},
            "ls960h-transcribe-greedy": {"joeys2t.request", "joeys2t.frontend",
                                         "joeys2t.encode", "joeys2t.decode",
                                         "joeys2t.decode.step", "joeys2t.decode.readback"}}
    cell = tiny(workload, trace=True)
    outcome = C.run_kind(cell)
    names = {n for n, _, _ in outcome.host_trace.host_ops}
    assert want[workload] <= names
    here = [m["name"] for m in C.cell_metrics(C.benchmark(), workload, True) if m["name"] in NEW]
    assert here and all(C.metric_reader(n)(C.Reading(cell, outcome)) is None for n in here)
