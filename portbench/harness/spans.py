"""The program's own spans in the unit traced with the host's operations
(``outcome.host_trace``): the ``torch.profiler.record_function`` ranges that
joeys2t_torch opens at its layer boundaries (``joeys2t.*``), on the clock of
the device operations, and the device time launched inside each.

Device time goes to a span by launch order. The program runs one stream, so
the k-th launch call the host recorded in the traced unit (a kernel launch
through a ``cuda*`` or ``cu*`` call, a memcpy or a memset; a call recorded
inside another, as a ``cu*`` call under a ``cuda*`` call, counts once)
started the k-th device operation. Two faults of the profiler's record bend that rule
on an H100 (torch 2.11): it loses a device record now and then (1-13 of
30,520 or 35,799 in half the traced decode requests, never a launch call;
none in a training update), and ordered by their starts the records of a
copy or a fill and of a kernel can come in another order than their
launches. So the operations are laid over the launch calls in order,
skipping as many calls as records were lost, where the fewest operations
land on a call of another kind (kernel, copy or fill), each skip as early
as it may be; each operation's seconds go to the call it lands on. Where
more than one launch call in a thousand has no operation, more than one
operation in a hundred lands on a call of another kind, or there are more
operations than calls, every reading through the pairing is None."""
import bisect
from typing import List, Optional, Tuple

import numpy as np

from harness.trace import Trace

COPY, FILL, KERNEL = "copy", "fill", "kernel"
# the calls that launched every device operation of the cells on an H100
# (torch 2.11): cudaLaunchKernel, cudaLaunchKernelExC, cuLaunchKernel,
# cuLaunchKernelEx, cudaMemcpyAsync, cudaMemsetAsync
LAUNCH_CALLS = {"cudaLaunchKernel": KERNEL, "cuLaunchKernel": KERNEL, "cudaMemcpy": COPY,
                "cudaMemset": FILL}


def host_trace(reading, kind: str) -> Optional[Trace]:
    """The unit traced with the host's operations, or None: another kind of
    traffic, no such trace, or no device operation in it."""
    out = reading.outcome
    if reading.kind != kind or out.host_trace is None or not out.host_trace.device_ops:
        return None
    return out.host_trace


def spans(trace: Trace, name: str) -> List[Tuple[float, float]]:
    """The (start, end) in us of every span named ``name``, in time order."""
    return [(s, e) for n, s, e in trace.host_ops if n == name]


def wall_us(intervals) -> float:
    return sum(e - s for s, e in intervals)


def launch_call(name: str) -> Optional[str]:
    """What a host call launches (``KERNEL``, ``COPY``, ``FILL``), or None."""
    return next((k for p, k in LAUNCH_CALLS.items() if name.startswith(p)), None)


def device_kind(name: str) -> str:
    return COPY if name.startswith("Memcpy") else FILL if name.startswith("Memset") else KERNEL


def launch_calls(trace: Trace) -> List[Tuple[float, float, str]]:
    """The launch calls (start, end, kind) in time order, each once (outermost)."""
    out = []
    for name, s, e in trace.host_ops:  # sorted by start
        kind = launch_call(name)
        if kind and not (out and s < out[-1][1]):
            out.append((s, e, kind))
    return out


def launched(trace: Trace) -> Optional[Tuple[List[float], List[float]]]:
    """Each launch call's start and the device seconds it started."""
    calls = launch_calls(trace)
    ops = trace.device_ops  # sorted by start: the stream's order
    lost = len(calls) - len(ops)
    if lost < 0 or 1000 * lost > len(calls):
        return None
    codes = {KERNEL: 0, COPY: 1, FILL: 2}
    call_kind = np.array([codes[k] for _, _, k in calls], dtype=np.int8)
    op_kind = np.array([codes[device_kind(n)] for n, _, _ in ops], dtype=np.int8)
    # cost[g]: the fewest operations on a call of another kind, with the
    # operation so far on call (its index + g); back[i, g]: the skip of the
    # operation before
    skips = np.arange(lost + 1)
    cost = np.zeros(lost + 1)
    back = np.zeros((len(ops), lost + 1), dtype=np.int32)
    for i, kind in enumerate(op_kind):
        least = np.minimum.accumulate(cost)
        back[i] = np.maximum.accumulate(np.where(cost <= least, skips, 0))
        cost = least + (call_kind[i:i + lost + 1] != kind)
    if 100 * cost.min() > len(ops):
        return None
    seconds, g = [0.0] * len(calls), int(np.argmin(cost))
    for i in range(len(ops) - 1, -1, -1):
        seconds[i + g] = (ops[i][2] - ops[i][1]) * 1e-6
        g = int(back[i, g])
    return [s for s, _, _ in calls], seconds


def merged(intervals) -> List[Tuple[float, float]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def launched_s(trace: Trace, *names: str) -> Optional[float]:
    """Device seconds of the operations launched inside any span of
    ``names``; None where launches and device operations do not pair."""
    got = launched(trace)
    if got is None:
        return None
    starts, seconds = got
    running = [0.0]
    for d in seconds:
        running.append(running[-1] + d)
    total = 0.0
    for s, e in merged(r for n in names for r in spans(trace, n)):
        total += running[bisect.bisect_right(starts, e)] - running[bisect.bisect_left(starts, s)]
    return total


def busy_s(trace: Trace, interval: Tuple[float, float]) -> float:
    """Seconds of ``interval`` in which some device operation ran."""
    return Trace(trace.device_ops, [], interval).busy_s


# the readers of metrics/<name>.py

def launch_ms_per_step(reading, kind: str):
    """Host ms a decode step spends outside its read-back of the stop flag:
    the launches of the step's work and the loop's Python."""
    trace = host_trace(reading, kind)
    steps = [] if trace is None else spans(trace, "joeys2t.decode.step")
    if not steps:
        return None
    return (wall_us(steps) - wall_us(spans(trace, "joeys2t.decode.readback"))) * 1e-3 / len(steps)


def loop_idle_share(reading, kind: str):
    """Share of the decode loops' wall in which no device operation ran, in %."""
    trace = host_trace(reading, kind)
    loops = [] if trace is None else spans(trace, "joeys2t.decode")
    wall = wall_us(loops) * 1e-6
    if wall <= 0:
        return None
    return 100.0 * (1.0 - sum(busy_s(trace, r) for r in loops) / wall)


def launched_share(reading, kind: str, parts, whole: str):
    """Device seconds launched in the spans ``parts`` over those launched in
    ``whole``, in %."""
    trace = host_trace(reading, kind)
    if trace is None:
        return None
    part, total = launched_s(trace, *parts), launched_s(trace, whole)
    if part is None or not total:
        return None
    return 100.0 * part / total


def host_over_launched(reading, kind: str, name: str):
    """The host wall of the spans ``name`` over the device seconds of what
    they launched, in %: near 100 the host's launches keep pace with the
    device's work only just."""
    trace = host_trace(reading, kind)
    if trace is None:
        return None
    device = launched_s(trace, name)
    if not device:
        return None
    return 100.0 * wall_us(spans(trace, name)) * 1e-6 / device
