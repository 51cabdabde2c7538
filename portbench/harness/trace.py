"""The traced slice: ``torch.profiler`` over a few units of work, reduced to the
device's busy time, kernel times by name, and the idle gaps by what the host
was doing in them."""
import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

WINDOW = "portbench.window"


class Trace:
    """Device operations (name, start us, end us) and host operations of one
    traced slice, and the slice's own span on the same clock."""

    def __init__(self, device_ops, host_ops, window: Tuple[float, float]):
        self.device_ops = sorted(device_ops, key=lambda e: e[1])
        self.host_ops = sorted(host_ops, key=lambda e: e[1])
        self.window = window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' spans inside the window."""
        lo, hi = self.window
        merged = []
        for _, s, e in self.device_ops:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernel_seconds(self, *needles: str) -> float:
        """Device seconds of the operations whose name holds any needle."""
        return sum(e - s for n, s, e in self.device_ops if any(k in n for k in needles)) * 1e-6

    def kernel_count(self) -> int:
        return len(self.device_ops)

    def top_ops(self, n: int = 10) -> List[List]:
        by_name = defaultdict(float)
        for name, s, e in self.device_ops:
            by_name[name[:64]] += (e - s) * 1e-6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle seconds of the device summed by the innermost host operation
        that was running at each gap's middle ("python" where none was)."""
        starts = [s for _, s, _ in self.host_ops]
        by_what = defaultdict(float)
        prev = self.window[0]
        for s, e in self.busy_intervals() + [(self.window[1], self.window[1])]:
            if s > prev:
                by_what[self._host_at((prev + s) / 2, starts)] += (s - prev) * 1e-6
            prev = max(prev, e)
        return [[k, v] for k, v in sorted(by_what.items(), key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: float, starts: List[float]) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 400, -1), -1):
            name, s, e = self.host_ops[j]
            if s <= t <= e:
                return name[:64]
        return "python"


@contextlib.contextmanager
def traced(store: Dict, host: bool = False):
    """Profile the block; its end synchronises the device. Without ``host``
    only the device's operations are recorded (the profiler then costs the
    host little) and the window runs from the first operation's start to the
    last one's end; with ``host`` the host's operations too, and the window
    is the block's own span. ``store["trace"]`` holds the :class:`Trace`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield
            if cuda:
                torch.cuda.synchronize()
    device_ops, host_ops, window = [], [], None
    for ev in prof.events():
        span = (ev.time_range.start, ev.time_range.end)
        if ev.device_type == DeviceType.CUDA:
            if not ev.is_user_annotation and ev.name != WINDOW:
                device_ops.append((ev.name, *span))
        elif ev.name == WINDOW:
            window = span
        else:
            host_ops.append((ev.name, *span))
    if not host and device_ops:
        window = (min(s for _, s, _ in device_ops), max(e for _, _, e in device_ops))
    if window is None:
        raise RuntimeError("the profiler recorded no window")
    store["trace"] = Trace(device_ops, host_ops, window)
