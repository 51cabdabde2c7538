"""What the host did in a window: its clock against the process's CPU time,
the CPU core the process ran on and that core's clock, and each unit's wall
time by the unit's kind. Printed on standard error, so that a run whose
rate is off can be told apart: a slower host (CPU time per unit up) or a
waiting one, a slow process or a slow unit."""
import os
import statistics
import time
from pathlib import Path
from typing import Dict, List


def core() -> int:
    """The CPU core this process last ran on (/proc/self/stat, field 39)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        return int(stat[stat.rindex(")") + 2:].split()[36])
    except (OSError, ValueError, IndexError):
        return -1


def core_mhz(n: int) -> str:
    """Core ``n``'s clock as the kernel reports it, or '?'."""
    freq = Path(f"/sys/devices/system/cpu/cpu{n}/cpufreq/scaling_cur_freq")
    try:
        return f"{int(freq.read_text()) / 1000:.0f}"
    except (OSError, ValueError):
        pass
    try:
        for block in Path("/proc/cpuinfo").read_text().split("\n\n"):
            fields = dict((k.strip(), v.strip()) for k, v in
                          (line.split(":", 1) for line in block.splitlines() if ":" in line))
            if fields.get("processor") == str(n):
                return fields.get("cpu MHz", "?")
    except OSError:
        pass
    return "?"


class Watch:
    """Start it where the window opens, ``lap(kind)`` after each unit, and
    ``report()`` once it has closed."""

    def __init__(self):
        self.core0 = core()
        self.mhz0 = core_mhz(self.core0)
        self.wall0 = self.last = time.perf_counter()
        self.cpu0 = time.process_time()
        self.laps: Dict[str, List[float]] = {}

    def lap(self, kind: str) -> None:
        now = time.perf_counter()
        self.laps.setdefault(kind, []).append(now - self.last)
        self.last = now

    def report(self) -> str:
        wall, cpu = time.perf_counter() - self.wall0, time.process_time() - self.cpu0
        n = core()
        kinds = "; ".join(f"{k}: {len(v)} x median {statistics.median(v):.4f} s "
                          f"(min {min(v):.4f}, max {max(v):.4f})"
                          for k, v in sorted(self.laps.items()))
        return (f"host: window {wall:.3f} s, process CPU {cpu:.3f} s ({100 * cpu / wall:.1f} %), "
                f"core {self.core0} at {self.mhz0} MHz -> core {n} at {core_mhz(n)} MHz, "
                f"load {os.getloadavg()[0]:.2f}; units {kinds}")
