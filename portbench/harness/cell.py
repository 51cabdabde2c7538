"""One run of one cell: find its configuration, traffic, metrics and limits by
the names ``BENCHMARK.json`` gives them, run the traffic kind's runner, read
the metrics and print the result line."""
import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]  # the benchmark's folder
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "joeys2t_tpu")


@dataclasses.dataclass
class Cell:
    """What a runner needs: the cell's name, its configuration and traffic
    (parsed files), the run's seed, window, trace flag, device and chips,
    and the limits of its comparison."""
    name: str
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: str
    chips: int
    limits: Dict
    control: str = ""  # a lower precision to read the control in too (calibration only)


@dataclasses.dataclass
class Outcome:
    """What a runner returns: the end-to-end quantities of the measured
    window (``work`` over ``window_s``), the traced slice's work and
    :class:`~harness.trace.Trace` when traced, the counts of the units, the
    compared numbers, peak memory, set-up time."""
    setup_s: float
    window_s: float = 0.0
    work: Dict = dataclasses.field(default_factory=dict)
    trace: Optional[object] = None
    host_trace: Optional[object] = None  # a unit traced with the host's operations
    trace_work: Dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checks: Dict = dataclasses.field(default_factory=dict)
    controls: Dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    notes: List[str] = dataclasses.field(default_factory=list)  # for standard error


@dataclasses.dataclass
class Reading:
    """What a metric reader sees."""
    cell: Cell
    outcome: Outcome

    @property
    def kind(self) -> str:
        return self.cell.traffic["kind"]


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def make_cell(spec: Dict, workload: str, seed: int, seconds: float, trace: bool,
              device: str) -> Cell:
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    return Cell(workload, config, traffic, seed, seconds, trace, device, entry["chips"], limits)


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(spec: Dict, workload: str, trace: bool) -> List[Dict]:
    """The metrics this cell reports in this kind of run: the end-to-end
    ones untraced, the per-layer ones traced; a metric without
    ``workloads`` in every cell that reports the metric it moves."""
    def e2e_here(m):
        return "workloads" not in m or workload in m["workloads"]

    if not trace:
        return [m for m in spec["end_to_end"] if e2e_here(m)]
    here = {m["name"] for m in spec["end_to_end"] if e2e_here(m)}
    return [m for m in spec["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in here else [])]


def run_kind(cell: Cell) -> Outcome:
    module = importlib.import_module(f"harness.kinds.{cell.traffic['kind']}")
    return module.run(cell)


def read_metrics(metrics: List[Dict], cell: Cell, outcome: Outcome) -> Dict:
    reading = Reading(cell, outcome)
    out = {}
    for m in metrics:
        value = metric_reader(m["name"])(reading)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(checks: Dict) -> bool:
    """Every compared number is finite and within its limit."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def card_report() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi not available ({err})"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def result_line(cell: Cell, outcome: Outcome, metrics: Dict, device: Dict) -> Dict:
    correct = judge(outcome.checks) and outcome.failed == 0
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if cell.trace and outcome.trace is not None:
        line["breakdown"] = {"device_ops": outcome.trace.top_ops(),
                             "idle_gaps": (outcome.host_trace or outcome.trace).idle_gaps()}
    line["checks"] = outcome.checks
    return line
