#!/usr/bin/env python3
"""The benchmark of joeys2t_torch, the PyTorch and CUDA port, on NVIDIA GPUs.

    python3 portbench/run.py --workload ls960h-train --seed 7 --seconds 20 --trace 0

Runs one cell of BENCHMARK.json from the root of a checkout: builds the
program's kernels (once, into build/ inside the checkout), makes the cell's
weights and inputs from --seed, warms every shape the cell uses, measures
for --seconds, checks what the timed path produced against the plain
reference, and prints one JSON line: the end-to-end metrics (--trace 0) or
the per-layer metrics read from a profiled slice (--trace 1). It runs on the
machine it is started on and stops, printing no result, without a CUDA card.
"""
import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for path in (str(ROOT), str(HERE)):
        if path not in sys.path:
            sys.path.insert(0, path)
    # every cache of a build or a compile lives at a fixed path in the checkout
    build = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    # one process with few threads: the host's launch loop paces some cells,
    # and idle CPU threads of the process only contend with it
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"

    from harness import cell as C  # pylint: disable=import-outside-toplevel

    spec = C.benchmark()
    cell = C.make_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    import torch  # pylint: disable=import-outside-toplevel

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: needs {cell.chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}; no result",
              file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on {cell.chips} x "
          f"{torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: "
          f"{C.card_report()}", file=sys.stderr)
    outcome = C.run_kind(cell)
    metrics = C.read_metrics(C.cell_metrics(spec, args.workload, cell.trace), cell, outcome)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if cell.trace:
        device.update(busy_s=outcome.trace.busy_s, window_s=outcome.trace.window_s)
    bad = C.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    line = C.result_line(cell, outcome, metrics, device)
    print(f"portbench: set-up {outcome.setup_s:.3f} s, window {outcome.window_s:.3f} s, "
          f"peak memory {outcome.memory_peak_bytes} B, attempted {outcome.attempted}, "
          f"failed {outcome.failed}", file=sys.stderr)
    for note in outcome.notes:
        print(f"portbench: {note}", file=sys.stderr)
    for name, c in outcome.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
