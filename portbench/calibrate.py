#!/usr/bin/env python3
"""Readings that the limits of ``limits/<workload>.json`` are set from.

    python3 portbench/calibrate.py --workload ls960h-train --seeds 12 --controls 3

For each of ``--seeds`` seeds, one run of the cell at its own size (the
window ``--seconds`` long, 0 for training, whose readings need none), with
the numbers it compares; on the first ``--controls`` seeds also the
control: the plain reference in float8 (e4m3, per-tensor scales), the
precision below the configurations' bfloat16, in the program's place.
``--fault NAME`` plants one of ``faults.py``'s faults in the program for
every run. One JSON line a seed, then the largest reading of each number
and the smallest control reading. Needs a CUDA card.
"""
import argparse
import contextlib
import gc
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=3000000000)
    parser.add_argument("--seconds", type=float, default=0.0)
    parser.add_argument("--fault", default="")
    args = parser.parse_args(argv)
    for path in (str(ROOT), str(HERE)):
        if path not in sys.path:
            sys.path.insert(0, path)
    os.environ["USE_FLAX"] = "0"
    import torch
    from faults import FAULTS
    from harness import cell as C

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    spec = C.benchmark()
    readings, controls = {}, {}
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        cell = C.make_cell(spec, args.workload, seed, args.seconds, False, "cuda")
        cell.control = "fp8" if k < args.controls else ""
        fault = FAULTS[args.fault]() if args.fault else contextlib.nullcontext()
        t0 = time.perf_counter()
        with fault:
            out = C.run_kind(cell)
        row = {"seed": seed, "checks": {n: c["value"] for n, c in out.checks.items()},
               "controls": out.controls, "setup_s": out.setup_s, "window_s": out.window_s,
               "work": out.work, "peak": out.memory_peak_bytes,
               "wall_s": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        for n, x in row["checks"].items():
            readings.setdefault(n, []).append(x)
        for n, x in out.controls.items():
            controls.setdefault(n, []).append(x)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "fault": args.fault,
                      "largest": {n: max(v) for n, v in readings.items()},
                      "control_smallest": {n: min(v) for n, v in controls.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
