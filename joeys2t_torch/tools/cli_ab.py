# coding: utf-8
"""Time ``python -m joeys2t_torch train`` of this checkout against another
checkout's (for example the same tree with another training loop, unpacked
under ``build/``) on one CUDA card, at chip_smoke.py phase 7's
configuration: configs/synthetic_asr.yaml at full width in bf16, 16 updates
of 64 generated utterances, a validation every 8, no test after training.

    python3 -m joeys2t_torch.tools.cli_ab OTHER_CHECKOUT [--pairs 2]

Each turn is a fresh ``python -m joeys2t_torch train --skip-test`` process
in one checkout, on one corpus and config; both checkouts build their
kernels into their own ``build/`` before the first turn, so no build falls
inside a timed loop. Turns run other, this, this, other for each pair, so a
drift of the host or the card falls on both sides alike. Prints the card's
name and power limit, every turn's ``Training loop`` line with its time per
update and trained audio-s/s, and each side's median. Imports nothing of
JAX.
"""
import argparse
import importlib.util
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
LOOP = re.compile(r"Training loop: (\d+) update\(s\) in ([\d.]+)\[sec\] besides validation "
                  r"\(([\d.]+)\[sec\] per update\)[^\n]*")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=2, help="other/this/this/other rounds")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from joeys2t_torch.config import dump_yaml

    smoke = _chip_smoke()
    trees = {"other": args.other.resolve(), "this": REPO}
    work = REPO / "build" / "cli_ab"
    data = work / "synthetic_asr"
    smoke.generate_corpus(data)
    audio_s = smoke.manifest_audio_s(data / "train.tsv") * 2  # 16 updates = 2 epochs
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for tree in trees.values():
        subprocess.run([sys.executable, "-c", "from joeys2t_torch.ops import cuda_build; "
                        "cuda_build.build_all()"], cwd=tree, env=env, check=True, timeout=900)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    turns = {"other": [], "this": []}
    for i, side in enumerate(["other", "this", "this", "other"] * args.pairs):
        model_dir = work / f"model_{i}"
        cfg_path = work / f"cfg_{i}.yaml"
        cfg_path.write_text(dump_yaml(smoke.cli_config(data, model_dir)), encoding="utf-8")
        subprocess.run([sys.executable, "-m", "joeys2t_torch", "train", str(cfg_path),
                        "--skip-test"], cwd=trees[side], env=env, check=True,
                       capture_output=True, timeout=1200)
        m = LOOP.search((model_dir / "train.log").read_text(encoding="utf-8"))
        if m is None or int(m.group(1)) != 16:
            raise RuntimeError(f"turn {i} ({side}): no training-loop line for 16 updates")
        ms, rate = float(m.group(3)) * 1e3, audio_s / float(m.group(2))
        turns[side].append((ms, rate))
        print(f"[cli-ab] turn {i} {side}: {ms:.2f} ms per update, {rate:.1f} trained "
              f"audio-s/s; {m.group(0)}", flush=True)
    for side, runs in turns.items():
        print(f"[cli-ab] {side} ({trees[side]}): median {statistics.median(r[0] for r in runs):.2f}"
              f" ms per update, {statistics.median(r[1] for r in runs):.1f} trained audio-s/s "
              f"over {len(runs)} turns")


if __name__ == "__main__":
    main()
