#!/usr/bin/env python3
# coding: utf-8
"""Time the decode-attention kernel of this checkout against another
checkout's (for example an earlier commit unpacked with ``git archive``) on
one CUDA card, on cold-L2 input copies, at chip_smoke.py's decode shapes:
every shape in bf16 and the headline shape in every mode, as chip_smoke.py
times them.

    python3 scripts/torch_decode_ab.py OTHER_CHECKOUT

Each turn is a fresh process that imports ``joeys2t_torch`` from one
checkout (whose kernel builds into that checkout's ``build/``) and times its
``ops.decode_attention.decode_attention``, with this checkout's
chip_smoke.py inputs, copies and timer. A turn first holds the kernel
against its checkout's plain version. Turns run other, this, this, other,
so a drift of the card's clock falls on both sides alike.
Prints the card's name and power limit, then per case every turn's ms and
each side's mean. Imports nothing of JAX.
"""
import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def turn(tree: Path) -> dict:
    """ms per case of the kernel of ``tree``, timed in this process."""
    sys.path.insert(0, str(tree))
    import torch

    import joeys2t_torch

    if not Path(joeys2t_torch.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"joeys2t_torch imported from {joeys2t_torch.__file__}, not {tree}")
    from joeys2t_torch.ops import decode_attention as da

    smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    times = {}
    for i, (kind, b, s, spec) in enumerate(smoke.DECODE_SHAPES):
        for mode in smoke.DECODE_MODES if i == 0 else ("bf16",):
            args, kw, _ = smoke.decode_inputs(kind, b, s, spec, mode, gen)
            err = (da.decode_attention(*args, **kw).float()
                   - da.decode_attention_plain(*args, **kw).float()).abs().max().item()
            if not err <= (1e-5 if mode == "f32" else 1e-2):
                raise RuntimeError(f"{tree}: {kind} B={b} S={s} {mode}: max abs err {err}")
            copies = smoke.cold_copies(args)
            times[f"{kind} B={b} S={s} {spec} {mode}"] = smoke.time_cold_ms(
                [lambda c=c: da.decode_attention(*c, **kw) for c in copies])
            del copies
    return times


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.turn:  # one turn, in its own process: time the checkout given
        print(json.dumps(turn(opts.other)))
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    trees = {"other": opts.other.resolve(), "this": HERE}
    runs = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        out = subprocess.run([sys.executable, __file__, str(trees[side]), "--turn"],
                             stdout=subprocess.PIPE, text=True, check=True).stdout
        runs[side].append(json.loads(out.strip().splitlines()[-1]))
    for case in runs["this"][0]:
        means = {side: sum(r[case] for r in rs) / len(rs) for side, rs in runs.items()}
        print(f"{case}: this {means['this']:.4f} ms "
              f"({' / '.join(f'{r[case]:.4f}' for r in runs['this'])}), other "
              f"{means['other']:.4f} ms ({' / '.join(f'{r[case]:.4f}' for r in runs['other'])})")


if __name__ == "__main__":
    main()
