# coding: utf-8
"""Time the flash-attention forward (or, with ``--backward``, the
backward) of this checkout against another checkout's (for example the
parent commit, unpacked under ``build/``) on one CUDA card, at the speech
and MT shapes of the 4-head (D=128) and 8-head (D=64) 512-wide models, and
the wrapper's host time per call.

    python3 -m joeys2t_torch.tools.flash_ab OTHER_CHECKOUT [--pairs 1] [--backward]

With ``--backward`` each turn runs chip_smoke.py's ``flash_bwd_case`` at
``BWD_SHAPES`` instead (the backward held to its plain version with two
calls bit-identical, then its time, its three kernels' times from the
profiler, the plain version's and SDPA's backward, the bound, and a digest
of the dq, dk and dv bits), and the summary applies the keep-or-revert rule
of PERF.md per head dim: the wgmma backward stays only if no shape
of that head dim is more than 2 % slower than the other checkout's and both
B=64 250x250 shapes are faster.

Each turn is a fresh process that imports one checkout's ``joeys2t_torch``
and runs chip_smoke.py's phase-2 case (``flash_case``: the kernel held to
its plain version, two calls bit-identical; then the kernel, the plain
version and SDPA timed back to back on warm L2, and the bound) at every
shape, on the same seeded inputs in every turn, and prints the route, the
wgmma tile (query rows x heads) and a digest of the out and lse bits of
each shape; the summary says whether the two checkouts' bits are equal.
At head dim 64 on the wgmma route, a turn also times each other tile the
kernel has (``wgmma_tile`` replaced for that call) on the same inputs, whose
bits must equal those of the tile the rule picks. Turns run other, this,
this, other for each pair, so a drift of the host or the card falls on both
sides alike. The host time is the wall of
500 back-to-back calls at B=1 Sq=Sk=16 over their count, beside the device
time of the same call: where the host time is the larger, the launch loop
is the wrapper's. Each turn first times its process's first two calls (head
dims 128 and 64, tiny shapes), which load the kernel libraries. Prints the
card's name and power limit, every turn's numbers, and each side's median
kernel time, host time and first-call time. Imports nothing of JAX.
"""
import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# (B, Sq, Sk, heads, head dim): the 10 s batch, a full batch of 30 s
# utterances, the 45 s request's two chunks, the MT self and cross shapes;
# at head dim 64 also the speech decoder's cross-attention (47 target
# positions over 250 frames) and the two sides of the tile rule's threshold
# (Sq 64 and 65) over 250 frames
SHAPES = [(b, sq, sk, h, d) for h, d in ((4, 128), (8, 64))
          for b, sq, sk in ((64, 250, 250), (64, 750, 750), (2, 750, 750), (192, 61, 61),
                            (192, 81, 61))]
SHAPES += [(64, sq, 250, 8, 64) for sq in (47, 64, 65)]
HOST_CALLS = 500
# (B, Sq, Sk, heads, head dim, dropout) of the backward: at head dim 128 the
# 10 s batch with and without dropout, the speech decoder's cross-attention,
# a full batch of 30 s utterances, the 45 s request's chunks (K4's shape),
# the MT self and cross shapes; at head dim 64 the phase-21 speech shapes
# (chip_smoke.BWD_D64) and MT self-attention
BWD_SHAPES = [(64, 250, 250, 4, 128, 0.1), (64, 250, 250, 4, 128, 0.0),
              (64, 47, 250, 4, 128, 0.1), (64, 750, 750, 4, 128, 0.1),
              (2, 750, 750, 4, 128, 0.1), (192, 61, 61, 4, 128, 0.1),
              (192, 81, 61, 4, 128, 0.1), (64, 250, 250, 8, 64, 0.1),
              (64, 250, 250, 8, 64, 0.0), (64, 47, 250, 8, 64, 0.1), (192, 61, 61, 8, 64, 0.1)]
RULE_SLACK = 1.02  # a shape may be at most 2 % slower than the other checkout


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def backward_worker(smoke) -> None:
    """One backward turn: a JSON line a shape of ``BWD_SHAPES``."""
    import torch

    for i, (b, sq, sk, h, d, rate) in enumerate(BWD_SHAPES):
        c = smoke.flash_bwd_case(b, sq, sk, torch.bfloat16, rate,
                                 torch.Generator().manual_seed(i), d=d, h=h, scaled=b == 192,
                                 digest=True)
        print(json.dumps(dict(shape=[b, sq, sk, h, d, rate], route=c["route"],
                              digest=c["digest"], ms=c["ms"], split_ms=c["split_ms"],
                              library_ms=c["library_ms"], plain_ms=c["plain_ms"],
                              bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                              max_abs_err=c["max_abs_err"], tol=c["tol"])), flush=True)


def backward_summary(rows: dict) -> None:
    """Each backward shape's medians side by side, then the rule per head
    dim."""
    verdict = {}
    for shape in rows["this"]:
        b, sq, sk, h, d, rate = shape
        this, other = rows["this"][shape], rows["other"][shape]
        med = {side: statistics.median(r["ms"] for r in rs)
               for side, rs in (("this", this), ("other", other))}
        split = {side: {k: statistics.median(r["split_ms"][k] for r in rs)
                        for k in rs[0]["split_ms"]}
                 for side, rs in (("this", this), ("other", other))}
        ratio = med["this"] / med["other"]
        parts = {side: ", ".join(f"{k} {v:.4f}" for k, v in split[side].items())
                 for side in split}
        bound = this[0]["bound_ms"]
        sdpa = statistics.median(r["library_ms"] for r in this + other)  # every turn's
        print(f"B={b} Sq={sq} Sk={sk} H={h} D={d} dropout {rate}: this ({this[0]['route']}) "
              f"{med['this']:.4f} ms ({parts['this']}), other ({other[0]['route']}) "
              f"{med['other']:.4f} ms ({parts['other']}), this / other {ratio:.3f}; SDPA "
              f"backward {sdpa:.4f} ms; bound {bound:.4f} ms "
              f"({this[0]['bound_by']}), share this {100 * bound / med['this']:.1f} %, other "
              f"{100 * bound / med['other']:.1f} %; max abs err this "
              f"{max(r['max_abs_err'] for r in this):.3g} (tol {this[0]['tol']:.3g}); "
              f"digests this {sorted({r['digest'] for r in this})}, other "
              f"{sorted({r['digest'] for r in other})}")
        v = verdict.setdefault(d, {"slower": [], "headline": []})
        if ratio > RULE_SLACK:
            v["slower"].append(f"{b}x{sq}x{sk} dropout {rate} ({ratio:.3f})")
        if (b, sq, sk) == (64, 250, 250):
            v["headline"].append(ratio < 1.0)
    for d, v in sorted(verdict.items()):
        keep = not v["slower"] and len(v["headline"]) == 2 and all(v["headline"])
        print(f"rule, head dim {d}: {'keep' if keep else 'REVERT'} this checkout's backward "
              f"(shapes over {RULE_SLACK:.2f}x the other: {v['slower'] or 'none'}; both B=64 "
              f"250x250 faster: {len(v['headline']) == 2 and all(v['headline'])})")


def worker(tree: Path, backward: bool = False) -> None:
    """One turn in ``tree``'s joeys2t_torch: a JSON line a shape."""
    sys.path.insert(0, str(tree))
    import torch
    from joeys2t_torch.ops import flash_attention as fa

    smoke = _chip_smoke()
    if backward:
        return backward_worker(smoke)
    gen = torch.Generator().manual_seed(0)
    q = torch.zeros(1, 16, 512, dtype=torch.bfloat16, device="cuda")  # the context exists
    bias = torch.zeros(1, 16, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # the first call loads the libraries and their kernels
    for h in (4, 8):
        fa.flash_attention_fwd(q, q, q, bias, 0.1, h)
    torch.cuda.synchronize()
    print(json.dumps(dict(first_calls_ms=(time.perf_counter() - t0) * 1e3)), flush=True)
    for i, (b, sq, sk, h, d) in enumerate(SHAPES):
        c = smoke.flash_case(b, sq, sk, torch.bfloat16, torch.Generator().manual_seed(i),
                             d=d, h=h, scaled=b == 192, digest=True)
        chosen = getattr(fa, "wgmma_tile", None)
        others = [t for t in getattr(fa, "_wgmma_tiles", lambda _d: [])(d)
                  if c["route"] == "wgmma" and d == 64 and t != tuple(c["tile"])]
        for tile in others:  # the same inputs on another tile of the kernel
            fa.wgmma_tile = lambda *_a, tile=tile: tile
            try:
                f = smoke.flash_case(b, sq, sk, torch.bfloat16,
                                     torch.Generator().manual_seed(i), d=d, h=h,
                                     scaled=b == 192, digest=True)
            finally:
                fa.wgmma_tile = chosen
            print(json.dumps(dict(shape=[b, sq, sk, h, d], forced_tile=f["tile"],
                                  digest=f["digest"], ms=f["ms"])), flush=True)
        q = torch.randn(1, 16, h * d, generator=gen).to(torch.bfloat16).cuda()
        bias = torch.zeros(1, 16, device="cuda")

        def call():
            fa.flash_attention_fwd(q, q, q, bias, d ** -0.5, h)

        for _ in range(20):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            call()
        torch.cuda.synchronize()
        host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        print(json.dumps(dict(shape=[b, sq, sk, h, d], route=c["route"], tile=c["tile"],
                              digest=c["digest"], ms=c["ms"],
                              library_ms=c["library_ms"], bound_ms=c["bound_ms"],
                              bound_by=c["bound_by"], max_abs_err=c["max_abs_err"],
                              tol=c["tol"], host_us=host_us,
                              tiny_device_us=smoke.time_ms(call) * 1e3)), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="?", help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=1, help="other/this/this/other rounds")
    ap.add_argument("--backward", action="store_true", help="time the backward instead")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker.resolve(), args.backward)
    if args.other is None:
        ap.error("the other checkout's root is needed")
    trees = {"other": args.other.resolve(), "this": REPO}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for tree in trees.values():
        subprocess.run([sys.executable, "-c", "from joeys2t_torch.ops import cuda_build; "
                        "cuda_build.build_all()"], cwd=tree, env=env, check=True, timeout=900)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    rows = {side: {} for side in trees}
    first = {side: [] for side in trees}
    forced = {side: {} for side in trees}
    for turn in ["other", "this", "this", "other"] * args.pairs:
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                              str(trees[turn])] + ["--backward"] * args.backward,
                             cwd=trees[turn], env=env, capture_output=True, text=True,
                             timeout=900)
        if run.returncode != 0:
            sys.exit(f"{turn} turn failed:\n{run.stdout}\n{run.stderr}")
        for line in run.stdout.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                print(turn, line)
                if "first_calls_ms" in r:
                    first[turn].append(r["first_calls_ms"])
                elif "forced_tile" in r:
                    forced[turn].setdefault(tuple(r["shape"]), []).append(r)
                else:
                    rows[turn].setdefault(tuple(r["shape"]), []).append(r)
    if args.backward:
        return backward_summary(rows)
    print(f"first calls in a fresh process (D=128 and D=64, the libraries loaded): this "
          f"{statistics.median(first['this']):.1f} ms, other "
          f"{statistics.median(first['other']):.1f} ms")
    for shape in rows["this"]:
        b, sq, sk, h, d = shape
        this, other = rows["this"][shape], rows["other"][shape]
        med = {side: statistics.median(r["ms"] for r in rs)
               for side, rs in (("this", this), ("other", other))}
        host = {side: statistics.median(r["host_us"] for r in rs)
                for side, rs in (("this", this), ("other", other))}
        digests = {side: {r["digest"] for r in rs} for side, rs in (("this", this),
                                                                     ("other", other))}
        bits = ("equal" if digests["this"] == digests["other"] and len(digests["this"]) == 1
                else f"this {sorted(digests['this'])}, other {sorted(digests['other'])}")

        def kernel(r):
            tile = f", tile {r['tile'][0]}x{r['tile'][1]}" if r.get("tile") else ""
            return f"{r['route']}{tile}"

        print(f"B={b} Sq={sq} Sk={sk} H={h} D={d}: this ({kernel(this[0])}) {med['this']:.4f} "
              f"ms, other ({kernel(other[0])}) {med['other']:.4f} ms, this / other "
              f"{med['this'] / med['other']:.3f}; SDPA {this[0]['library_ms']:.4f} ms; bound "
              f"{this[0]['bound_ms']:.4f} ms ({this[0]['bound_by']}), share this "
              f"{100 * this[0]['bound_ms'] / med['this']:.1f} %, other "
              f"{100 * this[0]['bound_ms'] / med['other']:.1f} %; host a call this "
              f"{host['this']:.1f} us, other {host['other']:.1f} us; out and lse bits "
              f"{bits}")
        if shape in forced["this"]:
            alt = forced["this"][shape]
            alt_ms = statistics.median(r["ms"] for r in alt)
            same = {r["digest"] for r in alt} == digests["this"]
            print(f"  this on the other tile {alt[0]['forced_tile'][0]}x"
                  f"{alt[0]['forced_tile'][1]}: {alt_ms:.4f} ms, chosen tile / other tile "
                  f"{med['this'] / alt_ms:.3f}, other tile / other checkout "
                  f"{alt_ms / med['other']:.3f}; bits "
                  f"{'equal to the chosen tile' if same else 'DIFFER from the chosen tile'}")


if __name__ == "__main__":
    main()
