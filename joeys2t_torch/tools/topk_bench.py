# coding: utf-8
"""Time beam search's selection kernel (``ops/topk.stable_topk``,
``csrc/beam_topk.cu``) on one CUDA card beside its bytes bound, its plain
version (the stable sort the port ran before the kernel) and two PyTorch
calls as yardsticks the port does not call (``torch.sort`` without
``stable``, ``torch.topk``), at the beam search shapes:

    python3 -m joeys2t_torch.tools.topk_bench [--out build/topk_bench.json]

Shapes (rows, n, k): a beam-5 step over a 32,000-id table for 3,004
sentences (the translation benchmark's request) and for 36 (the published
test batch of 1,024 tokens: fewer rows than SMs), the 960h recipe's beam 20 over
10,000 ids for 256 utterances, and the finished store's 2k-wide merge for
3,004 sentences. Each shape is first held bit for bit to the plain version,
then every method is timed with CUDA events over back-to-back calls on
rotating copies of the input (over 200 MB in all, so no call finds its rows
in the 50 MB L2; the store's rows, 120 KB, stay warm), enqueued behind a
spin of the card so that the host's time a call is not counted, the median
of 5 repeats. The bound is the bytes read
(rows x n) and written (rows x k values and int64 indices) over 3.35 TB/s.
Prints the card's name and power limit, the kernel's threads a block and its
ptxas report (registers, spills), and one JSON line. Imports nothing of JAX.
"""
import argparse
import json
import statistics
import subprocess
from pathlib import Path

import torch

from joeys2t_torch.ops import cuda_build
from joeys2t_torch.ops import topk as tk

HBM_BYTES_PER_S = 3.35e12
SHAPES = [("translate_step", 3004, 5 * 32000, 5), ("published_batch", 36, 5 * 32000, 5),
          ("ls960h_beam20", 256, 20 * 10000, 20), ("store", 3004, 10, 5)]
ROTATE_BYTES = 200e6
REPEATS = 5
CALLS = 20
# ~50 ms of the card's clock: longer than the host takes to enqueue a repeat
SPIN_CYCLES = 100_000_000


def beam_step_scores(rows: int, n: int, k: int, seed: int) -> torch.Tensor:
    """A beam step's float32 scores on the card: k beams' log-probabilities
    over n / k ids plus each beam's score, three ids banned at -1e9."""
    gen = torch.Generator("cuda").manual_seed(seed)
    vocab = n // k
    lp = torch.log_softmax(torch.randn(rows * k, vocab, generator=gen, device="cuda") * 3, -1)
    lp[:, :3] = -1e9
    beam = -(torch.rand(rows, k, generator=gen, device="cuda") * 4).cumsum(-1)
    return (lp.reshape(rows, k, vocab) + beam[..., None]).reshape(rows, n)


def time_ms(fn, inputs) -> float:
    """Median over ``REPEATS`` of the device ms a call: each repeat enqueues
    at least ``CALLS`` calls, over the input copies in turn, behind a spin of
    the card, so the card runs them back to back whatever the host's time a
    call."""
    fn(inputs[0])
    torch.cuda.synchronize()
    calls = [inputs[i % len(inputs)] for i in range(max(CALLS, len(inputs)))]
    times = []
    for _ in range(REPEATS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for x in calls:
            fn(x)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return statistics.median(times)


def ptxas_report() -> list:
    log = cuda_build.build_all(("beam_topk",))["beam_topk"].with_suffix(".log")
    return [line.strip() for line in log.read_text().splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="build/topk_bench.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("topk_bench needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    for line in ptxas_report():
        print("ptxas:", line)
    methods = {
        "kernel": lambda x, k: tk.stable_topk(x, k),
        "plain": lambda x, k: tk.stable_topk_plain(x, k),
        "torch_sort": lambda x, k: torch.sort(x, dim=-1, descending=True)[0][:, :k],
        "torch_topk": lambda x, k: torch.topk(x, k, dim=-1),
    }
    results = []
    for name, rows, n, k in SHAPES:
        x = beam_step_scores(rows, n, k, seed=rows + n)
        got, want = tk.stable_topk(x, k), tk.stable_topk_plain(x, k)
        bits = bool(torch.equal(got[0].view(torch.int32), want[0].contiguous().view(torch.int32))
                    and torch.equal(got[1], want[1]))
        copies = max(1, int(ROTATE_BYTES // (x.numel() * 4)))
        inputs = [x] + [x.clone() for _ in range(min(copies, 64) - 1)]
        bound_ms = (rows * n * 4 + rows * k * (4 + 8)) / HBM_BYTES_PER_S * 1e3
        row = dict(shape=name, rows=rows, n=n, k=k, bits_equal=bits, copies=len(inputs),
                   threads=tk.topk_plan(n, x.dtype),
                   bound_ms=round(bound_ms, 5))
        for method, fn in methods.items():
            row[f"{method}_ms"] = round(time_ms(lambda t, fn=fn: fn(t, k), inputs), 5)
        row["share_of_bound"] = round(bound_ms / row["kernel_ms"], 4)
        print(json.dumps(row))
        results.append(row)
        del inputs, x, got, want
        torch.cuda.empty_cache()
    summary = dict(card=smi.strip(), torch=torch.__version__, shapes=results,
                   ok=all(r["bits_equal"] for r in results))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    if not summary["ok"]:
        raise SystemExit("the kernel's output differs from the plain version's")


if __name__ == "__main__":
    main()
