"""Bulk translation traffic: ``search.search`` with beam search over a test set
of source sentences, one request a set, cycled through the window.

Set-up makes the sources from the seed and serves each request once. The
window sends the requests back to back; each returns its best hypotheses
and their scores, which the program reads back itself. After the window,
with the program freed, the reference scores a sample of the served
hypotheses, the longest source among them: its encoder and its decoder over
the hypothesis's tokens give their logits. Two numbers are compared:
``score_gap``, the widest gap between the program's score and the
reference's (the log-probabilities summed and divided by the GNMT length
penalty), and ``topk_gap``, the widest gap by which a served token's logit
lies below the beam-th best token the reference allows at its position: a
beam keeps a candidate only among the beam best of its own prefix, so a
top-k or sort that keeps a worse one shows there."""
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from harness import flops, program, traffic as T
from harness.cell import Cell, Outcome
from harness.trace import traced
from harness.weights import make_weights
from reference import model as ref


def request_work(config: Dict, lengths: np.ndarray, hyps: np.ndarray, steps: int,
                 beam: int) -> Dict:
    """Sentences, model FLOPs (encoder; ``beam`` rows decoding as many steps
    as the best hypothesis has tokens, eos included) and the least seconds of
    the cached vectors decode attention must read: each source's cross cache
    once a step for its beams, and at least one self vector a step and slot
    (the beams' shared history; more where they diverged)."""
    m, v = config["model"], config["vocab_size"]
    dec = m["decoder"]
    heads, dh = dec["num_heads"], dec["hidden_size"] // dec["num_heads"]
    total = {"units": 1, "sentences": len(lengths), "decode_steps": steps, "flops": 0.0}
    vectors = queries = 0.0
    for s, hyp in zip(lengths.tolist(), hyps):
        n = hyp_length(hyp)
        total["flops"] += flops.encoder_flops(m, s, False) + flops.decode_flops(m, v, n, s, beam)
        vectors += dec["num_layers"] * (n * s + n * (n + 1) / 2.0)
        queries += dec["num_layers"] * 2 * beam * n
    total["decode_attn_s"] = flops.decode_attention_least_s(vectors, queries, heads, dh)
    return total


def hyp_length(hyp: np.ndarray) -> int:
    """Tokens of a served hypothesis up to and with its eos (3), pad (1) after."""
    eos = np.flatnonzero(hyp == 3)
    return int(eos[0] + 1) if len(eos) else int((hyp != 1).sum())


def run(cell: Cell) -> Outcome:
    from joeys2t_torch.data.batch import Batch
    from joeys2t_torch.search import _cast_params_to_compute_dtype, search

    t0 = time.perf_counter()
    dev, cfg, tr = cell.device, cell.config, cell.traffic
    program.build_kernels(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    test = cfg["testing"]
    if test["batch_type"] != "sentence":
        raise ValueError("the translation traffic sends requests of whole sentences")
    model, spec, vocab, shapes = program.build(cfg, cell.seed, dev)
    decode_model = _cast_params_to_compute_dtype(model)
    reqs = T.text_requests(tr, test["batch_size"])
    requests = []
    for i in T.order(len(reqs), cell.seed):
        src = T.source_ids(reqs[i], cell.seed, i, cfg["vocab_size"], dev)
        batch = Batch(src.cpu().numpy(), reqs[i], None, None, None, None,
                      np.arange(len(reqs[i])), spec.pad_index, spec.eos_index,
                      is_train=False, task="MT")
        requests.append({"index": i, "batch": batch, "src": src, "lengths": reqs[i]})
    stats = {"decode_steps": 0}

    def serve(req):
        before = stats["decode_steps"]
        out, scores, _ = search(model, spec, req["batch"], test["max_output_length"],
                                test["beam_size"], test["beam_alpha"], n_best=1, device=dev,
                                decode_model=decode_model, stats=stats, return_prob="hyp")
        return out, scores[:, 0], stats["decode_steps"] - before

    for req in requests:  # every shape once
        serve(req)
    if dev == "cuda":
        torch.cuda.synchronize()
    outcome = Outcome(setup_s=time.perf_counter() - t0)

    served = []
    if cell.trace:
        store = {}
        with traced(store):
            for k in range(tr["trace_units"]):
                req = requests[k % len(requests)]
                served.append((req, *serve(req)))
        outcome.trace = store["trace"]
        with traced(store, host=True):  # one more, to name the host's work in the gaps
            serve(requests[0])
        outcome.host_trace = store["trace"]
    else:
        t_start, k = time.perf_counter(), 0
        # at least one pass over the requests, so the longest is served
        while k < len(requests) or time.perf_counter() - t_start < cell.seconds:
            req = requests[k % len(requests)]
            served.append((req, *serve(req)))
            k += 1
        outcome.window_s = time.perf_counter() - t_start
    if dev == "cuda":
        outcome.memory_peak_bytes = torch.cuda.max_memory_allocated()

    total = {}
    for req, out, scores, steps in served:
        for key, x in request_work(cfg, req["lengths"], out, steps, test["beam_size"]).items():
            total[key] = total.get(key, 0.0) + x
        outcome.attempted += len(req["lengths"])
        outcome.failed += int((~np.isfinite(scores)).sum() + (scores == -1.0).sum())
    if cell.trace:
        outcome.trace_work = total
    else:
        outcome.work = total

    sample = pick_sample(served, tr["check_sample"], cell.seed)
    del model, decode_model, served, requests, req
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    numbers = hypothesis_gaps(cfg, shapes, cell.seed, dev, sample, test, "f32")
    outcome.checks = {k: {"value": x, "limit": cell.limits[k]} for k, x in numbers.items()}
    if cell.control:
        outcome.controls = hypothesis_gaps(cfg, shapes, cell.seed, dev, sample, test,
                                           cell.control)
    return outcome


def pick_sample(served, size: int, seed: int) -> List[Dict]:
    """The longest source served and ``size`` - 1 others drawn from the seed,
    with the served hypothesis and score of each."""
    first = {}
    for req, out, scores, _ in served:
        first.setdefault(req["index"], (req, out, scores))
    pool = [(i, row) for i, (r, _, _) in first.items() for row in range(len(r["lengths"]))]
    longest = max(pool, key=lambda ir: first[ir[0]][0]["lengths"][ir[1]])
    rest = [x for x in pool if x != longest]
    rng = np.random.default_rng(T.stream(seed, 50))
    picks = [longest] + [rest[j] for j in rng.choice(len(rest), size - 1, replace=False)]
    out = []
    for i, row in picks:
        req, hyps, scores = first[i]
        n = int(req["lengths"][row])
        out.append({"src": req["src"][row:row + 1, :n].clone(), "n": n,
                    "tokens": hyps[row][:hyp_length(hyps[row])].tolist(),
                    "score": float(scores[row])})
    return out


def hypothesis_gaps(cfg: Dict, shapes: Dict, seed: int, device, sample: List[Dict],
                    test: Dict, precision: str) -> Dict[str, float]:
    """``score_gap``: the widest gap between the served score of a hypothesis
    and the reference's score of its tokens; ``topk_gap``: the widest gap by
    which a served token's reference logit lies below the beam-th best
    allowed one (bos and pad never, eos not first). For the control, the
    reference in ``precision`` stands in for the program: its score of the
    same tokens, and at each position the token it puts beam-th."""
    ref.no_tf32()
    p = make_weights(shapes, seed, device)
    k, alpha = test["beam_size"], test["beam_alpha"]
    score_gap = topk_gap = 0.0
    with torch.no_grad():
        for s in sample:
            tokens = torch.tensor(s["tokens"], device=device)
            n = torch.tensor([s["n"]], device=device)
            logits = ref.hypothesis_logits("f32", p, cfg["model"], s["src"], n, tokens)
            want = ref.gnmt_score(logits, tokens, alpha)
            kth, _ = ref.allowed_kth(logits, k, banned=(2, 1))
            if precision == "f32":
                got, chosen = s["score"], tokens
            else:
                low = ref.hypothesis_logits(precision, p, cfg["model"], s["src"], n, tokens)
                got = ref.gnmt_score(low, tokens, alpha)
                _, chosen = ref.allowed_kth(low, k, banned=(2, 1))
            score_gap = max(score_gap, abs(got - want))
            below = kth - logits.gather(1, chosen[:, None])[:, 0]
            topk_gap = max(topk_gap, float(below.max()))
    return {"score_gap": score_gap, "topk_gap": topk_gap}
