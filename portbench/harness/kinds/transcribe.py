"""Bulk transcription traffic: ``Transcriber.transcribe_batch`` on a test set
of waveforms resident on the device, sent as requests of sorted lengths and
cycled through the window.

Set-up serves each request once (every shape warm). The window sends the
requests back to back; each returns its transcripts, which the program
reads back from the device itself; the ids it detokenized are kept as it
hands them to its vocabulary. After the window, with the program freed,
the reference recomputes a sample of the served utterances, the longest
among them, from their waveforms: filterbank and CMVN, the encoder, and the
decoder over the served ids; the number compared is the widest gap by which
a served token's logit lies below the reference's best."""
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from harness import flops, program, traffic as T
from harness.cell import Cell, Outcome
from harness.host import Watch
from harness.trace import traced
from harness.weights import make_weights
from reference import model as ref


class ServedIds:
    """The transcriber's vocabulary, which keeps the id rows (B, L) that the
    program hands it to detokenize: the ids as search produced them."""

    def __init__(self, vocab):
        self.vocab = vocab
        self.rows = None

    def __getattr__(self, name):
        return getattr(self.vocab, name)

    def arrays_to_sentences(self, arrays, *args, **kwargs):
        self.rows = arrays
        return self.vocab.arrays_to_sentences(arrays, *args, **kwargs)


def row_ids(row, steps: int, eos: int = 3) -> List[int]:
    """A served row's ids up to and with its first eos, or its ``steps``
    ids where it has none."""
    row = np.asarray(row).ravel()
    hits = np.flatnonzero(row == eos)
    return [int(x) for x in (row[:hits[0] + 1] if hits.size else row[:steps])]


def request_inputs(tr: Dict, size: int, seed: int, device) -> List[Dict]:
    """The requests in the run's order: waveforms (B, N) on the device,
    their valid samples, durations."""
    reqs = T.speech_requests(tr, size)
    out = []
    for i in T.order(len(reqs), seed):
        n = torch.as_tensor(np.rint(reqs[i] * tr["sample_rate"]).astype(np.int64), device=device)
        out.append({"index": i, "wave": T.speechlike(n, T.stream(seed, 100 + i), device),
                    "n": n, "seconds": reqs[i]})
    return out


def request_work(config: Dict, req: Dict, ids: List[List[int]], steps: int) -> Dict:
    """Audio seconds, model FLOPs (front-end filterbank product, encoder,
    decode steps each row needs: its ids, eos included) and the
    cached key and value vectors decode attention must read."""
    m, v = config["model"], config["vocab_size"]
    dec = m["decoder"]
    heads, dh = dec["num_heads"], dec["hidden_size"] // dec["num_heads"]
    total = {"units": 1, "audio_s": float(req["seconds"].sum()), "decode_steps": steps,
             "flops": 0.0, "decode_attn_s": 0.0}
    vectors = queries = 0.0
    for n, toks in zip(req["n"].tolist(), ids):
        frames = max(1 + (n - 400) // 160, 0)
        src = flops.speech_frames_out(m, frames)
        rows = len(toks)
        total["flops"] += (2.0 * frames * 257 * m["encoder"]["in_channels"]
                           + flops.encoder_flops(m, frames, True)
                           + flops.decode_flops(m, v, rows, src))
        vectors += dec["num_layers"] * (rows * (rows + 1) / 2.0 + rows * src)
        queries += dec["num_layers"] * 2 * rows
    total["decode_attn_s"] = flops.decode_attention_least_s(vectors, queries, heads, dh)
    return total


def run(cell: Cell) -> Outcome:
    from joeys2t_torch.serving import Transcriber

    t0 = time.perf_counter()
    dev, cfg, tr = cell.device, cell.config, cell.traffic
    program.build_kernels(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    test = cfg["testing"]
    if test["beam_size"] != 1 or test["batch_type"] != "sentence":
        raise ValueError("the transcription traffic serves greedy requests of whole utterances")
    model, spec, vocab, shapes = program.build(cfg, cell.seed, dev)
    served_vocab = ServedIds(vocab)
    asr = Transcriber(model, spec, served_vocab, device=dev)
    requests = request_inputs(tr, test["batch_size"], cell.seed, dev)
    limit = test["max_output_length"]

    def serve(req):
        before = asr.stats["decode_steps"]
        asr.transcribe_batch(req["wave"], req["n"], max_output_length=limit)
        return served_vocab.rows, asr.stats["decode_steps"] - before

    for req in requests:  # every shape once
        serve(req)
    if dev == "cuda":
        torch.cuda.synchronize()
    outcome = Outcome(setup_s=time.perf_counter() - t0)

    served = []  # (request, served id rows, steps)
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
        watch = Watch()
        # at least one pass over the requests, so the longest is served
        while k < len(requests) or time.perf_counter() - t_start < cell.seconds:
            req = requests[k % len(requests)]
            served.append((req, *serve(req)))
            watch.lap(f"request {req['index']} ({len(req['seconds'])} utterances)")
            k += 1
        outcome.window_s = time.perf_counter() - t_start
        outcome.notes.append(watch.report())
    if dev == "cuda":
        outcome.memory_peak_bytes = torch.cuda.max_memory_allocated()

    # each row's ids up to and with its eos, worked out once the window has closed
    served = [(req, [row_ids(r, steps) for r in rows], steps) for req, rows, steps in served]
    total = {}
    for req, ids, steps in served:
        for key, x in request_work(cfg, req, ids, steps).items():
            total[key] = total.get(key, 0.0) + x
        outcome.attempted += len(req["seconds"])
        outcome.failed += sum(len(t) > limit for t in ids)
    if cell.trace:
        outcome.trace_work = total
    else:
        outcome.work = total

    sample = pick_sample(served, tr["check_sample"], cell.seed)
    del asr, model, served, requests, req
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    gap = token_gaps(cfg, shapes, cell.seed, dev, sample, "f32")
    outcome.checks = {"token_gap": {"value": gap, "limit": cell.limits["token_gap"]}}
    if cell.control:
        outcome.controls = {"token_gap": token_gaps(cfg, shapes, cell.seed, dev, sample,
                                                    cell.control)}
    return outcome


def pick_sample(served, size: int, seed: int) -> List[Dict]:
    """The longest utterance served and ``size`` - 1 others drawn from the
    seed, each with its waveform row, the request's padded length and its
    served ids."""
    first = {}
    for req, ids, steps in served:
        first.setdefault(req["index"], (req, ids, steps))
    pool = [(r["index"], row) for r, _, _ in first.values() for row in range(len(r["seconds"]))]
    longest = max(pool, key=lambda ir: first[ir[0]][0]["seconds"][ir[1]])
    rest = [x for x in pool if x != longest]
    rng = np.random.default_rng(T.stream(seed, 40))
    picks = [longest] + [rest[j] for j in rng.choice(len(rest), size - 1, replace=False)]
    out = []
    for i, row in picks:
        req, ids, _ = first[i]
        out.append({"wave": req["wave"][row:row + 1].clone(), "n": req["n"][row:row + 1].clone(),
                    "ids": ids[row]})
    return out


def token_gaps(cfg: Dict, shapes: Dict, seed: int, device, sample: List[Dict],
               precision: str) -> float:
    """The widest gap, over the sample's served tokens, between the
    reference's best logit and the logit of the token that was served
    (``precision="f32"``) or that the reference in ``precision`` puts first
    at the same position (the control)."""
    ref.no_tf32()
    p = make_weights(shapes, seed, device)
    widest = 0.0
    with torch.no_grad():
        for s in sample:
            feats, frames = ref.speech_features(s["wave"], s["n"],
                                                cfg["model"]["encoder"]["in_channels"])
            tokens = torch.tensor(s["ids"], device=device)
            logits = ref.hypothesis_logits("f32", p, cfg["model"], feats, frames, tokens)
            best, _ = ref.allowed_kth(logits, 1, banned=(2,))
            if precision != "f32":
                low = ref.hypothesis_logits(precision, p, cfg["model"], feats, frames, tokens)
                _, tokens = ref.allowed_kth(low, 1, banned=(2,))
            chosen = logits.gather(1, tokens[:, None])[:, 0]
            widest = max(widest, float((best - chosen).max()))
    return widest
