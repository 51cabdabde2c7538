"""Training traffic: ``TrainManager``'s update on a pool of batches made in
set-up, cycled through the window.

Set-up builds one trainer, takes its first ``check_updates`` updates on the
pool's first batches through the window's own call, keeps the losses, the
first update's gradient norms from the optimizer's state and the change of
the weights after them, then runs the rest of the pool once so that every
shape is warm. The window cycles the pool; the host waits for the device
only at the window's ends. After it, with the program freed, the reference
takes the same updates from the same weights and batches."""
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from harness import flops, program, traffic as T
from harness.cell import Cell, Outcome
from harness.trace import traced
from harness.weights import make_weights
from reference import compare, model as ref


def batch_work(config: Dict, shape) -> Dict[str, float]:
    """Audio seconds, model FLOPs (forward and backward, 3x the forward) and
    the flash kernels' least seconds of one micro-batch."""
    m, v = config["model"], config["vocab_size"]
    enc, dec = m["encoder"], m["decoder"]
    fps = 100.0
    outs = [flops.speech_frames_out(m, f) for f, _ in shape]
    fwd = sum(flops.encoder_flops(m, f, True) + flops.ctc_head_flops(m, v, o)
              + flops.decoder_flops(m, v, n, o) for (f, n), o in zip(shape, outs))
    dh_e, dh_d = enc["hidden_size"] // enc["num_heads"], dec["hidden_size"] // dec["num_heads"]
    self_pairs = [(o, o) for o in outs]
    cross_pairs = [(n, o) for (_, n), o in zip(shape, outs)]
    work = {"units": 1, "audio_s": sum(f for f, _ in shape) / fps, "flops": 3.0 * fwd}
    for key, back in (("flash_fwd_s", False), ("flash_bwd_s", True)):
        work[key] = (enc["num_layers"] * flops.flash_least_s(self_pairs, enc["num_heads"], dh_e, back)
                     + dec["num_layers"] * flops.flash_least_s(cross_pairs, dec["num_heads"], dh_d,
                                                               back))
    return work


def add(total: Dict, work: Dict) -> None:
    for k, x in work.items():
        total[k] = total.get(k, 0.0) + x


def reference_batch(raw: Dict) -> Dict[str, torch.Tensor]:
    """The teacher-forcing shift of a raw batch: input bos + ids (eos made
    pad), targets ids + eos, their count."""
    row = raw["trg"]
    return {"src": raw["src"], "src_length": raw["src_length"],
            "trg_input": torch.where(row == 3, 1, row)[:, :-1], "trg": row[:, 1:],
            "trg_length": raw["trg_length"] - 1}


def token_batch_size(train: Dict) -> int:
    """Padded frames a micro-batch holds: the configuration's token batch,
    which the window takes as one update (no accumulation)."""
    if train.get("batch_type") != "token" or train.get("batch_multiplier", 1) != 1:
        raise ValueError("the training traffic takes a token batch and one micro-batch an update")
    return int(train["batch_size"])


def normalizer(train: Dict, raw: Dict) -> float:
    norm = train.get("normalization", "batch")
    if norm == "batch":
        n = float(raw["src"].shape[0])
    elif norm == "tokens":
        n = float((raw["trg_length"] - 1).sum())
    else:
        n = 1.0
    return n * train.get("batch_multiplier", 1)


def leaf_norms(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack(torch._foreach_norm(tensors))


def run(cell: Cell) -> Outcome:
    from joeys2t_torch.config import parse_train_args
    from joeys2t_torch.data.batch import Batch
    from joeys2t_torch.losses import build_loss_function
    from joeys2t_torch.training import TrainManager

    t0 = time.perf_counter()
    dev, cfg, tr = cell.device, cell.config, cell.traffic
    program.build_kernels(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model, spec, vocab, shapes = program.build(cfg, cell.seed, dev)
    args = parse_train_args(cfg["training"])
    tm = TrainManager(model, spec, build_loss_function(args, spec), args,
                      seed=cell.seed % (2**62), device=dev)
    shapes_pool = T.token_batches(tr, token_batch_size(cfg["training"]))
    order = T.order(len(shapes_pool), cell.seed)
    num_freq = cfg["model"]["encoder"]["in_channels"]
    prepared, works = [], []
    for i in order:
        raw = T.speech_train_batch(shapes_pool[i], cell.seed, i, cfg["vocab_size"], num_freq, dev)
        batch = Batch(raw["src"].cpu().numpy(), raw["src_length"].cpu().numpy(), None,
                      raw["trg"].cpu().numpy(), raw["trg_length"].cpu().numpy(), None,
                      np.arange(len(shapes_pool[i])), spec.pad_index, spec.eos_index,
                      task="S2T")
        prepared.append(tm._prepare_batch(batch))
        works.append(batch_work(cfg, shapes_pool[i]))
    del raw, batch

    # the checked updates: the window's own call on the pool's first batches
    n_check = tr["check_updates"]
    b1 = cfg["training"]["adam_betas"][0]
    losses, grad_norms = [], None
    for k in range(n_check):
        losses.append(tm._train_prepared(prepared[k])["loss"])
        if k == 0:
            # the first moment after one update is (1 - b1) times the gradient
            # the optimizer took (zero where it holds none)
            moments = [tm.optimizer.state[p].get("exp_avg", torch.zeros_like(p)).float()
                       for p in tm.params]
            grad_norms = leaf_norms(moments) / (1.0 - b1)
            del moments
    start = make_weights(shapes, cell.seed, dev)
    names = [n for n, _ in tm.net.named_parameters()]
    change_norms = leaf_norms([p.detach() - start[n] for n, p in tm.net.named_parameters()])
    del start
    for k in range(n_check, len(prepared)):  # every other shape once
        tm._train_prepared(prepared[k])
    if dev == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    unit_losses, total, i = [], {}, 0
    outcome = Outcome(setup_s=setup_s)
    if cell.trace:
        store = {}
        with traced(store):
            for i in range(tr["trace_units"]):
                unit_losses.append(tm._train_prepared(prepared[i % len(prepared)])["loss"])
                add(total, works[i % len(prepared)])
        outcome.trace, outcome.trace_work = store["trace"], total
        with traced(store, host=True):  # one more, to name the host's work in the gaps
            tm._train_prepared(prepared[0])
        outcome.host_trace = store["trace"]
    else:
        if dev == "cuda":
            torch.cuda.synchronize()
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < cell.seconds:
            unit_losses.append(tm._train_prepared(prepared[i % len(prepared)])["loss"])
            add(total, works[i % len(prepared)])
            i += 1
        if dev == "cuda":
            torch.cuda.synchronize()
        outcome.window_s, outcome.work = time.perf_counter() - t_start, total
    outcome.attempted = len(unit_losses)
    if unit_losses:
        outcome.failed = int((~torch.isfinite(torch.stack(unit_losses))).sum())
    if dev == "cuda":
        outcome.memory_peak_bytes = torch.cuda.max_memory_allocated()

    prog_losses = [float(x) for x in losses]
    prog_grad = dict(zip(names, grad_norms.tolist()))
    prog_change = dict(zip(names, change_norms.tolist()))
    del tm, model, prepared, unit_losses, losses
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    want = reference_updates(cfg, tr, cell.seed, shapes, shapes_pool, order, dev, "f32")
    numbers = compare.train_numbers(prog_losses, want[0], prog_grad, want[1], prog_change,
                                    want[2])
    outcome.checks = {k: {"value": x, "limit": cell.limits[k]} for k, x in numbers.items()}
    if cell.control:
        low = reference_updates(cfg, tr, cell.seed, shapes, shapes_pool, order, dev,
                                cell.control)
        outcome.controls = compare.train_numbers(low[0], want[0], low[1], want[1], low[2],
                                                 want[2])
    return outcome


def reference_updates(cfg, tr, seed, shapes, shapes_pool, order, dev, precision):
    """The reference's losses, first clipped gradient norms and change norms
    over the checked updates."""
    ref.no_tf32()
    p = make_weights(shapes, seed, dev)
    batches, norms = [], []
    num_freq = cfg["model"]["encoder"]["in_channels"]
    for i in order[:tr["check_updates"]]:
        raw = T.speech_train_batch(shapes_pool[i], seed, i, cfg["vocab_size"], num_freq, dev)
        batches.append(reference_batch(raw))
        norms.append(normalizer(cfg["training"], raw))
    losses, grads, start = ref.train_steps(p, cfg, batches, norms, precision,
                                           tr.get("reference_rows", 16))
    grad = {n: float(g.norm()) for n, g in grads.items()}
    change = {n: float((p[n] - start[n]).norm()) for n in p}
    return losses, grad, change

