#!/usr/bin/env python3
# coding: utf-8
"""Smoke run of the PyTorch port (joeys2t_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
goes wrong:

1. build: compile every CUDA kernel of the port from joeys2t_torch/csrc
   (one nvcc per source, all started together), timed; print each kernel's
   registers and spills (ptxas) and HMMA instructions (cuobjdump -sass), and
   the route (mma.sync tensor cores for bf16, SIMT for f32) and shared
   memory of the flash kernels at every head size;
2. kernels: hold each kernel against its plain PyTorch version on the card
   at the shapes of the serving path, and time the kernel, the plain
   version and one PyTorch library call computing the same function (CUDA
   events after a device spin that outlasts the host's enqueueing), with the
   roofline share and achieved TFLOP/s. Decode attention runs at the decode
   loop's cross and self shapes in every dtype and int8 mode, with its
   split-S plan printed and two calls bit-identical; kernel and SDPA are
   timed on rotating input copies (> 100 MB, so L2 is cold) against a
   bound that counts only the K/V rows the valid keys need; and decode
   attention with 5 query rows a cache row at the beam request's cross
   shape (32 cache rows, 160 queries, S=250, bf16 and f32), bit-identical to
   one query a row on the cache repeated 5 times, timed beside that call and
   SDPA on the repeated cache, against two bounds (the shared cache read
   once; once for each query);
3. serving: build the librispeech_100h model (configs/librispeech_100h.yaml,
   16 encoder / 8 decoder layers, hidden 512) with random weights from a
   seed and a synthetic 5000-token vocabulary, in bf16, and serve three
   requests through ``Transcriber``: 64 utterances of 10 s, one of 30 s, and
   a 45 s recording through ``transcribe_long``; the kernels' launch
   counters, zeroed just before, must show that every attention of the
   path went through them; then where the time of the 64 x 10 s request
   goes (front end, encoder, decode loop) and the card's busy share in a
   profiled decode loop, with the decode kernel's device time and launches;
   then one beam request at bench.py's beam shape (32 x 10 s, beam 5, length
   penalty 1, 96 steps at most) with the counters zeroed and the plain
   versions refused: 16 flash launches and 16 decode launches a step (8 of
   them with 5 queries a cache row), its audio-s/s, ms a step, and busy
   share and launches a step over a profiled 16-step slice of the beam loop;
4. card vs CPU: a small float32 model with the same seeded weights on the
   card and on the CPU must give the same encoder output (within 1e-4), the
   same greedy tokens and the same beam-5 2-best hypotheses (scores within
   1e-4); and key-masked attention at a head size or dtype
   the flash kernel does not take must raise on the card;
5. training: the librispeech_100h model (``model:`` and ``training:`` of the
   config: bf16 compute on float32 masters, dropout 0.1, label smoothing 0.1,
   CTC weight 0.3, AdamW, warmup-inverse-sqrt, clipping at 10,
   ``batch_multiplier`` 4) takes 2 updates of 4 micro-batches of 64
   synthetic 6-10 s utterances with 48-token targets through
   ``TrainManager``; the loss must be finite, every weight must move and stay
   float32, the learning rate must follow the scheduler, and each
   micro-batch must launch the flash forward and backward exactly 24 times
   each (16 encoder self-attentions, 8 decoder cross-attentions) with the
   plain attention versions disabled; then the time per micro-batch and
   update, trained audio-s/s, a forward / backward / optimizer breakdown,
   peak memory, and the card's busy share and top kernels over 4 profiled
   micro-batches;
6. training, card vs CPU: one float32 update of a small model at dropout 0
   on the card and on the CPU must agree (loss to 1e-5 relative, gradients
   to 1e-4 of their global norm, weights to 2 * lr);
7. CLI: the synthetic corpus (scripts/generate_synthetic_asr.py, 512 / 64 /
   64 utterances, into build/chip_smoke) and configs/synthetic_asr.yaml at
   full width in bf16, cut to 16 updates (2 epochs of 8 batches of 64) and a
   validation every 8 (greedy, as always), with the config's beam 5 in
   ``test`` and ``translate``, go through
   ``joeys2t_torch.__main__.main`` in this process: ``train``, ``test -o``
   and ``translate`` of 8 paths, each with the launch counters zeroed just
   before and the plain attention versions disabled. The model directory,
   finite losses, float32 weights, 2 WERs in validations.txt and the exact
   launch counts the path implies must hold, ``python -m joeys2t_torch test``
   (8 dev utterances) must exit 0, and a float32 ``test`` of the trained checkpoint cut to 2 + 2
   layers must give the same hypotheses on the card and on the CPU; then the
   CLI's time per update, the host data pipeline's time a batch and share
   of the training wall, trained audio-s/s beside phase 5's, and the
   validation and test walls. During the three bf16 runs the inputs of the
   first and of a later call of each kind to each kernel wrapper are kept
   (``kernel_inputs``), and each kernel is then held against its plain
   version on exactly those inputs: the CLI's own shapes (short utterances:
   about 100-130 encoder and 50-65 target positions, across the flash
   kernels' 64-wide tiles; B=8 in ``translate``; decode attention also
   with 5 queries a cache row), the flash kernels with and without dropout;
8. speech translation: configs/synthetic_st.yaml at full width in bf16 (12
   encoder / 6 decoder layers) on scripts/generate_synthetic_st.py's corpus
   (512 / 64 / 64), cut to 16 updates and a validation every 8, its encoder
   loaded from phase 7's best checkpoint through ``load_encoder`` (12 of
   the 16 layers load, 4 are ignored), through ``train``, ``test -o`` and
   ``translate``: BLEU in validations.txt, ``best.ckpt`` at the highest
   BLEU, beam 5 in ``test`` and ``translate``, and exact launch counts with
   the plain versions refused;
9. int8 serving: phase 3's librispeech_100h model with ``cache_cross_int8``
   and ``cache_self_int8`` serves greedy 64 x 10 s and beam 5 over 32 x 10 s
   with exact launch counts, every decode launch int8 (channel scales on the
   cross caches, position scales on the self ring buffers), the kernel held
   against its plain version on the path's own inputs, audio-s/s and K5's
   device ms a step beside phase 3's, the share of words equal to the bf16
   requests'; then a small float32 int8 model gives the same tokens and
   beams on the card and the CPU;
10. SentencePiece targets: phase 7's config and corpus with ``level: bpe,
    tokenizer_type: sentencepiece`` on a unigram model written by
    ``joeys2t_torch.tools.spm_fixture`` through ``train`` (4 updates),
    ``test -o`` and ``translate``, then ``load_model_dir`` and
    ``Transcriber.from_hub``: detokenized text, the model file in the model
    directory, exact launch counts, each kernel against its plain version;
11. Conformer: configs/synthetic_asr_conformer.yaml (read by the port's own
    YAML reader) at full width through ``train`` (8 updates), ``test -o``
    and ``translate``, exact launch counts, each kernel against its plain
    version on the path's inputs, a float32 cut ``test`` identical on card
    and CPU, ms an update beside phase 7's;
12. MT: configs/synthetic_mt.yaml at full width in bf16 (8 + 8 layers,
    hidden 512, tied softmax) on scripts/generate_synthetic_mt.py's corpus
    (4096 / 64 / 64 pairs) through ``train`` (16 updates of 192 sentences, a
    validation every 8), ``test -o`` and ``translate`` (beam 5), then
    ``load_model_dir`` -> ``generate`` equal to ``translate``, and forced
    prompts: a config copy with a sep token and two language tags, prompt
    files beside the corpus, 4 updates, ``score`` (beam 5) and ``generate``
    (greedy) with the repetition penalty and n-gram blocking; exact launch
    counts with the plain versions refused, each kernel against its plain
    version on the path's inputs, a float32 cut ``test`` identical on card
    and CPU; ms an update, the host pipeline's share, test sentences/s;
13. head dim 16: configs/transformer_reverse.yaml as configured (float32, 4
    heads of 16, tied embeddings and softmax) on test/data/reverse/ (dev cut
    to 100 sentences), cut to 32 updates and one validation, then ``test``
    and ``translate``: every attention on the D=16 kernels, exact launch
    counts, each kernel against its plain version on the path's inputs.

14. recurrent MT: configs/rnn_reverse.yaml as configured (bidirectional
    LSTM of 64, Luong attention, input feeding, zero initial state, greedy;
    ``fp16: True``, which a recurrent model ignores, float32 as in JAX) but
    on the card, on test/data/reverse/ (dev cut to 100 pairs), cut to 200
    updates of 10 sentences and one validation, then ``test -o`` (dev and
    test) and ``translate`` of 8 sentences and ``load_model_dir`` ->
    ``generate`` equal to ``translate``; then rnn_small.yaml's model and
    training sections (bidirectional GRU of 30, Bahdanau, bridge, beam 5 in
    ``test``) on the same data (its own corpus, test/data/toy/, is not in
    the repository); no attention kernel of the port runs on this path
    (every counter 0); the card's and the CPU's float32 ``test`` of the
    trained rnn_reverse model on 8 dev sentences identical, the card's in a
    fresh interpreter (cuDNN's RNN with TF32 off without the flags set
    here); ms an update, test sentences/s, kernels and busy share a
    decode step of a profiled ``generate``;
15. mixture of experts: configs/synthetic_mt.yaml at full width with
    ``num_experts: 4`` in the encoder (switch top-1, dense dispatch) on
    phase 12's corpus through ``train`` (8 updates of 192 sentences, one
    validation), ``test -o`` and ``translate`` (beam 5), exact launch counts
    with the plain versions refused, each kernel against its plain version
    on the path's inputs, ``generate`` equal to ``translate``, the logged
    load-balance term finite, a float32 ``test`` cut to 2 + 2 layers
    identical on card and CPU; ms an update beside phase 12's dense model,
    and the device time an update and its largest kernels over a profiled
    2-update ``train``.

Phases 9-15 run after phase 8, each with the counters zeroed just before
its runs and the plain versions refused. Phase 2 also holds decode attention
with int8 channel scales and ``group`` 5 bit for bit against group 1, and
times int8 cases against SDPA on the dequantized cache.

Phase 2 also holds the kernels at the MT shapes (flash forward and
backward at B=192, Sq=Sk 1, 7, 33, 61 and cross 81 x 61, bf16 and f32,
dropout 0 and 0.1, zero-length rows included; decode attention over the
61-row cross cache with 1 and 5 queries a row and the 81-slot self ring
buffer) and at head dim 16 (flash at B=12 S=26 and B=192 S=61, decode at
B=12 over 26 and 31 rows, every dtype and int8 mode), timed beside SDPA.

Phase 2 also holds the flash backward against its plain version at the
training path's shapes (B=64 Sq=Sk=250; B=64 Sq=47 Sk=250; B=2 Sq=Sk=750),
in f32 and bf16, at dropout 0 and 0.1, with the forward's dropped output
against the plain one, two backward calls bit-identical, and the dropout
mask read out of both kernels bit for bit in bf16 and f32, and times SDPA's
backward beside it.

Output: diagnostics, then one JSON line of kernel measurements, then the
card's name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``. Needs one CUDA card; imports nothing of
JAX or of joeys2t_tpu.
"""
import collections
import contextlib
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs. The card
    first spins for 20 ms, long enough for the host to enqueue every run, so
    the runs follow each other without gaps even where one run's host work
    (Python, the launch) takes longer than its kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(20e-3 * 2.0e9))  # ~20 ms at the H100's ~2 GHz clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: int, n_ops: int, dtype: torch.dtype):
    """Least time (ms) for this work on an H100 SXM, and what bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def speechlike(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Loudness-modulated noise in int16 scale with short pauses."""
    envelope = np.repeat(np.exp(rng.uniform(3, 9, size=n // 800 + 1)), 800)[:n]
    envelope[rng.rand(n // 800 + 1).repeat(800)[:n] < 0.15] = 1.0
    return (envelope * rng.randn(n)).astype(np.float32)


def sync_time(fn):
    """(fn's result, its wall time in s on the host clock, ending in a device
    sync)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profiled(fn):
    """(wall s, {kernel name: (launches, device us)}) of ``fn`` under the
    profiler: device work only, an annotated range (Optimizer.step) is no
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(fn)
    kernels = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation:
            n, t = kernels.get(ev.name, (0, 0.0))
            kernels[ev.name] = (n + 1, t + ev.time_range.elapsed_us())
    return wall, kernels


def counters():
    """{name: (object, attribute)} of the kernel wrappers' launch counters;
    ``decode_attention_group`` counts the decode launches whose query rows
    share a cache row (beam search's cross attention), and
    ``decode_attention_int8_{channel,position}`` those on int8 caches with
    channel scales (cross) or position scales (self)."""
    from joeys2t_torch.ops import decode_attention as da
    from joeys2t_torch.ops import flash_attention as fa

    return {"flash_attention_fwd": (fa.flash_attention_fwd, "launches"),
            "flash_attention_bwd": (fa.flash_attention_bwd, "launches"),
            "decode_attention": (da.decode_attention, "launches"),
            "decode_attention_group": (da.decode_attention, "group_launches"),
            "decode_attention_int8_channel": (da.decode_attention, "channel_launches"),
            "decode_attention_int8_position": (da.decode_attention, "position_launches")}


def zero_counters() -> None:
    for obj, attr in counters().values():
        setattr(obj, attr, 0)


def read_counters() -> dict:
    return {name: getattr(obj, attr) for name, (obj, attr) in counters().items()}


@contextlib.contextmanager
def plain_refused(path: str):
    """While active, the plain attention versions raise: ``path`` must take
    the kernels."""
    from joeys2t_torch.ops import decode_attention as da
    from joeys2t_torch.ops import flash_attention as fa

    plain = (fa.flash_attention_plain, fa.flash_attention_bwd_plain,
             da.decode_attention_plain)

    def refuse(*_a, **_k):
        raise AssertionError(f"a plain attention version ran on the card's {path}")

    fa.flash_attention_plain = fa.flash_attention_bwd_plain = da.decode_attention_plain = \
        refuse
    try:
        yield
    finally:
        fa.flash_attention_plain, fa.flash_attention_bwd_plain, \
            da.decode_attention_plain = plain


# ------------------------------------------------------------------ phase 1
def kernel_name(mangled: str) -> str:
    """``flash_fwd_mma_kernel<128, 64, 1>`` from a mangled kernel name (the
    mangled name itself where no demangler is installed)."""
    for tool in ("cu++filt", "c++filt"):
        path = shutil.which(tool) or shutil.which(tool, path="/usr/local/cuda/bin")
        if path:
            out = subprocess.run([path, mangled], capture_output=True, text=True).stdout
            out = re.sub(r"\((int|bool)\)", "", out)  # cu++filt's casts of template values
            m = re.search(r"(\w+<[^()]*>)\(", out)
            return m.group(1) if m else out.strip()
    return mangled


def ptxas_report(log: str) -> dict:
    """{mangled kernel: (registers, spill store bytes, spill load bytes)} from
    the ``-Xptxas -v`` report that the build keeps beside each library."""
    report, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
            report[fn] = [0, 0, 0]
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            report[fn][1:] = [int(m.group(1)), int(m.group(2))]
        elif fn and (m := re.search(r"Used (\d+) registers", ln)):
            report[fn][0] = int(m.group(1))
    return report


def hmma_counts(lib: Path):
    """{mangled kernel: HMMA instructions} in the library's SASS, or None
    without cuobjdump."""
    tool = shutil.which("cuobjdump") or shutil.which("cuobjdump", path="/usr/local/cuda/bin")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and "HMMA" in ln:
            counts[fn] += 1
    return counts


def build_phase():
    from joeys2t_torch.ops import cuda_build
    from joeys2t_torch.ops import flash_attention as fa

    t0 = time.time()
    paths = cuda_build.build_all()
    print(f"[build] {len(paths)} kernels built in {time.time() - t0:.1f} s")
    for name, path in paths.items():
        log = path.with_suffix(".log")
        report = ptxas_report(log.read_text() if log.is_file() else "")
        hmma = hmma_counts(path)
        names = {fn: kernel_name(fn) for fn in report}
        print(f"[build] {name}: {path.name}, {len(report)} kernels")
        for fn, (regs, st, ld) in sorted(report.items(), key=lambda kv: names[kv[0]]):
            count = "HMMA not measured (no cuobjdump)" if hmma is None else \
                f"{hmma.get(fn, 0)} HMMA"
            print(f"[build]   {names[fn]}: {regs} registers, spill {st}/{ld} bytes "
                  f"(stores/loads), {count}")
    for d in (16, 64, 128, 192, 256):
        for dtype in (torch.bfloat16, torch.float32):
            info = fa.kernel_info(d, dtype)
            print(f"[build] flash D={d} {str(dtype)[6:]}: route {info['route']}; dynamic "
                  f"shared memory forward {info['smem_fwd']} B, dK/dV {info['smem_dkdv']} B, "
                  f"dQ {info['smem_dq']} B")
            check(info["route"] == ("mma.sync" if dtype == torch.bfloat16 else "simt"),
                  f"flash D={d} {dtype} takes route {info['route']}")


# ------------------------------------------------------------------ phase 2
def out_tol(ref, f32: bool, scaled: bool) -> float:
    """The forward's tolerance: 1e-4 (f32) or 2e-2 (bf16) absolute, and for
    the token-length cases (``scaled``) in units of the largest reference
    value where that exceeds 1: with few keys an output is no average (at
    Sk = 1 the kept value times 1 / (1 - rate)), and bf16 rounds it to its
    own ulp."""
    tol = 1e-4 if f32 else 2e-2
    return tol * max(1.0, ref.float().abs().max().item()) if scaled else tol


def flash_case(b, sq, sk, dtype, gen, d=128, timed=True, scaled=False):
    """The forward kernel against its plain version (output and lse; two
    calls bit-identical), and when ``timed`` the kernel, the plain version
    and SDPA on the same inputs. Key lengths are drawn from Sk/2..Sk; row 0
    of a batch of more than 2 has every key masked."""
    from joeys2t_torch.ops import flash_attention as fa

    h = 4
    e = h * d
    q = torch.randn(b, sq, e, generator=gen).to(dtype).cuda()
    k, v = (torch.randn(b, sk, e, generator=gen).to(dtype).cuda() for _ in range(2))
    lengths = torch.randint(sk // 2, sk + 1, (b,), generator=gen)
    valid = torch.arange(sk)[None, :] < lengths[:, None]
    if b > 2:
        valid[0] = False  # a row with every key masked
    bias = torch.where(valid, 0.0, -1e9).float().cuda()
    sm = d ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, bias, sm, h)
    again = fa.flash_attention_fwd(q, k, v, bias, sm, h)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, bias, sm, h)
    torch.cuda.synchronize()
    name = (f"B={b} Sq=Sk={sq}" if sq == sk else f"B={b} Sq={sq} Sk={sk}") + \
        f" H={h} D={d} {str(dtype)[6:]} ({fa.kernel_info(d, dtype)['route']})"
    err = max((out.float() - ref.float()).abs().max().item(),
              (lse - ref_lse).abs().max().item())
    tol = out_tol(ref, dtype == torch.float32, scaled)
    check(bool(torch.isfinite(out.float()).all()), f"flash {name}: non-finite output")
    check(err <= tol, f"flash {name}: max abs err {err} > {tol}")
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          f"flash {name}: two calls differ")
    case = dict(case=name, route=fa.kernel_info(d, dtype)["route"], max_abs_err=err, tol=tol)
    if not timed:
        return case
    qh = q.view(b, sq, h, d).transpose(1, 2).contiguous()
    kh, vh = (t.view(b, sk, h, d).transpose(1, 2).contiguous() for t in (k, v))
    mask = bias.to(dtype)[:, None, None, :]
    ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, bias, sm, h))
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, bias, sm, h), iters=5)
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=sm))
    flops = 4 * b * sq * sk * e
    bound_ms, bound_by = bound(nbytes(q, k, v, bias, out, lse), flops, dtype)
    case.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, roofline=bound_ms / ms, tflops=flops / ms / 1e9)
    return case


def sdpa_backend(qh, kh, vh, mask, sm, rate):
    """The first SDPA backend that takes an additive mask and a backward
    here (flash does not take a mask): (name, context manager factory)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                q = qh.detach().requires_grad_()
                out = torch.nn.functional.scaled_dot_product_attention(
                    q, kh, vh, attn_mask=mask, scale=sm, dropout_p=rate)
                out.sum().backward()
            torch.cuda.synchronize()
            return backend.name, lambda b=backend: sdpa_kernel([b])
        except RuntimeError:
            continue
    fail("no SDPA backend runs forward and backward with an additive mask")


def flash_bwd_case(b, sq, sk, dtype, rate, gen, d=128, timed=True, scaled=False):
    """The backward kernels against the plain backward; with dropout also the
    forward kernel against the plain forward (the same keep bits); timed
    (kernel, plain, SDPA's backward) when ``timed``."""
    from joeys2t_torch.ops import flash_attention as fa

    h = 4
    e = h * d
    q = torch.randn(b, sq, e, generator=gen).to(dtype).cuda()
    k, v = (torch.randn(b, sk, e, generator=gen).to(dtype).cuda() for _ in range(2))
    d_out = torch.randn(b, sq, e, generator=gen).to(dtype).cuda()
    lengths = torch.randint(sk // 2, sk + 1, (b,), generator=gen)
    lengths[0] = sk
    bias = torch.where(torch.arange(sk)[None, :] < lengths[:, None], 0.0, -1e9).float().cuda()
    seed = torch.tensor([1234 + b + sq], dtype=torch.int32, device="cuda")
    sm = d ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, bias, sm, h, rate, seed)
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, bias, sm, h, rate, seed)
    grads = fa.flash_attention_bwd(q, k, v, bias, out, lse, d_out, sm, h, rate, seed)
    again = fa.flash_attention_bwd(q, k, v, bias, out, lse, d_out, sm, h, rate, seed)
    refs = fa.flash_attention_bwd_plain(q, k, v, bias, out, lse, d_out, sm, h, rate, seed)
    torch.cuda.synchronize()
    check(all(torch.equal(g, g2) for g, g2 in zip(grads, again)),
          f"flash bwd {dtype} rate {rate} {b}x{sq}x{sk}: two calls differ")
    del again
    # f32: summation order only; bf16: rounding of each output and, on the
    # tensor cores, of P_drop and dS before their products
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    fwd_tol = out_tol(ref_out, dtype == torch.float32, scaled)
    fwd_err = (out.float() - ref_out.float()).abs().max().item()
    check(fwd_err <= fwd_tol, f"flash fwd dropout {rate} {dtype} {b}x{sq}x{sk}: "
          f"err {fwd_err} > {fwd_tol}")
    errs, tols = [], []
    # at Sk = 1 (one key: ds = 0, so dQ = dK = 0 but for rounding) each
    # gradient is held to the largest of the three
    floor = max(r.float().abs().max().item() for r in refs) if sk == 1 else 0.0
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        check(bool(torch.isfinite(g.float()).all()), f"flash bwd {name}: non-finite")
        errs.append((g.float() - r.float()).abs().max().item())
        tols.append(rel * max(floor, r.float().abs().max().item()))
        check(errs[-1] <= tols[-1], f"flash bwd {name} {dtype} rate {rate} {b}x{sq}x{sk} "
              f"D={d}: max abs err {errs[-1]} > {tols[-1]} ({rel} of the largest value)")
    route = fa.kernel_info(d, dtype)["route"]
    case = dict(case=f"B={b} Sq={sq} Sk={sk} H={h} D={d} {str(dtype)[6:]} dropout {rate} "
                     f"({route})", route=route, max_abs_err=max(errs), tol=min(tols),
                fwd_err=fwd_err)
    if not timed:
        return case
    ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, bias, out, lse, d_out, sm, h,
                                                rate, seed))
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, bias, out, lse, d_out, sm, h, rate, seed), iters=5)
    fwd_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, bias, sm, h, rate, seed))
    qh, kh, vh, doh = (t.view(t.shape[0], t.shape[1], h, d).transpose(1, 2).contiguous()
                       .requires_grad_() for t in (q, k, v, d_out))
    mask = bias.to(dtype)[:, None, None, :]
    backend, ctx = sdpa_backend(qh, kh, vh, mask, sm, rate)
    with ctx():
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, attn_mask=mask, scale=sm, dropout_p=rate)
        sdpa_out = sdpa()
        library_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qh, kh, vh), doh,
                                                         retain_graph=True))
        sdpa_fb_ms = time_ms(lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh))
    del sdpa_out
    n_bytes = nbytes(q, k, v, bias, out, lse, d_out, *grads)
    flops = 10 * b * sq * sk * e
    bound_ms, bound_by = bound(n_bytes, flops, dtype)
    case.update(ms=ms, plain_ms=plain_ms, fwd_ms=fwd_ms, library_ms=library_ms,
                library=f"SDPA backward ({backend})", sdpa_fwd_bwd_ms=sdpa_fb_ms,
                bound_ms=bound_ms, bound_by=bound_by, roofline=bound_ms / ms,
                tflops=flops / ms / 1e9)
    return case


def mask_bits_case(dtype):
    """The kernels' keep mask read out bit for bit: with V the identity in
    each head band the forward's output is the dropped probability matrix,
    and with dO the identity the backward's dV is its transpose."""
    from joeys2t_torch.ops import flash_attention as fa

    b, h, d = 8, 4, 128
    gen = torch.Generator().manual_seed(5)
    q, k = (torch.randn(b, d, h * d, generator=gen).to(dtype).cuda() for _ in range(2))
    eye = (torch.eye(d, device="cuda").repeat(1, h)[None].expand(b, d, h * d).to(dtype)
           .contiguous())
    bias = torch.zeros(b, d, device="cuda")
    seed = torch.tensor([2024], dtype=torch.int32, device="cuda")
    keep = fa.attention_keep(seed, b, h, d, d, 0.1, "cuda")
    out, lse = fa.flash_attention_fwd(q, k, eye, bias, 1.0 / d, h, 0.1, seed)
    _, _, dv = fa.flash_attention_bwd(q, k, eye, bias, out, lse, eye, 1.0 / d, h, 0.1, seed)
    fwd_keep = out.reshape(b, d, h, d).permute(0, 2, 1, 3) != 0
    bwd_keep = dv.reshape(b, d, h, d).permute(0, 2, 3, 1) != 0
    check(torch.equal(fwd_keep, keep), f"{dtype} forward kernel's dropout mask differs")
    check(torch.equal(bwd_keep, keep), f"{dtype} backward kernel's dropout mask differs")
    return keep.numel(), keep.float().mean().item()


def time_cold_ms(calls, iters: int = 50) -> float:
    """``time_ms`` over a list of calls that each read their own copy of the
    inputs, taken in turn, so that every call finds its inputs out of the
    50 MB L2 cache, as the decode loop does (the copies total > 100 MB)."""
    turn = iter(range(10 ** 9))
    return time_ms(lambda: calls[next(turn) % len(calls)](), iters=iters)


def cold_copies(tensors, total_bytes: float = 2.2 * 50e6, most: int = 600):
    """Copies of ``tensors`` (None stays None) that together exceed
    ``total_bytes``: at least 2, so no call reads what the previous one left
    in L2."""
    n = min(most, max(2, -(-int(total_bytes) // nbytes(*tensors))))
    return [[None if t is None else t.clone() for t in tensors] for _ in range(n)]


# the decode loop's shapes (H=4, D=128): the 64 x 10 s request's cross
# attention (source tails 125-250 frames; the headline, first), the 30 s
# request (B=1 S=750), the 45 s request's two chunks (500 and 625 of 750
# frames), and the 97-slot self-attention ring buffer at steps 0, 48, 95
DECODE_SHAPES = [("cross", 64, 250, "tails"), ("cross", 1, 750, None),
                 ("cross", 2, 750, (500, 625)), ("self", 64, 97, 0), ("self", 64, 97, 48),
                 ("self", 64, 97, 95), ("self", 1, 97, 48)]
DECODE_MODES = ("bf16", "f32", "int8-channel", "int8-position")


def decode_inputs(kind, b, s, valid_spec, mode, gen, d=128):
    from joeys2t_torch.ops import decode_attention as da

    h = 4
    qdt = torch.float32 if mode == "f32" else torch.bfloat16
    q = torch.randn(b, h, d, generator=gen).to(qdt).cuda()
    kf, vf = (torch.randn(b, h, s, d, generator=gen).cuda() for _ in range(2))
    pos = torch.arange(s)[None, :]
    if kind == "self":  # ring buffer at step t: slots beyond it masked
        valid = (pos <= valid_spec).expand(b, s)
    elif valid_spec == "tails":
        valid = pos < torch.randint(s // 2, s + 1, (b,), generator=gen).clamp(min=1)[:, None]
    else:
        valid = pos < torch.tensor(valid_spec or [s] * b)[:, None]
    bias = torch.where(valid, 0.0, -1e9).float().cuda().contiguous()
    ks = vs = layout = None
    if mode == "int8-channel":
        layout = "channel"
        ks, vs = (t.abs().amax(2) / 127.0 + 1e-8 for t in (kf, vf))
        k, v = (torch.clamp(torch.round(t / sc[:, :, None]), -127, 127).to(torch.int8)
                for t, sc in ((kf, ks), (vf, vs)))
    elif mode == "int8-position":
        layout = "position"
        (k, ks), (v, vs) = da.quantize_per_position(kf), da.quantize_per_position(vf)
    else:
        k, v = kf.to(qdt), vf.to(qdt)
    return (q, k, v, bias, ks, vs), dict(sm_scale=d ** -0.5, scale_layout=layout), valid


def sdpa_inputs(args, layout):
    """SDPA's arguments for one decode call ``(q, k, v, bias, k_scale,
    v_scale)``: int8 caches dequantized to q's dtype beforehand (SDPA takes no
    int8), so SDPA's time is that of one pass over a bf16 cache."""
    q, k, v, bias, ks, vs = args
    if layout == "channel":
        k, v = (t.float() * sc[:, :, None, :] for t, sc in ((k, ks), (v, vs)))
    elif layout == "position":
        k, v = (t.float() * sc[..., None] for t, sc in ((k, ks), (v, vs)))
    return (q[:, :, None, :], k.to(q.dtype), v.to(q.dtype),
            bias.to(q.dtype)[:, None, None, :])


def decode_case(kind, b, s, valid_spec, mode, gen, timed, d=128, cold=True):
    """The kernel against the plain version (and a second call bit for bit);
    when ``timed``, the kernel, SDPA (on the dequantized cache for int8) and
    the plain version, the first two on cold inputs unless not ``cold``
    (inputs of a few KB: hundreds of copies would time the copying, and a
    call that small is launch-bound either way). The bound counts the
    bytes the work needs: the K/V rows (and "position" scales) of a row's
    valid keys, or all S rows where every key is masked, plus q, the whole
    bias, the "channel" scales and the output."""
    from joeys2t_torch.ops import decode_attention as da

    args, kw, valid = decode_inputs(kind, b, s, valid_spec, mode, gen, d)
    q, k, v, bias, ks, vs = args
    h = q.shape[1]
    out = da.decode_attention(*args, **kw)
    again = da.decode_attention(*args, **kw)
    ref = da.decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    name = f"{kind} B={b} H={h} S={s} D={d} {mode}" + (
        f" step {valid_spec}" if kind == "self" else
        f" lengths {list(valid_spec)}" if isinstance(valid_spec, tuple) else
        " tails S/2..S" if valid_spec == "tails" else "")
    err = (out.float() - ref.float()).abs().max().item()
    tol = 1e-5 if q.dtype == torch.float32 else 1e-2
    check(bool(torch.isfinite(out.float()).all()), f"decode {name}: non-finite output")
    check(err <= tol, f"decode {name}: max abs err {err} > {tol}")
    check(torch.equal(out, again), f"decode {name}: two calls differ")
    splits, split_rows = da.decode_plan(b, h, s, da.num_sms(q.device))
    case = dict(case=name, max_abs_err=err, tol=tol, splits=splits, split_rows=split_rows)
    if not timed:
        return case
    needed = torch.where(valid.any(1), valid.sum(1), s).sum().item() * h  # rows over (b, h)
    n_bytes = (needed * d * k.element_size() * 2 + nbytes(q, bias, out)
               + (nbytes(ks, vs) if kw["scale_layout"] == "channel" else 0)
               + (needed * 8 if kw["scale_layout"] == "position" else 0))
    flops = 4 * needed * d
    bound_ms, bound_by = bound(n_bytes, flops, k.dtype)
    copies = cold_copies(args) if cold else [args]
    ms = time_cold_ms([lambda c=c: da.decode_attention(*c, **kw) for c in copies])
    sdpa = [sdpa_inputs(c, kw["scale_layout"]) for c in copies]
    library_ms = time_cold_ms([lambda c=c: torch.nn.functional.scaled_dot_product_attention(
        c[0], c[1], c[2], attn_mask=c[3], scale=kw["sm_scale"]) for c in sdpa])
    del sdpa, copies
    if not cold:
        case["case"] += " (warm L2)"
    case.update(ms=ms, plain_ms=time_ms(lambda: da.decode_attention_plain(*args, **kw), iters=5),
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                roofline=bound_ms / ms, tflops=flops / ms / 1e9, needed_rows=needed,
                rows=b * h * s)
    return case


# the beam request's cross attention (bench.py's beam shape): 32 utterances of
# 10 s (source tails 125-250 frames), 5 beams each asking the shared cache
BEAM_CROSS = (32, 5, 250)


def decode_group_case(mode, gen, shape=BEAM_CROSS):
    """Decode attention with ``group`` 5 at the beam cross shape against the
    plain version, bit for bit against group 1 on the cache, bias and
    scales repeated 5 times, and two calls bit-identical; the kernel, the
    expanded group-1 call and SDPA on the expanded (for int8: also
    dequantized) cache timed on cold L2. Two bounds: one pass over the
    shared cache (each input read once, the bound proper) and one pass for
    each of the G queries of a row."""
    from joeys2t_torch.ops import decode_attention as da

    b, g, s = shape
    args, kw, valid = decode_inputs("cross", b, s, "tails", mode, gen)
    _, k, v, bias, ks, vs = args
    h, d = k.shape[1], k.shape[3]
    q = torch.randn(b * g, h, d, generator=gen).to(args[0].dtype).cuda()
    out = da.decode_attention(q, k, v, bias, ks, vs, group=g, **kw)
    again = da.decode_attention(q, k, v, bias, ks, vs, group=g, **kw)
    ref = da.decode_attention_plain(q, k, v, bias, ks, vs, group=g, **kw)

    def expand(t):
        return None if t is None else t.repeat_interleave(g, 0).contiguous()

    flat = da.decode_attention(q, *map(expand, (k, v, bias, ks, vs)), **kw)
    torch.cuda.synchronize()
    name = f"cross group {g} B={b} ({b * g} query rows) H={h} S={s} D={d} {mode} tails S/2..S"
    err = (out.float() - ref.float()).abs().max().item()
    tol = 1e-5 if q.dtype == torch.float32 else 1e-2
    check(bool(torch.isfinite(out.float()).all()), f"decode {name}: non-finite output")
    check(err <= tol, f"decode {name}: max abs err {err} > {tol}")
    check(torch.equal(out, again), f"decode {name}: two calls differ")
    check(torch.equal(out, flat), f"decode {name}: differs from group 1 on the expanded cache")
    splits, split_rows = da.decode_plan(b * g, h, s, da.num_sms(q.device))
    needed = torch.where(valid.any(1), valid.sum(1), s).sum().item() * h  # cache rows
    flops = 4 * needed * g * d
    fixed = nbytes(q, bias, out, ks, vs)
    bound_ms, bound_by = bound(needed * d * k.element_size() * 2 + fixed, flops, k.dtype)
    g_bound_ms, _ = bound(g * needed * d * k.element_size() * 2 + fixed, flops, k.dtype)
    copies = cold_copies((q, k, v, bias, ks, vs))
    ms = time_cold_ms([lambda c=c: da.decode_attention(*c, group=g, **kw) for c in copies])
    del copies
    flat_copies = cold_copies((q, *map(expand, (k, v, bias, ks, vs))))
    flat_ms = time_cold_ms([lambda c=c: da.decode_attention(*c, **kw) for c in flat_copies])
    sdpa = [sdpa_inputs(c, kw["scale_layout"]) for c in flat_copies]
    library_ms = time_cold_ms([lambda c=c: torch.nn.functional.scaled_dot_product_attention(
        c[0], c[1], c[2], attn_mask=c[3], scale=kw["sm_scale"]) for c in sdpa])
    del sdpa, flat_copies
    plain_ms = time_ms(lambda: da.decode_attention_plain(q, k, v, bias, ks, vs, group=g,
                                                         **kw), iters=5)
    return dict(case=name, max_abs_err=err, tol=tol, splits=splits, split_rows=split_rows,
                ms=ms, flat_ms=flat_ms, plain_ms=plain_ms, library_ms=library_ms,
                library="SDPA on the expanded cache", bound_ms=bound_ms,
                bound_by=bound_by, g_bound_ms=g_bound_ms, roofline=bound_ms / ms,
                g_roofline=g_bound_ms / ms, tflops=flops / ms / 1e9)


def print_flash(c):
    line = f"[kernels] {c['case']}: err {c['max_abs_err']:.3g} (tol {c['tol']}), two calls " \
        "bit-identical"
    if "ms" in c:
        line += (f", kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, library "
                 f"{c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
                 f"({c['bound_by']}), roofline share {100 * c['roofline']:.1f} % "
                 f"({c['bound_by']}), {c['tflops']:.1f} TFLOP/s")
    print(line)


def print_flash_bwd(c):
    line = (f"[kernels] flash bwd {c['case']}: err {c['max_abs_err']:.3g} (tol "
            f"{c['tol']:.3g}), fwd err {c['fwd_err']:.3g}; two calls bit-identical")
    if "ms" in c:
        line += (f"; kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, {c['library']} "
                 f"{c['library_ms']:.4f} ms (fwd+bwd {c['sdpa_fwd_bwd_ms']:.4f} ms), bound "
                 f"{c['bound_ms']:.4f} ms ({c['bound_by']}), roofline share "
                 f"{100 * c['roofline']:.1f} % ({c['bound_by']}), {c['tflops']:.1f} "
                 f"TFLOP/s; forward kernel with this dropout {c['fwd_ms']:.4f} ms")
    print(line)


def print_decode(c, b):
    line = (f"[kernels] decode {c['case']}: plan {c['splits']} split(s) of "
            f"{c['split_rows']} rows, a cluster of {c['splits']} block(s) per (b, h), "
            f"grid ({c['splits']}, 4, {b}); err {c['max_abs_err']:.3g} (tol "
            f"{c['tol']}), two calls bit-identical")
    if "ms" in c:
        sdpa = "SDPA on the dequantized cache" if "int8" in c["case"] else "SDPA"
        cache = "warm" if "(warm L2)" in c["case"] else "cold"
        line += (f"; {cache} L2: kernel {c['ms']:.4f} ms, {sdpa} {c['library_ms']:.4f} ms; "
                 f"plain {c['plain_ms']:.4f} ms; bound "
                 f"{c['bound_ms']:.4f} ms ({c['bound_by']}; {c['needed_rows']} of "
                 f"{c['rows']} rows needed), roofline share "
                 f"{100 * c['roofline']:.1f} %")
    print(line)


def print_group(c):
    print(f"[kernels] decode {c['case']}: plan {c['splits']} split(s) of "
          f"{c['split_rows']} rows; err {c['max_abs_err']:.3g} (tol {c['tol']}), two "
          f"calls bit-identical, bit-identical to group 1 on the expanded cache; cold "
          f"L2: kernel {c['ms']:.4f} ms, group 1 on the expanded cache "
          f"{c['flat_ms']:.4f} ms, SDPA on the expanded cache {c['library_ms']:.4f} ms; "
          f"plain {c['plain_ms']:.4f} ms; bound one pass {c['bound_ms']:.4f} ms "
          f"({c['bound_by']}), roofline share {100 * c['roofline']:.1f} %; bound one "
          f"pass a query {c['g_bound_ms']:.4f} ms, share {100 * c['g_roofline']:.1f} %")


# phase 12's MT shapes (configs/synthetic_mt.yaml: H=4, D=128, 192 sentences
# a training batch, sources of <= 60 tokens + eos, targets of <= 80):
# encoder self-attention at token lengths (every key tile partial, wholly
# padded rows where a row's length is 0) and decoder cross-attention; the
# decode loop's cross cache (128 sentences a test batch, 5 beams) and its
# self ring buffer of max_output_length + 1 = 81 slots
MT_FLASH = ((1, 1), (7, 7), (33, 33), (61, 61), (81, 61))
MT_TIMED = ((61, 61), (81, 61))
MT_CROSS = (128, 5, 61)
# phase 13's head dim 16 (configs/transformer_reverse.yaml: 4 heads of 16,
# 12 sentences of <= 25 tokens + eos, a ring buffer of 30 + 1 slots), and a
# 64-wide model at the MT batch shape
D16_FLASH = ((12, 26), (192, 61))
D16_DECODE = (("cross", 12, 26, "tails"), ("self", 12, 31, 15))


def mt_kernel_cases(gen):
    """Phase 2's cases at the MT shapes and at head dim 16: (flash, backward,
    decode, group) lists, printed."""
    dtypes = (torch.bfloat16, torch.float32)
    flash = [flash_case(192, sq, sk, dt, gen, scaled=True,
                        timed=(sq, sk) in MT_TIMED and dt == torch.bfloat16)
             for sq, sk in MT_FLASH for dt in dtypes]
    flash += [flash_case(b, s, s, dt, gen, d=16, scaled=True) for b, s in D16_FLASH
              for dt in dtypes]
    backward = [flash_bwd_case(192, sq, sk, dt, rate, gen, scaled=True,
                               timed=rate > 0 and (sq, sk) in MT_TIMED
                               and dt == torch.bfloat16)
                for sq, sk in MT_FLASH for rate in (0.1, 0.0) for dt in dtypes]
    backward += [flash_bwd_case(b, s, s, dt, rate, gen, d=16, scaled=True, timed=rate > 0)
                 for b, s in D16_FLASH for rate in (0.1, 0.0) for dt in dtypes]
    decode = []
    for mode in DECODE_MODES:
        for kind, b, s, spec, d in (("cross", MT_CROSS[0], MT_CROSS[2], "tails", 128),
                                    ("self", MT_CROSS[0] * MT_CROSS[1], 81, 40, 128),
                                    *((*shape, 16) for shape in D16_DECODE)):
            c = decode_case(kind, b, s, spec, mode, gen,
                            d == 16 or (kind == "cross" and mode != "f32") or mode == "bf16", d,
                            cold=d != 16)
            print_decode(c, b)
            decode.append(c)
    group = [decode_group_case(mode, gen, MT_CROSS) for mode in ("bf16", "f32", "int8-channel")]
    for c in flash:
        print_flash(c)
    for c in backward:
        print_flash_bwd(c)
    for c in group:
        print_group(c)
    return flash, backward, decode, group


def kernel_phase():
    gen = torch.Generator().manual_seed(0)
    # B=64 S=250: the 64 x 10 s request; B=2 S=750: the 45 s request's two
    # 20-25 s chunks; B=64 S=750: a full batch in the range the TPU package
    # sent to its second (B, H, S, D) kernel
    flash = [flash_case(b, s, s, dt, gen) for b, s in ((64, 250), (2, 750), (64, 750))
             for dt in (torch.bfloat16, torch.float32)]
    # every decode shape in every mode is checked; bf16 is timed at each
    # shape and every mode at the headline shape
    decode = []
    for i, (kind, b, s, spec) in enumerate(DECODE_SHAPES):
        for mode in DECODE_MODES:
            # int8 with position scales is also timed at the self shape the
            # int8 serving path gives it (phase 9): the ring buffer half full
            timed = mode == "bf16" or i == 0 or (mode == "int8-position"
                                                 and (kind, b, spec) == ("self", 64, 48))
            c = decode_case(kind, b, s, spec, mode, gen, timed)
            if "ms" in c:
                decode.append(c)
            print_decode(c, b)
    group = [decode_group_case(mode, gen) for mode in ("bf16", "f32", "int8-channel")]
    for c in group:
        print_group(c)
    for c in flash:
        print_flash(c)
    # the training path's shapes: encoder (250 frames), decoder cross (47
    # target positions), and 30 s utterances (K4's range); the headline first
    backward = [flash_bwd_case(b, sq, sk, dt, rate, gen)
                for b, sq, sk in ((64, 250, 250), (64, 47, 250), (2, 750, 750))
                for rate in (0.1, 0.0) for dt in (torch.bfloat16, torch.float32)]
    for c in backward:
        print_flash_bwd(c)
    for dtype in (torch.bfloat16, torch.float32):
        n, kept = mask_bits_case(dtype)
        print(f"[kernels] dropout mask bits of the {str(dtype)[6:]} forward and backward "
              f"kernels identical to the plain version's: {n} of {n} (keep fraction "
              f"{kept:.4f} at rate 0.1)")
    return flash, decode, group, backward, mt_kernel_cases(gen)


# ------------------------------------------------------------------ phase 3
def serving_phase():
    from joeys2t_torch.config import SpecialSymbols, load_config
    from joeys2t_torch.models import build_model
    from joeys2t_torch.ops.decode_attention import decode_attention
    from joeys2t_torch.ops.flash_attention import flash_attention_fwd
    from joeys2t_torch.serving import Transcriber
    from joeys2t_torch.vocabulary import Vocabulary

    cfg = load_config(REPO / "configs" / "librispeech_100h.yaml")["model"]
    vocab = Vocabulary([f"w{i}" for i in range(4996)], SpecialSymbols())
    check(len(vocab) == 5000, f"vocabulary has {len(vocab)} entries")
    t0 = time.time()
    model, spec = build_model(cfg, trg_vocab=vocab, compute_dtype=torch.bfloat16,
                              device="cuda", generator=torch.Generator().manual_seed(0))
    asr = Transcriber(model, spec, vocab, device="cuda")
    n_enc, n_dec = len(model.encoder.layers), len(model.decoder.layers)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serving] librispeech_100h: {n_enc} enc / {n_dec} dec layers, "
          f"{n_params / 1e6:.1f} M params, bf16, built in {time.time() - t0:.1f} s")
    rng = np.random.RandomState(0)
    asr.transcribe([speechlike(rng, 16000)] * 2, max_output_length=4)  # warm-up

    batch = [speechlike(rng, 160000) for _ in range(64)]
    single, long_wave = speechlike(rng, 480000), speechlike(rng, 720000)
    requests = [  # (name, request, audio seconds, encoder calls)
        ("64 x 10 s", lambda: asr.transcribe(batch, max_output_length=96), 640.0, 1),
        ("1 x 30 s", lambda: asr.transcribe([single], max_output_length=96), 30.0, 1),
        ("45 s long", lambda: [asr.transcribe_long(long_wave, max_output_length=96)],
         45.0, 1)]
    flash_attention_fwd.launches = 0
    decode_attention.launches = 0
    asr.stats.update(requests=0, utterances=0, audio_seconds=0.0, decode_steps=0)
    total_wall, total_audio, served = 0.0, 0.0, {}
    for name, run, seconds, batches in requests:
        f0, d0 = flash_attention_fwd.launches, decode_attention.launches
        s0 = asr.stats["decode_steps"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        texts = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = asr.stats["decode_steps"] - s0
        check(all(isinstance(t, str) for t in texts), f"{name}: non-text output")
        check(all(vocab.lookup(w) != vocab.unk_index or w == "<unk>"
                  for t in texts for w in t.split()), f"{name}: output outside the vocabulary")
        check(flash_attention_fwd.launches - f0 == n_enc * batches,
              f"{name}: {flash_attention_fwd.launches - f0} flash launches, "
              f"expected {n_enc * batches}")
        check(1 <= steps <= 96 * batches, f"{name}: {steps} decode steps")
        check(decode_attention.launches - d0 == 2 * n_dec * steps,
              f"{name}: {decode_attention.launches - d0} decode launches, expected "
              f"{2 * n_dec * steps}")
        total_wall += wall
        total_audio += seconds
        served[name] = (texts, wall, steps)
        print(f"[serving] {name}: {len(texts)} transcripts, {steps} decode steps, "
              f"{wall:.3f} s wall, {seconds / wall:.1f} audio-s/s")
    check(asr.stats["requests"] == 3, f"{asr.stats['requests']} requests served")
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "serving cast the caller's float32 master weights")
    print(f"[serving] total: {total_audio:.0f} audio-s in {total_wall:.3f} s = "
          f"{total_audio / total_wall:.1f} audio-s/s")
    return flash_attention_fwd.launches, decode_attention.launches, asr, batch, served


def breakdown_phase(asr, batch):
    """Where the 64 x 10 s request's time goes: front end, encoder and decode
    loop on the host clock (each ending in a device sync), then the card's
    busy share and top kernels over a profiled 16-step decode; returns K5's
    device ms a step there."""
    from joeys2t_torch.ops.frontend import device_frontend
    from joeys2t_torch.search import transformer_greedy

    waves = torch.tensor(np.stack(batch)).cuda()
    lengths = torch.full((len(batch),), waves.shape[1], device="cuda")
    with torch.inference_mode():
        (feats, flen), t_front = sync_time(lambda: device_frontend(waves, lengths))
        (enc, _, mask), t_enc = sync_time(lambda: asr.model.encode(feats, flen))
        stats = {}
        _, t_dec = sync_time(lambda: transformer_greedy(asr.decode_model, asr.spec, enc,
                                                        mask, 96, device="cuda",
                                                        stats=stats))
        total = t_front + t_enc + t_dec
        print(f"[breakdown] 64 x 10 s: front end {t_front * 1e3:.2f} ms "
              f"({100 * t_front / total:.1f} %), encoder {t_enc * 1e3:.2f} ms "
              f"({100 * t_enc / total:.1f} %), decode {t_dec * 1e3:.2f} ms "
              f"({100 * t_dec / total:.1f} %) = {stats['decode_steps']} steps of "
              f"{t_dec / stats['decode_steps'] * 1e3:.3f} ms")
        pstats = {}
        wall, kernels = profiled(lambda: transformer_greedy(
            asr.decode_model, asr.spec, enc, mask, 16, device="cuda", stats=pstats))
    return decode_profile("breakdown", "decode", asr, wall, kernels, pstats["decode_steps"])


def decode_profile(tag, what, asr, wall, kernels, steps):
    """The card's busy share, kernels a step, top kernels and K5's device
    time in a profiled decode of ``steps`` steps; K5 must have launched 2 x
    (decoder layers) times a step. Returns K5's device ms a step (None when
    the profiler recorded no device events)."""
    if not kernels:
        print(f"[{tag}] device busy share: not measured (no device events recorded)")
        return None
    busy_us = sum(t for _, t in kernels.values())
    launches = sum(n for n, _ in kernels.values())
    print(f"[{tag}] profiled {steps}-step {what}: wall {wall * 1e3:.2f} ms, device "
          f"busy {busy_us / 1e3:.2f} ms ({100 * busy_us / (wall * 1e6):.1f} %), "
          f"{launches / steps:.0f} kernels per step")
    for name, (n, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[{tag}]   {t / 1e3:8.3f} ms {n:5d}x  {name[:110]}")
    k5 = [(n, t) for name, (n, t) in kernels.items() if "decode_attention_kernel" in name]
    k5_n, k5_us = sum(n for n, _ in k5), sum(t for _, t in k5)
    check(k5_n == 2 * len(asr.decode_model.decoder.layers) * steps,
          f"profiled {what}: {k5_n} decode attention kernels in {steps} steps")
    print(f"[{tag}] K5 (decode_attention_kernel) in the profiled {what}: "
          f"{k5_us / 1e3:.3f} ms of device time over {k5_n} launches ({k5_n // steps} a "
          f"step, {k5_us / k5_n:.2f} us each), {100 * k5_us / busy_us:.1f} % of busy")
    return k5_us / 1e3 / steps


def beam_serving_phase(asr, batch):
    """Phase 3's beam request at bench.py's beam shape: 32 x 10 s, beam 5,
    length penalty 1, ``max_output_length`` 96, the best hypothesis, with
    the launch counters zeroed just before and the plain attention versions
    refused: 16 flash forward launches (the encoder) and 16 decode launches
    a step (8 self-attentions over the 160-row ring buffers, 8 cross with 5
    queries a cache row). Then the decode loop's ms a step, and the busy
    share and launches a step over a profiled 16-step slice of the loop."""
    from joeys2t_torch.ops.frontend import device_frontend
    from joeys2t_torch.search import beam_search

    waves = batch[:32]
    n_enc, n_dec = len(asr.model.encoder.layers), len(asr.model.decoder.layers)
    asr.transcribe(waves[:2], max_output_length=4, beam_size=5)  # warm-up
    s0 = asr.stats["decode_steps"]
    zero_counters()
    with plain_refused("beam serving path"):
        texts, request_wall = sync_time(lambda: asr.transcribe(
            waves, max_output_length=96, beam_size=5, beam_alpha=1.0))
    launches = read_counters()
    steps = asr.stats["decode_steps"] - s0
    check(len(texts) == 32 and all(isinstance(t, str) for t in texts),
          "beam request: not 32 transcripts")
    check(1 <= steps <= 96, f"beam request: {steps} decode steps")
    want = {"flash_attention_fwd": n_enc, "flash_attention_bwd": 0,
            "decode_attention": 2 * n_dec * steps, "decode_attention_group": n_dec * steps,
            "decode_attention_int8_channel": 0, "decode_attention_int8_position": 0}
    check(launches == want, f"beam request launches {launches}, expected {want}")
    print(f"[serving] 32 x 10 s beam 5 (alpha 1, n_best 1): {steps} decode steps, "
          f"{request_wall:.3f} s wall, {320.0 / request_wall:.1f} audio-s/s; launches "
          f"{launches} as the path implies, plain attention never ran")

    wave_t = torch.tensor(np.stack(waves)).cuda()
    lengths = torch.full((32,), wave_t.shape[1], device="cuda")
    with torch.inference_mode():
        feats, flen = device_frontend(wave_t, lengths)
        enc, _, mask = asr.model.encode(feats, flen)
        stats = {}
        _, t_dec = sync_time(lambda: beam_search(asr.decode_model, asr.spec, enc, None,
                                                 mask, 5, 96, 1.0, device="cuda",
                                                 stats=stats))
        print(f"[beam] decode loop: {stats['decode_steps']} steps of "
              f"{t_dec / stats['decode_steps'] * 1e3:.3f} ms ({t_dec * 1e3:.2f} ms)")
        pstats = {}
        wall, kernels = profiled(lambda: beam_search(
            asr.decode_model, asr.spec, enc, None, mask, 5, 16, 1.0, device="cuda",
            stats=pstats))
    k5_ms = decode_profile("beam", "beam loop", asr, wall, kernels, pstats["decode_steps"])
    return launches, (texts, request_wall, steps), k5_ms


# ------------------------------------------------------------------ phase 4
def small_models(**flags):
    """The same seeded float32 model (2 + 2 layers, hidden 256, head dim 128,
    a 200-token vocabulary, the model ``flags`` on top) on the CPU and on the
    card, and the front end's features of 4 speech-like waveforms on the CPU."""
    from joeys2t_torch.config import SpecialSymbols
    from joeys2t_torch.models import build_model
    from joeys2t_torch.ops.frontend import device_frontend
    from joeys2t_torch.vocabulary import Vocabulary

    cfg = {"encoder": {"type": "transformer", "num_layers": 2, "num_heads": 2,
                       "embeddings": {"embedding_dim": 80}, "hidden_size": 256,
                       "ff_size": 1024, "subsample": True, "conv_kernel_sizes": [5, 5],
                       "conv_channels": 256, "in_channels": 80, "layer_norm": "pre"},
           "decoder": {"type": "transformer", "num_layers": 2, "num_heads": 2,
                       "embeddings": {"embedding_dim": 256, "scale": True},
                       "hidden_size": 256, "ff_size": 1024, "layer_norm": "pre"}, **flags}
    vocab = Vocabulary([f"w{i}" for i in range(196)], SpecialSymbols())
    models = {dev: build_model(cfg, trg_vocab=vocab, device=dev,
                               generator=torch.Generator().manual_seed(1))
              for dev in ("cpu", "cuda")}
    for name, p in models["cpu"][0].state_dict().items():
        check(torch.equal(p, models["cuda"][0].state_dict()[name].cpu()),
              f"seeded weights differ between devices at {name}")
    rng = np.random.RandomState(1)
    lengths = np.array([48000, 61000, 39000, 80000])
    waves = np.zeros((4, 80000), np.float32)
    for i, n in enumerate(lengths):
        waves[i, :n] = speechlike(rng, n)
    return models, waves, lengths, device_frontend(torch.tensor(waves), torch.tensor(lengths))


def decode_on_both(models, feats, flen, cpu_encoder_output: bool = False):
    """Encoder output, greedy tokens (40 steps) and beam-5 2-best hypotheses
    with their scores of ``small_models``'s pair on each device; the card run
    must go through the kernels. With ``cpu_encoder_output`` both devices
    decode from the CPU's encoder output (each device still encodes). Returns
    (encoder error on valid frames, largest beam-score difference, the CPU's
    outputs) after checking masks, tokens and hypotheses equal."""
    from joeys2t_torch.ops.decode_attention import decode_attention
    from joeys2t_torch.ops.flash_attention import flash_attention_fwd
    from joeys2t_torch.search import beam_search, transformer_greedy

    out = {}
    f0, d0 = flash_attention_fwd.launches, decode_attention.launches
    with torch.inference_mode():
        cpu_enc = models["cpu"][0].encode(feats, flen)[0] if cpu_encoder_output else None
        for dev, (model, spec) in models.items():
            enc, _, mask = model.encode(feats.to(dev), flen.to(dev))
            if cpu_encoder_output:
                enc = cpu_enc.to(dev)
            tokens, _, _ = transformer_greedy(model, spec, enc, mask, 40, device=dev)
            beams, beam_scores, _ = beam_search(model, spec, enc, None, mask, 5, 40, 1.0,
                                                n_best=2, device=dev, return_prob="hyp")
            out[dev] = (enc.cpu(), mask.cpu(), tokens, beams, beam_scores)
    check(flash_attention_fwd.launches - f0 == 2 and decode_attention.launches > d0,
          "the card run did not go through the kernels")
    valid = out["cpu"][1][:, 0, :, None]
    enc_err = ((out["cuda"][0] - out["cpu"][0]) * valid).abs().max().item()
    check(torch.equal(out["cuda"][1], out["cpu"][1]), "encoder masks differ")
    check(np.array_equal(out["cuda"][2], out["cpu"][2]),
          f"greedy tokens differ:\n{out['cuda'][2]}\n{out['cpu'][2]}")
    check(np.array_equal(out["cuda"][3], out["cpu"][3]),
          f"beam hypotheses differ:\n{out['cuda'][3]}\n{out['cpu'][3]}")
    return enc_err, float(np.abs(out["cuda"][4] - out["cpu"][4]).max()), out["cpu"]


def card_vs_cpu_phase():
    from joeys2t_torch.ops.frontend import device_frontend

    models, waves, lengths, (feats, flen) = small_models()
    feats_gpu, flen_gpu = device_frontend(torch.tensor(waves).cuda(),
                                          torch.tensor(lengths).cuda())
    feat_err = (feats_gpu.cpu() - feats).abs().max().item()
    check(torch.equal(flen_gpu.cpu(), flen), "frame lengths differ between devices")
    check(feat_err <= 1e-3, f"front end differs between devices by {feat_err}")
    enc_err, score_err, cpu = decode_on_both(models, feats, flen)
    check(enc_err <= 1e-4, f"encoder output differs between card and CPU by {enc_err}")
    check(score_err <= 1e-4, f"beam scores differ between card and CPU by {score_err}")
    print(f"[card-vs-cpu] f32 2+2 layers hidden 256 D=128: front end err {feat_err:.3g}, "
          f"encoder err {enc_err:.3g} (tol 1e-4), greedy tokens identical "
          f"({cpu[2].shape[1]} steps); beam 5 2-best hypotheses identical "
          f"({cpu[3].shape[1]} tokens), scores err {score_err:.3g} (tol 1e-4)")

    # no plain path on the card: key-masked attention at a head size or dtype
    # the flash kernel does not take raises instead of running plain PyTorch
    from joeys2t_torch.models.modules import MultiHeadedAttention

    x = torch.randn(2, 5, 64, device="cuda")
    key_mask = torch.ones(2, 1, 5, dtype=torch.bool, device="cuda")
    for heads, dtype in ((2, torch.bfloat16), (1, torch.float16)):
        mha = MultiHeadedAttention(heads, 64, dtype=dtype, device="cuda").eval()
        try:
            mha(x, x, x, key_mask)
            fail(f"attention with head size {64 // heads} in {dtype} ran on the card")
        except ValueError:
            pass
    print("[card-vs-cpu] head size 32 bf16 and head size 64 f16 attention raise on the card")


# ------------------------------------------------------------ phases 5, 6
def synthetic_batches(n, b, rng, vocab_size, min_frames=600, max_frames=1000, trg_len=48):
    """``n`` training batches of ``b`` fbank-like utterances (CMVN-scaled,
    slowly varying noise; 10 ms frames) with ``trg_len``-token targets
    (bos, words, eos)."""
    from joeys2t_torch.data.batch import Batch

    out = []
    for _ in range(n):
        lengths = rng.randint(min_frames, max_frames + 1, size=b)
        lengths[0] = max_frames
        t = int(lengths.max())
        smooth = np.cumsum(rng.randn(b, t, 80).astype(np.float32), axis=1) * 0.05
        src = (rng.randn(b, t, 80).astype(np.float32) + smooth) * (
            np.arange(t)[None, :, None] < lengths[:, None, None])
        trg = rng.randint(4, vocab_size, size=(b, trg_len))
        trg[:, 0], trg[:, -1] = 2, 3
        out.append(Batch(src.astype(np.float32), lengths, None, trg,
                         np.full(b, trg_len), None, np.arange(b), 1, 3, task="S2T"))
    return out


def train_phase():
    from joeys2t_torch.config import SpecialSymbols, load_config, parse_train_args
    from joeys2t_torch.losses import build_loss_function
    from joeys2t_torch.models import build_model
    from joeys2t_torch.ops import flash_attention as fa
    from joeys2t_torch.optim import WarmupInverseSquareRootScheduler
    from joeys2t_torch.training import TrainManager
    from joeys2t_torch.vocabulary import Vocabulary

    cfg = load_config(REPO / "configs" / "librispeech_100h.yaml")
    vocab = Vocabulary([f"w{i}" for i in range(4996)], SpecialSymbols())
    model, spec = build_model(cfg["model"], trg_vocab=vocab, compute_dtype=torch.bfloat16,
                              device="cuda", generator=torch.Generator().manual_seed(0))
    args = parse_train_args(cfg["training"])
    check(args.batch_multiplier == 4 and args.optimizer == "adamw"
          and args.scheduling == "warmupinversesquareroot" and args.clip_grad_norm == 10.0
          and args.label_smoothing == 0.1 and args.ctc_weight == 0.3,
          f"unexpected training config {args}")
    check(cfg["model"]["encoder"]["dropout"] == 0.1 == cfg["model"]["decoder"]["dropout"],
          "the flagship trains with dropout 0.1")
    tm = TrainManager(model, spec, build_loss_function(args, spec), args,
                      seed=cfg.get("random_seed", 42), device="cuda")
    n_enc, n_dec = len(model.encoder.layers), len(model.decoder.layers)
    per_micro = n_enc + n_dec  # encoder self + decoder cross attentions
    rng = np.random.RandomState(7)
    batches = synthetic_batches(8, 64, rng, len(vocab))
    audio_s = [float(b.src_length.sum()) / 100.0 for b in batches]  # 10 ms frames
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    expected = WarmupInverseSquareRootScheduler(peak_rate=args.learning_rate,
                                                warmup=args.learning_rate_warmup,
                                                min_rate=args.learning_rate_min)
    check(tm.current_lr == expected.step(0), f"initial lr {tm.current_lr}")

    fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    micro_ms, update_s, losses, lrs = [], [], [], []
    with plain_refused("training path"):
        torch.cuda.synchronize()
        t_update = time.perf_counter()
        for i, batch in enumerate(batches):
            f0, b0 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
            out, wall = sync_time(lambda: tm.train_batch(batch))
            micro_ms.append(wall * 1e3)
            losses.append(out["loss"].item())
            check(fa.flash_attention_fwd.launches - f0 == per_micro
                  and fa.flash_attention_bwd.launches - b0 == per_micro,
                  f"micro-batch {i}: {fa.flash_attention_fwd.launches - f0} forward and "
                  f"{fa.flash_attention_bwd.launches - b0} backward flash launches, "
                  f"expected {per_micro} each")
            check(out["stepped"] == (i % 4 == 3), f"micro-batch {i}: stepped={out['stepped']}")
            if out["stepped"]:
                update_s.append(time.perf_counter() - t_update)
                t_update = time.perf_counter()
                lrs.append(tm.current_lr)
    fwd_launches, bwd_launches = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(losses)), f"non-finite training loss {losses}")
    check(tm.stats.steps == 2, f"{tm.stats.steps} updates")
    check(lrs == [expected.step(1), expected.step(2)], f"lr {lrs} off the schedule")
    check(all(p.dtype == torch.float32 for p in model.parameters()), "masters left float32")
    moved = sum(not torch.equal(p, before[n]) for n, p in model.named_parameters())
    check(moved == len(before), f"{len(before) - moved} weights did not move")
    del before
    print(f"[train] librispeech_100h: {n_enc} enc / {n_dec} dec layers, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M float32 masters, bf16 "
          f"compute, dropout 0.1, batch_multiplier {args.batch_multiplier}, B=64, "
          f"{batches[0].trg.shape[1]} decoder positions")
    print(f"[train] 2 updates: losses {[round(x, 4) for x in losses]}, lr {lrs}, "
          f"{fwd_launches} forward + {bwd_launches} backward flash launches "
          f"({per_micro} + {per_micro} per micro-batch), every weight moved, float32")
    print(f"[train] ms per micro-batch: {[round(x, 2) for x in micro_ms]}; per update: "
          f"{[round(x * 1e3, 2) for x in update_s]}; trained audio-s/s: "
          f"{[round(sum(audio_s[4 * i:4 * i + 4]) / t, 1) for i, t in enumerate(update_s)]}"
          f" (second update {sum(audio_s[4:]):.1f} audio-s in {update_s[1]:.3f} s); peak "
          f"memory {peak_gib:.2f} GiB")

    # breakdown: forward (loss), backward, optimizer, each ending in a sync
    fwd_s, bwd_s = [], []
    for batch in batches[:4]:
        _, _, arrays, normalizer = tm._prepare_batch(batch)
        (loss, _), t = sync_time(lambda: tm._loss_and_metrics(arrays, normalizer))
        fwd_s.append(t)
        _, t = sync_time(loss.backward)
        bwd_s.append(t)
    _, opt_s = sync_time(tm.apply_accum)
    fwd_ms, bwd_ms = 1e3 * np.mean(fwd_s), 1e3 * np.mean(bwd_s)
    print(f"[train] breakdown per micro-batch: forward+loss {fwd_ms:.2f} ms, backward "
          f"{bwd_ms:.2f} ms; optimizer (clip + AdamW) {opt_s * 1e3:.2f} ms per update")
    train_batch_rate = sum(audio_s[4:]) / update_s[1]  # the second update's audio-s/s

    # the card's busy share and top kernels over 4 profiled micro-batches
    profiled_batches = batches[:4]
    wall, kernels = profiled(lambda: [tm.train_batch(b) for b in profiled_batches])
    if not kernels:
        print("[train] device busy share: not measured (no device events recorded)")
        return fwd_launches, bwd_launches, train_batch_rate
    busy_us = sum(t for _, t in kernels.values())
    flash_bwd_us = sum(t for name, (_, t) in kernels.items() if "flash_bwd" in name)
    flash_fwd_us = sum(t for name, (_, t) in kernels.items() if "flash_fwd" in name)
    print(f"[train] profiled 4 micro-batches: wall {wall * 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({100 * busy_us / (wall * 1e6):.1f} %), "
          f"{sum(n for n, _ in kernels.values()) / len(profiled_batches):.0f} kernels per "
          f"micro-batch; flash "
          f"backward kernels {flash_bwd_us / 1e3:.2f} ms ({100 * flash_bwd_us / busy_us:.1f} %"
          f" of busy), flash forward {flash_fwd_us / 1e3:.2f} ms "
          f"({100 * flash_fwd_us / busy_us:.1f} %)")
    for name, (n, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"[train]   {t / 1e3:8.3f} ms {n:5d}x  {name[:110]}")
    return fwd_launches, bwd_launches, train_batch_rate


def train_card_vs_cpu_phase():
    """One float32 update at dropout 0 of a small model on the card and on
    the CPU, from the same seeded weights and batches."""
    from joeys2t_torch.config import SpecialSymbols, parse_train_args
    from joeys2t_torch.losses import build_loss_function
    from joeys2t_torch.models import build_model
    from joeys2t_torch.training import TrainManager
    from joeys2t_torch.vocabulary import Vocabulary

    cfg = {"encoder": {"type": "transformer", "num_layers": 2, "num_heads": 2,
                       "embeddings": {"embedding_dim": 80}, "hidden_size": 256,
                       "ff_size": 1024, "subsample": True, "conv_kernel_sizes": [5, 5],
                       "conv_channels": 256, "in_channels": 80, "layer_norm": "pre",
                       "dropout": 0.0},
           "decoder": {"type": "transformer", "num_layers": 2, "num_heads": 2,
                       "embeddings": {"embedding_dim": 256, "scale": True},
                       "hidden_size": 256, "ff_size": 1024, "layer_norm": "pre",
                       "dropout": 0.0}}
    training = {"optimizer": "adamw", "adam_betas": [0.9, 0.98], "weight_decay": 0.01,
                "scheduling": "warmupinversesquareroot", "learning_rate": 2e-3,
                "learning_rate_warmup": 10, "clip_grad_norm": 1.0, "batch_size": 8,
                "batch_multiplier": 2, "label_smoothing": 0.1,
                "loss": "crossentropy-ctc", "ctc_weight": 0.3}
    vocab = Vocabulary([f"w{i}" for i in range(196)], SpecialSymbols())
    batches = synthetic_batches(2, 6, np.random.RandomState(3), len(vocab), 300, 520, 20)
    runs = {}
    for dev in ("cpu", "cuda"):
        model, spec = build_model(cfg, trg_vocab=vocab, device=dev,
                                  generator=torch.Generator().manual_seed(2))
        args = parse_train_args(training)
        tm = TrainManager(model, spec, build_loss_function(args, spec), args, device=dev)
        apply, seen = tm.apply_accum, {}

        def capture(model=model, apply=apply, seen=seen):
            seen.update({n: p.grad.detach().cpu().clone()
                         for n, p in model.named_parameters()})
            apply()

        tm.apply_accum = capture
        loss = sum(tm.train_batch(b)["loss"].item() for b in batches)
        runs[dev] = (loss, seen, {n: p.detach().cpu() for n, p in model.named_parameters()},
                     tm.current_lr)
    (l_cpu, g_cpu, p_cpu, lr), (l_gpu, g_gpu, p_gpu, _) = runs["cpu"], runs["cuda"]
    norm = float(torch.stack([g.double().square().sum() for g in g_cpu.values()]).sum().sqrt())
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_err = max((g_gpu[n] - g).abs().max().item() for n, g in g_cpu.items()) / norm
    param_err = max((p_gpu[n] - p).abs().max().item() for n, p in p_cpu.items())
    check(loss_err <= 1e-5, f"training loss differs between card and CPU by {loss_err}")
    check(grad_err <= 1e-4, f"gradients differ by {grad_err} of their norm")
    check(param_err <= 2 * lr, f"updated weights differ by {param_err} > 2 lr = {2 * lr}")
    print(f"[train-card-vs-cpu] f32 2+2 layers hidden 256, 2 micro-batches: loss rel err "
          f"{loss_err:.3g} (tol 1e-5), gradient err {grad_err:.3g} of the norm (tol 1e-4), "
          f"weight err {param_err:.3g} (tol 2 lr = {2 * lr:.3g})")


# ------------------------------------------------------------------ phase 7
class LogLines(logging.Handler):
    """Keeps the message of every record of the port's loggers."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@contextlib.contextmanager
def kernel_inputs(kept: dict, flash_calls=(0, 80), decode_calls=(0, 384)):
    """While active, keeps card copies of the inputs that the main path gives
    the kernel wrappers: for the flash forward and backward, those of the
    first and the 81st call of each kind (batch size, self or cross, dtype,
    dropout or not), the latter a later training batch of other lengths; for
    decode attention, those of the first and the 385th call of each (batch
    size, S, dtype), the latter some 24-48 greedy steps in, where a
    self-attention ring buffer holds many valid keys. The copies are made
    outside the wrappers and launch no kernel of the port."""
    from joeys2t_torch.models import modules
    from joeys2t_torch.ops import flash_attention as fa

    forward, backward = fa.FlashAttention.__dict__["forward"], \
        fa.FlashAttention.__dict__["backward"]
    decode = modules.decode_attention
    calls = collections.Counter()

    def keep(key, args, which=(0,)):
        n = calls[key]
        calls[key] += 1
        if n in which:
            kept[key + (n,)] = [a.detach().clone() if torch.is_tensor(a) else a
                                for a in args]

    def flash_key(name, q, k, rate):
        return (name, q.shape[0], q.shape[1] == k.shape[1], q.dtype, rate > 0)

    def kept_forward(ctx, q, k, v, bias, sm_scale, num_heads, dropout_rate=0.0, seed=None):
        keep(flash_key("flash_attention_fwd", q, k, dropout_rate),
             (q, k, v, bias, sm_scale, num_heads, dropout_rate, seed), flash_calls)
        return forward.__func__(ctx, q, k, v, bias, sm_scale, num_heads, dropout_rate, seed)

    def kept_backward(ctx, d_out):
        q, k, v, bias, out, lse, seed = ctx.saved_tensors
        sm_scale, num_heads, rate = ctx.args
        keep(flash_key("flash_attention_bwd", q, k, rate),
             (q, k, v, bias, out, lse, d_out.contiguous(), sm_scale, num_heads, rate, seed),
             flash_calls)
        return backward.__func__(ctx, d_out)

    def kept_decode(q, k, v, bias, k_scale=None, v_scale=None, **kw):
        keep(("decode_attention", q.shape[0], k.shape[2], k.dtype, kw.get("group", 1)),
             (q, k, v, bias, k_scale, v_scale, kw), decode_calls)
        return decode(q, k, v, bias, k_scale, v_scale, **kw)

    fa.FlashAttention.forward = staticmethod(kept_forward)
    fa.FlashAttention.backward = staticmethod(kept_backward)
    modules.decode_attention = kept_decode
    try:
        yield kept
    finally:
        fa.FlashAttention.forward, fa.FlashAttention.backward = forward, backward
        modules.decode_attention = decode


def cli_kernel_checks(kept: dict, names=("flash_attention_fwd", "flash_attention_bwd",
                                          "decode_attention"), tag: str = "cli") -> dict:
    """Each kernel against its plain version on the inputs ``kernel_inputs``
    kept from the main path; the flash kernels also without dropout where
    the path ran them with it. Tolerances are phase 2's: the backward's
    1e-5 (f32) / 2e-2 (bf16) of the largest reference value of each
    gradient; the forward's 1e-4 / 2e-2 and decode's 1e-5 / 1e-2 absolute,
    in units of the largest reference value where that exceeds 1 (phase 2's
    inputs are of unit scale, the path's activations are not); the lse only
    over rows with a valid key. Every kernel of ``names`` must have had an
    input. Returns {kernel: [case, ...]}."""
    from joeys2t_torch.ops import decode_attention as da
    from joeys2t_torch.ops import flash_attention as fa

    out = {name: [] for name in names}
    cases = []
    for key, args in kept.items():
        name = key[0]
        if name == "decode_attention":
            q, k, v, bias, ks, vs, kw = args
            cases.append((name, (q, k, v, bias, ks, vs), kw, bias))
        else:
            cases.append((name, tuple(args), {}, args[3]))
            rate_at = 6 if name == "flash_attention_fwd" else 9
            if args[rate_at] > 0:  # the same inputs without dropout
                cases.append((name, tuple(args[:rate_at]) + (0.0, None), {}, args[3]))
    for name, args, kw, bias in cases:
        q, k = args[0], args[1]
        f32 = q.dtype == torch.float32
        unit = 1.0  # the least reference scale the tolerance is taken in
        if name == "flash_attention_fwd":
            got, ref = fa.flash_attention_fwd(*args), fa.flash_attention_plain(*args)
            rows = (bias > -1e8).any(1)  # the lse of a row with no valid key is -1e9
            pairs = [("out", got[0], ref[0]), ("lse", got[1][rows], ref[1][rows])]
            rel, rate = (1e-4 if f32 else 2e-2), args[6]
            shape = f"B={q.shape[0]} Sq={q.shape[1]} Sk={k.shape[1]} dropout {rate}"
        elif name == "flash_attention_bwd":
            got, ref = fa.flash_attention_bwd(*args), fa.flash_attention_bwd_plain(*args)
            pairs = list(zip(("dq", "dk", "dv"), got, ref))
            rel, rate, unit = (1e-5 if f32 else 2e-2), args[9], 0.0
            shape = f"B={q.shape[0]} Sq={q.shape[1]} Sk={k.shape[1]} dropout {rate}"
        else:
            pairs = [("out", da.decode_attention(*args, **kw),
                      da.decode_attention_plain(*args, **kw))]
            rel = 1e-5 if f32 else 1e-2
            valid = (bias > -1e8).sum(1)
            shape = (f"B={q.shape[0]} (group {kw.get('group', 1)}) S={k.shape[2]} valid "
                     f"keys {int(valid.min())}-{int(valid.max())}"
                     + (f" int8 {kw['scale_layout']}" if k.dtype == torch.int8 else ""))
        torch.cuda.synchronize()
        desc = f"{shape} {str(q.dtype)[6:]}"
        worst = None  # the output nearest its tolerance: (err / tol, part, err, tol)
        for part, g, r in pairs:
            check(bool(torch.isfinite(g.float()).all()), f"{name} {desc}: non-finite {part}")
            err = (g.float() - r.float()).abs().max().item()
            tol = rel * max(unit, r.float().abs().max().item())
            check(err <= tol, f"{name} on the {tag} path's inputs {desc}: {part} max abs "
                  f"err {err} > {tol}")
            ratio = err / tol if tol > 0 else 0.0
            if worst is None or ratio > worst[0]:
                worst = (ratio, part, err, tol)
        out[name].append(dict(case=desc, output=worst[1], max_abs_err=worst[2], tol=worst[3]))
    for name, found in out.items():
        check(bool(found), f"the {tag} path gave {name} no input to check")
        print(f"[{tag}] {name} against its plain version on the path's own inputs (the "
              f"output nearest its tolerance): " + "; ".join(
                  f"{c['case']} {c['output']} err {c['max_abs_err']:.3g} (tol {c['tol']:.3g})"
                  for c in found))
    return out


def cli_run(argv, stdin: str = ""):
    """``joeys2t_torch.__main__.main(argv)`` in this process with the kernels'
    launch counters zeroed just before and read just after: (wall s, log
    lines, stdout, {kernel: launches})."""
    import io

    from joeys2t_torch.__main__ import main as cli_main

    port_logs = logging.getLogger("joeys2t_torch")
    levels = [(h, h.level) for h in port_logs.handlers]
    for h, _ in levels:  # the port's console log: warnings only
        h.setLevel(logging.WARNING)
    log, stdout, stdin_before = LogLines(), io.StringIO(), sys.stdin
    port_logs.addHandler(log)
    sys.stdin = io.StringIO(stdin)
    try:
        zero_counters()
        with contextlib.redirect_stdout(stdout):
            _, wall = sync_time(lambda: cli_main([str(a) for a in argv]))
        launches = read_counters()
    finally:
        sys.stdin = stdin_before
        port_logs.removeHandler(log)
        for h, level in levels:
            h.setLevel(level)
    return wall, log.lines, stdout.getvalue(), launches


def generations(lines):
    """(seconds, batches, decode steps) of every ``predict`` call logged."""
    return [(float(m.group(1)), int(m.group(2)), int(m.group(3))) for m in (
        re.search(r"Generation took ([\d.]+)\[sec\] over (\d+) batch\(es\), (\d+) decode",
                  ln) for ln in lines) if m]


def manifest_audio_s(tsv: Path, n: int = None) -> float:
    """Audio seconds (10 ms frames) of the first ``n`` rows of a manifest."""
    rows = tsv.read_text(encoding="utf-8").splitlines()[1:]
    return sum(int(r.split("\t")[2]) for r in rows[:n]) / 100.0


def generate_corpus(data: Path) -> None:
    """Phase 7's corpus: 512 / 64 / 64 generated utterances into ``data``."""
    subprocess.run([sys.executable, str(REPO / "scripts" / "generate_synthetic_asr.py"),
                    "--out", str(data), "--train", "512", "--dev", "64", "--test", "64"],
                   check=True, capture_output=True, timeout=600)


def cli_config(data: Path, model_dir: Path) -> dict:
    """configs/synthetic_asr.yaml as phase 7 cuts it: the corpus in ``data``,
    16 updates (2 epochs of 8 batches of 64), a validation every 8, logging
    every 4; full width, bf16, beam 5, on the card."""
    from joeys2t_torch.config import load_config

    cfg = load_config(REPO / "configs" / "synthetic_asr.yaml")
    cfg["model_dir"] = str(model_dir)
    for split in ("train", "dev", "test"):
        cfg["data"][split] = str(data / split)
    cfg["data"]["trg"]["voc_file"] = str(data / "char.txt")
    cfg["training"].update(updates=16, validation_freq=8, logging_freq=4)
    check(cfg["use_cuda"] and cfg["fp16"] and cfg["training"]["batch_size"] == 64
          and cfg["testing"]["beam_size"] == 5
          and cfg["model"]["encoder"]["num_layers"] == 16
          and cfg["model"]["decoder"]["num_layers"] == 8, "unexpected synthetic_asr config")
    return cfg


def cli_launches(n_enc: int, n_dec: int, updates: int, validations, decodes,
                 beam: bool = True) -> dict:
    """The launches a CLI run implies, from the ``predict`` calls it logged
    (``generations``): per training update (one micro-batch) n_enc + n_dec
    flash forward and as many backward; per validation batch the eval
    loss's n_enc + n_dec forward and the encoder's n_enc; per ``test`` or
    ``translate`` batch the encoder's n_enc; 2 n_dec decode launches a
    step, greedy in validation, beam search in ``decodes`` (greedy where
    not ``beam``), where the n_dec cross-attention launches a beam step
    have 5 query rows a cache row."""
    per_micro = n_enc + n_dec
    valid_batches = sum(b for _, b, _ in validations)
    beam_steps = sum(s for _, _, s in decodes)
    return {"flash_attention_fwd": per_micro * updates
            + (per_micro + n_enc) * valid_batches + n_enc * sum(b for _, b, _ in decodes),
            "flash_attention_bwd": per_micro * updates,
            "decode_attention": 2 * n_dec * (sum(s for _, _, s in validations) + beam_steps),
            "decode_attention_group": n_dec * beam_steps if beam else 0,
            "decode_attention_int8_channel": 0, "decode_attention_int8_position": 0}


def cut_test_on_both(cfg: dict, state: dict, model_dir: Path, data: Path, cut: Path) -> None:
    """A float32 ``test`` of the trained checkpoint ``state`` cut to 2 + 2
    layers on the first 8 dev utterances of ``data``, on the card and on the
    CPU: the hypotheses must be identical."""
    from joeys2t_torch.config import dump_yaml

    cut.mkdir(exist_ok=True)
    rows = (data / "dev.tsv").read_text(encoding="utf-8").splitlines()
    (data / "dev8.tsv").write_text("\n".join(rows[:9]) + "\n", encoding="utf-8")
    keep = re.compile(r"(encoder|decoder)\.layers\.(\d+)\.")
    torch.save({"model_state": {k: v for k, v in state.items()
                                if not keep.match(k) or int(keep.match(k).group(2)) < 2}},
               cut / "best.ckpt")
    shutil.copy(model_dir / "trg_vocab.txt", cut / "trg_vocab.txt")
    cut_cfg = dict(cfg, fp16=False, model_dir=str(cut))
    cut_cfg["data"] = dict(cfg["data"], dev=str(data / "dev8"))
    del cut_cfg["data"]["test"]
    cut_cfg["model"] = {**cfg["model"],
                        "encoder": dict(cfg["model"]["encoder"], num_layers=2),
                        "decoder": dict(cfg["model"]["decoder"], num_layers=2)}
    outs = {}
    for use_cuda in (True, False):
        path = cut / f"cut_{use_cuda}.yaml"
        path.write_text(dump_yaml(dict(cut_cfg, use_cuda=use_cuda)), encoding="utf-8")
        cli_run(["test", path, "-o", cut / f"out_{use_cuda}"])
        outs[use_cuda] = (cut / f"out_{use_cuda}.dev").read_text(encoding="utf-8")
    check(outs[True] == outs[False] and len(outs[True].splitlines()) == 8,
          f"float32 hypotheses differ between card and CPU:\n{outs[True]}\n{outs[False]}")


def cli_phase(train_batch_rate: float):
    """Phase 7: ``python -m joeys2t_torch {train,test,translate}`` on the
    synthetic_asr transformer at full width in bf16, every attention through
    the kernels with exact launch counts, then a float32 ``test`` of the
    trained checkpoint at a cut depth on the card and on the CPU."""
    from joeys2t_torch.config import dump_yaml

    work = REPO / "build" / "chip_smoke"
    data = work / "synthetic_asr"
    t0 = time.time()
    generate_corpus(data)
    print(f"[cli] corpus: 512 / 64 / 64 utterances in {time.time() - t0:.1f} s")
    model_dir = work / "model"
    cfg = cli_config(data, model_dir)
    cfg_path = work / "cli.yaml"
    cfg_path.write_text(dump_yaml(cfg), encoding="utf-8")
    n_enc, n_dec = 16, 8
    kept = {}
    with plain_refused("CLI path"):
        with kernel_inputs(kept):
            train_wall, lines, _, train_n = cli_run(["train", cfg_path])
            test_wall, test_lines, _, test_n = cli_run(["test", cfg_path, "-o",
                                                        work / "out"])
            feats = sorted((data / "feats").glob("test-*.npy"))[:8]
            tr_wall, tr_lines, tr_out, tr_n = cli_run(
                ["translate", cfg_path], stdin="".join(f"{p}\n" for p in feats))
    checks = cli_kernel_checks(kept)
    del kept

    # the model directory
    for name in ("config.yaml", "train.log", "trg_vocab.txt", "validations.txt",
                 "8.ckpt", "16.ckpt", "8.hyps", "16.hyps", "best.hyps.dev",
                 "best.hyps.test"):
        check((model_dir / name).is_file(), f"train wrote no {name}")
    for link in ("best.ckpt", "latest.ckpt"):
        check((model_dir / link).is_symlink() and (model_dir / link).resolve().is_file(),
              f"no {link} symlink")
    valid = (model_dir / "validations.txt").read_text().splitlines()
    wers = [float(m.group(1)) for m in (re.search(r"\twer: ([\d.]+)\t", v) for v in valid)
            if m]
    check(len(valid) == 2 and len(wers) == 2, f"validations.txt: {valid}")
    losses = [float(m.group(1)) for m in (re.search(r"Batch Loss: +([-\d.einfa]+)", ln)
                                          for ln in lines) if m]
    check(len(losses) == 4 and all(np.isfinite(losses)), f"training losses {losses}")
    from joeys2t_torch.checkpoints import load_checkpoint

    state = load_checkpoint(model_dir / "latest.ckpt")["model_state"]
    check(all(v.dtype == torch.float32 for v in state.values()),
          "the trained weights are not float32")
    for split in ("dev", "test"):
        for name in (f"best.hyps.{split}", f"out.{split}"):
            path = model_dir / name if name.startswith("best") else work / name
            n = len(path.read_text(encoding="utf-8").splitlines())
            check(n == 64, f"{name}: {n} hypotheses, expected 64")
    hyps = tr_out.splitlines()
    check(len(hyps) == 8 and hyps == (work / "out.test").read_text(
        encoding="utf-8").splitlines()[:8], f"translate printed {tr_out!r}")

    loop = re.search(r"Training loop: (\d+) update\(s\) in ([\d.]+)\[sec\] besides "
                     r"validation \(([\d.]+)\[sec\] per update\), ([\d.]+)\[sec\] "
                     r"\(([\d.]+) %\) of it in the data pipeline \(read, collate, upload\); "
                     r"validation ([\d.]+)\[sec\]; final checkpoint ([\d.]+)\[sec\]",
                     "\n".join(lines))
    check(loop is not None and int(loop.group(1)) == 16, "no training-loop summary")
    gens = generations(lines)
    check(len(gens) == 4, f"train logged {len(gens)} predict calls, expected 2 + 2")
    expected = cli_launches(n_enc, n_dec, 16, gens[:2], gens[2:])
    check(train_n == expected, f"train launches {train_n}, expected {expected}")
    for name, run_lines, counts in (("test", test_lines, test_n),
                                    ("translate", tr_lines, tr_n)):
        want = cli_launches(n_enc, n_dec, 0, [], generations(run_lines))
        check(counts == want, f"{name} launches {counts}, expected {want}")

    # the same config in a fresh interpreter, on 8 dev utterances
    rows = (data / "dev.tsv").read_text(encoding="utf-8").splitlines()
    (data / "dev8.tsv").write_text("\n".join(rows[:9]) + "\n", encoding="utf-8")
    sub_cfg = dict(cfg, data={k: v for k, v in cfg["data"].items() if k != "test"})
    sub_cfg["data"]["dev"] = str(data / "dev8")
    sub_path = work / "cli_dev8.yaml"
    sub_path.write_text(dump_yaml(sub_cfg), encoding="utf-8")
    sub = subprocess.run([sys.executable, "-m", "joeys2t_torch", "test", str(sub_path)],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    check(sub.returncode == 0, f"python -m joeys2t_torch test exited {sub.returncode}: "
          f"{sub.stderr[-2000:]}")

    cut_test_on_both(cfg, state, model_dir, data, work / "cut")
    train_audio = manifest_audio_s(data / "train.tsv") * 2  # 16 updates = 2 epochs
    dev_audio = manifest_audio_s(data / "dev.tsv")
    train_s, per_update, data_s, _, valid_s, final_ckpt_s = (float(loop.group(i))
                                                             for i in range(2, 8))
    n_batches = 16 * cfg["training"].get("batch_multiplier", 1)
    test_gen = generations(test_lines)[0]  # the dev set in `test`
    print(f"[cli] train: 16 updates of 64 utterances (2 epochs), 2 validations, test "
          f"after training; {train_wall:.2f} s wall in all; losses "
          f"{[round(x, 4) for x in losses]}; WER {wers}; weights float32")
    print(f"[cli] launches: train {train_n}, test {test_n}, translate {tr_n}; each as "
          f"the path implies; plain attention never ran")
    print(f"[cli] CLI training loop: {per_update * 1e3:.2f} ms per update, of which the "
          f"host data pipeline (read, CMVN, SpecAugment, sampler filtering, collate, "
          f"upload) {data_s / n_batches * 1e3:.2f} ms a batch, {100 * data_s / train_s:.2f} %"
          f" of the loop's wall ({data_s:.3f} s of {train_s:.3f} s); "
          f"{train_audio / train_s:.1f} trained audio-s/s through the CLI against "
          f"{train_batch_rate:.1f} through train_batch (phase 5); final checkpoint "
          f"{final_ckpt_s:.3f} s")
    print(f"[cli] validation: {valid_s / 2:.3f} s wall per validation (64 utterances, "
          f"{dev_audio:.1f} audio-s, eval loss + greedy); test: {test_wall:.3f} s wall "
          f"(dev + test, 128 utterances), dev decode {test_gen[0]:.3f} s = "
          f"{dev_audio / test_gen[0]:.1f} audio-s/s over {test_gen[2]} beam-5 steps; "
          f"translate 8 paths {tr_wall:.3f} s")
    print("[cli] `python -m joeys2t_torch test` (8 dev utterances) exited 0; float32 "
          "beam-5 test at 2 + 2 layers: card and CPU hypotheses identical over 8 dev "
          "utterances")
    launches = {name: train_n[name] + test_n[name] + tr_n[name] for name in train_n}
    return launches, checks, model_dir / "best.ckpt", per_update


# ------------------------------------------------------------------ phase 8
def st_config(data: Path, model_dir: Path, encoder_ckpt: Path) -> dict:
    """configs/synthetic_st.yaml as phase 8 cuts it: the corpus in ``data``,
    16 updates (2 epochs of 8 batches of 64), a validation every 8, logging
    every 4, the encoder loaded from ``encoder_ckpt`` (the config's own
    transfer recipe); full width (12 + 6 layers, hidden 512, 4 heads of
    128), bf16, BLEU, beam 5, on the card."""
    from joeys2t_torch.config import load_config

    cfg = load_config(REPO / "configs" / "synthetic_st.yaml")
    cfg["model_dir"] = str(model_dir)
    for split in ("train", "dev", "test"):
        cfg["data"][split] = str(data / split)
    cfg["data"]["trg"]["voc_file"] = str(data / "trg_vocab.txt")
    cfg["training"].update(updates=16, validation_freq=8, logging_freq=4,
                           load_encoder=str(encoder_ckpt))
    check(cfg["use_cuda"] and cfg["fp16"] and cfg["training"]["batch_size"] == 64
          and cfg["testing"]["beam_size"] == 5 and cfg["testing"]["eval_metrics"] == ["bleu"]
          and cfg["training"]["early_stopping_metric"] == "bleu"
          and cfg["model"]["encoder"]["num_layers"] == 12
          and cfg["model"]["decoder"]["num_layers"] == 6, "unexpected synthetic_st config")
    return cfg


def st_phase(encoder_ckpt: Path) -> dict:
    """Phase 8: the speech-translation leg through ``python -m joeys2t_torch
    {train,test,translate}`` at full width in bf16, its 12-layer encoder
    loaded from phase 7's 16-layer ASR checkpoint (12 layers load, 4 are
    ignored), BLEU in validation and early stopping, beam 5 in ``test`` and
    ``translate``, every attention through the kernels with exact launch
    counts. Cuts: the corpus (512 / 64 / 64 generated utterances) and 16
    updates, as phase 7; the widths are the config's."""
    from joeys2t_torch.config import dump_yaml

    work = REPO / "build" / "chip_smoke"
    data = work / "synthetic_st"
    t0 = time.time()
    subprocess.run([sys.executable, str(REPO / "scripts" / "generate_synthetic_st.py"),
                    "--out", str(data), "--train", "512", "--dev", "64", "--test", "64"],
                   check=True, capture_output=True, timeout=600)
    print(f"[st] corpus: 512 / 64 / 64 utterances in {time.time() - t0:.1f} s")
    model_dir = work / "st_model"
    cfg_path = work / "st.yaml"
    cfg_path.write_text(dump_yaml(st_config(data, model_dir, encoder_ckpt)),
                        encoding="utf-8")
    n_enc, n_dec = 12, 6
    with plain_refused("speech-translation path"):
        train_wall, lines, _, train_n = cli_run(["train", cfg_path])
        test_wall, test_lines, _, test_n = cli_run(["test", cfg_path, "-o", work / "st_out"])
        feats = sorted((data / "feats").glob("test-*.npy"))[:8]
        tr_wall, tr_lines, tr_out, tr_n = cli_run(["translate", cfg_path],
                                                  stdin="".join(f"{p}\n" for p in feats))
    log = "\n".join(lines)
    loaded = re.search(r"partial_load\(encoder\): (\d+) tensors loaded, (\d+) kept at init "
                       r"\(missing in ckpt\), (\d+) ckpt tensors ignored \(not in model\); "
                       r"(\d+) layers loaded, (\d+) layers ignored", log)
    check(loaded is not None and loaded.group(4, 5) == ("12", "4") and loaded.group(2) == "0",
          f"load_encoder: {loaded.group(0) if loaded else 'no partial_load line'}")
    valid = (model_dir / "validations.txt").read_text().splitlines()
    bleus = [float(m.group(1)) for m in (re.search(r"\tbleu: ([\d.]+)\t", v) for v in valid)
             if m]
    check(len(valid) == 2 and len(bleus) == 2, f"validations.txt: {valid}")
    best = 8 * (1 + bleus.index(max(bleus)))  # the first of the highest scores
    check(os.readlink(model_dir / "best.ckpt") == f"{best}.ckpt",
          f"best.ckpt -> {os.readlink(model_dir / 'best.ckpt')}, BLEU {bleus}")
    check("Beam search with beam_size=5" in "\n".join(test_lines), "test did not run beam 5")
    losses = [float(m.group(1)) for m in (re.search(r"Batch Loss: +([-\d.einfa]+)", ln)
                                          for ln in lines) if m]
    check(len(losses) == 4 and all(np.isfinite(losses)), f"training losses {losses}")
    for name in ("best.hyps.dev", "best.hyps.test"):
        n = len((model_dir / name).read_text(encoding="utf-8").splitlines())
        check(n == 64, f"{name}: {n} hypotheses, expected 64")
    hyps = tr_out.splitlines()
    check(len(hyps) == 8 and hyps == (work / "st_out.test").read_text(
        encoding="utf-8").splitlines()[:8], f"translate printed {tr_out!r}")
    gens = generations(lines)
    check(len(gens) == 4, f"train logged {len(gens)} predict calls, expected 2 + 2")
    expected = cli_launches(n_enc, n_dec, 16, gens[:2], gens[2:])
    check(train_n == expected, f"st train launches {train_n}, expected {expected}")
    for name, run_lines, counts in (("test", test_lines, test_n),
                                    ("translate", tr_lines, tr_n)):
        want = cli_launches(n_enc, n_dec, 0, [], generations(run_lines))
        check(counts == want, f"st {name} launches {counts}, expected {want}")
    loop = re.search(r"Training loop: 16 update\(s\) in ([\d.]+)\[sec\] besides validation "
                     r"\(([\d.]+)\[sec\] per update\).*validation ([\d.]+)\[sec\]", log)
    check(loop is not None, "no training-loop summary")
    dev_gen = generations(test_lines)[0]
    dev_audio = manifest_audio_s(data / "dev.tsv")
    print(f"[st] train: 16 updates of 64 utterances, encoder from the ASR checkpoint "
          f"({loaded.group(1)} tensors, {loaded.group(4)} layers loaded, "
          f"{loaded.group(5)} layers ignored), 2 validations; {train_wall:.2f} s wall in "
          f"all; {float(loop.group(2)) * 1e3:.2f} ms per update; losses "
          f"{[round(x, 4) for x in losses]}; BLEU {bleus}, best.ckpt -> {best}.ckpt")
    print(f"[st] validation {float(loop.group(3)) / 2:.3f} s wall each (eval loss + "
          f"greedy); test {test_wall:.3f} s wall (dev + test, beam 5), dev decode "
          f"{dev_gen[0]:.3f} s = {dev_audio / dev_gen[0]:.1f} audio-s/s over {dev_gen[2]} "
          f"steps; translate 8 paths {tr_wall:.3f} s")
    print(f"[st] launches: train {train_n}, test {test_n}, translate {tr_n}; each as the "
          f"path implies; plain attention never ran")
    return {name: train_n[name] + test_n[name] + tr_n[name] for name in train_n}


# ------------------------------------------------------------------ phase 9
def token_share(texts, reference) -> float:
    """Share of the reference transcripts' words that the other transcripts
    repeat at the same position."""
    same = total = 0
    for a, b in zip(texts, reference):
        a, b = a.split(), b.split()
        same += sum(x == y for x, y in zip(a, b))
        total += max(len(a), len(b))
    return same / max(total, 1)


def int8_phase(batch, bf16):
    """Phase 9: the librispeech_100h model of phase 3 (the same seeded
    weights, bf16) with ``cache_cross_int8`` and ``cache_self_int8``, served
    through ``Transcriber``: greedy 64 x 10 s (96 steps) and beam 5 over 32
    x 10 s (length penalty 1), each with the counters zeroed just before and
    the plain versions refused: 16 decode launches a step, all int8 (8 with
    channel scales on the cross caches, 8 with position scales on the self
    ring buffers; in beam the 8 cross launches take 5 queries a cache row),
    and 16 flash launches (the encoder). Decode attention is then held
    against its plain version on the inputs of a first and a later call of
    each kind; audio-s/s and K5's device ms a step (16 profiled steps) stand
    beside phase 3's bf16 requests, with the share of words equal to theirs
    (reported, not checked: int8 changes the numerics). Last, a small float32
    model with both int8 caches gives the same greedy tokens and beam-5
    2-best hypotheses on the card and on the CPU. ``bf16`` holds phase 3's
    {request: (texts, wall s, steps, K5 ms a step)}."""
    from joeys2t_torch.config import SpecialSymbols, load_config
    from joeys2t_torch.models import build_model
    from joeys2t_torch.ops.frontend import device_frontend
    from joeys2t_torch.search import beam_search, transformer_greedy
    from joeys2t_torch.serving import Transcriber
    from joeys2t_torch.vocabulary import Vocabulary

    cfg = dict(load_config(REPO / "configs" / "librispeech_100h.yaml")["model"],
               cache_cross_int8=True, cache_self_int8=True)
    vocab = Vocabulary([f"w{i}" for i in range(4996)], SpecialSymbols())
    model, spec = build_model(cfg, trg_vocab=vocab, compute_dtype=torch.bfloat16,
                              device="cuda", generator=torch.Generator().manual_seed(0))
    asr = Transcriber(model, spec, vocab, device="cuda")
    n_enc, n_dec = len(model.encoder.layers), len(model.decoder.layers)
    asr.transcribe(batch[:2], max_output_length=4)  # warm-up
    asr.transcribe(batch[:2], max_output_length=4, beam_size=5)
    requests = [("greedy 64 x 10 s", 64, {}), ("beam 5 32 x 10 s", 32,
                                               dict(beam_size=5, beam_alpha=1.0))]
    kept, results = {}, {}
    for name, n, kw in requests:
        s0 = asr.stats["decode_steps"]
        zero_counters()
        with plain_refused(f"int8 {name} path"), kernel_inputs(kept):
            texts, wall = sync_time(lambda: asr.transcribe(batch[:n], max_output_length=96,
                                                           **kw))
        launches = read_counters()
        steps = asr.stats["decode_steps"] - s0
        check(len(texts) == n and all(isinstance(t, str) for t in texts),
              f"int8 {name}: not {n} transcripts")
        check(1 <= steps <= 96, f"int8 {name}: {steps} decode steps")
        want = {"flash_attention_fwd": n_enc, "flash_attention_bwd": 0,
                "decode_attention": 2 * n_dec * steps,
                "decode_attention_group": n_dec * steps if kw else 0,
                "decode_attention_int8_channel": n_dec * steps,
                "decode_attention_int8_position": n_dec * steps}
        check(launches == want, f"int8 {name} launches {launches}, expected {want}")
        results[name] = (texts, wall, steps, launches)
    checks = cli_kernel_checks(kept, names=("flash_attention_fwd", "decode_attention"),
                               tag="int8")
    for kind in ("channel", "position"):
        check(any(f"int8 {kind}" in c["case"] for c in checks["decode_attention"]),
              f"no int8 {kind} decode input was checked")
    del kept

    waves = torch.tensor(np.stack(batch)).cuda()
    with torch.inference_mode():
        for name, n, kw in requests:
            feats, flen = device_frontend(waves[:n], torch.full((n,), waves.shape[1],
                                                                device="cuda"))
            enc, _, mask = asr.model.encode(feats, flen)
            pstats = {}
            if kw:
                run = lambda: beam_search(asr.decode_model, spec, enc, None, mask, 5, 16,  # noqa: E731
                                          1.0, device="cuda", stats=pstats)
            else:
                run = lambda: transformer_greedy(asr.decode_model, spec, enc, mask, 16,  # noqa: E731
                                                 device="cuda", stats=pstats)
            wall, kernels = profiled(run)
            k5_ms = decode_profile("int8", f"int8 {name.split()[0]} loop", asr, wall, kernels,
                                   pstats["decode_steps"])
            texts, wall, steps, launches = results[name]
            ref_texts, ref_wall, ref_steps, ref_k5 = bf16[name]
            audio = 10.0 * n
            print(f"[int8] {name}: {steps} steps, {wall:.3f} s wall = {audio / wall:.1f} "
                  f"audio-s/s (bf16 caches, phase 3: {audio / ref_wall:.1f}); K5 "
                  f"{'not measured' if k5_ms is None else f'{k5_ms:.4f}'} ms a step "
                  f"(bf16: {'not measured' if ref_k5 is None else f'{ref_k5:.4f}'}); "
                  f"{100 * token_share(texts, ref_texts):.1f} % of the words equal the "
                  f"bf16 request's; launches {launches} as the path implies, plain "
                  f"attention never ran")
    del asr, model, waves

    # both devices decode from the CPU's encoder output: the card's differs in
    # its last bits, and each such difference can round a cross-cache value
    # one int8 step the other way; so can the decode step's own projections,
    # which is what the score tolerance allows for (one step of one cached
    # value moved a beam score by 3.5e-4 in the CPU tests against JAX)
    models, _, _, (feats, flen) = small_models(cache_cross_int8=True, cache_self_int8=True)
    c0 = read_counters()
    _, score_err, cpu = decode_on_both(models, feats, flen, cpu_encoder_output=True)
    c1 = read_counters()
    check(all(c1[k] > c0[k] for k in ("decode_attention_int8_channel",
                                       "decode_attention_int8_position")),
          "the small int8 model's card run did not launch the int8 decode kernels")
    check(score_err <= 1e-3, f"int8 beam scores differ between card and CPU by {score_err}")
    print(f"[int8] card vs CPU, f32 2+2 layers hidden 256 with both int8 caches, from one "
          f"encoder output: greedy tokens identical ({cpu[2].shape[1]} steps), beam 5 "
          f"2-best hypotheses identical, scores err {score_err:.3g} (tol 1e-3)")
    return {name: r[3] for name, r in results.items()}, checks


# ----------------------------------------------------------------- phase 10
def check_cli_leg(tag: str, runs: dict, n_enc: int, n_dec: int, updates: int,
                  validations: int, beam: bool = True) -> dict:
    """The exact launches of a leg's ``train``, ``test`` and ``translate``
    (``runs``: name -> (wall, log lines, stdout, launches)), by
    ``cli_launches`` from the ``predict`` calls each logged. Returns the
    launches of the three runs summed."""
    gens = generations(runs["train"][1])
    check(len(gens) == validations + 2,
          f"{tag} train logged {len(gens)} predict calls, expected {validations} + 2")
    want = cli_launches(n_enc, n_dec, updates, gens[:validations], gens[validations:],
                        beam)
    check(runs["train"][3] == want, f"{tag} train launches {runs['train'][3]}, "
          f"expected {want}")
    for name in ("test", "translate"):
        want = cli_launches(n_enc, n_dec, 0, [], generations(runs[name][1]), beam)
        check(runs[name][3] == want, f"{tag} {name} launches {runs[name][3]}, "
              f"expected {want}")
    return {name: sum(r[3][name] for r in runs.values()) for name in runs["train"][3]}


def update_ms(lines) -> float:
    """ms an update of a ``train`` run, from its ``Training loop`` line."""
    loop = re.search(r"Training loop: \d+ update\(s\) in [\d.]+\[sec\] besides "
                     r"validation \(([\d.]+)\[sec\] per update\)", "\n".join(lines))
    check(loop is not None, "no training-loop summary")
    return float(loop.group(1)) * 1e3


def spm_phase(data: Path) -> dict:
    """Phase 10: configs/synthetic_asr.yaml at full width in bf16 with its
    targets switched to ``level: bpe, tokenizer_type: sentencepiece``, on
    phase 7's corpus, the SentencePiece model a unigram model of 300 pieces
    that ``joeys2t_torch.tools.spm_fixture`` draws from the (lowercased)
    train transcripts, the ``voc_file`` its pieces: ``train`` (cut to 4
    updates and one validation, fewer than phase 7's 16 and 2), ``test -o``
    and ``translate`` of 8 paths with the config's beam 5, then
    ``load_model_dir`` of the model directory and ``Transcriber.from_hub``
    serving 8 speech-like waveforms. The model file must be in the model
    directory, every hypothesis detokenized text (no '▁'; empty where the
    model emitted space pieces alone), the hub's
    ``generate`` equal to ``translate``, the launch counts exact with the
    plain versions refused, and each kernel equal to its plain version on
    the inputs the path gave it."""
    from joeys2t_torch.config import dump_yaml
    from joeys2t_torch.hub_interface import load_model_dir
    from joeys2t_torch.serving import Transcriber
    from joeys2t_torch.tokenizers import SentencePieceTokenizer
    from joeys2t_torch.tools import spm_fixture

    work = REPO / "build" / "chip_smoke"
    model_dir = work / "spm_model"
    rows = (data / "train.tsv").read_text(encoding="utf-8").splitlines()
    col = rows[0].split("\t").index("trg")
    pieces = spm_fixture.corpus_pieces([r.split("\t")[col].lower() for r in rows[1:]], 300)
    model_file = spm_fixture.write_model(work / "spm_unigram300.model", pieces, "unigram")
    cfg = cli_config(data, model_dir)
    cfg["data"]["trg"].update(level="bpe", tokenizer_type="sentencepiece",
                              voc_file=str(spm_fixture.write_vocab(work / "spm_vocab.txt",
                                                                   pieces)),
                              tokenizer_cfg={"model_file": str(model_file)})
    cfg["training"].update(updates=4, validation_freq=4)
    cfg_path = work / "spm.yaml"
    cfg_path.write_text(dump_yaml(cfg), encoding="utf-8")
    n_enc, n_dec = 16, 8
    feats = sorted((data / "feats").glob("test-*.npy"))[:8]
    kept, runs = {}, {}
    with plain_refused("SentencePiece CLI path"), kernel_inputs(kept):
        runs["train"] = cli_run(["train", cfg_path])
        runs["test"] = cli_run(["test", cfg_path, "-o", work / "spm_out"])
        runs["translate"] = cli_run(["translate", cfg_path],
                                    stdin="".join(f"{p}\n" for p in feats))
        launches = check_cli_leg("spm", runs, n_enc, n_dec, 4, 1)

        hub = load_model_dir(model_dir)
        zero_counters()
        generated = hub.generate([str(p) for p in feats])
        hub_n = read_counters()
        asr = Transcriber.from_hub(hub)
        rng = np.random.RandomState(10)
        waves = [speechlike(rng, n) for n in (32000, 40000, 24000, 48000) * 2]
        s0 = asr.stats["decode_steps"]
        zero_counters()
        texts, wall = sync_time(lambda: asr.transcribe(waves, max_output_length=48))
        serve_n = read_counters()
    checks = cli_kernel_checks(kept, tag="spm")
    del kept
    steps = asr.stats["decode_steps"] - s0
    want = {"flash_attention_fwd": n_enc, "flash_attention_bwd": 0,
            "decode_attention": 2 * n_dec * steps, "decode_attention_group": 0,
            "decode_attention_int8_channel": 0, "decode_attention_int8_position": 0}
    check(serve_n == want, f"spm serving launches {serve_n}, expected {want}")
    check(hub_n["flash_attention_fwd"] == n_enc and hub_n["decode_attention_group"] > 0,
          f"hub generate launches {hub_n}")
    check((model_dir / model_file.name).read_bytes() == model_file.read_bytes(),
          "train did not copy the SentencePiece model into the model directory")
    translated = runs["translate"][2].splitlines()
    check(generated == translated and len(translated) == 8,
          f"hub generate {generated} differs from translate {translated}")
    hyps = [h for split in ("dev", "test")
            for h in (work / f"spm_out.{split}").read_text(encoding="utf-8").splitlines()]
    for name, out in (("test", hyps), ("translate", translated), ("Transcriber", texts)):
        # an empty transcript is text too: the 8-update model may emit space
        # pieces alone
        check(all(isinstance(t, str) and "▁" not in t for t in out),
              f"spm {name}: not detokenized text: {out[:3]}")
    check(isinstance(asr.tokenizer, SentencePieceTokenizer) and asr.norm_means
          and asr.norm_vars, "Transcriber.from_hub took no SentencePiece tokenizer or "
          "not the config's CMVN flags")
    for name in ("flash_attention_fwd", "flash_attention_bwd", "decode_attention",
                 "decode_attention_group"):
        launches[name] += hub_n[name] + serve_n[name]
    print(f"[spm] train (4 updates, 1 validation) {runs['train'][0]:.2f} s, "
          f"{update_ms(runs['train'][1]):.2f} ms an update; test {runs['test'][0]:.2f} s; "
          f"translate 8 paths {runs['translate'][0]:.2f} s; {len(pieces) - 3} "
          f"SentencePiece pieces, model copied into the model directory; e.g. "
          f"{translated[0][:60]!r}")
    print(f"[spm] load_model_dir -> generate equals translate; Transcriber.from_hub: 8 "
          f"waveforms, {steps} greedy steps, {wall:.3f} s; e.g. {texts[0][:60]!r}; "
          f"launches {launches} as the path implies, plain attention never ran")
    return launches, checks


# ----------------------------------------------------------------- phase 11
def conformer_phase(data: Path, transformer_update_ms: float) -> dict:
    """Phase 11: configs/synthetic_asr_conformer.yaml, read by the port's
    YAML reader, at full width in bf16 (16 conformer layers of hidden 512,
    depthwise kernel 31, macaron "paper", LayerScale 0.1; 8 decoder layers)
    on phase 7's corpus through ``train`` (8 updates and one validation,
    half of phase 7's), ``test -o`` and ``translate`` of 8 paths (beam 5):
    exact launch counts (24 flash forward and 24 backward a micro-batch)
    with the plain versions refused, each kernel equal to its plain version
    on the path's inputs, and a float32 ``test`` of the trained checkpoint
    cut to 2 + 2 layers identical on the card and on the CPU; ms an update
    beside phase 7's transformer."""
    from joeys2t_torch.checkpoints import load_checkpoint
    from joeys2t_torch.config import dump_yaml, load_config

    work = REPO / "build" / "chip_smoke"
    model_dir = work / "conformer_model"
    cfg = load_config(REPO / "configs" / "synthetic_asr_conformer.yaml")
    cfg["model_dir"] = str(model_dir)
    for split in ("train", "dev", "test"):
        cfg["data"][split] = str(data / split)
    cfg["data"]["trg"]["voc_file"] = str(data / "char.txt")
    cfg["training"].update(updates=8, validation_freq=8, logging_freq=4)
    enc = cfg["model"]["encoder"]
    check(cfg["fp16"] and enc["type"] == "conformer" and enc["num_layers"] == 16
          and enc["hidden_size"] == 512 and enc["depthwise_conv_kernel_size"] == 31
          and enc["macaron"] == "paper" and enc["layerscale"] == 0.1
          and cfg["model"]["decoder"]["num_layers"] == 8
          and cfg["data"]["src"]["tokenizer_cfg"]["specaugment"]["time_mask_t"] == 40,
          "unexpected synthetic_asr_conformer config")
    cfg_path = work / "conformer.yaml"
    cfg_path.write_text(dump_yaml(cfg), encoding="utf-8")
    feats = sorted((data / "feats").glob("test-*.npy"))[:8]
    kept, runs = {}, {}
    with plain_refused("Conformer CLI path"), kernel_inputs(kept):
        runs["train"] = cli_run(["train", cfg_path])
        runs["test"] = cli_run(["test", cfg_path, "-o", work / "conformer_out"])
        runs["translate"] = cli_run(["translate", cfg_path],
                                    stdin="".join(f"{p}\n" for p in feats))
    launches = check_cli_leg("conformer", runs, 16, 8, 8, 1)
    checks = cli_kernel_checks(kept, tag="conformer")
    del kept
    valid = (model_dir / "validations.txt").read_text().splitlines()
    check(len(valid) == 1, f"conformer validations.txt: {valid}")
    losses = [float(m.group(1)) for m in (re.search(r"Batch Loss: +([-\d.einfa]+)", ln)
                                          for ln in runs["train"][1]) if m]
    check(len(losses) == 2 and all(np.isfinite(losses)), f"conformer losses {losses}")
    state = load_checkpoint(model_dir / "latest.ckpt")["model_state"]
    check(all(v.dtype == torch.float32 for v in state.values())
          and "encoder.layers.15.ls_conv" in state, "conformer checkpoint")
    for split in ("dev", "test"):
        n = len((work / f"conformer_out.{split}").read_text(encoding="utf-8").splitlines())
        check(n == 64, f"conformer out.{split}: {n} hypotheses")
    cut_test_on_both(cfg, state, model_dir, data, work / "conformer_cut")
    ms = update_ms(runs["train"][1])
    print(f"[conformer] train: 8 updates, 1 validation, {runs['train'][0]:.2f} s wall; "
          f"{ms:.2f} ms an update (the transformer of phase 7: "
          f"{transformer_update_ms * 1e3:.2f}); losses {[round(x, 4) for x in losses]}; "
          f"test {runs['test'][0]:.2f} s (beam 5), translate 8 paths "
          f"{runs['translate'][0]:.2f} s")
    print(f"[conformer] launches {launches} as the path implies, plain attention never "
          f"ran; float32 test at 2 + 2 layers: card and CPU hypotheses identical")
    return launches, checks


# ----------------------------------------------------------------- phase 12
def loop_stats(lines) -> tuple:
    """(updates, loop s, s an update, data pipeline s, its share of the loop
    %) from the ``Training loop`` line of a ``train`` run."""
    loop = re.search(r"Training loop: (\d+) update\(s\) in ([\d.]+)\[sec\] besides "
                     r"validation \(([\d.]+)\[sec\] per update\), ([\d.]+)\[sec\] "
                     r"\(([\d.]+) %\) of it in the data pipeline", "\n".join(lines))
    check(loop is not None, "no training-loop summary")
    return (int(loop.group(1)),) + tuple(float(loop.group(i)) for i in range(2, 6))


def window_rate(lines, step: int) -> float:
    """Target tokens a second of the training window that the ``train``
    log's line at update ``step`` closes (validation excluded)."""
    found = (re.search(r"Step: +(\d+), .*Tokens per Sec: +(\d+)", ln) for ln in lines)
    rates = {int(x.group(1)): float(x.group(2)) for x in found if x}
    check(step in rates, f"no training log line at update {step}")
    return rates[step]


def mt_corpus(data: Path) -> None:
    """Phase 12's corpus: 4096 / 64 / 64 sentence pairs into ``data``."""
    subprocess.run([sys.executable, str(REPO / "scripts" / "generate_synthetic_mt.py"),
                    "--out", str(data), "--train", "4096", "--dev", "64", "--test", "64"],
                   check=True, capture_output=True, timeout=600)


def mt_config(data: Path, model_dir: Path) -> dict:
    """configs/synthetic_mt.yaml as phase 12 cuts it: the corpus in ``data``,
    16 updates of 192 sentences, a validation every 8, logging every 4; full
    width, bf16, tied softmax, beam 5, on the card."""
    from joeys2t_torch.config import load_config

    cfg = load_config(REPO / "configs" / "synthetic_mt.yaml")
    cfg["model_dir"] = str(model_dir)
    for split in ("train", "dev", "test"):
        cfg["data"][split] = str(data / split)
    cfg["training"].update(updates=16, validation_freq=8, logging_freq=4)
    m = cfg["model"]
    check(cfg["use_cuda"] and cfg["fp16"] and cfg["task"] == "MT"
          and cfg["data"]["dataset_type"] == "plain"
          and cfg["training"]["batch_size"] == 192 and cfg["testing"]["beam_size"] == 5
          and m["tied_softmax"] and m["encoder"]["num_layers"] == 8
          and m["decoder"]["num_layers"] == 8 and m["encoder"]["hidden_size"] == 512
          and m["encoder"]["num_heads"] == 4, "unexpected synthetic_mt config")
    return cfg


def cut_mt_test_on_both(cfg: dict, state: dict, model_dir: Path, data: Path,
                        cut: Path) -> None:
    """A float32 ``test`` of the trained checkpoint ``state`` cut to 2 + 2
    layers on the first 8 dev sentences of ``data``, on the card and on the
    CPU: the hypotheses must be identical."""
    from joeys2t_torch.config import dump_yaml

    cut.mkdir(exist_ok=True)
    for side in ("src", "trg"):
        lines = (data / f"dev.{side}").read_text(encoding="utf-8").splitlines()[:8]
        (data / f"dev8.{side}").write_text("\n".join(lines) + "\n", encoding="utf-8")
        shutil.copy(model_dir / f"{side}_vocab.txt", cut / f"{side}_vocab.txt")
    keep = re.compile(r"(encoder|decoder)\.layers\.(\d+)\.")
    torch.save({"model_state": {k: v for k, v in state.items()
                                if not keep.match(k) or int(keep.match(k).group(2)) < 2}},
               cut / "best.ckpt")
    cut_cfg = dict(cfg, fp16=False, model_dir=str(cut))
    cut_cfg["data"] = {k: v for k, v in cfg["data"].items() if k not in ("train", "test")}
    cut_cfg["data"]["dev"] = str(data / "dev8")
    cut_cfg["model"] = {**cfg["model"],
                        "encoder": dict(cfg["model"]["encoder"], num_layers=2),
                        "decoder": dict(cfg["model"]["decoder"], num_layers=2)}
    outs = {}
    for use_cuda in (True, False):
        path = cut / f"cut_{use_cuda}.yaml"
        path.write_text(dump_yaml(dict(cut_cfg, use_cuda=use_cuda)), encoding="utf-8")
        cli_run(["test", path, "-o", cut / f"out_{use_cuda}"])
        outs[use_cuda] = (cut / f"out_{use_cuda}.dev").read_text(encoding="utf-8")
    check(outs[True] == outs[False] and len(outs[True].splitlines()) == 8,
          f"float32 MT hypotheses differ between card and CPU:\n{outs[True]}\n{outs[False]}")


def mt_prompt_leg(cfg: dict, data: Path, work: Path, n_enc: int, n_dec: int) -> dict:
    """Forced prompts on phase 12's model shape: a copy of the config with a
    sep token and two language tags, prompt files written beside the
    corpus (``<en>`` before each source, ``<de>`` and the reference's first
    word before each target), ``train`` (4 updates, one validation), then
    ``load_model_dir`` -> ``score`` (beam 5) and ``generate`` (greedy) of 8
    sentences with their prompts, the repetition penalty and n-gram
    blocking: every hypothesis starts with its forced prompt and <sep>, the
    text has none of it, the launches are as the path implies."""
    from joeys2t_torch.config import dump_yaml
    from joeys2t_torch.hub_interface import load_model_dir

    pdata = work / "synthetic_mt_prompts"
    pdata.mkdir(exist_ok=True)
    for split in ("train", "dev", "test"):
        for side in ("src", "trg"):
            shutil.copy(data / f"{split}.{side}", pdata / f"{split}.{side}")
        trg = (data / f"{split}.trg").read_text(encoding="utf-8").splitlines()
        (pdata / f"{split}.src_prompt").write_text("<en>\n" * len(trg), encoding="utf-8")
        (pdata / f"{split}.trg_prompt").write_text(
            "".join(f"<de> {t.split()[0]}\n" for t in trg), encoding="utf-8")
    pcfg = json.loads(json.dumps(cfg))
    pcfg["model_dir"] = str(work / "mt_prompt_model")
    for split in ("train", "dev", "test"):
        pcfg["data"][split] = str(pdata / split)
    pcfg["data"]["special_symbols"].update(sep_token="<sep>", sep_id=4,
                                           lang_tags=["<en>", "<de>"])
    pcfg["training"].update(updates=4, validation_freq=4, logging_freq=4)
    path = work / "mt_prompt.yaml"
    path.write_text(dump_yaml(pcfg), encoding="utf-8")
    train_wall, lines, _, train_n = cli_run(["train", path, "--skip-test"])
    gens = generations(lines)
    want = cli_launches(n_enc, n_dec, 4, gens, [])
    check(len(gens) == 1 and train_n == want, f"prompted train launches {train_n}, "
          f"expected {want}")
    srcs = (pdata / "test.src").read_text(encoding="utf-8").splitlines()[:8]
    refs = (pdata / "test.trg").read_text(encoding="utf-8").splitlines()[:8]
    src_prompt, trg_prompt = ["<en>"] * 8, [f"<de> {r.split()[0]}" for r in refs]
    hub = load_model_dir(pcfg["model_dir"])
    controls = dict(repetition_penalty=1.2, no_repeat_ngram_size=3)
    zero_counters()
    scored = hub.score(srcs, src_prompt=src_prompt, trg_prompt=trg_prompt, **controls)
    beam_n = read_counters()
    zero_counters()
    greedy = hub.generate(srcs, src_prompt=src_prompt, trg_prompt=trg_prompt, beam_size=1,
                          **controls)
    greedy_n = read_counters()
    vocab = hub.dataset.trg_vocab
    for out, prompt in zip(scored, trg_prompt):
        forced = vocab.arrays_to_sentences([[vocab.lookup(t) for t in prompt.split()]
                                            + [vocab.sep_index]])[0]
        check(out.tokens[0][:3] == forced, f"beam hypothesis {out.tokens[0]} does not "
              f"start with its prompt {forced}")
        check("<sep>" not in out.translation[0] and "<de>" not in out.translation[0],
              f"the prompt was not cut from {out.translation[0]!r}")
    check(len(greedy) == 8 and all("<sep>" not in g for g in greedy),
          f"greedy prompted hypotheses {greedy}")
    for name, n, group in (("beam", beam_n, True), ("greedy", greedy_n, False)):
        steps = n["decode_attention"] // (2 * n_dec)
        check(n["flash_attention_fwd"] == n_enc and n["flash_attention_bwd"] == 0
              and steps > 2 and n["decode_attention"] == 2 * n_dec * steps
              and n["decode_attention_group"] == (n_dec * steps if group else 0),
              f"prompted {name} launches {n}")
    print(f"[mt] prompts: sep + 2 language tags, prompt files beside the corpus; train 4 "
          f"updates {train_wall:.2f} s; load_model_dir -> score (beam 5) and generate "
          f"(greedy) with repetition_penalty 1.2 and no_repeat_ngram_size 3: every "
          f"hypothesis forced to its prompt, e.g. {scored[0].tokens[0][:6]} -> "
          f"{scored[0].translation[0][:40]!r}; launches beam {beam_n}, greedy {greedy_n}")
    return {name: train_n[name] + beam_n[name] + greedy_n[name] for name in train_n}


def mt_phase() -> tuple:
    """Phase 12: configs/synthetic_mt.yaml at full width in bf16 (8 + 8
    layers, hidden 512, 4 heads of 128, tied softmax) on
    scripts/generate_synthetic_mt.py's corpus (4096 / 64 / 64 pairs) through
    ``train`` (16 updates of 192 sentences, a validation every 8), ``test
    -o`` and ``translate`` of 8 sentences (beam 5) with exact launch counts
    and the plain versions refused, ``load_model_dir`` -> ``generate`` equal
    to ``translate``, the prompt leg (``mt_prompt_leg``), each kernel held
    against its plain version on the path's inputs, and a float32 ``test``
    of the checkpoint cut to 2 + 2 layers identical on card and CPU; ms an
    update, the data pipeline's share and test sentences a second."""
    from joeys2t_torch.checkpoints import load_checkpoint
    from joeys2t_torch.config import dump_yaml
    from joeys2t_torch.hub_interface import load_model_dir

    work = REPO / "build" / "chip_smoke"
    data = work / "synthetic_mt"
    t0 = time.time()
    mt_corpus(data)
    print(f"[mt] corpus: 4096 / 64 / 64 sentence pairs in {time.time() - t0:.1f} s")
    model_dir = work / "mt_model"
    cfg = mt_config(data, model_dir)
    cfg_path = work / "mt.yaml"
    cfg_path.write_text(dump_yaml(cfg), encoding="utf-8")
    n_enc = n_dec = 8
    srcs = (data / "test.src").read_text(encoding="utf-8").splitlines()[:8]
    kept, runs = {}, {}
    with plain_refused("MT CLI path"), kernel_inputs(kept):
        runs["train"] = cli_run(["train", cfg_path])
        runs["test"] = cli_run(["test", cfg_path, "-o", work / "mt_out"])
        runs["translate"] = cli_run(["translate", cfg_path],
                                    stdin="".join(f"{s}\n" for s in srcs))
        launches = check_cli_leg("mt", runs, n_enc, n_dec, 16, 2)
        hub = load_model_dir(model_dir)
        zero_counters()
        generated = hub.generate(srcs)
        hub_n = read_counters()
        # kernels a decode step and the card's busy share over a profiled
        # generate cut to 16 steps (the profiler's own cost grows with them)
        per_step = {}
        for name, beam in (("greedy", 1), ("beam 5", 5)):
            zero_counters()
            wall, kernels = profiled(lambda b=beam: hub.generate(
                srcs, beam_size=b, max_output_length=16))
            steps = read_counters()["decode_attention"] // (2 * n_dec)
            per_step[name] = (sum(n for n, _ in kernels.values()) / steps, steps,
                              sum(t for _, t in kernels.values()) / 1e4 / wall, wall)
        prompt_n = mt_prompt_leg(cfg, data, work, n_enc, n_dec)
    checks = cli_kernel_checks(kept, tag="mt")
    del kept, hub
    translated = runs["translate"][2].splitlines()
    check(generated == translated and len(translated) == 8,
          f"hub generate {generated} differs from translate {translated}")
    check(hub_n["flash_attention_fwd"] == n_enc and hub_n["decode_attention_group"] > 0,
          f"hub generate launches {hub_n}")
    for name in launches:
        launches[name] += hub_n[name] + prompt_n[name]
    valid = (model_dir / "validations.txt").read_text().splitlines()
    bleus = [float(m.group(1)) for m in (re.search(r"\tbleu: ([\d.]+)\t", v)
                                         for v in valid) if m]
    check(len(valid) == 2 and len(bleus) == 2, f"mt validations.txt: {valid}")
    losses = [float(m.group(1)) for m in (re.search(r"Batch Loss: +([-\d.einfa]+)", ln)
                                          for ln in runs["train"][1]) if m]
    check(len(losses) == 4 and all(np.isfinite(losses)), f"mt losses {losses}")
    state = load_checkpoint(model_dir / "latest.ckpt")["model_state"]
    check(all(v.dtype == torch.float32 for v in state.values())
          and "decoder.output_layer.weight" not in state
          and "src_embed.lut.weight" in state, "mt checkpoint")
    for split in ("dev", "test"):
        n = len((work / f"mt_out.{split}").read_text(encoding="utf-8").splitlines())
        check(n == 64, f"mt out.{split}: {n} hypotheses")
    cut_mt_test_on_both(cfg, state, model_dir, data, work / "mt_cut")
    updates, loop_s, per_update, data_s, share = loop_stats(runs["train"][1])
    test_gen = generations(runs["test"][1])[0]  # the dev set in `test`
    print(f"[mt] train: 16 updates of 192 sentences, 2 validations (BLEU {bleus}), "
          f"{runs['train'][0]:.2f} s wall; losses {[round(x, 4) for x in losses]}")
    print(f"[mt] MT training loop: {per_update * 1e3:.2f} ms per update, the host data "
          f"pipeline (read, tokenize, sampler, collate, upload) {data_s / updates * 1e3:.2f} "
          f"ms a batch, {share:.2f} % of the loop's wall ({data_s:.3f} s of {loop_s:.3f} "
          f"s); test: dev decode {test_gen[0]:.3f} s = {64 / test_gen[0]:.1f} sentences/s "
          f"over {test_gen[2]} beam-5 steps ({test_gen[1]} batch); translate 8 sentences "
          f"{runs['translate'][0]:.3f} s")
    print("[mt] decode of 8 sentences through generate, 16 steps, profiled: " + "; ".join(
        f"{name}: {k:.1f} kernels a step over {n} steps (the encoder and cache set-up "
        f"included), the card busy {busy:.1f} % of {wall:.3f} s"
        for name, (k, n, busy, wall) in per_step.items()))
    print(f"[mt] launches {launches} as the paths imply, plain attention never ran; "
          f"load_model_dir -> generate equals translate; float32 test at 2 + 2 layers: "
          f"card and CPU hypotheses identical")
    return launches, checks, per_update, window_rate(runs["train"][1], 8)


# ----------------------------------------------------------------- phase 13
def reverse_dev_cut(work: Path) -> Path:
    """The first 100 pairs of test/data/reverse/dev, as phases 13 and 14
    validate on them."""
    data, cut = REPO / "test" / "data" / "reverse", work / "reverse_dev100"
    for side in ("src", "trg"):
        lines = (data / f"dev.{side}").read_text(encoding="utf-8").splitlines()[:100]
        cut.with_suffix(f".{side}").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return cut


def reverse_phase() -> tuple:
    """Phase 13: configs/transformer_reverse.yaml as configured (float32,
    2 + 2 layers of hidden 64, 4 heads of 16, tied embeddings and softmax)
    on test/data/reverse/ (the dev set cut to its first 100 pairs), cut to 32
    updates (64 micro-batches of 12) and one validation, then ``test -o``
    (dev and test) and ``translate`` of 8
    sentences: every attention on the head-dim-16 kernels (SIMT flash, f32
    decode), exact launch counts with the plain versions refused, each
    kernel against its plain version on the path's inputs."""
    from joeys2t_torch.config import dump_yaml, load_config

    work = REPO / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    model_dir = work / "reverse_model"
    shutil.rmtree(model_dir, ignore_errors=True)
    cfg = load_config(REPO / "configs" / "transformer_reverse.yaml")
    cfg["model_dir"] = str(model_dir)
    data, cut = REPO / "test" / "data" / "reverse", reverse_dev_cut(work)
    cfg["data"].update(train=str(data / "train"), dev=str(cut), test=str(data / "test"))
    del cfg["data"]["sample_dev_subset"], cfg["testing"]["load_model"]
    cfg["training"].update(updates=32, validation_freq=32, logging_freq=8)
    m = cfg["model"]
    check(not cfg["fp16"] and m["encoder"]["hidden_size"] // m["encoder"]["num_heads"] == 16
          and m["tied_embeddings"] and m["tied_softmax"]
          and cfg["training"]["batch_multiplier"] == 2, "unexpected transformer_reverse config")
    cfg_path = work / "reverse.yaml"
    cfg_path.write_text(dump_yaml(cfg), encoding="utf-8")
    srcs = (data / "test.src").read_text(encoding="utf-8").splitlines()[:8]
    kept, runs = {}, {}
    with plain_refused("head-dim-16 CLI path"), kernel_inputs(kept):
        runs["train"] = cli_run(["train", cfg_path])
        runs["test"] = cli_run(["test", cfg_path, "-o", work / "reverse_out"])
        runs["translate"] = cli_run(["translate", cfg_path],
                                    stdin="".join(f"{s}\n" for s in srcs))
    launches = check_cli_leg("reverse", runs, 2, 2, 64, 1, beam=False)
    checks = cli_kernel_checks(kept, tag="reverse")
    del kept
    valid = (model_dir / "validations.txt").read_text().splitlines()
    bleu = re.search(r"\tbleu: ([\d.]+)\t", valid[0]) if valid else None
    check(len(valid) == 1 and bleu is not None, f"reverse validations.txt: {valid}")
    for split, n in (("dev", 100), ("test", 100)):
        got = len((work / f"reverse_out.{split}").read_text(encoding="utf-8").splitlines())
        check(got == n, f"reverse out.{split}: {got} hypotheses, expected {n}")
    per_update = update_ms(runs["train"][1])
    print(f"[reverse] train: 32 updates (64 micro-batches of 12), 1 validation "
          f"(BLEU {bleu.group(1)}), {runs['train'][0]:.2f} s wall, {per_update:.2f} "
          f"ms an update; test (dev 100 + test 100, greedy) {runs['test'][0]:.2f} s; "
          f"translate 8 sentences {runs['translate'][0]:.2f} s")
    print(f"[reverse] head-dim-16 launches: flash forward {launches['flash_attention_fwd']}, "
          f"flash backward {launches['flash_attention_bwd']}, decode "
          f"{launches['decode_attention']}; as the path implies, plain attention never ran")
    return launches, checks


# ----------------------------------------------------------------- phase 14
def rnn_config(name: str, model_dir: Path, dev: Path, updates: int) -> dict:
    """``name``'s config on the card with rnn_reverse.yaml's data section
    (test/data/reverse/, the dev set cut to ``dev``), ``updates`` updates
    and one validation at the end."""
    from joeys2t_torch.config import load_config

    cfg = load_config(REPO / "configs" / f"{name}.yaml")
    data = load_config(REPO / "configs" / "rnn_reverse.yaml")["data"]
    reverse = REPO / "test" / "data" / "reverse"
    data.update(train=str(reverse / "train"), dev=str(dev), test=str(reverse / "test"))
    cfg.update(use_cuda=True, model_dir=str(model_dir), data=data)
    cfg["training"].update(updates=updates, validation_freq=updates,
                           logging_freq=updates // 4, overwrite=True)
    return cfg


def decode_step_profile(hub, srcs, beam: int):
    """(kernels a decode step, steps, the card's busy share %, wall s) of a
    profiled ``generate`` of ``srcs`` held to 16 steps (eos banned before
    the last): the steps from the ``predict`` line it logs (the recurrent
    path has no decode counter)."""
    log = LogLines()
    logging.getLogger("joeys2t_torch").addHandler(log)
    try:
        wall, kernels = profiled(lambda: hub.generate(srcs, beam_size=beam,
                                                      max_output_length=16,
                                                      min_output_length=16))
    finally:
        logging.getLogger("joeys2t_torch").removeHandler(log)
    steps = sum(s for _, _, s in generations(log.lines))
    check(steps == 16, f"the profiled generate ran {steps} decode steps, not 16")
    return (sum(n for n, _ in kernels.values()) / steps, steps,
            sum(t for _, t in kernels.values()) / 1e4 / wall, wall)


def recurrent_phase() -> None:
    """Phase 14: configs/rnn_reverse.yaml and rnn_small.yaml's model and
    training sections on test/data/reverse/ through ``train`` (200
    updates of 10 sentences, one validation), ``test -o`` and ``translate``
    on the card, ``load_model_dir`` -> ``generate`` equal to ``translate``,
    no attention kernel launched (the recurrent models' attention is
    Bahdanau or Luong over one query, in PyTorch, as JAX computes it
    outside Pallas), and the float32 ``test`` of the rnn_reverse model on
    8 dev sentences identical on card and CPU."""
    from joeys2t_torch.checkpoints import load_checkpoint
    from joeys2t_torch.config import dump_yaml
    from joeys2t_torch.hub_interface import load_model_dir

    work = REPO / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    cut = reverse_dev_cut(work)
    srcs = (REPO / "test" / "data" / "reverse" / "test.src").read_text(
        encoding="utf-8").splitlines()[:8]
    shape = {"rnn_reverse": ("lstm", "luong", "zero", 1, True),
             "rnn_small": ("gru", "bahdanau", "bridge", 5, False)}
    for name, (rnn, attention, init, beam, fp16) in shape.items():
        model_dir = work / f"{name}_model"
        shutil.rmtree(model_dir, ignore_errors=True)
        cfg = rnn_config(name, model_dir, cut, 200)
        m = cfg["model"]
        check(m["encoder"]["type"] == m["decoder"]["type"] == "recurrent"
              and m["encoder"]["rnn_type"] == m["decoder"]["rnn_type"] == rnn
              and m["encoder"]["bidirectional"] and m["decoder"]["attention"] == attention
              and m["decoder"]["init_hidden"] == init and m["decoder"]["input_feeding"]
              and cfg["testing"]["beam_size"] == beam and cfg["fp16"] == fp16
              and cfg["training"]["batch_size"] == 10, f"unexpected {name} config")
        cfg_path = work / f"{name}.yaml"
        cfg_path.write_text(dump_yaml(cfg), encoding="utf-8")
        runs = {}
        with plain_refused(f"{name} CLI path"):
            runs["train"] = cli_run(["train", cfg_path, "--skip-test"])
            runs["test"] = cli_run(["test", cfg_path, "-o", work / f"{name}_out"])
            runs["translate"] = cli_run(["translate", cfg_path],
                                        stdin="".join(f"{s}\n" for s in srcs))
            hub = load_model_dir(model_dir)
            zero_counters()
            generated = hub.generate(srcs)
            hub_n = read_counters()
            profile = decode_step_profile(hub, srcs, beam)
        for run, (_, _, _, n) in list(runs.items()) + [("generate", (0, 0, 0, hub_n))]:
            check(not any(n.values()), f"{name} {run} launched attention kernels: {n}")
        translated = runs["translate"][2].splitlines()
        check(generated == translated and len(translated) == 8,
              f"{name}: hub generate {generated} differs from translate {translated}")
        valid = (model_dir / "validations.txt").read_text().splitlines()
        bleu = re.search(r"\tbleu: ([\d.]+)\t", valid[0]) if valid else None
        check(len(valid) == 1 and bleu is not None, f"{name} validations.txt: {valid}")
        losses = [float(x.group(1)) for x in (re.search(r"Batch Loss: +([-\d.einfa]+)", ln)
                                              for ln in runs["train"][1]) if x]
        check(len(losses) == 4 and all(np.isfinite(losses)), f"{name} losses {losses}")
        state = load_checkpoint(model_dir / "latest.ckpt")["model_state"]
        check(all(v.dtype == torch.float32 for v in state.values())
              and "encoder.rnn.weight_hh_l0_reverse" in state, f"{name} checkpoint")
        for split in ("dev", "test"):
            got = len((work / f"{name}_out.{split}").read_text(encoding="utf-8").splitlines())
            check(got == 100, f"{name} out.{split}: {got} hypotheses, expected 100")
        updates, _, per_update, data_s, share = loop_stats(runs["train"][1])
        test_gen = generations(runs["test"][1])[0]  # the dev set
        print(f"[rnn] {name} ({rnn.upper()}, {attention}, {init} initial state, "
              f"{'greedy' if beam == 1 else f'beam {beam}'}; float32{' under fp16' if fp16 else ''}): "
              f"train {updates} updates of 10 sentences, 1 validation (BLEU {bleu.group(1)}), "
              f"{runs['train'][0]:.2f} s wall, {per_update * 1e3:.2f} ms an update, "
              f"the host pipeline {data_s / updates * 1e3:.2f} ms a batch ({share:.2f} %); "
              f"losses {[round(x, 4) for x in losses]}; test: dev decode {test_gen[0]:.3f} s "
              f"= {100 / test_gen[0]:.1f} sentences/s over {test_gen[2]} steps "
              f"({test_gen[1]} batches); translate 8 sentences {runs['translate'][0]:.3f} s")
        print(f"[rnn] {name}: a profiled generate of 8 sentences held to 16 steps: "
              f"{profile[0]:.1f} kernels a step over {profile[1]} steps (the encoder "
              f"included), the card busy {profile[2]:.1f} % of {profile[3]:.3f} s; no "
              f"attention kernel of the port launched on the path; load_model_dir -> "
              f"generate equals translate")
        if name == "rnn_reverse":  # float32 on the card and on the CPU
            dev8 = work / "reverse_dev8"
            for side in ("src", "trg"):
                lines = cut.with_suffix(f".{side}").read_text(encoding="utf-8").splitlines()
                dev8.with_suffix(f".{side}").write_text("\n".join(lines[:8]) + "\n",
                                                        encoding="utf-8")
            both = dict(cfg, data={k: v for k, v in cfg["data"].items() if k != "test"})
            both["data"]["dev"] = str(dev8)
            for use_cuda in (True, False):
                path = work / f"{name}_{use_cuda}.yaml"
                path.write_text(dump_yaml(dict(both, use_cuda=use_cuda)), encoding="utf-8")
                if use_cuda:  # a fresh interpreter: none of the TF32 flags main sets
                    sub = subprocess.run([sys.executable, "-m", "joeys2t_torch", "test",
                                          str(path), "-o", str(work / f"{name}_{use_cuda}")],
                                         cwd=REPO, capture_output=True, text=True,
                                         timeout=600)
                    check(sub.returncode == 0, f"python -m joeys2t_torch test exited "
                          f"{sub.returncode}: {sub.stderr[-2000:]}")
                else:
                    cli_run(["test", path, "-o", work / f"{name}_{use_cuda}"])
            card, cpu = ((work / f"{name}_{c}.dev").read_text(encoding="utf-8")
                         for c in (True, False))
            check(card == cpu and len(card.splitlines()) == 8,
                  f"float32 RNN hypotheses differ between card and CPU:\n{card}\n{cpu}")
            print("[rnn] rnn_reverse float32 test of 8 dev sentences, on the card in a "
                  "fresh interpreter and on the CPU: hypotheses identical")


# ----------------------------------------------------------------- phase 15
def moe_phase(dense_update_s: float, dense_rate: float) -> tuple:
    """Phase 15: configs/synthetic_mt.yaml at full width with 4 experts in
    each encoder layer on phase 12's corpus through ``train`` (8 updates of
    192 sentences, one validation), ``test -o`` and ``translate`` (beam 5):
    exact launch counts with the plain versions refused, each kernel
    against its plain version on the path's inputs, ``load_model_dir`` ->
    ``generate`` equal to ``translate``, the load-balance term in the
    training log finite, the float32 ``test`` cut to 2 + 2 layers identical
    on card and CPU; ms an update and the tokens a second of updates 5-8
    (the same batches) beside phase 12's dense model, and the device time of
    a profiled 2-update ``train``."""
    from joeys2t_torch.checkpoints import load_checkpoint
    from joeys2t_torch.config import dump_yaml
    from joeys2t_torch.hub_interface import load_model_dir

    work = REPO / "build" / "chip_smoke"
    data = work / "synthetic_mt"
    model_dir = work / "moe_model"
    cfg = mt_config(data, model_dir)
    cfg["model"]["encoder"]["num_experts"] = 4
    cfg["training"].update(updates=8, validation_freq=8, logging_freq=4)
    cfg_path = work / "moe.yaml"
    cfg_path.write_text(dump_yaml(cfg), encoding="utf-8")
    n_enc = n_dec = 8
    srcs = (data / "test.src").read_text(encoding="utf-8").splitlines()[:8]
    kept, runs = {}, {}
    with plain_refused("MoE CLI path"), kernel_inputs(kept):
        runs["train"] = cli_run(["train", cfg_path])
        runs["test"] = cli_run(["test", cfg_path, "-o", work / "moe_out"])
        runs["translate"] = cli_run(["translate", cfg_path],
                                    stdin="".join(f"{s}\n" for s in srcs))
        launches = check_cli_leg("moe", runs, n_enc, n_dec, 8, 1)
        hub = load_model_dir(model_dir)
        zero_counters()
        generated = hub.generate(srcs)
        hub_n = read_counters()
    checks = cli_kernel_checks(kept, tag="moe")
    del kept, hub
    # where an update's device time goes: 2 updates of a copy of the config
    # (no validation, no closing test) under the profiler
    prof_cfg = json.loads(json.dumps(cfg))
    prof_cfg["model_dir"] = str(work / "moe_profile_model")
    prof_cfg["training"].update(updates=2, validation_freq=1000, logging_freq=1000,
                                overwrite=True)
    prof_path = work / "moe_profile.yaml"
    prof_path.write_text(dump_yaml(prof_cfg), encoding="utf-8")
    prof_wall, kernels = profiled(lambda: cli_run(["train", prof_path, "--skip-test"]))
    # the copies are mostly set-up: the weights up, the final checkpoint down
    copies = {k: v for k, v in kernels.items() if k.startswith(("Memcpy", "Memset"))}
    kernels = {k: v for k, v in kernels.items() if k not in copies}
    device_ms = sum(t for _, t in kernels.values()) / 2 / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
    translated = runs["translate"][2].splitlines()
    check(generated == translated and len(translated) == 8,
          f"MoE hub generate {generated} differs from translate {translated}")
    check(hub_n["flash_attention_fwd"] == n_enc and hub_n["decode_attention_group"] > 0,
          f"MoE hub generate launches {hub_n}")
    for name in launches:
        launches[name] += hub_n[name]
    aux = [float(x.group(1)) for x in (re.search(
        r"MoE load-balance term of the last micro-batch: ([-\d.einfa]+) \(8 layers\)", ln)
        for ln in runs["train"][1]) if x]
    check(len(aux) == 2 and all(np.isfinite(aux)) and min(aux) > 0,
          f"MoE load-balance terms {aux}")
    state = load_checkpoint(model_dir / "latest.ckpt")["model_state"]
    check(state["encoder.layers.7.feed_forward.w1"].shape == (4, 512, 2048)
          and state["encoder.layers.0.feed_forward.router.weight"].shape == (4, 512)
          and all(v.dtype == torch.float32 for v in state.values()), "MoE checkpoint")
    for split in ("dev", "test"):
        n = len((work / f"moe_out.{split}").read_text(encoding="utf-8").splitlines())
        check(n == 64, f"moe out.{split}: {n} hypotheses")
    cut_mt_test_on_both(cfg, state, model_dir, data, work / "moe_cut")
    updates, loop_s, per_update, data_s, share = loop_stats(runs["train"][1])
    test_gen = generations(runs["test"][1])[0]
    print(f"[moe] train: {updates} updates of 192 sentences, 4 experts in each of 8 encoder "
          f"layers, 1 validation, {runs['train'][0]:.2f} s wall; load-balance term (8 layers, "
          f"1 each at uniform routing) {[round(x, 4) for x in aux]}")
    print(f"[moe] ms an update: MoE {per_update * 1e3:.2f}, the dense synthetic_mt (phase 12) "
          f"{dense_update_s * 1e3:.2f} ({per_update / dense_update_s:.2f}x); the host "
          f"pipeline {data_s / updates * 1e3:.2f} ms a batch ({share:.2f} %); test: dev decode "
          f"{test_gen[0]:.3f} s = {64 / test_gen[0]:.1f} sentences/s ({test_gen[2]} beam-5 "
          f"steps)")
    rate = window_rate(runs["train"][1], 8)
    print(f"[moe] updates 5-8 (warm, the same batches as phase 12's): MoE {rate:.0f} target "
          f"tokens/s, dense {dense_rate:.0f} ({dense_rate / rate:.2f}x the time)")
    print(f"[moe] a profiled train of 2 updates ({prof_wall:.2f} s wall, the model set-up "
          f"included): kernels {device_ms:.2f} ms of device time an update (copies, mostly "
          f"set-up: {sum(t for _, t in copies.values()) / 1e3:.2f} ms in all); the largest: "
          + "; ".join(f"{name[:70]} x{n} {us / 2e3:.2f} ms an update"
                      for name, (n, us) in top))
    print(f"[moe] launches {launches} as the path implies, plain attention never ran; "
          f"generate equals translate; float32 test at 2 + 2 layers: card and CPU identical")
    return launches, checks


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(REPO))
    import joeys2t_torch  # noqa: F401  (fails outside a checkout of the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    marks = [("start", t_start)]

    def mark(name):
        marks.append((name, time.time()))
        print(f"[timing] {name}: {marks[-1][1] - marks[-2][1]:.1f} s")

    build_phase()
    mark("phase 1")
    flash, decode, decode_group, backward, mt_cases = kernel_phase()
    mt_flash, mt_backward, mt_decode, mt_group = mt_cases
    mark("phase 2")
    flash_launches, decode_launches, asr, batch, served = serving_phase()
    greedy_k5_ms = breakdown_phase(asr, batch)
    beam_launches, beam_served, beam_k5_ms = beam_serving_phase(asr, batch)
    bf16 = {"greedy 64 x 10 s": served["64 x 10 s"] + (greedy_k5_ms,),
            "beam 5 32 x 10 s": beam_served + (beam_k5_ms,)}
    del asr
    mark("phase 3")
    card_vs_cpu_phase()
    mark("phase 4")
    torch.cuda.empty_cache()
    train_fwd_launches, train_bwd_launches, train_batch_rate = train_phase()
    train_card_vs_cpu_phase()
    mark("phases 5-6")
    torch.cuda.empty_cache()
    cli_counts, cli_checks, asr_ckpt, cli_update_s = cli_phase(train_batch_rate)
    mark("phase 7")
    st_counts = st_phase(asr_ckpt)
    mark("phase 8")
    torch.cuda.empty_cache()
    int8_counts, int8_checks = int8_phase(batch, bf16)
    mark("phase 9")
    del batch
    torch.cuda.empty_cache()
    corpus = REPO / "build" / "chip_smoke" / "synthetic_asr"
    spm_counts, spm_checks = spm_phase(corpus)
    mark("phase 10")
    conformer_counts, conformer_checks = conformer_phase(corpus, cli_update_s)
    mark("phase 11")
    torch.cuda.empty_cache()
    mt_counts, mt_checks, mt_update_s, mt_rate = mt_phase()
    print(f"[mt] ms an update: synthetic_mt {mt_update_s * 1e3:.2f}, synthetic_asr (phase "
          f"7) {cli_update_s * 1e3:.2f}")
    mark("phase 12")
    reverse_counts, reverse_checks = reverse_phase()
    mark("phase 13")
    recurrent_phase()
    mark("phase 14")
    torch.cuda.empty_cache()
    moe_counts, moe_checks = moe_phase(mt_update_s, mt_rate)
    mark("phase 15")

    def compact(c):  # a case's measurements, without what its printed line adds
        return {k: c[k] for k in ("case", "max_abs_err", "ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by") if k in c}

    def entry(name, source, replaces, also, cases, launches, checks):
        head = cases[0]  # the main path's headline shape and dtype
        # of the checks on the paths' own inputs, the count and the case
        # nearest its tolerance (each was printed above)
        worst = max(checks, key=lambda c: c["max_abs_err"] / c["tol"] if c["tol"] else 0.0)
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    also_replaces=also, launches=sum(launches.values()),
                    launches_by_path=launches, max_abs_err=head["max_abs_err"],
                    ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                    bound_by=head["bound_by"], library_ms=head["library_ms"],
                    case=head["case"], cases=[compact(c) for c in cases if "ms" in c],
                    path_checks=dict(worst, n_cases=len(checks)))

    def paths(name, **extra):
        return dict(extra, serving_beam=beam_launches[name], cli=cli_counts[name],
                    st=st_counts[name], int8_greedy=int8_counts["greedy 64 x 10 s"][name],
                    int8_beam=int8_counts["beam 5 32 x 10 s"][name],
                    spm=spm_counts[name], conformer=conformer_counts[name],
                    mt=mt_counts[name], reverse_d16=reverse_counts[name],
                    moe=moe_counts[name])

    def int8_paths(name):
        return {"int8_greedy": int8_counts["greedy 64 x 10 s"][name],
                "int8_beam": int8_counts["beam 5 32 x 10 s"][name]}

    def mode_cases(cases, mode):
        return [c for c in cases if f" {mode}" in c["case"]]

    # phases 10-13 on their own inputs
    for later in (spm_checks, conformer_checks, mt_checks, reverse_checks, moe_checks):
        for name, cases in later.items():
            cli_checks[name] = cli_checks[name] + cases
    decode_checks = cli_checks["decode_attention"]
    mt_timed = [c for c in mt_decode if "ms" in c]
    int8_decode_checks = int8_checks["decode_attention"]
    kernels = [
        entry("flash_attention_fwd", "joeys2t_torch/csrc/flash_attention.cu",
              "joeys2t_tpu/ops/flash_attention.py:492",
              "joeys2t_tpu/ops/flash_attention.py:262", flash + mt_flash,
              paths("flash_attention_fwd", serving=flash_launches, train=train_fwd_launches),
              cli_checks["flash_attention_fwd"]),
        entry("flash_attention_bwd", "joeys2t_torch/csrc/flash_attention.cu",
              "joeys2t_tpu/ops/flash_attention.py:562",
              "joeys2t_tpu/ops/flash_attention.py:306", backward + mt_backward,
              paths("flash_attention_bwd", train=train_bwd_launches),
              cli_checks["flash_attention_bwd"]),
        entry("decode_attention", "joeys2t_torch/csrc/decode_attention.cu",
              "joeys2t_tpu/ops/decode_attention.py:185", None,
              decode + mt_timed,
              paths("decode_attention", serving=decode_launches),
              [c for c in decode_checks if "(group 1)" in c["case"]]),
        entry("decode_attention (group 5: the beam-shared cross cache)",
              "joeys2t_torch/csrc/decode_attention.cu",
              "joeys2t_tpu/ops/decode_attention.py:185", None, decode_group + mt_group,
              paths("decode_attention_group"),
              [c for c in decode_checks if "(group 1)" not in c["case"]]),
        entry("decode_attention (int8 with channel scales: the cross caches)",
              "joeys2t_torch/csrc/decode_attention.cu",
              "joeys2t_tpu/ops/decode_attention.py:185", None,
              mode_cases(decode + mt_timed, "int8-channel")
              + mode_cases(decode_group + mt_group, "int8-channel"),
              int8_paths("decode_attention_int8_channel"),
              [c for c in int8_decode_checks if "int8 channel" in c["case"]]),
        entry("decode_attention (int8 with position scales: the self caches)",
              "joeys2t_torch/csrc/decode_attention.cu",
              "joeys2t_tpu/ops/decode_attention.py:185", None,
              [c for c in mode_cases(decode + mt_timed, "int8-position")
               if c["case"].startswith("self")],
              int8_paths("decode_attention_int8_position"),
              [c for c in int8_decode_checks if "int8 position" in c["case"]]),
    ]
    print(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
