#!/usr/bin/env python3
# coding: utf-8
"""Smoke run of the PyTorch port (joeys2t_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
goes wrong:

1. build: compile every CUDA kernel of the port from joeys2t_torch/csrc
   (one nvcc per source, all started together), timed;
2. kernels: hold each kernel against its plain PyTorch version on the card
   at the shapes of the serving path, and time the kernel, the plain
   version and one PyTorch library call computing the same function;
3. serving: build the librispeech_100h model (configs/librispeech_100h.yaml,
   16 encoder / 8 decoder layers, hidden 512) with random weights from a
   seed and a synthetic 5000-token vocabulary, in bf16, and serve three
   requests through ``Transcriber``: 64 utterances of 10 s, one of 30 s, and
   a 45 s recording through ``transcribe_long``; the kernels' launch
   counters, zeroed just before, must show that every attention of the
   path went through them; then where the time of the 64 x 10 s request
   goes (front end, encoder, decode loop) and the card's busy share in a
   profiled decode loop;
4. card vs CPU: a small float32 model with the same seeded weights on the
   card and on the CPU must give the same encoder output (within 1e-4) and
   the same greedy tokens; and key-masked attention at a head size or dtype
   the flash kernel does not take must raise on the card.

Output: diagnostics, then one JSON line of kernel measurements, then the
card's name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``. Needs one CUDA card; imports nothing of
JAX or of joeys2t_tpu.
"""
import json
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
    """Mean device time of ``fn`` over ``iters`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


# ------------------------------------------------------------------ phase 1
def build_phase():
    from joeys2t_torch.ops import cuda_build

    t0 = time.time()
    paths = cuda_build.build_all()
    print(f"[build] {len(paths)} kernels built in {time.time() - t0:.1f} s")
    for name, path in paths.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.is_file() else []
        regs = [ln.split(":", 1)[1].strip() for ln in lines if "registers" in ln]
        spills = [ln.strip() for ln in lines if "spill" in ln and " 0 bytes spill" not in ln]
        print(f"[build] {name}: {path.name}; ptxas per instantiation: {regs}")
        for ln in spills:
            print(f"[build] {name}: {ln}")


# ------------------------------------------------------------------ phase 2
def flash_case(b, s, dtype, gen):
    from joeys2t_torch.ops import flash_attention as fa

    h, d = 4, 128
    e = h * d
    q, k, v = (torch.randn(b, s, e, generator=gen).to(dtype).cuda() for _ in range(3))
    lengths = torch.randint(s // 2, s + 1, (b,), generator=gen)
    valid = torch.arange(s)[None, :] < lengths[:, None]
    if b > 2:
        valid[0] = False  # a row with every key masked
    bias = torch.where(valid, 0.0, -1e9).float().cuda()
    sm = d ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, bias, sm, h)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, bias, sm, h)
    torch.cuda.synchronize()
    err = max((out.float() - ref.float()).abs().max().item(),
              (lse - ref_lse).abs().max().item())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    check(bool(torch.isfinite(out.float()).all()), f"flash {dtype} {b}x{s}: non-finite output")
    check(err <= tol, f"flash {dtype} B={b} S={s}: max abs err {err} > {tol}")
    qh, kh, vh = (t.view(b, s, h, d).transpose(1, 2).contiguous() for t in (q, k, v))
    mask = bias.to(dtype)[:, None, None, :]
    ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, bias, sm, h))
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, bias, sm, h), iters=5)
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=sm))
    bound_ms, bound_by = bound(nbytes(q, k, v, bias, out, lse), 4 * b * s * s * e, dtype)
    return dict(case=f"B={b} Sq=Sk={s} H={h} D={d} {str(dtype)[6:]}", max_abs_err=err,
                tol=tol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def decode_case(kind, s, mode, gen):
    from joeys2t_torch.ops import decode_attention as da

    b, h, d = 64, 4, 128
    qdt = torch.float32 if mode == "f32" else torch.bfloat16
    q = torch.randn(b, h, d, generator=gen).to(qdt).cuda()
    kf, vf = (torch.randn(b, h, s, d, generator=gen).cuda() for _ in range(2))
    if kind == "self":  # ring buffer at step 48: slots beyond it masked
        valid = (torch.arange(s) <= 48)[None, :].expand(b, s)
    else:
        lengths = torch.randint(s // 2, s + 1, (b,), generator=gen)
        valid = torch.arange(s)[None, :] < lengths[:, None]
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
    sm = d ** -0.5
    args = (q, k, v, bias, ks, vs)
    kw = dict(sm_scale=sm, scale_layout=layout)
    out = da.decode_attention(*args, **kw)
    ref = da.decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = 1e-5 if qdt == torch.float32 else 1e-2
    check(bool(torch.isfinite(out.float()).all()), f"decode {kind} {mode}: non-finite output")
    check(err <= tol, f"decode {kind} {mode}: max abs err {err} > {tol}")
    library_ms = None
    if k.dtype != torch.int8:
        q4 = q[:, :, None, :]
        mask = bias.to(qdt)[:, None, None, :]
        library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask, scale=sm))
    bound_ms, bound_by = bound(nbytes(q, k, v, bias, ks, vs, out), 4 * b * h * s * d, k.dtype)
    return dict(case=f"{kind} B={b} H={h} S={s} D={d} {mode}", max_abs_err=err, tol=tol,
                ms=time_ms(lambda: da.decode_attention(*args, **kw), iters=50),
                plain_ms=time_ms(lambda: da.decode_attention_plain(*args, **kw)),
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def kernel_phase():
    gen = torch.Generator().manual_seed(0)
    # B=64 S=250: the 64 x 10 s request; B=2 S=750: the 45 s request's two
    # 20-25 s chunks; B=64 S=750: a full batch in the range the TPU package
    # sent to its second (B, H, S, D) kernel
    flash = [flash_case(b, s, dt, gen) for b, s in ((64, 250), (2, 750), (64, 750))
             for dt in (torch.bfloat16, torch.float32)]
    decode = [decode_case(kind, s, mode, gen) for kind, s in (("cross", 250), ("self", 97))
              for mode in ("bf16", "f32", "int8-channel", "int8-position")]
    for c in flash + decode:
        print(f"[kernels] {c['case']}: err {c['max_abs_err']:.3g} (tol {c['tol']}), "
              f"kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, library "
              f"{c['library_ms'] if c['library_ms'] is None else round(c['library_ms'], 4)}"
              f" ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
    return flash, decode


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
    total_wall, total_audio = 0.0, 0.0
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
        print(f"[serving] {name}: {len(texts)} transcripts, {steps} decode steps, "
              f"{wall:.3f} s wall, {seconds / wall:.1f} audio-s/s")
    check(asr.stats["requests"] == 3, f"{asr.stats['requests']} requests served")
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "serving cast the caller's float32 master weights")
    print(f"[serving] total: {total_audio:.0f} audio-s in {total_wall:.3f} s = "
          f"{total_audio / total_wall:.1f} audio-s/s")
    return flash_attention_fwd.launches, decode_attention.launches, asr, batch


def breakdown_phase(asr, batch):
    """Where the 64 x 10 s request's time goes: front end, encoder and decode
    loop on the host clock (each ending in a device sync), then the card's
    busy share and top kernels over a profiled 16-step decode."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from joeys2t_torch.ops.frontend import device_frontend
    from joeys2t_torch.search import transformer_greedy

    waves = torch.tensor(np.stack(batch)).cuda()
    lengths = torch.full((len(batch),), waves.shape[1], device="cuda")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.inference_mode():
        (feats, flen), t_front = timed(lambda: device_frontend(waves, lengths))
        (enc, _, mask), t_enc = timed(lambda: asr.model.encode(feats, flen))
        stats = {}
        _, t_dec = timed(lambda: transformer_greedy(asr.decode_model, asr.spec, enc, mask,
                                                    96, device="cuda", stats=stats))
        total = t_front + t_enc + t_dec
        print(f"[breakdown] 64 x 10 s: front end {t_front * 1e3:.2f} ms "
              f"({100 * t_front / total:.1f} %), encoder {t_enc * 1e3:.2f} ms "
              f"({100 * t_enc / total:.1f} %), decode {t_dec * 1e3:.2f} ms "
              f"({100 * t_dec / total:.1f} %) = {stats['decode_steps']} steps of "
              f"{t_dec / stats['decode_steps'] * 1e3:.3f} ms")
        steps = 16
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = timed(lambda: transformer_greedy(asr.decode_model, asr.spec, enc,
                                                       mask, steps, device="cuda"))
    kernels = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            n, t = kernels.get(ev.name, (0, 0.0))
            kernels[ev.name] = (n + 1, t + ev.time_range.elapsed_us())
    busy_us = sum(t for _, t in kernels.values())
    if not kernels:
        print("[breakdown] device busy share: not measured (no device events recorded)")
        return
    launches = sum(n for n, _ in kernels.values())
    print(f"[breakdown] profiled {steps}-step decode: wall {wall * 1e3:.2f} ms, device "
          f"busy {busy_us / 1e3:.2f} ms ({100 * busy_us / (wall * 1e6):.1f} %), "
          f"{launches / steps:.0f} kernels per step")
    for name, (n, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[breakdown]   {t / 1e3:8.3f} ms {n:5d}x  {name[:110]}")


# ------------------------------------------------------------------ phase 4
def card_vs_cpu_phase():
    from joeys2t_torch.config import SpecialSymbols
    from joeys2t_torch.models import build_model
    from joeys2t_torch.ops.decode_attention import decode_attention
    from joeys2t_torch.ops.flash_attention import flash_attention_fwd
    from joeys2t_torch.ops.frontend import device_frontend
    from joeys2t_torch.search import transformer_greedy
    from joeys2t_torch.vocabulary import Vocabulary

    cfg = {"encoder": {"type": "transformer", "num_layers": 2, "num_heads": 2,
                       "embeddings": {"embedding_dim": 80}, "hidden_size": 256,
                       "ff_size": 1024, "subsample": True, "conv_kernel_sizes": [5, 5],
                       "conv_channels": 256, "in_channels": 80, "layer_norm": "pre"},
           "decoder": {"type": "transformer", "num_layers": 2, "num_heads": 2,
                       "embeddings": {"embedding_dim": 256, "scale": True},
                       "hidden_size": 256, "ff_size": 1024, "layer_norm": "pre"}}
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
    feats, flen = device_frontend(torch.tensor(waves), torch.tensor(lengths))
    feats_gpu, flen_gpu = device_frontend(torch.tensor(waves).cuda(),
                                          torch.tensor(lengths).cuda())
    feat_err = (feats_gpu.cpu() - feats).abs().max().item()
    check(torch.equal(flen_gpu.cpu(), flen), "frame lengths differ between devices")
    check(feat_err <= 1e-3, f"front end differs between devices by {feat_err}")
    out = {}
    f0, d0 = flash_attention_fwd.launches, decode_attention.launches
    with torch.inference_mode():
        for dev, (model, spec) in models.items():
            enc, _, mask = model.encode(feats.to(dev), flen.to(dev))
            tokens, _, _ = transformer_greedy(model, spec, enc, mask, 40, device=dev)
            out[dev] = (enc.cpu(), mask.cpu(), tokens)
    check(flash_attention_fwd.launches - f0 == 2 and decode_attention.launches > d0,
          "the card run did not go through the kernels")
    valid = out["cpu"][1][:, 0, :, None]
    enc_err = ((out["cuda"][0] - out["cpu"][0]) * valid).abs().max().item()
    check(torch.equal(out["cuda"][1], out["cpu"][1]), "encoder masks differ")
    check(enc_err <= 1e-4, f"encoder output differs between card and CPU by {enc_err}")
    check(np.array_equal(out["cuda"][2], out["cpu"][2]),
          f"greedy tokens differ:\n{out['cuda'][2]}\n{out['cpu'][2]}")
    print(f"[card-vs-cpu] f32 2+2 layers hidden 256 D=128: front end err {feat_err:.3g}, "
          f"encoder err {enc_err:.3g} (tol 1e-4), greedy tokens identical "
          f"({out['cpu'][2].shape[1]} steps)")

    # no plain path on the card: key-masked attention at a head size or dtype
    # the flash kernel does not take raises instead of running plain PyTorch
    from joeys2t_torch.models.modules import MultiHeadedAttention

    x = torch.randn(2, 5, 64, device="cuda")
    key_mask = torch.ones(2, 1, 5, dtype=torch.bool, device="cuda")
    for heads, dtype in ((4, torch.bfloat16), (1, torch.float16)):
        mha = MultiHeadedAttention(heads, 64, dtype=dtype, device="cuda").eval()
        try:
            mha(x, x, x, key_mask)
            fail(f"attention with head size {64 // heads} in {dtype} ran on the card")
        except ValueError:
            pass
    print("[card-vs-cpu] head size 16 bf16 and head size 64 f16 attention raise on the card")


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(REPO))
    import joeys2t_torch  # noqa: F401  (fails outside a checkout of the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    build_phase()
    flash, decode = kernel_phase()
    flash_launches, decode_launches, asr, batch = serving_phase()
    breakdown_phase(asr, batch)
    del asr, batch
    card_vs_cpu_phase()

    def entry(name, source, replaces, also, cases, launches):
        head = cases[0]  # the serving path's shape and dtype
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    also_replaces=also, launches=launches,
                    max_abs_err=head["max_abs_err"], ms=head["ms"],
                    plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                    bound_by=head["bound_by"], library_ms=head["library_ms"],
                    case=head["case"], cases=cases)

    kernels = [
        entry("flash_attention_fwd", "joeys2t_torch/csrc/flash_attention.cu",
              "joeys2t_tpu/ops/flash_attention.py:492",
              "joeys2t_tpu/ops/flash_attention.py:262", flash, flash_launches),
        entry("decode_attention", "joeys2t_torch/csrc/decode_attention.cu",
              "joeys2t_tpu/ops/decode_attention.py:185", None, decode, decode_launches),
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
