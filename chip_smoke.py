#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); imports nothing of JAX
or of the JAX package.  Phases, each of which fails the run (non-zero
exit, no result line) when a check fails:

1. Card and build: prints the card's name and power limit
   (`nvidia-smi`) and builds the CUDA kernels from `src/repro_torch/csrc`
   (one nvcc per source, all at once), printing the build time.
2. Kernels: each kernel's launch wrapper against its plain PyTorch
   version on the card, at the serving paths' shapes (smollm-135m: d 576,
   F 1536, 9 query / 3 KV heads of 64, bfloat16 and float32; rwkv6-3b:
   wkv6 over 40 heads of 64, in the JAX op's (BH, S, D) layout and in the
   model's (B, S, H, D) layout that `rwkv6.time_mix` passes;
   recurrentgemma-2b: rglru_scan over 2560 channels; both float32), TF32
   off, with the tolerance stated; kernel, plain-version and library
   times from CUDA events, and the least time the card could take (bytes
   over 3.35 TB/s or operations over the type's peak).
3. Correctness end to end, float32 at full width: smollm-135m (4 layers)
   serves one 8-request trace through the plain impls and through the
   kernel impls; rwkv6-3b (4 layers) and recurrentgemma-2b (3 layers: two
   recurrent, one attention) serve one on the card, which runs the
   kernels, and on the CPU, which runs the plain versions.  Greedy tokens
   must be equal and the first prefill's logits within 1e-3.
4. Main paths, each at full width and depth in bfloat16 with random
   weights from a seed, through `repro_torch.launch.serve`: smollm-135m
   with a policy that turns all three fusion flags on (12 requests), then
   rwkv6-3b and recurrentgemma-2b (8 requests each); prompts of 16-300
   tokens, 32 new tokens each, 4 slots, max_len 512.  Launch counts are
   set to 0 just before each path and read just after; every kernel of
   the path must have run, and each recurrent layer's kernel exactly once
   a prefill and once a decode step.  Prints tokens/s, TTFT and TPOT.
5. Breakdown, for each main path: the wall time of a steady decode step
   on the same engine, and from one profiled window the device's busy
   time, the heaviest kernels and the port's own kernels' time a step.

The last two lines are one JSON object listing the kernels and one with
the device: `{"ok": true, "device": {"platform": "gpu", ...}}`.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12,         # dense tensor-core bf16
              "float32": 67e12}           # float32 outside the tensor cores
TOL = {"bfloat16": 2.5e-2}
# wkv6: sums in another order than the plain version's chunked form,
# which clips its decay exponents at -60
TOL_F32 = {"fused_rmsnorm": 1e-5, "fused_rmsnorm_residual": 1e-5,
           "fused_mlp": 1e-5, "flash_attention": 3e-5, "wkv6": 1e-4,
           "rglru_scan": 1e-5}
D, F_FF, H, HKV, HD = 576, 1536, 9, 3, 64  # smollm-135m
DECODE_N = 4                               # the main path's slot count
RWKV_H, RWKV_D = 40, 64                    # rwkv6-3b heads of 64
LRU_W = 2560                               # recurrentgemma-2b lru_width
# the port's CUDA kernels, as the profiler names them
OWN_KERNELS = ("rmsnorm_kernel", "mlp_partial_kernel", "mlp_reduce_kernel",
               "flash_fwd_kernel", "wkv6_kernel", "rglru_scan_kernel")


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean milliseconds of fn() over `iters` calls, by CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 10) -> float | None:
    """Mean milliseconds of device time (every CUDA kernel, by the
    profiler) that one fn() call launches: the device's share of what
    `time_ms` reads, without the host's.  None when the profiler
    returned no device event (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / iters / 1e3 if us > 0 else None


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase(torch, F):
    """Check each kernel against its plain version and time it."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.fused_mlp import kernel as mk
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    from repro_torch.kernels.fused_norm import kernel as nk
    from repro_torch.kernels.fused_norm.ref import (fused_rmsnorm_ref,
                                                    fused_rmsnorm_residual_ref)
    from repro_torch.kernels.rglru_scan import kernel as gk
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.kernels.wkv6.ref import wkv6_bshd_ref, wkv6_ref

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    # library yardsticks, where this PyTorch has them
    rms_norm = getattr(F, "rms_norm", None)
    sdpa_gqa = tuple(int(p) for p in torch.__version__.split(".")[:2]) >= (2, 5)
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def rand(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dt)

    def err(out, ref, tol):
        """max |out - ref| and whether |out - ref| <= tol + tol * |ref|."""
        o, r = [t.float() for t in (out if isinstance(out, tuple) else (out,))], \
            [t.float() for t in (ref if isinstance(ref, tuple) else (ref,))]
        e = max(float((a - b).abs().max()) for a, b in zip(o, r))
        ok = all(bool(((a - b).abs() <= tol + tol * b.abs()).all()) and
                 bool(torch.isfinite(a).all()) for a, b in zip(o, r))
        return e, ok

    rows = []

    launchers = {"fused_rmsnorm": nk.RMSNORM,
                 "fused_rmsnorm_residual": nk.RMSNORM_RESIDUAL,
                 "fused_mlp": mk.MLP, "flash_attention": fk.FLASH,
                 "wkv6": wk.WKV6, "rglru_scan": gk.SCAN}

    def record(name, shape, dtype, out, ref, kern, plain, lib, nbytes, flops):
        """`out` is the kernel's first result (launched by the caller);
        `launches` counts that launch and the event-timed ones.  The
        `*_device_ms` keys are profiler device times of the same calls."""
        tol = TOL.get(dtype, TOL_F32[name])
        e, ok = err(out, ref, tol)
        check(ok, f"{name} {shape} {dtype}: kernel disagrees with its plain "
                  f"version (max abs err {e:.3g}, tol {tol})")
        b, by = bound_ms(nbytes, flops, dtype)
        before = launchers[name].launches - 1
        kernel_ms = time_ms(torch, kern)
        row = {"name": name, "shape": shape, "dtype": dtype,
               "launches": launchers[name].launches - before, "max_err": e,
               "tol": tol, "kernel_ms": kernel_ms,
               "plain_ms": time_ms(torch, plain),
               "library_ms": None if lib is None else time_ms(torch, lib),
               "bound_ms": b, "bound_by": by}
        row["kernel_device_ms"] = device_ms(torch, kern)
        row["plain_device_ms"] = device_ms(torch, plain)
        rows.append(row)
        print(json.dumps(row), flush=True)

    for dtype, dt in dts.items():
        es = torch.tensor([], dtype=dt).element_size()
        for n in (DECODE_N, 16, 256):
            x, r = rand((n, D), dt), rand((n, D), dt)
            sc = rand((D,), dt, 0.1)
            w1 = (1.0 + sc.float()).to(dt)
            record("fused_rmsnorm", [n, D], dtype,
                   nk.fused_rmsnorm_cuda(x, sc), fused_rmsnorm_ref(x, sc),
                   lambda i: nk.fused_rmsnorm_cuda(x, sc),
                   lambda i: fused_rmsnorm_ref(x, sc),
                   None if rms_norm is None else
                   lambda i: rms_norm(x, (D,), weight=w1, eps=1e-6),
                   (2 * n * D + D) * es, 4 * n * D)
            record("fused_rmsnorm_residual", [n, D], dtype,
                   nk.fused_rmsnorm_residual_cuda(x, r, sc),
                   fused_rmsnorm_residual_ref(x, r, sc),
                   lambda i: nk.fused_rmsnorm_residual_cuda(x, r, sc),
                   lambda i: fused_rmsnorm_residual_ref(x, r, sc), None,
                   (4 * n * D + D) * es, 5 * n * D)
            # weights are read cold on the serving path (30 layers' worth,
            # beyond the 50 MB L2): rotate through copies that exceed it
            w_bytes = 3 * D * F_FF * es
            copies = max(1, math.ceil(64e6 / w_bytes))
            ws = [(rand((D, F_FF), dt, D ** -0.5), rand((D, F_FF), dt, D ** -0.5),
                   rand((F_FF, D), dt, F_FF ** -0.5)) for _ in range(copies)]
            xm = rand((n, D), dt)
            wg, wi, wo = ws[0]

            def mlp_lib(i, xm=xm, ws=ws):
                g, u, o = ws[i % len(ws)]
                return (F.silu(xm @ g) * (xm @ u)) @ o

            record("fused_mlp", [n, D, F_FF], dtype,
                   mk.fused_mlp_cuda(xm, wg, wi, wo), fused_mlp_ref(xm, wg, wi, wo),
                   lambda i, xm=xm, ws=ws: mk.fused_mlp_cuda(xm, *ws[i % len(ws)]),
                   lambda i, xm=xm, ws=ws: fused_mlp_ref(xm, *ws[i % len(ws)]),
                   mlp_lib, (2 * n * D + 3 * D * F_FF) * es, 6 * n * D * F_FF)
        for s in (16, 128, 512):
            q, k, v = rand((1, s, H, HD), dt), rand((1, s, HKV, HD), dt), \
                rand((1, s, HKV, HD), dt)
            pairs = s * (s + 1) // 2              # causal (q, k) pairs
            record("flash_attention", [1, s, H, HKV, HD], dtype,
                   fk.flash_attention_cuda(q, k, v), flash_attention_ref(q, k, v),
                   lambda i: fk.flash_attention_cuda(q, k, v),
                   lambda i: flash_attention_ref(q, k, v),
                   None if not sdpa_gqa else
                   lambda i: F.scaled_dot_product_attention(
                       q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       is_causal=True, enable_gqa=True),
                   (2 * s * H * HD + 2 * s * HKV * HD) * es, 4 * HD * pairs * H)

    # recurrent kernels, float32 as the models call them: decode (four
    # slots, one token) and one prefill of 256 tokens
    f32 = torch.float32
    for bh, s in ((DECODE_N * RWKV_H, 1), (RWKV_H, 256)):
        r, k, v = (rand((bh, s, RWKV_D), f32, 0.5) for _ in range(3))
        logw = torch.log(torch.exp(-torch.exp(
            rand((bh, s, RWKV_D), f32).clamp(-1.0, 1.0))).clamp(min=1e-12))
        u = rand((bh, 1, RWKV_D), f32, 0.1)
        s0 = rand((bh, RWKV_D, RWKV_D), f32, 0.1)

        def wkv_kern(i, r=r, k=k, v=v, logw=logw, u=u, s0=s0):
            return wops.wkv6(r, k, v, logw, u, s0)      # CUDA tensors: the kernel

        def wkv_plain(i, r=r, k=k, v=v, logw=logw, u=u, s0=s0):
            return wkv6_ref(r, k, v, logw, u, s0, chunk=32)

        record("wkv6", [bh, s, RWKV_D], "float32", wkv_kern(0), wkv_plain(0),
               wkv_kern, wkv_plain, None,
               4 * (5 * bh * s * RWKV_D + 2 * bh * RWKV_D ** 2),
               4 * bh * s * RWKV_D ** 2)
    # the model layout that `rwkv6.time_mix` passes: (B, S, H, D) views of
    # (B, S, H*D) projections (time stride H*D), u (H, D), s0 (B, H, D, D)
    for b, s in ((DECODE_N, 1), (1, 256)):
        shape = (b, s, RWKV_H, RWKV_D)
        r, k, v = (rand((b, s, RWKV_H * RWKV_D), f32, 0.5).reshape(shape)
                   for _ in range(3))
        logw = torch.log(torch.exp(-torch.exp(
            rand((b, s, RWKV_H * RWKV_D), f32).clamp(-1.0, 1.0))).clamp(
                min=1e-12)).reshape(shape)
        u = rand((RWKV_H, RWKV_D), f32, 0.1)
        s0 = rand((b, RWKV_H, RWKV_D, RWKV_D), f32, 0.1)

        def bshd_kern(i, r=r, k=k, v=v, logw=logw, u=u, s0=s0):
            return wops.wkv6_bshd(r, k, v, logw, u, s0)

        def bshd_plain(i, r=r, k=k, v=v, logw=logw, u=u, s0=s0):
            return wkv6_bshd_ref(r, k, v, logw, u, s0, chunk=32)

        bh = b * RWKV_H
        record("wkv6", list(shape), "float32", bshd_kern(0), bshd_plain(0),
               bshd_kern, bshd_plain, None,
               4 * (5 * bh * s * RWKV_D + 2 * bh * RWKV_D ** 2),
               4 * bh * s * RWKV_D ** 2)
    for b, s in ((DECODE_N, 1), (1, 256)):
        a = torch.rand((b, s, LRU_W), generator=gen).to(dev)
        x, h0 = rand((b, s, LRU_W), f32), rand((b, LRU_W), f32)
        # reads a, b and h0, writes h (no final-state output)
        record("rglru_scan", [b, s, LRU_W], "float32",
               gk.rglru_scan_cuda(a, x, h0), rglru_scan_ref(a, x, h0),
               lambda i, a=a, x=x, h0=h0: gk.rglru_scan_cuda(a, x, h0),
               lambda i, a=a, x=x, h0=h0: rglru_scan_ref(a, x, h0), None,
               4 * (3 * b * s * LRU_W + b * LRU_W), 2 * b * s * LRU_W)
    return rows


def e2e_phase(torch):
    """Plain impls vs kernel impls, full width, 4 layers, float32."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models import api, transformer
    from repro_torch.serving.engine import Request, ServingEngine

    base = configs.get_config("smollm-135m").replace(
        n_layers=4, dtype="float32", param_dtype="float32")
    plain = base.replace(attn_impl="einsum", mlp_impl="dense", norm_impl="ref")
    kern = base.replace(attn_impl="flash", mlp_impl="fused", norm_impl="fused")
    params = api.init_params(base, 1, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, base.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(16, 301, size=8)]
    toks = {}
    for name, cfg in (("plain", plain), ("kernels", kern)):
        eng = ServingEngine(cfg, params, max_batch=4, max_len=512, device="cuda")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]
        serve(eng, reqs)
        toks[name] = [r.out_tokens for r in reqs]
        check(all(r.finish_reason == "max_new_tokens" for r in reqs),
              f"e2e {name}: a request did not finish with max_new_tokens")
    same = sum(a == b for a, b in zip(toks["plain"], toks["kernels"]))
    p0 = torch.as_tensor(prompts[0], device="cuda").long()[None]
    lp = transformer.forward(plain, params, p0)[0, -1]
    lk = transformer.forward(kern, params, p0)[0, -1]
    diff = float((lp - lk).abs().max())
    print(f"[smoke] e2e f32 4 layers full width: {same}/8 request streams "
          f"equal, first-prefill logits max |diff| {diff:.3g}", flush=True)
    check(toks["plain"] == toks["kernels"],
          "e2e: kernel impls changed greedy tokens")
    check(diff <= 1e-3, f"e2e: first-prefill logits differ by {diff}")


def recurrent_e2e_phase(torch, arch: str, n_layers: int):
    """The card (kernels) against the CPU (plain versions): `arch` at full
    width, `n_layers` layers, float32, one 8-request trace on the same
    weights."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models import api
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = configs.get_config(arch).replace(
        n_layers=n_layers, dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    params = api.init_params(cfg, 1, device="cpu")
    draw_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(16, 301, size=8)]
    toks, first, secs = {}, {}, {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(cfg, params, max_batch=4, max_len=512, device=dev)
        check(eng.state.kind == "recurrent", f"e2e {arch}: not the recurrent state")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]
        secs[dev] = serve(eng, reqs)["seconds"]
        toks[dev] = [r.out_tokens for r in reqs]
        check(all(r.finish_reason == "max_new_tokens" for r in reqs),
              f"e2e {arch} {dev}: a request did not finish with max_new_tokens")
        p0 = torch.as_tensor(prompts[0], device=dev).long()[None]
        first[dev] = api.prefill(cfg, eng.params, {"tokens": p0}, 512)[0][0, -1].cpu()
        del eng
    same = sum(a == b for a, b in zip(toks["cuda"], toks["cpu"]))
    diff = float((first["cuda"] - first["cpu"]).abs().max())
    print(f"[smoke] e2e {arch} f32 {n_layers} layers full width, card vs CPU: "
          f"{same}/8 request streams equal, first-prefill logits max |diff| "
          f"{diff:.3g} (weights drawn in {draw_s:.1f}s; served in "
          f"{secs['cuda']:.1f}s on the card, {secs['cpu']:.1f}s on the CPU)",
          flush=True)
    check(toks["cuda"] == toks["cpu"], f"e2e {arch}: the kernels changed greedy tokens")
    check(diff <= 1e-3, f"e2e {arch}: first-prefill logits differ by {diff}")


def _requests(rng, vocab, n, lo, hi, max_new):
    import numpy as np

    from repro_torch.serving.engine import Request
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=int(p))
                    .astype(np.int32), max_new_tokens=max_new)
            for i, p in enumerate(rng.integers(lo, hi + 1, size=n))]


def recurrent_path_phase(torch, arch: str, launchers, name: str):
    """The full `arch` (bfloat16, random weights from a seed) through the
    serve launcher's own functions; `name` is the kernel of its recurrent
    layers, which must launch once a layer a prefill and a decode step."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.serve import build_engine, serve
    from repro_torch.models import rglru

    cfg = configs.get_config(arch)
    n_rec = cfg.n_layers if cfg.family == "rwkv6" else \
        sum(not rglru.is_attn_layer(cfg, i) for i in range(cfg.n_layers))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_engine(cfg, max_batch=4, max_len=512, seed=0, device="cuda",
                       log=lambda s: print(s, flush=True))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(eng.state.kind == "recurrent", f"{arch}: not the recurrent state")
    rng = np.random.default_rng(0)
    serve(eng, _requests(rng, cfg.vocab, 2, 16, 40, 4))   # warm-up
    for ln in launchers.values():
        ln.launches = 0
    reqs = _requests(rng, cfg.vocab, 8, 16, 300, 32)
    s = serve(eng, reqs)
    counts = {n: ln.launches for n, ln in launchers.items()}
    want = n_rec * (s["prefills"] + s["decode_steps"])
    print(f"[smoke] main path {arch} {cfg.n_layers}L bf16: {s['tokens_out']} "
          f"tokens, {s['prefills']} prefills, {s['decode_steps']} decode steps "
          f"in {s['seconds']:.3f}s = {s['tokens_per_s']:.1f} tok/s; TTFT p50 "
          f"{s['ttft_p50_ms']:.1f} ms, TPOT p50 {s['tpot_p50_ms']:.2f} ms; "
          f"launches {counts} ({name} expected {n_rec} x (prefills + decode "
          f"steps) = {want}); weights drawn and engine built in {build_s:.1f}s; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    print(json.dumps({"main_path": s, "arch": arch, "launches": counts,
                      "build_engine_s": build_s}), flush=True)
    check(all(r.finish_reason == "max_new_tokens" and len(r.out_tokens) == 32
              for r in reqs), f"{arch}: a request did not finish with 32 tokens")
    check(s["nan_steps"] == 0 and not eng.health["nan_detected"],
          f"{arch}: non-finite logits")
    check(counts[name] == want,
          f"{arch}: {name} launched {counts[name]} times, expected {want}")
    return eng, counts


def free(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def main_path_phase(torch, launchers):
    """The full smollm-135m through the serve launcher's own functions."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.policy import load_policy
    from repro_torch.launch.serve import build_engine, serve

    pol = {"network": "smollm-135m", "interval_s": 1e-3, "operators": [
        {"group": "norm1+qkv_proj+attention", "batch": 4, "tp": 1,
         "memory": "HBM3", "chiplet": "H100", "fused": True},
        {"group": "norm2+mlp", "batch": 4, "tp": 1, "memory": "HBM3",
         "chiplet": "H100", "fused": True}]}
    path = ROOT / "build" / "smoke_policy.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(pol))
    cfg = configs.get_config("smollm-135m")
    eng = build_engine(cfg, policy=load_policy(path), max_batch=4, max_len=512,
                       seed=0, device="cuda",
                       log=lambda s: print(s, flush=True))
    check(eng.mcfg.attn_impl == "flash" and eng.mcfg.mlp_impl == "fused"
          and eng.mcfg.norm_impl == "fused", "policy did not turn the kernels on")
    rng = np.random.default_rng(0)
    serve(eng, _requests(rng, cfg.vocab, 2, 16, 40, 4))   # warm-up: library handles
    for ln in launchers.values():
        ln.launches = 0
    reqs = _requests(rng, cfg.vocab, 12, 16, 300, 32)
    s = serve(eng, reqs)
    counts = {name: ln.launches for name, ln in launchers.items()}
    print(f"[smoke] main path smollm-135m 30L bf16: {s['tokens_out']} tokens, "
          f"{s['prefills']} prefills, {s['decode_steps']} decode steps in "
          f"{s['seconds']:.3f}s = {s['tokens_per_s']:.1f} tok/s; TTFT p50 "
          f"{s['ttft_p50_ms']:.1f} ms, TPOT p50 {s['tpot_p50_ms']:.2f} ms; "
          f"launches {counts}", flush=True)
    print(json.dumps({"main_path": s, "launches": counts,
                      "buckets": sorted({int(2 ** math.ceil(math.log2(max(16, len(r.prompt)))))
                                         for r in reqs})}), flush=True)
    check(all(r.finish_reason == "max_new_tokens" and len(r.out_tokens) == 32
              for r in reqs), "main path: a request did not finish with 32 tokens")
    check(s["nan_steps"] == 0 and not eng.health["nan_detected"],
          "main path: non-finite logits")
    check(all(c > 0 for c in counts.values()),
          f"main path: a kernel was never launched: {counts}")
    return eng, counts


def breakdown_phase(torch, eng, arch: str):
    """Where a decode step's time goes: the wall time of steady decode
    steps (4 slots, 100-token prompts), then one profiled window for the
    device's busy time, kernel count and heaviest kernels a step."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(2)
    for i in range(4):
        eng.submit(Request(rid=i, prompt=rng.integers(0, eng.mcfg.vocab, 100)
                           .astype(np.int32), max_new_tokens=40))
    for _ in range(3):                 # admit all four, settle
        eng.step()
    n = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    n_prof = 4
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            eng.step()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    dev_ms = sum(by_name.values()) / n_prof / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    ours = {k: sum(v for name, v in by_name.items() if k in name) / n_prof / 1e3
            for k in OWN_KERNELS}
    eng.run()
    out = {"decode_step_ms": step_ms, "device_ms_per_step": dev_ms,
           "device_busy_share": dev_ms / step_ms,
           "kernels_per_step": len(kern) / n_prof,
           "top_kernels_ms_per_step": [[k[:60], v / n_prof / 1e3] for k, v in top],
           "own_kernels_ms_per_step": {k: v for k, v in ours.items() if v > 0}}
    print(json.dumps({"breakdown": out, "arch": arch}), flush=True)
    check(dev_ms > 0, "breakdown: the profiler saw no device time")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.fused_mlp import kernel as mk
    from repro_torch.kernels.fused_norm import kernel as nk
    from repro_torch.kernels.rglru_scan import kernel as gk
    from repro_torch.kernels.wkv6 import kernel as wk

    card = card_line()
    print(f"[smoke] card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    build_s = _build.build()
    print(f"[smoke] built {', '.join(_build.SOURCES)} in {build_s:.1f}s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[smoke] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    rows = kernel_phase(torch, F)
    e2e_phase(torch)
    recurrent_e2e_phase(torch, "rwkv6-3b", 4)
    recurrent_e2e_phase(torch, "recurrentgemma-2b", 3)
    launchers = {"fused_rmsnorm": nk.RMSNORM,
                 "fused_rmsnorm_residual": nk.RMSNORM_RESIDUAL,
                 "fused_mlp": mk.MLP, "flash_attention": fk.FLASH}
    eng, counts = main_path_phase(torch, launchers)
    breakdown_phase(torch, eng, "smollm-135m")
    del eng
    free(torch)
    launchers.update(wkv6=wk.WKV6, rglru_scan=gk.SCAN)
    eng, path = recurrent_path_phase(torch, "rwkv6-3b", launchers, "wkv6")
    counts["wkv6"] = path["wkv6"]
    breakdown_phase(torch, eng, "rwkv6-3b")
    del eng
    free(torch)
    eng, path = recurrent_path_phase(torch, "recurrentgemma-2b", launchers,
                                     "rglru_scan")
    counts["rglru_scan"] = path["rglru_scan"]
    breakdown_phase(torch, eng, "recurrentgemma-2b")
    del eng
    free(torch)

    meta = {
        "fused_rmsnorm": ("fused_norm.cu", "fused_norm/kernel.py:51",
                          [DECODE_N, D], "bfloat16"),
        "fused_rmsnorm_residual": ("fused_norm.cu", "fused_norm/kernel.py:78",
                                   [DECODE_N, D], "bfloat16"),
        "fused_mlp": ("fused_mlp.cu", "fused_mlp/kernel.py:75",
                      [DECODE_N, D, F_FF], "bfloat16"),
        "flash_attention": ("flash_attention.cu", "flash_attention/kernel.py:80",
                            [1, 512, H, HKV, HD], "bfloat16"),
        "wkv6": ("wkv6.cu", "wkv6/kernel.py:73",
                 [DECODE_N, 1, RWKV_H, RWKV_D], "float32"),
        "rglru_scan": ("rglru_scan.cu", "rglru_scan/kernel.py:39",
                       [DECODE_N, 1, LRU_W], "float32"),
    }
    kernels = []
    for name, (source, replaces, shape, dtype) in meta.items():
        row = next(r for r in rows if r["name"] == name and r["shape"] == shape
                   and r["dtype"] == dtype)
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{source}",
                        "replaces": f"src/repro/kernels/{replaces}",
                        "launches": counts[name],
                        "max_abs_err": row["max_err"], "ms": row["kernel_ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "shape": shape,
                        "dtype": dtype, "build_s": build_s})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
