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
   version on the card, at the serving path's shapes (smollm-135m: d 576,
   F 1536, 9 query / 3 KV heads of 64), in bfloat16 and float32 (TF32
   off), with the tolerance stated; kernel, plain-version and library
   times from CUDA events, and the least time the card could take
   (bytes over 3.35 TB/s or operations over the type's peak).
3. Correctness end to end: smollm-135m at full width, 4 layers, float32,
   serves one 8-request trace through the plain impls and through the
   kernel impls; greedy tokens must be equal and the first prefill's
   logits within 1e-3.
4. Main path: the full smollm-135m (30 layers, bfloat16, random weights
   from a seed) through `repro_torch.launch.serve` with a policy that
   turns all three fusion flags on: 12 requests, prompts of 16-300
   tokens, 32 new tokens each, 4 slots, max_len 512.  Launch counts are
   set to 0 just before and read just after; every kernel must have run.
   Prints tokens/s, TTFT and TPOT.
5. Breakdown: the wall time of a steady decode step on the same engine,
   and from one profiled window the device's busy time and the heaviest
   kernels a step.

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
TOL_F32 = {"fused_rmsnorm": 1e-5, "fused_rmsnorm_residual": 1e-5,
           "fused_mlp": 1e-5, "flash_attention": 3e-5}
D, F_FF, H, HKV, HD = 576, 1536, 9, 3, 64  # smollm-135m
DECODE_N = 4                               # the main path's slot count


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
                 "fused_mlp": mk.MLP, "flash_attention": fk.FLASH}

    def record(name, shape, dtype, out, ref, kern, plain, lib, nbytes, flops):
        """`out` is the kernel's first result (launched by the caller);
        `launches` counts that launch and the timed ones."""
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


def main_path_phase(torch, launchers):
    """The full smollm-135m through the serve launcher's own functions."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.policy import load_policy
    from repro_torch.launch.serve import build_engine, serve
    from repro_torch.serving.engine import Request

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

    def requests(n, lo, hi, max_new):
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=int(p))
                        .astype(np.int32), max_new_tokens=max_new)
                for i, p in enumerate(rng.integers(lo, hi + 1, size=n))]

    serve(eng, requests(2, 16, 40, 4))          # warm-up: library handles
    for ln in launchers.values():
        ln.launches = 0
    reqs = requests(12, 16, 300, 32)
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


def breakdown_phase(torch, eng):
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
    eng.run()
    out = {"decode_step_ms": step_ms, "device_ms_per_step": dev_ms,
           "device_busy_share": dev_ms / step_ms,
           "kernels_per_step": len(kern) / n_prof,
           "top_kernels_ms_per_step": [[k[:60], v / n_prof / 1e3] for k, v in top]}
    print(json.dumps({"breakdown": out}), flush=True)
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
    launchers = {"fused_rmsnorm": nk.RMSNORM,
                 "fused_rmsnorm_residual": nk.RMSNORM_RESIDUAL,
                 "fused_mlp": mk.MLP, "flash_attention": fk.FLASH}
    eng, counts = main_path_phase(torch, launchers)
    breakdown_phase(torch, eng)

    meta = {
        "fused_rmsnorm": ("src/repro_torch/csrc/fused_norm.cu",
                          "src/repro/kernels/fused_norm/kernel.py:51", [DECODE_N, D]),
        "fused_rmsnorm_residual": ("src/repro_torch/csrc/fused_norm.cu",
                                   "src/repro/kernels/fused_norm/kernel.py:78",
                                   [DECODE_N, D]),
        "fused_mlp": ("src/repro_torch/csrc/fused_mlp.cu",
                      "src/repro/kernels/fused_mlp/kernel.py:75", [DECODE_N, D, F_FF]),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:80",
                            [1, 512, H, HKV, HD]),
    }
    kernels = []
    for name, (source, replaces, shape) in meta.items():
        row = next(r for r in rows if r["name"] == name and r["shape"] == shape
                   and r["dtype"] == "bfloat16")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": row["max_err"], "ms": row["kernel_ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "shape": shape,
                        "dtype": "bfloat16", "build_s": build_s})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
