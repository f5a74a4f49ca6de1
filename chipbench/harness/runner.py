"""One run of one cell: set-up, the measured window, the traced
sub-window (`--trace 1`), the correctness check, and the result.

Set-up: the configuration's policy (every operator's batch set to the
cell's slots) through `repro_torch.launch.serve.configure`; the cell's
kernels built (`repro_torch.kernels._build`: a library a source, cached
in the checkout's `build/kernels/` by the digest of its source); the
weights drawn on the device from the seed; a `ServingEngine`; every
client's warm-up request, stepped until each has finished one.
`setup_s` runs from the process's start to the window's opening.
"""
from __future__ import annotations

import gc
import importlib
import sys
import time

from . import check, loop as loop_mod, weights as weights_mod, window

WARMUP_LIMIT_S = 240.0
# the numbers a cell may compare (with a `<name>_limit` in its check),
# and the control's reading of each
COMPARED = {"logit_gap": "control_gap", "mean_logit_gap": "control_mean_gap"}


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def kernels_of(mcfg) -> list[str]:
    """The CUDA sources a configured model launches on the dense state."""
    names = []
    if mcfg.norm_impl == "fused":
        names.append("fused_norm")
    if mcfg.mlp_impl == "fused":
        names += ["fused_mlp"] + (["moe_mlp"] if mcfg.use_moe else [])
    if mcfg.attn_impl == "flash":
        names.append("flash_attention")
    return names


def family(cfg: dict):
    """The configuration's module under `chipbench/layouts/`: its
    `model_config(cfg)` and `leaves(model_config)`."""
    return importlib.import_module(f"layouts.{cfg['layout']}")


def layout(cfg: dict, mcfg):
    return family(cfg).leaves(mcfg)


def build(cell, seed: int, device, log=_log):
    """(engine, model config) of a cell, weights drawn from `seed`."""
    import torch

    from repro_torch.launch.policy import ExecutionPolicy
    from repro_torch.launch.serve import configure
    from repro_torch.serving.engine import ServingEngine

    cfg = cell.config
    slots = int(cell.spec["slots"])
    pol = dict(cell.policy, operators=[dict(op, batch=slots) for op in cell.policy["operators"]])
    mcfg, eng_kwargs = configure(family(cfg).model_config(cfg), policy=ExecutionPolicy.from_dict(pol),
                                 max_batch=slots, device=device, log=log)
    if eng_kwargs["device"].type == "cuda":
        from repro_torch.kernels import _build

        names = kernels_of(mcfg)
        log(f"[chipbench] kernels {names}: {_build.build(names):.1f} s to build or find")
    w = weights_mod.draw(layout(cfg, mcfg), seed, eng_kwargs["device"], mcfg.tparam_dtype)
    eng = ServingEngine(mcfg, w, max_len=int(cell.spec["max_len"]), seed=int(seed) % (1 << 62),
                        **eng_kwargs)
    if eng.paged:
        raise ValueError("the harness drives the dense KV state; the engine chose pages")
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return eng, mcfg


def run(cell, seed: int, seconds: float, trace: bool, *, device="cuda", t_start: float,
        control: bool = False, log=_log, clock=time.monotonic) -> dict:
    """The result of one run, as `run.py` prints it (without `device`'s
    card fields, which `run.py` adds).  `clock`: the host clock every mark
    and the window read (a test may give one that counts its reads).
    With `control` (never in a benchmark run) the float8 control's
    readings take the program's place in the checks, so that `correct`
    judges the control by the same decision; `compared` keeps both."""
    import torch

    from repro_torch.serving.engine import Request

    from .traffic import Traffic

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_build = clock()
    eng, mcfg = build(cell, seed, device, log)
    log(f"[chipbench] set-up: {t_build - t_start:.2f} s to the engine's build, "
        f"{clock() - t_build:.2f} s to build it")
    traffic = Traffic(cell.traffic, seed, int(cell.spec["slots"]), cell.config["vocab_size"])
    lp = loop_mod.ClosedLoop(eng, traffic, Request, clock)
    failure = None
    res = None
    try:
        lp.start()
        lp.warm_up(WARMUP_LIMIT_S)
        if cuda:
            torch.cuda.synchronize()
        setup_s = clock() - t_start
        log(f"[chipbench] set-up: warm-up to {setup_s:.2f} s, {lp.steps} steps")
        before = {k: v for k, v in eng.stats.items() if isinstance(v, int)}
        gc.disable()
        try:
            opened, closed, steps = lp.run_for(seconds)
        finally:
            gc.enable()
        after = {k: v for k, v in eng.stats.items() if isinstance(v, int)}
        if trace:
            from .trace import traced

            res = traced(lp, float(cell.spec.get("trace_seconds", 3.0)), log=log)
    except loop_mod.StallError as e:
        failure = str(e)
        setup_s = clock() - t_start
        opened = closed = clock()
        steps, before, after = 0, {}, {}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    recs = lp.recs
    attempted = sum(1 for r in recs if r.req.t_submit is not None and r.req.t_submit <= closed)
    failed = sum(1 for r in recs if r.done and not r.ok)
    e2e = window.end_to_end(recs, opened, closed) if closed > opened else {}
    spec = cell.spec["check"]
    picked = check.sample(recs, opened, closed, seed, int(spec["sample_tokens"]),
                          int(spec["sample_max"]))
    items = [check.served(r) for r in picked]
    # the program's state goes before the reference runs
    lp.eng = None
    del eng, lp
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_w = weights_mod.draw(layout(cell.config, mcfg), seed, device, mcfg.tparam_dtype)
    t_ref = time.monotonic()
    compared = check.gaps(cell.config, ref_w, items, device, control=control) if items else {}
    del ref_w
    log(f"[chipbench] reference over {len(items)} requests: {compared} "
        f"in {time.monotonic() - t_ref:.2f} s")
    checks = {"failed_requests": {"value": failed, "limit": 0}}
    for name, ctl in COMPARED.items():
        if f"{name}_limit" in spec:
            checks[name] = {"value": compared.get(ctl if control else name),
                            "limit": spec[f"{name}_limit"]}
    correct = failure is None and failed == 0 and bool(items) and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    ctx = {"cfg": cell.config, "e2e": e2e, "opened": opened, "closed": closed, "steps": steps,
           "stats": {k: after[k] - before[k] for k in after}, "recs": recs,
           "processed": window.processed(recs, opened, closed), "peak_bytes": peak,
           "trace": res}
    return {"correct": correct, "attempted": attempted, "failed": failed + (failure is not None),
            "failure": failure, "setup_s": setup_s, "ctx": ctx, "checks": checks,
            "compared": compared,
            "peak_bytes": peak, "trace": res}
