"""Serve launcher of the port: the continuous-batching engine on
synthetic requests, optionally driven by a Mozart deployment artifact.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        [--smoke] [--policy deployment.json] [--device cuda|cpu] \
        [--requests 8] [--max-new 16] [--max-batch 4] [--max-len 128] \
        [--replicas 2 --router round_robin --rate 4 --deadline-ms 2000 \
         --chaos --chaos-seed 0] [--scenario specdec --k 4] [--specdec]

`--replicas N` (N > 1) serves through a `ServingCluster` of N replicas
on the device, fed by the seeded open-loop `LoadGenerator` at `--rate`
requests a second (0: a burst), each request with a `--deadline-ms` SLO
(0: none); `--chaos` replays `ChaosSchedule.generate(--chaos-seed)` over
a horizon of max(requests x max-new, 64) cluster steps.  `--scenario
specdec` serves through the live `SpecDecodeEngine` (draft: the first
quarter of the target's layers, shared trunk); `--specdec` runs the
uncached reference loop with a fresh draft of a quarter of the layers.

`--policy` takes a `mozart-deployment/v1` artifact or a bare policy JSON
and applies it as the JAX launcher does: flash_attention ->
attn_impl="flash" (flash prefill, paged decode from the page pool),
fused_mlp -> mlp_impl="fused" (the fused MLP, or `moe_mlp` on MoE
layers), fused_norm -> norm_impl="fused" (the CUDA kernels), and the
policy's batch split sets the engine's max/decode batch.  A policy with
tp > 1 whose tp the cards divide runs on a mesh over every card, for
any family, as the JAX launcher's `make_host_mesh(model_axis=tp)` does:
`main` starts one rank a card over NCCL (`tcp://localhost`, a free
port), each builds the (cards / tp, tp) `launch.mesh` mesh and serves
the same requests: one engine (its dense KV batch, or one long
sequence's cache length, over "data"; tensor-parallel over "model"), a
`ServingCluster` of `--replicas N` replicas, `replica_meshes` carving
the data axis into N blocks (an N that does not divide it is refused
with JAX's error before any rank starts), or, with `--scenario
specdec`, a `SpecDecodeEngine` with the target sharded and the draft
replicated (`--specdec`: the reference loop with the target's forward
sharded); rank 0 prints.  A policy whose tp the cards do not divide
runs unsharded, as in JAX.  Weights are random, from `--seed`.
"""
from __future__ import annotations

import argparse
import socket
import sys
import time
from typing import Any

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.launch.policy import ExecutionPolicy, load_policy
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.serving import cluster as cluster_mod
from repro_torch.serving import resilience
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.specdec import SPEC_K


def apply_policy(pol: ExecutionPolicy, mcfg: ModelConfig, max_batch: int,
                 n_devices: int | None = None
                 ) -> tuple[ModelConfig, dict, list[str]]:
    """Lower an ExecutionPolicy onto the serving substrate: (model config,
    ServingEngine kwargs plus "mesh_tp", log lines) — the JAX launcher's
    mapping.  Pure: no engine is built here."""
    if n_devices is None:
        n_devices = max(1, torch.cuda.device_count())
    lines: list[str] = []
    flags = pol.fusion_flags()

    applied = []
    if flags["flash_attention"]:
        if mcfg.family == "transformer":
            mcfg = mcfg.replace(attn_impl="flash")
            applied.append("flash_attention->attn_impl=flash")
        elif mcfg.family == "rglru":
            applied.append("flash_attention(no hook: rglru's interleaved "
                           "attention decodes through its ring-buffer "
                           "window path)")
        elif mcfg.family == "whisper":
            applied.append("flash_attention(no hook: whisper decoder "
                           "blocks interleave cross-attention over the "
                           "encoder window)")
        else:
            applied.append(f"flash_attention(no hook: {mcfg.family} has "
                           f"no softmax-attention operator)")
    if flags["fused_mlp"]:
        if mcfg.family == "transformer":
            mcfg = mcfg.replace(mlp_impl="fused")
            applied.append("fused_mlp->mlp_impl=fused" + (
                " (MoE layers: the moe_mlp kernel over the expert capacity "
                "buffers)" if mcfg.use_moe else ""))
        elif mcfg.family == "whisper":
            applied.append("fused_mlp(no hook: whisper cross-attn blocks "
                           "interleave the MLP with encoder reads)")
        else:
            applied.append(f"fused_mlp(no hook: {mcfg.family} uses gated "
                           f"recurrent channel mixing, not the plain MLP "
                           f"the fused kernel covers)")
    if flags["fused_norm"]:
        if mcfg.family == "transformer" and mcfg.norm == "rmsnorm":
            mcfg = mcfg.replace(norm_impl="fused")
            applied.append("fused_norm->norm_impl=fused")
        elif mcfg.family == "transformer":
            applied.append(f"fused_norm(no hook: norm={mcfg.norm}; the "
                           f"fused kernel implements rmsnorm only)")
        else:
            applied.append(f"fused_norm(no hook: {mcfg.family}'s norm "
                           f"dispatch has no fused path, norm="
                           f"{mcfg.norm})")
    lines.append(f"[serve] policy network={pol.network} "
                 f"fusion flags: flash_attention={flags['flash_attention']} "
                 f"fused_mlp={flags['fused_mlp']} "
                 f"fused_norm={flags['fused_norm']} "
                 f"applied=[{', '.join(applied) or 'none'}]")

    # Insight 2's batch split: batch-sensitive stages set the slot count,
    # batch-agnostic stages bound the lock-step decode batch; the CLI
    # --max-batch stays a cap
    sens, agn = pol.batch_sensitive_batch, pol.batch_agnostic_batch
    eng_batch = max(1, min(max_batch, sens))
    dec_batch = max(1, min(eng_batch, agn))
    lines.append(f"[serve] policy microbatch: max_batch {max_batch}->"
                 f"{eng_batch} (batch_sensitive_batch={sens}), "
                 f"decode_batch={dec_batch} (batch_agnostic_batch={agn})")
    if mcfg.family != "transformer":
        lines.append(f"[serve] policy microbatch: {mcfg.family} decodes "
                     f"gathered at width {dec_batch} (recurrent state is "
                     f"irreversible; no full-width emulation)")
    tp = pol.tp_degree
    if tp > 1 and n_devices % tp == 0 and n_devices >= tp:
        lines.append(f"[serve] policy tp={tp}: building mesh with model "
                     f"axis {tp} over {n_devices} device(s); engine "
                     f"params/cache/compute shard over it")
        mesh_tp = tp
    else:
        if tp > 1:
            lines.append(f"[serve] policy tp={tp}: only {n_devices} "
                         f"device(s), running unsharded (tp=1)")
        mesh_tp = 1
    return mcfg, {"max_batch": eng_batch, "decode_batch": dec_batch,
                  "mesh_tp": mesh_tp}, lines


def configure(mcfg: ModelConfig, *, policy: ExecutionPolicy | None = None,
              max_batch: int = 4, device=None, log=print) -> tuple[ModelConfig, dict]:
    """Apply `policy` (if any) to `mcfg`: (model config, engine kwargs:
    device and batch)."""
    dev = resolve_device(device)
    eng_kwargs = {"max_batch": max_batch}
    if policy is not None:
        mcfg, eng_kwargs, lines = apply_policy(
            policy, mcfg, max_batch,
            n_devices=torch.cuda.device_count() if dev.type == "cuda" else 1)
        for ln in lines:
            log(ln)
        eng_kwargs.pop("mesh_tp")
    return mcfg, dict(eng_kwargs, device=dev)


def prepare(mcfg: ModelConfig, *, policy: ExecutionPolicy | None = None,
            max_batch: int = 4, seed: int = 0, device=None, mesh=None, log=print
            ) -> tuple[ModelConfig, Any, dict]:
    """Apply `policy` (if any) to `mcfg` and draw seeded weights on
    `device` (under `mesh` this rank's blocks only): (model config,
    params, engine kwargs: device and batch)."""
    mcfg, eng_kwargs = configure(mcfg, policy=policy, max_batch=max_batch, device=device,
                                 log=log)
    params = api.init_params(mcfg, seed, device=eng_kwargs["device"], mesh=mesh)
    return mcfg, params, eng_kwargs


def build_engine(mcfg: ModelConfig, *, policy: ExecutionPolicy | None = None,
                 max_batch: int = 4, max_len: int = 128, seed: int = 0,
                 device=None, kv_quant: bool | str = False, paged: bool = True,
                 enc_len: int | None = None, mesh=None, log=print) -> ServingEngine:
    """Apply `policy` (if any) to `mcfg`, draw seeded weights on `device`
    and build the engine (`kv_quant`, `paged`, `enc_len`, `mesh`: the
    engine's switches; `enc_len`, whisper's encoder window, defaults to
    `max_len` as in the JAX package; under `mesh` every rank draws the
    model from the seed one layer's leaf at a time and keeps its blocks:
    a card holds its shards, not the whole model)."""
    if mesh is not None and device is None:
        device = mesh.device
    mcfg, params, eng_kwargs = prepare(mcfg, policy=policy, max_batch=max_batch,
                                       seed=seed, device=device, mesh=mesh, log=log)
    return ServingEngine(mcfg, params, max_len=max_len, kv_quant=kv_quant,
                         paged=paged, enc_len=enc_len, mesh=mesh, **eng_kwargs)


def serve(engine: ServingEngine, requests: list[Request]) -> dict:
    """Submit every request at once, run the engine dry and summarize:
    tokens, wall seconds, tokens/s, TTFT and TPOT percentiles (host clock;
    the engine waits for each step's tokens, so the marks are real).
    Counts are those of this call, not of the engine's lifetime."""
    before = {k: v for k, v in engine.stats.items() if isinstance(v, int)}
    for r in requests:
        engine.submit(r)
    t0 = time.perf_counter()
    engine.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    ttft = [r.t_first - r.t_submit for r in requests if r.t_first is not None]
    tpot = [(r.t_done - r.t_first) / (len(r.out_tokens) - 1)
            for r in requests
            if r.t_first is not None and r.t_done is not None
            and len(r.out_tokens) > 1]
    st = {k: engine.stats[k] - v for k, v in before.items()}

    def pct(xs, q):
        return float(np.percentile(xs, q) * 1e3) if xs else float("nan")

    return {"tokens_out": st["tokens_out"], "seconds": dt,
            "tokens_per_s": st["tokens_out"] / max(dt, 1e-9),
            "ttft_p50_ms": pct(ttft, 50), "ttft_p99_ms": pct(ttft, 99),
            "tpot_p50_ms": pct(tpot, 50), "tpot_p99_ms": pct(tpot, 99),
            "decode_steps": st["decode_steps"], "prefills": st["prefills"],
            "preemptions": st["preemptions"], "nan_steps": st["nan_steps"],
            "occupancy": (st["occupied_slot_steps"] / (st["decode_steps"] * engine.max_batch)
                          if st["decode_steps"] else 0.0)}


def serve_cluster(mcfg: ModelConfig, params, *, n_replicas: int,
                  router: str = cluster_mod.ROUTER, rate: float = 0.0,
                  deadline_ms: float = 0.0, chaos_horizon: int = 0,
                  chaos_seed: int = resilience.CHAOS_SEED, n_requests: int = 8,
                  max_new: int = 16, seed: int = 0, log=print, **engine_kwargs) -> dict:
    """Serve `n_requests` from the seeded `LoadGenerator` (Poisson at
    `rate`, deadline `deadline_ms`, 0 = none) through a `ServingCluster` of
    `n_replicas` engines on one set of weights (`mesh` in `engine_kwargs`:
    per-replica meshes, `params` as `ServingCluster` takes them there);
    `chaos_horizon` > 0
    replays `ChaosSchedule.generate(chaos_seed)` over that many steps (the
    CLI's `--chaos` passes max(requests x max-new, 64)).  Returns the
    cluster's `summary` with "seconds", "tokens_per_s", the cluster, its
    requests and the chaos script ("chaos", None without one)."""
    deadline_bands = ((deadline_ms / 1e3, deadline_ms / 1e3),) if deadline_ms > 0 else None
    cl = cluster_mod.ServingCluster(mcfg, params, n_replicas=n_replicas, router=router,
                                    **engine_kwargs)
    lg = cluster_mod.LoadGenerator(n_requests=n_requests, rate=rate, vocab=mcfg.vocab,
                                   seed=seed, max_new_tokens=max_new,
                                   deadline_bands=deadline_bands)
    schedule = None
    if chaos_horizon > 0:
        schedule = resilience.ChaosSchedule.generate(
            chaos_seed, n_replicas=n_replicas, horizon=chaos_horizon)
        log(f"[serve] chaos script: "
            f"{[(e.step, e.kind, e.replica) for e in schedule.events]}")
    trace = lg.schedule()
    t0 = time.perf_counter()
    summary = cl.drive(trace, chaos=schedule)
    dev = next(e.device for e in cl.replicas if isinstance(e, ServingEngine))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    agg = summary["aggregate"]
    log(f"[serve] cluster x{n_replicas} router={cl.router.policy} rate={rate:g}: "
        f"{agg['tokens_out']} tokens in {dt:.2f}s "
        f"({agg['tokens_out'] / max(dt, 1e-9):.1f} tok/s aggregate), ttft p50/p99 "
        f"{agg['ttft_p50_ms']:.1f}/{agg['ttft_p99_ms']:.1f}ms, tpot p50/p99 "
        f"{agg['tpot_p50_ms']:.2f}/{agg['tpot_p99_ms']:.2f}ms")
    log(f"[serve]   goodput {agg['goodput_tokens']} tokens "
        f"({agg['goodput_tokens'] / max(dt, 1e-9):.1f} tok/s), deadlines met/missed "
        f"{agg['deadline_met']}/{agg['deadline_missed']}, shed={agg['shed']} "
        f"poisoned={agg['poisoned']} quarantined={agg['quarantined']} "
        f"restarts={agg['restarts']} unrouted={agg['n_unrouted']}")
    for row in summary["per_replica"]:
        log(f"[serve]   replica {row['replica']}: {row['tokens_out']} tokens, "
            f"{row['prefills']} prefills, {row['preemptions']} preemptions")
    return dict(summary, seconds=dt, tokens_per_s=agg["tokens_out"] / max(dt, 1e-9),
                cluster=cl, requests=[r for _, r in trace], chaos=schedule)


def _specdec_demo(mcfg: ModelConfig, params, args, rng, dev, log=print, mesh=None) -> None:
    """The uncached reference loop: a fresh draft of a quarter of the
    target's layers, one 12-token prompt.  `mesh`: `params` are this
    rank's blocks and the target's forward runs sharded; the draft is
    whole on every rank."""
    from repro_torch.models import transformer
    from repro_torch.parallel import sharding
    from repro_torch.serving.specdec import spec_decode_greedy

    if mcfg.family != "transformer":
        raise SystemExit("specdec demo targets transformer archs")
    dcfg = mcfg.replace(n_layers=max(1, mcfg.n_layers // 4))
    dparams = api.init_params(dcfg, args.seed + 1, device=dev)
    prompt = rng.integers(0, mcfg.vocab, size=12).astype(np.int32)

    def target(t):
        with sharding.use_mesh(mesh):
            return transformer.forward(mcfg, params, t)

    t0 = time.perf_counter()
    out, st = spec_decode_greedy(
        target, lambda t: transformer.forward(dcfg, dparams, t), prompt, k=args.k,
        max_new_tokens=args.max_new, device=dev)
    dt = time.perf_counter() - t0
    log(f"[serve] specdec: {len(out)} tokens in {dt:.2f}s; "
        f"accept={st.acceptance_rate:.2f} tokens/iter={st.tokens_per_iteration:.2f}")


def serve_specdec(mcfg: ModelConfig, params, requests: list[Request], *, k: int = SPEC_K,
                  mesh=None, log=print, **engine_kwargs) -> dict:
    """The live spec-decode scenario: a `SpecDecodeEngine` with the
    target's first quarter of layers as a shared-trunk draft serves
    `requests`; returns `serve`'s summary with the acceptance, tokens an
    iteration and the engine.  `mesh`: `params` is the whole tree; the
    target takes this rank's blocks, the draft stays whole (replicated)."""
    from repro_torch.parallel import sharding
    from repro_torch.serving.specdec import SpecDecodeEngine, shared_trunk_draft

    if mcfg.family != "transformer":
        raise SystemExit("--scenario specdec needs a transformer arch")
    dcfg, dparams = shared_trunk_draft(mcfg, params, max(1, mcfg.n_layers // 4))
    if mesh is not None:
        params = sharding.shard_params(params, mesh, mcfg)
    eng = SpecDecodeEngine(mcfg, params, dcfg, dparams, k=k, mesh=mesh, **engine_kwargs)
    log(f"[serve] scenario=spec_decode: live spec-decode, k={k}, draft=shared-trunk "
        f"{dcfg.n_layers}/{mcfg.n_layers} layers")
    s = serve(eng, requests)
    st = eng.spec_stats
    log(f"[serve] specdec-live: {s['tokens_out']} tokens in {s['seconds']:.2f}s "
        f"({s['tokens_per_s']:.1f} tok/s); accept={st.acceptance_rate:.2f} "
        f"tokens/iter={st.tokens_per_iteration:.2f} ({s['decode_steps']} verify steps)")
    return dict(s, acceptance=st.acceptance_rate,
                tokens_per_iteration=st.tokens_per_iteration, engine=eng)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--policy", default=None, metavar="DEPLOYMENT_JSON",
                   help="mozart deployment artifact (or bare policy JSON) "
                        "to apply: fusion flags, microbatches and tp")
    p.add_argument("--policy-network", default=None,
                   help="which network's policy to take from a "
                        "multi-network artifact")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kv-quant", default="0", choices=("0", "1", "dense"),
                   help="int8 KV: 1 quantizes the paged pool; dense the "
                        "dense rectangles of a non-paged engine (--no-paged)")
    p.add_argument("--no-paged", action="store_true",
                   help="dense KV rectangles instead of the page pool")
    p.add_argument("--replicas", type=int, default=1,
                   help="serving-cluster replica count (> 1: a ServingCluster, "
                        "on the one device or, under a tp > 1 policy, over "
                        "the mesh's data axis)")
    p.add_argument("--router", default=cluster_mod.ROUTER,
                   choices=cluster_mod.ROUTER_POLICIES,
                   help="cluster routing policy")
    p.add_argument("--rate", type=float, default=0.0,
                   help="open-loop Poisson arrival rate in req/s for the "
                        "cluster path (0 = closed-loop burst)")
    p.add_argument("--deadline-ms", type=float, default=0.0,
                   help="per-request SLO deadline in ms (0 = none); "
                        "infeasible requests are shed at admission")
    p.add_argument("--chaos", action="store_true",
                   help="replay a seeded fault script (kill/restart/stall/"
                        "nan) against the cluster while it serves")
    p.add_argument("--chaos-seed", type=int, default=resilience.CHAOS_SEED,
                   help="seed of the chaos script")
    p.add_argument("--specdec", action="store_true",
                   help="speculative decoding demo (uncached reference loop; "
                        "see --scenario specdec for the live engine)")
    p.add_argument("--k", type=int, default=SPEC_K,
                   help="spec-decode draft window")
    p.add_argument("--scenario", default="", choices=("", "specdec"),
                   help="serving scenario: specdec serves through the live "
                        "SpecDecodeEngine (shared-trunk draft)")
    return p


def main(argv: list[str] | None = None) -> None:
    args = _parser().parse_args(argv)

    mcfg = configs.get_smoke_config(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    pol = load_policy(args.policy, args.policy_network) if args.policy \
        else None
    mesh_tp = 1
    if pol is not None and resolve_device(args.device).type == "cuda":
        mesh_tp = apply_policy(pol, mcfg, args.max_batch,
                               n_devices=torch.cuda.device_count())[1]["mesh_tp"]
    if mesh_tp > 1:
        # every card, as JAX's make_host_mesh takes every device: a
        # (cards / tp, tp) mesh whose data axis the replicas split
        world = torch.cuda.device_count()
        data = world // mesh_tp
        if args.replicas > 1 and data % args.replicas:
            raise ValueError(f"data axis of size {data} does not divide into "
                             f"{args.replicas} replicas")
        import torch.multiprocessing as mp
        mp.spawn(_serve_rank, args=(world, mesh_tp, free_port(),
                                    list(argv or sys.argv[1:])),
                 nprocs=world, join=True)
        return
    if args.specdec or args.scenario or args.replicas > 1:
        mcfg, params, eng_kwargs = prepare(mcfg, policy=pol, max_batch=args.max_batch,
                                           seed=args.seed, device=args.device)
        rng = np.random.default_rng(args.seed)
        if args.specdec:
            _specdec_demo(mcfg, params, args, rng, eng_kwargs["device"])
        elif args.scenario == "specdec":
            reqs = [Request(rid=i, prompt=rng.integers(0, mcfg.vocab, size=int(
                rng.integers(4, 12))).astype(np.int32), max_new_tokens=args.max_new)
                for i in range(args.requests)]
            serve_specdec(mcfg, params, reqs, k=args.k, max_len=args.max_len,
                          **eng_kwargs)
        else:
            serve_cluster(mcfg, params, n_replicas=args.replicas, router=args.router,
                          rate=args.rate, deadline_ms=args.deadline_ms,
                          chaos_horizon=max(args.requests * args.max_new, 64)
                          if args.chaos else 0, chaos_seed=args.chaos_seed,
                          n_requests=args.requests, max_new=args.max_new,
                          seed=args.seed, max_len=args.max_len,
                          kv_quant={"0": False, "1": True}.get(args.kv_quant,
                                                               args.kv_quant),
                          paged=not args.no_paged, **eng_kwargs)
        return
    eng = build_engine(mcfg, policy=pol, max_batch=args.max_batch,
                       max_len=args.max_len, seed=args.seed,
                       device=args.device,
                       kv_quant={"0": False, "1": True}.get(args.kv_quant,
                                                            args.kv_quant),
                       paged=not args.no_paged)
    _report(serve(eng, _cli_requests(args, eng.mcfg)), eng)


def free_port() -> int:
    """A free TCP port on localhost (for a process group's rendezvous)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _serve_rank(rank: int, world: int, tp: int, port: int, argv: list[str]) -> None:
    """One rank of `main` on a mesh: NCCL over `world` cards, a (world /
    tp, tp) mesh, the same requests as every other rank; rank 0 reports."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(model_axis=tp, backend="nccl")
        args = _parser().parse_args(argv)
        log = print if rank == 0 else (lambda _: None)
        mcfg = configs.get_smoke_config(args.arch) if args.smoke \
            else configs.get_config(args.arch)
        pol = load_policy(args.policy, args.policy_network)
        kv_quant = {"0": False, "1": True}.get(args.kv_quant, args.kv_quant)
        if args.replicas > 1 or args.scenario or args.specdec:
            mcfg, eng_kwargs = configure(mcfg, policy=pol, max_batch=args.max_batch,
                                         device=mesh.device, log=log)
            rng = np.random.default_rng(args.seed)
            if args.replicas > 1:
                serve_cluster(mcfg, lambda m: api.init_params(mcfg, args.seed, mesh=m),
                              n_replicas=args.replicas, router=args.router,
                              rate=args.rate, deadline_ms=args.deadline_ms,
                              chaos_horizon=max(args.requests * args.max_new, 64)
                              if args.chaos else 0, chaos_seed=args.chaos_seed,
                              n_requests=args.requests, max_new=args.max_new,
                              seed=args.seed, max_len=args.max_len, kv_quant=kv_quant,
                              paged=not args.no_paged, mesh=mesh, log=log, **eng_kwargs)
            elif args.scenario == "specdec":
                # the draft is replicated: every rank draws the whole tree
                full = api.init_params(mcfg, args.seed, device=mesh.device)
                serve_specdec(mcfg, full, _cli_requests(args, mcfg), k=args.k,
                              max_len=args.max_len, mesh=mesh, log=log, **eng_kwargs)
            else:
                params = api.init_params(mcfg, args.seed, mesh=mesh)
                _specdec_demo(mcfg, params, args, rng, mesh.device, log=log, mesh=mesh)
            return
        eng = build_engine(mcfg, policy=pol, max_batch=args.max_batch, max_len=args.max_len,
                           seed=args.seed, mesh=mesh, kv_quant=kv_quant,
                           paged=not args.no_paged, log=log)
        s = serve(eng, _cli_requests(args, eng.mcfg))
        if rank == 0:
            _report(s, eng)
    finally:
        dist.destroy_process_group()


def _cli_requests(args, mcfg: ModelConfig) -> list[Request]:
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(4, 12))
        reqs.append(Request(
            rid=i, prompt=rng.integers(0, mcfg.vocab, size=plen)
            .astype(np.int32), max_new_tokens=args.max_new))
    return reqs


def _report(s: dict, eng: ServingEngine) -> None:
    mesh = "" if eng.mesh is None else f", mesh {eng.mesh.shape}"
    print(f"[serve] {s['tokens_out']} tokens, {s['decode_steps']} steps, "
          f"{s['prefills']} prefills in {s['seconds']:.2f}s "
          f"({s['tokens_per_s']:.1f} tok/s, occupancy {s['occupancy']:.2f}), "
          f"ttft p50 {s['ttft_p50_ms']:.1f}ms, tpot p50 "
          f"{s['tpot_p50_ms']:.2f}ms on {eng.device}{mesh}"
          + (f", int8 KV ({eng.kv_quant_mode})" if eng.kv_quant_mode else ""))


if __name__ == "__main__":
    main()
