"""Gloo ranks on the CPU for the port's mesh tests.

`run(tmp_path, meshes, jobs)` spawns, for each (world, model axis) of
`meshes`, `world` processes that join a gloo process group through a
`FileStore` under `tmp_path` (so no port is shared between pytest-xdist
workers), build a ("data", "model") mesh with that model axis, run
every job (or those naming the mesh) and return rank 0's results by
job name.  One spawn runs many jobs.  A job is (name, kind,
kwargs): "forward" (logits of a forward, a prefill and two decode steps
of the port's transformer under the mesh), "family_forward" (the same
through `api` for any family, whisper's frames in the batch), "engine"
(greedy tokens of the port's `ServingEngine(mesh=...)`), "moe" (a MoE
block's output), "replicas" (`replica_meshes` over the data axis),
"cluster" (a `ServingCluster(mesh=...)` run: closed loop, the chaos
drill or open loop with deadlines, with every rank's request records)
or "spec" (`SpecDecodeEngine(mesh=...)` tokens and `spec_stats`).
Each result carries the collectives it called (`collectives.COUNTS`).

Imports no JAX: the children run the port alone.
"""
from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(tmp_path, meshes: list, jobs: list, meanwhile=None):
    """Run `jobs` on each mesh of `meshes` ((world, model axis) pairs, all
    spawned at once); returns {mesh: rank 0's results by job name}.
    `meanwhile`: a function called while the ranks run; then returns
    (its result, the results)."""
    job_path = tmp_path / "jobs.pt"
    torch.save(jobs, job_path)
    procs = {}
    for world, model_axis in meshes:
        tag = f"{world}x{model_axis}"
        procs[(world, model_axis)] = (tmp_path / f"out-{tag}.pt", mp.start_processes(
            _child, args=(world, model_axis, str(tmp_path / f"store-{tag}"),
                          str(job_path), str(tmp_path / f"out-{tag}.pt")),
            nprocs=world, join=False, start_method="spawn"))
    side = meanwhile() if meanwhile is not None else None
    # a rank that raises ends its spawn: the others are killed and its
    # traceback is raised here
    for _, ctx in procs.values():
        while not ctx.join():
            pass
    got = {mesh: torch.load(out, weights_only=False) for mesh, (out, _) in procs.items()}
    return got if meanwhile is None else (side, got)


def _child(rank, world, model_axis, store_path, job_path, out_path):
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    mesh = make_host_mesh(model_axis, backend="gloo", device_type="cpu")
    # a job may name the (world, model axis) meshes it runs on (4th entry)
    results = {job[0]: KINDS[job[1]](mesh, **job[2])
               for job in torch.load(job_path, weights_only=False)
               if len(job) < 4 or (world, model_axis) in job[3]}
    if rank == 0:
        torch.save(results, out_path)
    dist.barrier()
    dist.destroy_process_group()


def _counted(fn):
    from repro_torch.parallel import collectives as coll
    coll.reset()
    out = fn()
    return out, dict(coll.COUNTS)


def forward_job(mesh, cfg, params, tokens, max_len):
    """Logits of forward(tokens), of prefill(tokens)'s last token and of
    two greedy decode steps after it, under the mesh."""
    from repro_torch.models import transformer
    from repro_torch.parallel import sharding

    sp = sharding.shard_params(params, mesh, cfg)

    def go():
        with sharding.use_mesh(mesh):
            logits = transformer.forward(cfg, sp, tokens)
            last, cache = transformer.prefill(cfg, sp, tokens, max_len)
            steps = []
            tok = last[:, -1].argmax(-1, keepdim=True)
            for _ in range(2):
                lg, cache = transformer.decode_step(cfg, sp, tok, cache)
                steps.append(lg)
                tok = lg[:, -1].argmax(-1, keepdim=True)
        return {"forward": logits, "prefill": last, "decode": torch.stack(steps)}

    out, counts = _counted(go)
    return dict(out, counts=counts)


def family_forward_job(mesh, cfg, params, batch, max_len):
    """`forward(batch)`, `prefill`'s last logits and two greedy decode
    steps after it through `api` under the mesh (any family)."""
    from repro_torch.models import api
    from repro_torch.parallel import sharding

    sp = sharding.shard_params(params, mesh, cfg)

    def go():
        with sharding.use_mesh(mesh):
            logits = api.forward(cfg, sp, batch)
            last, cache = api.prefill(cfg, sp, batch, max_len)
            steps = []
            tok = last[:, -1].argmax(-1, keepdim=True)
            for _ in range(2):
                lg, cache = api.decode_step(cfg, sp, tok, cache)
                steps.append(lg)
                tok = lg[:, -1].argmax(-1, keepdim=True)
        return {"forward": logits, "prefill": last, "decode": torch.stack(steps)}

    out, counts = _counted(go)
    return dict(out, counts=counts)


def engine_job(mesh, cfg, params, prompts, max_new, frames=None, **eng_kw):
    """Greedy tokens and finish reasons of the port's engine on the mesh
    (its blocks of `params` cut by `shard_params`); `frames`: one frame
    array (or None) a request, whisper's."""
    from repro_torch.parallel import sharding
    from repro_torch.serving.engine import Request, ServingEngine

    def go():
        eng = ServingEngine(cfg, sharding.shard_params(params, mesh, cfg), device="cpu",
                            mesh=mesh, **eng_kw)
        reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=max_new,
                        frames=None if frames is None else frames[i])
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return {"tokens": [r.out_tokens for r in reqs],
                "reasons": [r.finish_reason for r in reqs],
                "decode_steps": eng.stats["decode_steps"],
                "prefills": eng.stats["prefills"]}

    out, counts = _counted(go)
    return dict(out, counts=counts)


def moe_job(mesh, cfg, params, x):
    """transformer.moe_block(cfg, params, x) under the mesh (params: one
    MoE layer's tree, sharded here as a stacked segment's would be)."""
    from repro_torch.models import transformer
    from repro_torch.parallel import sharding

    tree = {"segments": [{"kind_moe": {"moe": {k: v[None] for k, v in params.items()
                                              if k != "shared"}}}]}
    if "shared" in params:
        tree["segments"][0]["kind_moe"]["moe"]["shared"] = {
            k: v[None] for k, v in params["shared"].items()}
    sp = sharding.shard_params(tree, mesh, cfg)["segments"][0]["kind_moe"]["moe"]
    sp = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0])
          for k, v in sp.items()}

    def go():
        with sharding.use_mesh(mesh):
            return transformer.moe_block(cfg, sp, x)

    out, counts = _counted(go)
    return {"y": out, "counts": counts}


def replicas_job(mesh):
    """`replica_meshes` split over the mesh's data axis (one replica a data
    rank): this rank's replica mesh, a sum over its "model" group and
    its root's broadcast."""
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding

    n = mesh.shape["data"]
    subs = sharding.replica_meshes(mesh, n)
    own = [m for m in subs if isinstance(m, Mesh)]
    assert len(own) == 1
    m = own[0]
    total = coll.all_reduce(torch.tensor([float(dist.get_rank())]), m, "model")
    root = coll.broadcast(torch.tensor([dist.get_rank()]), m)
    return {"n": n, "shapes": [dict(s.shape) for s in subs], "rank": m.rank,
            "root": m.root, "sum": float(total[0]), "bcast": int(root[0])}


def _records(reqs) -> list:
    return [(r.rid, list(r.out_tokens), r.finish_reason, r.done, r.requeues, r.admit_seq,
             r.t_submit, r.t_first, r.t_done) for r in reqs]


def cluster_job(mesh, cfg, params, n_replicas, mode, n_requests, seed, max_new,
                bands, router="round_robin", chaos=None, stall_steps=50, rate=0.0,
                deadline_s=None, **eng_kw):
    """A `ServingCluster(mesh=...)` run over `n_replicas` of the mesh's data
    rows, on the requests `serving.workload` draws from `seed`: "closed"
    (all submitted, then `run`), "chaos" (`run` under
    `ChaosSchedule.generate(*chaos)`, a watchdog of `stall_steps`) or
    "open" (`LoadGenerator` at `rate` with deadlines of `deadline_s`,
    `drive`).  Returns the digest (tokens, finish reasons, summary
    counters, per-replica rows, stats, watchdog log, health, assignment)
    and every rank's request records (`all_gather_object`)."""
    from repro_torch.serving import cluster, resilience, workload

    def go():
        kw = dict(eng_kw, device="cpu")
        cl = cluster.ServingCluster(cfg, params, n_replicas=n_replicas, router=router,
                                    mesh=mesh, watchdog=resilience.Watchdog(
                                        n_replicas, stall_steps=stall_steps), **kw)
        script = None
        if mode == "open":
            lg = cluster.LoadGenerator(n_requests=n_requests, rate=rate, vocab=cfg.vocab,
                                       seed=seed, max_new_tokens=max_new, bands=bands,
                                       deadline_bands=((deadline_s, deadline_s),))
            trace = lg.schedule()
            cl.drive(trace)
            reqs = [r for _, r in trace]
        else:
            reqs = workload.zipf_mix_requests(np.random.default_rng(seed), n_requests,
                                              cfg.vocab, bands=bands, max_new_tokens=max_new)
            for r in reqs:
                cl.submit(r)
            if mode == "chaos":
                script = resilience.ChaosSchedule.generate(chaos[0], n_replicas=n_replicas,
                                                           horizon=chaos[1],
                                                           restart_after=chaos[2])
            cl.run(chaos=script)
        summ = cl.metrics.summary(cl)
        return {"tokens": {r.rid: list(r.out_tokens) for r in reqs},
                "finish": {r.rid: r.finish_reason for r in reqs},
                "aggregate": summ["aggregate"], "rows": summ["per_replica"],
                "stats": dict(cl.stats), "events": list(cl.watchdog.events),
                "healthy": list(cl.healthy), "assignment": dict(cl.assignment),
                "poisoned": None if script is None else list(script.poisoned),
                "records": _records(reqs)}

    out, counts = _counted(go)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, out["records"])
    return dict(out, counts=counts, ranks=ranks)


def spec_job(mesh, cfg, params, n_draft, k, prompts, max_new, **eng_kw):
    """`SpecDecodeEngine(mesh=...)`: the target's blocks of `params`, a
    whole shared-trunk draft of `n_draft` layers; tokens, finish reasons
    and `spec_stats`."""
    from repro_torch.parallel import sharding
    from repro_torch.serving.engine import Request
    from repro_torch.serving.specdec import SpecDecodeEngine, shared_trunk_draft

    def go():
        dcfg, dparams = shared_trunk_draft(cfg, params, n_draft)
        eng = SpecDecodeEngine(cfg, sharding.shard_params(params, mesh, cfg), dcfg, dparams,
                               k=k, device="cpu", mesh=mesh, **eng_kw)
        reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        st = eng.spec_stats
        return {"tokens": [r.out_tokens for r in reqs],
                "reasons": [r.finish_reason for r in reqs],
                "spec_stats": (st.iterations, st.proposed, st.accepted, st.bonus)}

    out, counts = _counted(go)
    return dict(out, counts=counts)


KINDS = {"forward": forward_job, "family_forward": family_forward_job,
         "engine": engine_job, "moe": moe_job, "replicas": replicas_job,
         "cluster": cluster_job, "spec": spec_job}
