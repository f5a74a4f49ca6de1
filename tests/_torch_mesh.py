"""Gloo ranks on the CPU for the port's mesh tests.

`run(tmp_path, meshes, jobs)` spawns, for each (world, model axis) of
`meshes`, `world` processes that join a gloo process group through a
`FileStore` under `tmp_path` (so no port is shared between pytest-xdist
workers), build a ("data", "model") mesh with that model axis, run
every job (or those naming the mesh) and return rank 0's results by
job name.  A mesh given as three sizes (pod, data, model) is a
("pod", "data", "model") mesh of their product's ranks.  One spawn runs
many jobs.  A job is (name, kind, kwargs): "forward" (logits of a
forward, a prefill and two decode steps of the port's transformer
under the mesh), "family_forward" (the same
through `api` for any family, whisper's frames in the batch), "engine"
(greedy tokens of the port's `ServingEngine(mesh=...)`, with its decode
state's split and per-rank leaf shapes), "moe" (a MoE
block's output), "replicas" (`replica_meshes` over the data axis),
"cluster" (a `ServingCluster(mesh=...)` run: closed loop, the chaos
drill or open loop with deadlines, with every rank's request records),
"spec" (`SpecDecodeEngine(mesh=...)` tokens and `spec_stats`), "grad"
(`value_and_grad` under the mesh, the gradients gathered whole),
"train" (`train(mesh=)` resumed from a checkpoint), "ckpt" (a checkpoint
saved on the mesh and restored onto (n, 1)), "grad_rules" (each
collective's gradient on toy tensors), "pipeline" (`pipeline_apply`
on a ("pp",) mesh of every rank), "fsdp_train" (training steps with
the weights held as FSDP's blocks and as the TP blocks), "fsdp_ckpt"
(an FSDP checkpoint restored onto (n, 1) without FSDP) or "fsdp_layout"
(`gather_held` on leaves of known values).
Each result carries the collectives it called (`collectives.COUNTS`).

Imports no JAX: the children run the port alone.
"""
from __future__ import annotations

import datetime
import math

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(tmp_path, meshes: list, jobs: list, meanwhile=None):
    """Run `jobs` on each mesh of `meshes` ((world, model axis) pairs, or
    (pod, data, model) sizes, all spawned at once); returns {mesh: rank
    0's results by job name}.
    `meanwhile`: a function called while the ranks run; then returns
    (its result, the results)."""
    job_path = tmp_path / "jobs.pt"
    torch.save(jobs, job_path)
    procs = {}
    for key in meshes:
        tag = "x".join(map(str, key))
        world = math.prod(key) if len(key) == 3 else key[0]
        procs[tuple(key)] = (tmp_path / f"out-{tag}.pt", mp.start_processes(
            _child, args=(tuple(key), str(tmp_path / f"store-{tag}"),
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


def _child(rank, key, store_path, job_path, out_path):
    from repro_torch.launch.mesh import make_host_mesh, make_mesh

    world = math.prod(key) if len(key) == 3 else key[0]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    if len(key) == 3:
        mesh = make_mesh(key, ("pod", "data", "model"), backend="gloo", device_type="cpu")
    else:
        mesh = make_host_mesh(key[1], backend="gloo", device_type="cpu")
    # a job may name the meshes it runs on (4th entry), as `run` takes them
    results = {job[0]: KINDS[job[1]](mesh, **job[2])
               for job in torch.load(job_path, weights_only=False)
               if len(job) < 4 or key in job[3]}
    if rank == 0:
        torch.save(results, out_path)
    dist.barrier()
    dist.destroy_process_group()


def _counted(fn):
    """(fn(), the forward collectives it called: `collectives.FORWARD`'s
    counts, which a backward's never enter)."""
    from repro_torch.parallel import collectives as coll
    coll.reset()
    out = fn()
    return out, {k: coll.COUNTS[k] for k in coll.FORWARD}


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


def state_digest(state) -> dict:
    """A decode state's split over "data" (None where it has none) and
    the per-rank shape of each of its KV leaves by path (the rectangles
    and index, or the page pools), with their bytes."""
    from repro_torch import bridge

    tree = state.cache if state.cache is not None else state.pool.segments
    leaves = bridge.tree_paths(tree)
    return {"split": getattr(state, "split", None), "length": getattr(state, "length", None),
            "cache": [(path, tuple(t.shape)) for path, t in leaves],
            "kv_bytes": sum(t.nbytes for _, t in leaves)}


def engine_job(mesh, cfg, params, prompts, max_new, frames=None, hold="tp",
               record_logits=False, **eng_kw):
    """Greedy tokens and finish reasons of the port's engine on the mesh
    (its blocks of `params` cut by `shard_params`, held as `hold`) and
    its decode state's `state_digest`; `frames`: one frame array (or
    None) a request, whisper's; `record_logits`: every decode step's
    logits too ("logits")."""
    from repro_torch.parallel import sharding
    from repro_torch.serving.engine import Request, ServingEngine

    seen: list = []

    def go():
        eng = ServingEngine(cfg, sharding.shard_params(params, mesh, cfg, hold), device="cpu",
                            mesh=mesh, hold=hold, **eng_kw)
        if record_logits:
            eng.state.decode = _recording(eng.state.decode, seen)
        reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=max_new,
                        frames=None if frames is None else frames[i])
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return {"tokens": [r.out_tokens for r in reqs],
                "reasons": [r.finish_reason for r in reqs],
                "decode_steps": eng.stats["decode_steps"],
                "prefills": eng.stats["prefills"], "state": state_digest(eng.state)}

    out, counts = _counted(go)
    return dict(out, counts=counts, logits=seen)


def _recording(decode, seen: list):
    """A decode state's `decode` that appends each step's logits to `seen`."""
    def run(*args, **kw):
        out = decode(*args, **kw)
        seen.append(out[0].detach().clone())
        return out
    return run


def moe_job(mesh, cfg, params, x, data_split=False):
    """transformer.moe_block(cfg, params, x) under the mesh (params: one
    MoE layer's tree, sharded here as a stacked segment's would be).
    `data_split`: each rank runs its rows of x over the mesh's DP axes
    (`use_mesh(data_split=True)`, as training does) and the rows' outputs
    are gathered back to the whole y."""
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

    dp = sharding.dp_axes(mesh)
    if data_split:
        x = sharding.local_slice(x, (dp, None, None), mesh)

    def go():
        with sharding.use_mesh(mesh, data_split=data_split):
            return transformer.moe_block(cfg, sp, x)

    out, counts = _counted(go)
    if data_split:
        from repro_torch.parallel import collectives as coll
        out = coll.all_gather(out, mesh, dp, dim=0)
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
                "spec_stats": (st.iterations, st.proposed, st.accepted, st.bonus),
                "state": state_digest(eng.state), "draft": state_digest(eng.draft_state)}

    out, counts = _counted(go)
    return dict(out, counts=counts)


def grad_job(mesh, cfg, params, batch):
    """The loss and every gradient leaf (gathered whole) of the port's
    `value_and_grad(cfg, blocks, batch)` inside `use_mesh(mesh)`, the
    blocks cut from the whole tree `params` by `shard_params`; `batch`
    the global batch."""
    from repro_torch.parallel import sharding
    from repro_torch.training.loop import value_and_grad

    sp = sharding.shard_params(params, mesh, cfg)
    specs = sharding.param_spec_map(mesh, params, cfg=cfg)

    from repro_torch.parallel import collectives as coll
    coll.reset()
    with sharding.use_mesh(mesh):
        loss, grads = value_and_grad(cfg, sp, batch)
    counts = dict(coll.COUNTS)
    return {"loss": float(loss), "grads": sharding.gather_tree(grads, specs, mesh),
            "counts": counts}


def train_job(mesh, cfg, ocfg, tcfg, dcfg, init_dir, out_dir):
    """`train(mesh=)` resumed from the checkpoint in `init_dir` (copied to
    `out_dir`, one a mesh): its losses and the parameters of its final
    checkpoint, read back whole."""
    import dataclasses
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.training.loop import init_train_state, train

    out_dir = f"{out_dir}-{mesh.shape['data']}x{mesh.shape['model']}"
    if dist.get_rank() == 0:
        shutil.copytree(init_dir, out_dir, dirs_exist_ok=True)
    dist.barrier()
    tcfg = dataclasses.replace(tcfg, ckpt_dir=out_dir)
    lines = []
    out = train(cfg, ocfg, tcfg, dcfg, mesh=mesh, log_fn=lines.append)
    params, opt = init_train_state(cfg, ocfg, tcfg, "cpu")
    (whole, _), meta = CheckpointManager(out_dir).restore((params, opt))
    from repro_torch import bridge
    return {"losses": out["losses"], "lines": lines, "meta": meta,
            "params": bridge.tree_paths(whole)}


def ckpt_job(mesh, cfg, ocfg, tcfg, save_dir):
    """Checkpoints across meshes, on the (2, 2) mesh: two steps of the
    rank's blocks, saved through `save(mesh=, shardings=)` (every block
    gathered whole, by path: "saved"); then the same ranks as a (4, 1)
    mesh restore it through `restore(shardings=)` and gather their
    blocks whole ("restored")."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding
    from repro_torch.training import loop

    params, opt = loop.init_train_state(cfg, ocfg, tcfg, mesh=mesh)
    step = loop.make_train_step(cfg, ocfg, tcfg, mesh=mesh)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))
             for k in ("tokens", "labels")}
    for _ in range(2):        # so the optimizer state holds values
        params, opt, _ = step(params, opt, batch)
    specs = loop.state_specs(cfg, mesh, opt)
    saved = sharding.gather_tree((params, opt), specs, mesh)
    mgr = CheckpointManager(save_dir)
    mgr.save(7, (params, opt), {"next_step": 7}, mesh=mesh, shardings=specs)
    flat = make_host_mesh(1, backend="gloo", device_type="cpu")
    params, opt = loop.init_train_state(cfg, ocfg, tcfg, mesh=flat)
    specs = loop.state_specs(cfg, flat, opt)
    (params, opt), meta = mgr.restore((params, opt), shardings=specs, mesh=flat)
    return {"saved": saved, "restored": sharding.gather_tree((params, opt), specs, flat),
            "meta": meta,
            "flat_shape": dict(flat.shape)}


def grad_rules_job(mesh):
    """Each collective's gradient on toy tensors over a (2, 2) mesh, with
    what the rule gives: {name: (gradient, expected)}.  m is the rank's
    "model" index, c = (3, 5).

    * all_gather of x = m + 1 over "model", a replicated downstream
      sum(c y): "split" gives c[m]; "reduce_scatter" (the wrong rule
      there) twice that, the axis size;
    * the same gather with a per-rank downstream sum((m + 1) c y):
      "reduce_scatter" gives the sum over the ranks, 3 c[m]; "split"
      (the wrong rule there) (m + 1) c[m];
    * copy_to of x = 2, downstream (m + 1) x: 1 + 2 = 3 on every rank;
    * all_reduce of x = m + 1, downstream 4 y: 4 (the identity);
    * all_to_all over ("data", "model") of 4 chunks, downstream
      sum(w y), w = (1, 2, 3, 4): rank r's every chunk went to a rank
      that weights it by w[r]."""
    from repro_torch.kernels import _grad
    from repro_torch.parallel import collectives as coll

    m = mesh.coord("model")
    c = torch.tensor([3.0, 5.0])

    def grad(f, x):
        x = x.clone().requires_grad_(True)
        f(x).backward()
        return x.grad.tolist()

    def gathered(rule, weights):
        return grad(lambda x: (coll.all_gather(x, mesh, "model", dim=0, backward=rule)
                               * weights).sum(), torch.tensor([m + 1.0]))

    r = mesh.axis_rank(("data", "model"))
    w = torch.arange(1.0, 5.0)
    return {
        "split_replicated": (gathered("split", c), [float(c[m])]),
        "reduce_scatter_replicated": (gathered("reduce_scatter", c), [2 * float(c[m])]),
        "reduce_scatter_per_rank": (gathered("reduce_scatter", (m + 1) * c), [3 * float(c[m])]),
        "split_per_rank": (gathered("split", (m + 1) * c), [(m + 1) * float(c[m])]),
        "copy_to": (grad(lambda x: (coll.copy_to(x, mesh) * (m + 1)).sum(),
                         torch.tensor([2.0])), [3.0]),
        "all_reduce": (grad(lambda x: (coll.all_reduce(x * 1, mesh) * 4).sum(),
                            torch.tensor([m + 1.0])), [4.0]),
        # of a view a custom Function returned (as a kernel wrapper's
        # reshape is): reduced without writing it in place
        "all_reduce_of_a_view": (grad(lambda x: (coll.all_reduce(_grad._KernelFunction.apply(
            lambda t: t.reshape(-1), lambda t: t.reshape(-1), {}, x), mesh) * 4).sum(),
            torch.tensor([[m + 1.0]])), [[4.0]]),
        "all_to_all": (grad(lambda x: (coll.all_to_all(x * 1, mesh, ("data", "model"))
                                       * w).sum(), torch.arange(4.0) + 10 * r),
                       [float(w[r])] * 4),
    }


def pipeline_job(mesh, ws, x, c):
    """`pipeline_apply` of the tanh(h @ w) stack `ws` (L, d, d) on a
    ("pp",) mesh of every rank (`make_mesh`), `split_stages` cutting the
    L layers into one stage a rank: the output without autograd, and with
    it the output, the gradients of sum(c * out) for x and for every
    layer's w (each stage's gathered over "pp", in layer order), and the
    collectives each way."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import pipeline, sharding

    pp = make_mesh((dist.get_world_size(),), ("pp",), backend="gloo", device_type="cpu")
    n = pp.shape["pp"]
    stages = pipeline.split_stages({"w": ws}, n)
    mine = {"w": sharding.local_slice(stages["w"], ("pp", None, None, None), pp)}

    def layer(p, h):
        for w in p["w"]:
            h = torch.tanh(h @ w)
        return h

    with torch.no_grad():
        plain = pipeline.pipeline_apply(layer, mine, x, mesh=pp)
    coll.reset()
    mine["w"].requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    out = pipeline.pipeline_apply(layer, mine, xg, mesh=pp)
    (out * c).sum().backward()
    counts = {k: v for k, v in coll.COUNTS.items() if v}
    gw = sharding.gather_whole(mine["w"].grad, ("pp", None, None, None), pp)
    return {"plain": plain, "out": out.detach(), "grad_x": xg.grad,
            "grad_w": gw.reshape(ws.shape), "stage_shape": tuple(mine["w"].shape),
            "split_shape": tuple(stages["w"].shape), "counts": counts}


def fsdp_train_job(mesh, cfg, params, batch, ocfg, steps, holds=("tp", "fsdp")):
    """`steps` of `make_train_step` from the whole weights `params`, held as
    each of `holds` (the TP blocks "tp", JAX's table "jax", FSDP's blocks
    "fsdp"): by hold, the losses, the gradients' norms, the parameters
    gathered whole, whether every parameter and optimizer leaf has its
    held block's shape, and the held-leaf gathers a step."""
    from repro_torch.bridge import tree_paths
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding
    from repro_torch.training import loop
    from repro_torch.training.optimizer import init_opt

    whole = {"/".join(map(str, p)): tuple(t.shape) for p, t in tree_paths(params)}
    tcfg = loop.TrainConfig(steps=steps)
    out = {}
    for hold in holds:
        specs = loop.param_specs(cfg, mesh, hold)
        p = sharding.shard_params(params, mesh, cfg, hold)
        opt = {"inner": init_opt(ocfg, p, mesh, specs)}
        step = loop.make_train_step(cfg, ocfg, tcfg, mesh=mesh, hold=hold)
        losses, norms = [], []
        coll.reset()
        for _ in range(steps):
            p, opt, m = step(p, opt, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        holds = coll.COUNTS["hold"] / steps
        ospecs = sharding.optimizer_shardings(mesh, sharding.whole_shapes(cfg), opt,
                                              cfg=cfg, hold=hold)
        shapes_ok = all(tuple(t.shape) == sharding.local_shape(whole[path], specs[path], mesh)
                        for path, t in ((sharding.path_str(q), t) for q, t in tree_paths(p)))
        opt_whole = dict(sharding.gather_tree(opt, ospecs, mesh))
        opt_ok = all(tuple(t.shape) == sharding.local_shape(tuple(opt_whole[path].shape),
                                                            ospecs[path], mesh)
                     for path, t in ((sharding.path_str(q), t) for q, t in tree_paths(opt)))
        out[hold] = {"losses": losses, "grad_norms": norms, "holds_per_step": holds,
                     "params": dict(sharding.gather_tree(p, specs, mesh)),
                     "param_shapes_ok": shapes_ok, "opt_shapes_ok": opt_ok,
                     "opt_specs": ospecs,
                     "param_specs": specs, "opt_local": {sharding.path_str(q): tuple(t.shape)
                                                         for q, t in tree_paths(opt)}}
    return out


def fsdp_ckpt_job(mesh, cfg, ocfg, tcfg, save_dir):
    """An FSDP checkpoint across layouts: two steps of the rank's FSDP
    blocks, saved through `save(mesh=, shardings=)` ("saved", every leaf
    gathered whole by path); the same ranks as a (4, 1) mesh without FSDP
    restore it through `restore(shardings=)` and gather it ("restored")."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding
    from repro_torch.training import loop

    params, opt = loop.init_train_state(cfg, ocfg, tcfg, mesh=mesh, hold="fsdp")
    step = loop.make_train_step(cfg, ocfg, tcfg, mesh=mesh, hold="fsdp")
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))
             for k in ("tokens", "labels")}
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)
    specs = loop.state_specs(cfg, mesh, opt, "fsdp")
    saved = sharding.gather_tree((params, opt), specs, mesh)
    CheckpointManager(save_dir).save(7, (params, opt), {"next_step": 7}, mesh=mesh,
                                     shardings=specs)
    flat = make_host_mesh(1, backend="gloo", device_type="cpu")
    params, opt = loop.init_train_state(cfg, ocfg, tcfg, mesh=flat)
    fspecs = loop.state_specs(cfg, flat, opt)
    (params, opt), meta = CheckpointManager(save_dir).restore((params, opt), shardings=fspecs,
                                                              mesh=flat)
    return {"saved": saved, "restored": sharding.gather_tree((params, opt), fspecs, flat),
            "meta": meta, "flat_shape": dict(flat.shape),
            "fsdp_specs": {k: v for k, v in specs.items() if "data" in str(v)}}


def fsdp_layout_job(mesh):
    """`gather_held` on leaves of known values, every rank checking its own
    result: each held block (`local_slice` under the held spec) to the TP
    block (`local_slice` under the TP spec), and the held block's gradient
    against the whole gradient (every rank's TP-block cotangent placed in
    the leaf and summed over the ranks; where the TP spec keeps the leaf
    whole, over the ranks of this rank's "model" coordinate) cut to the
    held block.  Cases: an exchange on dim 0 and on dim
    1, a gather (TP whole), a cut (held whole)."""
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding

    n = mesh.size
    msz = mesh.shape["model"]
    cases = {"exchange0": ((12 * n, 3), (("data", "model"), None), ("model", None)),
             "exchange1": ((2, 6 * n), (None, ("data", "model")), (None, "model")),
             "gather": ((4 * n, 3), (("data", "model"), None), (None, None)),
             "cut": ((3, 2 * msz), (None, None), (None, "model"))}
    out = {}
    for name, (shape, held, comp) in cases.items():
        whole = torch.arange(math.prod(shape), dtype=torch.float64).reshape(shape)
        x = sharding.local_slice(whole, held, mesh).requires_grad_(True)
        y = coll.gather_held(x, mesh, held, comp, ("data",))
        fwd_ok = torch.equal(y.detach(), sharding.local_slice(whole, comp, mesh))
        # rank r's cotangent: known to every rank, so each can sum them all
        def cot(r):
            return torch.arange(y.numel(), dtype=torch.float64).reshape(y.shape) + 1000.0 * r
        y.backward(cot(mesh.rank))
        split = any(a == "model" for a in comp)
        grad = torch.zeros(shape, dtype=torch.float64)
        for r in range(n):
            m = r % msz
            if not split and m != mesh.coord("model"):
                continue        # a TP-whole leaf's gradient sums over "data" alone
            view = grad
            for dim, a in enumerate(comp):
                if a == "model":
                    size = shape[dim] // msz
                    view = view.narrow(dim, m * size, size)
            view += cot(r)
        want = sharding.local_slice(grad, held, mesh)
        grad_ok = torch.equal(x.grad, want)
        if not (fwd_ok and grad_ok):
            raise AssertionError(f"rank {mesh.rank} {name}: forward {fwd_ok}, grad {grad_ok}")
        out[name] = {"forward_ok": fwd_ok, "grad_ok": grad_ok,
                     "held": tuple(x.shape), "tp": tuple(y.shape)}
    return out


KINDS = {"forward": forward_job, "family_forward": family_forward_job,
         "engine": engine_job, "moe": moe_job, "replicas": replicas_job,
         "cluster": cluster_job, "spec": spec_job, "grad": grad_job, "train": train_job,
         "ckpt": ckpt_job, "grad_rules": grad_rules_job, "pipeline": pipeline_job,
         "fsdp_train": fsdp_train_job, "fsdp_ckpt": fsdp_ckpt_job,
         "fsdp_layout": fsdp_layout_job}
