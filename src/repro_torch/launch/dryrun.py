"""Multi-pod dry run of the port (from `repro.launch.dryrun`): trace one
rank's step of every (arch x shape x mesh) cell with no allocation, then
record its FLOPs, bytes, collective bytes, memory and the three roofline
terms (`launch.analyze`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

A cell runs in this one process as rank 0 of a `fake` process group of
256 ranks (single pod, a 16 x 16 ("data", "model") mesh) or 512 (two
pods, 2 x 16 x 16 ("pod", "data", "model")), set up and torn down inside
`run_cell`; importing the module touches no process group.  Every input
is a `FakeTensor` of the rank's block (`launch.specs`), and the step runs
on the CPU route, where each kernel's work goes through its plain
version's aten ops, so the counters see it (no kernel is launched: the
record says `"route": "plain"`).  The collectives run on the fake
backend, which moves nothing but lets every size be counted.

The train step is `training.loop.make_train_step` (autograd and the
optimizer), prefill is `api.prefill`, decode is `api.decode_step` with
the cache placed by `sharding.cache_specs` (JAX's `cache_shardings`:
MLA's latent and, with `cache_seq_shard`, a cache whose KV heads do not
split have their length over "model" and decode by the partial-softmax
combine over "model").  The weights are held as JAX's dry run places
them (`hold`: "fsdp" where `ARCH_POLICY` sets FSDP, JAX's table for
every other cell).

Records land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json
with JAX's keys (`trace_s` in place of `lower_s` and `compile_s`), apart
from JAX's experiments/dryrun/.  A failed cell is recorded with its
error and traceback, and `main` exits non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.bridge import tree_map
from repro_torch.launch import analyze
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import batch_specs, decode_specs, params_specs
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding
from repro_torch.training import loop
from repro_torch.training.optimizer import OptimizerConfig

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# Per-arch execution policy for the production shapes (JAX's, unchanged).
ARCH_POLICY: dict[str, dict] = {
    "deepseek-v3-671b": {"fsdp": True, "optimizer": "adafactor"},
    "qwen2.5-32b": {"fsdp": True},
    "mixtral-8x7b": {"fsdp": True},
}


def arch_policy(arch: str) -> dict:
    return {"fsdp": False, "optimizer": "adamw",
            **ARCH_POLICY.get(arch, {})}


def tune_config(cfg: ModelConfig, shape) -> ModelConfig:
    """Production-shape execution knobs (remat for train, chunked attn)."""
    kw = {}
    if shape.kind == "train":
        kw["remat"] = "dots"
    if shape.seq_len >= 32768 and cfg.family == "transformer":
        kw["attn_chunk"] = 2048
    return cfg.replace(**kw) if kw else cfg


def hold_for(cfg: ModelConfig, fsdp: bool) -> str:
    """How a cell's ranks hold the weights (`sharding.HOLDS`): JAX's
    `params_shardings(fsdp=)` blocks."""
    return "fsdp" if fsdp else "jax"


def production_shape(multi_pod: bool) -> tuple[tuple, tuple]:
    return ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))


@contextlib.contextmanager
def fake_mesh(multi_pod: bool):
    """Rank 0's `Mesh` of the production shape over a `fake` process group
    of as many ranks, torn down on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, names = production_shape(multi_pod)
    n = 1
    for v in shape:
        n *= v
    if dist.is_initialized():
        raise RuntimeError("the dry run sets up its own fake process group; one is "
                           "already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield make_mesh(shape, names, backend="fake", device_type="cpu")
    finally:
        dist.destroy_process_group()


def _zeros(tree):
    """Fake zeros of a `meta` tree's shapes (inside a `FakeTensorMode`)."""
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype), tree)


def _local(tree, specs, mesh):
    """Fake zeros of the rank's blocks of a whole `meta` tree under `specs`
    (a tree of specs of the same structure)."""
    return tree_map(lambda t, s: torch.zeros(sharding.local_shape(tuple(t.shape), s, mesh),
                                             dtype=t.dtype), tree, specs)


def _rank_batch(batch: dict, mesh):
    specs = sharding.data_shardings(mesh, batch)
    return _local(batch, specs, mesh), sharding.batch_spec(
        mesh, next(iter(batch.values())).shape[0], 1)[0]


def cache_rank_specs(cfg: ModelConfig, mesh, cache, batch: int):
    """The specs of a rank's block of the whole decode cache: JAX's
    `cache_shardings` (`sharding.cache_specs`: the batch over DP, a
    single long sequence's length over DP, KV heads over "model", MLA's
    latent length and, with `cache_seq_shard`, a cache length over
    "model" where its heads do not split); a recurrent family's or
    whisper's per-layer state takes its "model" dims from
    `sharding.layer_state_specs`, where the port's TP computes them, and
    a batch of one sequence stays whole (only the transformer decodes a
    cache length split over "data").  Raises NotImplementedError for
    `cache_seq_shard` where it would split whisper's or recurrentgemma's
    attention cache length over "model": their decoders do not combine
    attention over "model"."""
    specs = sharding.cache_specs(mesh, cache, cfg.kv_heads, batch,
                                 seq_shard=cfg.cache_seq_shard, n_heads=cfg.n_heads)
    if cfg.family == "transformer":
        return specs
    if cfg.cache_seq_shard and json.dumps(specs) != json.dumps(
            sharding.cache_specs(mesh, cache, cfg.kv_heads, batch, n_heads=cfg.n_heads)):
        raise NotImplementedError(
            f"{cfg.name}: cache_seq_shard splits the {cfg.family} attention cache's "
            f"length over 'model', and its decoder does not combine attention over 'model'")
    tp = sharding.layer_state_specs(mesh, cfg, cache["layers"])
    layers = [{k: tuple("model" if b == "model" else (a if d == 0 and a != "model" else None)
                        for d, (a, b) in enumerate(zip(dp[k], tp[i][k]))) for k in dp}
              for i, dp in enumerate(specs["layers"])]
    return dict(specs, layers=layers)


def build_step(cfg: ModelConfig, shape, mesh, opt_name: str, hold: str):
    """(fn, the rank's inputs as a tuple of trees, the donated ones) of a
    cell, its inputs fake tensors of the rank's blocks.  Build and call it
    inside one `FakeTensorMode`, after `sharding.spec_maps` has read the
    whole shapes outside it (`trace_cell`)."""
    if shape.kind == "train":
        ocfg = OptimizerConfig(name=opt_name)
        tcfg = loop.TrainConfig()
        step = loop.make_train_step(cfg, ocfg, tcfg, mesh=mesh, hold=hold)
        params, opt_state = loop.init_train_state(cfg, ocfg, tcfg, "cpu", mesh=mesh,
                                                  hold=hold)
        batch = _zeros(batch_specs(cfg, shape))
        rows, _ = _rank_batch(batch_specs(cfg, shape), mesh)

        def train_step():
            return step(params, opt_state, batch)

        return train_step, (params, opt_state, rows), (params, opt_state)

    params = api.init_params(cfg, 0, device="cpu", mesh=mesh, hold=hold)
    if shape.kind == "prefill":
        rows, dp = _rank_batch(batch_specs(cfg, shape), mesh)

        def prefill_step():
            with torch.no_grad(), sharding.use_mesh(mesh, data_split=dp is not None,
                                                    hold=hold):
                return api.prefill(cfg, params, rows, shape.seq_len)

        return prefill_step, (params, rows), ()

    tspec, cspec = decode_specs(cfg, shape)
    tokens, dp = _rank_batch({"t": tspec}, mesh)
    tokens = tokens["t"]
    specs = cache_rank_specs(cfg, mesh, cspec, shape.global_batch)
    cache = _local(cspec, specs, mesh)
    split = dict(data_split=True) if dp is not None else {}
    if cfg.family == "transformer":
        if sharding.dense_split(mesh, specs) == "seq":
            split = dict(seq_split=True)
        if sharding.length_axes(mesh, specs) == ("model",):
            split["seq_split"] = "model"

    def serve_step():
        with torch.no_grad(), sharding.use_mesh(mesh, hold=hold, **split):
            return api.decode_step(cfg, params, tokens, cache)

    return serve_step, (params, tokens, cache), (cache,)


def trace_cell(cfg: ModelConfig, shape, mesh, opt_name: str, hold: str) -> tuple:
    """(counts for `analyze.roofline_from_trace`, memory_analysis) of one
    rank's traced step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    sharding.spec_maps(cfg, mesh, hold)        # the whole shapes, before any fake mode
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args, donated = build_step(cfg, shape, mesh, opt_name, hold)
        counter = analyze.TraceCounter()
        counter.hold(args)
        arg_b = analyze.storage_bytes(args)
        coll.reset()
        with FlopCounterMode(display=False) as fc, counter:
            out = fn()
        flops = fc.get_total_flops()
        colls = coll.collective_bytes()
        out_b = analyze.storage_bytes(out)
        alias_b = analyze.storage_bytes(donated)
        peak = counter.peak
        del out
    counts = {"flops": flops, "bytes": counter.bytes, "collectives": colls,
              "arg_bytes": arg_b, "temp_bytes": max(peak - arg_b, 0), "out_bytes": out_b}
    memory = {"argument_size_in_bytes": int(arg_b), "output_size_in_bytes": int(out_b),
              "temp_size_in_bytes": int(max(peak - arg_b, 0)),
              "alias_size_in_bytes": int(alias_b), "peak_size_in_bytes": int(peak)}
    return counts, memory


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             save: bool = True, verbose: bool = True,
             overrides: dict | None = None, tag: str = "") -> dict:
    shape = configs.SHAPES[shape_name]
    pol = arch_policy(arch)
    cfg = tune_config(configs.get_config(arch), shape)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape_, _ = production_shape(mesh_kind == "multi")
    n_dev = 1
    for v in shape_:
        n_dev *= v
    hold = hold_for(cfg, pol["fsdp"])
    t0 = time.time()
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "n_devices": n_dev, "policy": pol, "ok": False,
              "tag": tag, "overrides": overrides or {}, "route": "plain",
              "hold": hold}
    try:
        with fake_mesh(mesh_kind == "multi") as mesh:
            counts, memory = trace_cell(cfg, shape, mesh, pol["optimizer"], hold)
        t_trace = time.time() - t0
        mf = analyze.model_flops_for(cfg, shape, params_specs(cfg))
        roof = analyze.roofline_from_trace(counts, mf, n_dev)
        record.update(ok=True, trace_s=t_trace, roofline=roof.as_dict(),
                      memory_analysis=memory)
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: OK "
                  f"(trace {t_trace:.1f}s, hold {hold})")
            print(f"  memory_analysis: {memory}")
            keys = ("flops_per_device", "bytes_per_device",
                    "collective_bytes_per_device", "bottleneck", "model_flops_ratio")
            print("  roofline:", {k: record["roofline"][k] for k in keys})
    except Exception as e:  # noqa: BLE001 - a failing cell is a bug report
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: FAIL {record['error']}")
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fn_out = os.path.join(OUT_DIR, f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")
        with open(fn_out, "w") as f:
            json.dump(record, f, indent=2, default=float)
    return record


def parse_overrides(items) -> dict:
    out = {}
    for kv in items:
        k, v = kv.split("=", 1)
        out[k] = {"true": True, "false": False}.get(
            v.lower(), int(v) if v.isdigit() else v)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", choices=configs.ARCH_IDS)
    p.add_argument("--shape", choices=tuple(configs.SHAPES))
    p.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    p.add_argument("--all", action="store_true",
                   help="sweep every runnable (arch x shape) cell")
    p.add_argument("--no-save", action="store_true")
    p.add_argument("--tag", default="",
                   help="variant label appended to the artifact name")
    p.add_argument("--override", nargs="*", default=[],
                   help="ModelConfig overrides, e.g. gqa_einsum=true")
    args = p.parse_args(argv)
    overrides = parse_overrides(args.override)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        cells = configs.cells()
    else:
        if not args.arch or not args.shape:
            p.error("--arch/--shape required unless --all")
        cells = [(args.arch, args.shape)]
    n_fail = 0
    for arch, shape in cells:
        for mk in meshes:
            rec = run_cell(arch, shape, mk, save=not args.no_save,
                           overrides=overrides, tag=args.tag)
            n_fail += 0 if rec["ok"] else 1
    if n_fail:
        raise SystemExit(f"{n_fail} dry-run cells FAILED")
    print("[dryrun] all requested cells traced successfully")


if __name__ == "__main__":
    main()
