"""The port's dry run (`repro_torch.launch.{specs,analyze,dryrun,report}`
and the registry's cells) against the JAX package's, on the CPU.

* `Shape`, `SHAPES`, `LONG_CONTEXT_OK` and `cells(include_skipped=)`
  equal JAX's.
* For every cell, `input_specs` has JAX's tree, shapes and dtypes, leaf
  by leaf (`meta` tensors: no storage); each arch's `jax.eval_shape` of
  `init_params` is built once and reused.
* `model_flops_for` (every cell) and `matmul_param_counts` (every arch)
  equal JAX's to a relative 1e-12.
* JAX's checks of `tests/test_specs_analyze.py` on the port's specs: the
  train and decode shapes, the sliding-window ring, MLA's 576-wide
  latent, rwkv6's O(1) state, the vision and whisper stubs, and the
  model FLOPs accounting.
* In one subprocess (a `fake` process group must never stay up in a
  pytest worker): `run_cell` on smollm-135m's three shape kinds (single
  pod; train and prefill cut to 2 layers, decode at full depth) and on
  mixtral-8x7b train_4k on two pods (FSDP over 512 ranks, cut to 2
  layers: the trace's time, not its widths, grows with depth).  Each
  record is ok with JAX's keys (`trace_s` in place of `lower_s` and
  `compile_s`), and its argument bytes equal the per-device bytes of
  JAX's own specs for the cell (`param_spec_map(fsdp=)`,
  `optimizer_shardings`, `data_shardings`, `cache_shardings` on an
  `AbstractMesh` of the production axis sizes; nothing compiled).  The
  collective byte counter equals each collective's result `nbytes`
  (forward and backward, the held-leaf gather too).  A decode cell with
  `--override cache_seq_shard=true` the port refuses (whisper-base with
  16 heads of KV but 8 `kv_heads`: the cache rule splits the 16 heads
  over "model", its TP keeps them whole, and the decoder raises rather
  than guess) is recorded as failed, and `main` exits non-zero.
  `report` renders both tables from the records.
* In two more subprocesses, beside it: the decode cells whose layout
  follows JAX's (deepseek-v3-671b decode_32k on both meshes, its latent's
  length over "model"; internlm2-1.8b decode_32k with `cache_seq_shard`;
  rwkv6-3b decode_32k, recurrentgemma-2b decode_32k on both meshes and
  whisper-base decode_32k held as JAX's table; recurrentgemma-2b
  decode_32k and whisper-base decode_32k on both meshes with
  `cache_seq_shard`, their attention cache's length over "model";
  recurrentgemma-2b long_500k on both meshes, its ring's length and `h`'s
  channels over the DP axes) and mixtral-8x7b train_4k on two pods with
  `moe_shard_map` (its rows over ("pod", "data")), each at full depth:
  ok, with argument bytes equal to JAX's specs', every state leaf
  included.
"""
import functools
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro import configs as jax_configs
from repro.launch import analyze as jax_analyze
from repro.launch import specs as jax_specs
from repro.parallel import sharding as jax_sharding
from repro.training import optimizer as jax_opt
from repro_torch import bridge, configs
from repro_torch.launch import analyze, dryrun, report, specs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = jax_configs.cells()
# (arch, shape, mesh, overrides) the subprocess traces
RUN_CELLS = [("smollm-135m", "train_4k", "single", {"n_layers": 2}),
             ("smollm-135m", "prefill_32k", "single", {"n_layers": 2}),
             ("smollm-135m", "decode_32k", "single", {}),
             ("mixtral-8x7b", "train_4k", "multi", {"n_layers": 2})]
# the cells whose layout follows JAX's, full depth, in two more subprocesses
SEQ = {"cache_seq_shard": True}
DECODE_GROUPS = [[("deepseek-v3-671b", "decode_32k", "single", {}),
                  ("rwkv6-3b", "decode_32k", "single", {}),
                  ("recurrentgemma-2b", "decode_32k", "single", {}),
                  ("recurrentgemma-2b", "decode_32k", "multi", {}),
                  ("recurrentgemma-2b", "decode_32k", "single", SEQ),
                  ("whisper-base", "decode_32k", "single", {}),
                  ("whisper-base", "decode_32k", "single", SEQ)],
                 [("deepseek-v3-671b", "decode_32k", "multi", {}),
                  ("internlm2-1.8b", "decode_32k", "single", SEQ),
                  ("mixtral-8x7b", "train_4k", "multi", {"moe_shard_map": True}),
                  ("recurrentgemma-2b", "long_500k", "single", {}),
                  ("recurrentgemma-2b", "long_500k", "multi", {}),
                  ("whisper-base", "decode_32k", "multi", SEQ)]]
DECODE_CELLS = [c for g in DECODE_GROUPS for c in g]
# the cell `test_cache_seq_shard_cell_is_recorded_failed` traces: whisper's KV
# holds `n_heads`, which split over 16 where its TP (which needs `kv_heads`
# to split too) keeps them whole, and the decoder raises
FAILING = ["--arch", "whisper-base", "--shape", "decode_32k", "--override",
           "cache_seq_shard=true", "n_heads=16", "kv_heads=8", "--tag", "seqshard"]
JAX_KEYS = {"arch", "shape", "mesh", "n_devices", "policy", "ok", "tag", "overrides",
            "roofline", "memory_analysis"}


@functools.lru_cache(maxsize=None)
def jax_params(arch: str):
    return jax_specs.params_specs(jax_configs.get_config(arch))


@functools.lru_cache(maxsize=None)
def torch_params(arch: str):
    return specs.params_specs(configs.get_config(arch))


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def jax_leaves(tree) -> list:
    out = []
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        out.append(("/".join(map(str, keys)), tuple(x.shape), _dtype(x)))
    return out


def torch_leaves(tree) -> list:
    return [("/".join(map(str, p)), tuple(t.shape), _dtype(t))
            for p, t in bridge.tree_paths(tree)]


def test_shapes_and_cells_equal_jax():
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind)
            for k, s in configs.SHAPES.items()} == \
        {k: (s.name, s.seq_len, s.global_batch, s.kind)
         for k, s in jax_configs.SHAPES.items()}
    assert configs.LONG_CONTEXT_OK == jax_configs.LONG_CONTEXT_OK
    assert configs.cells() == jax_configs.cells()
    assert configs.cells(include_skipped=True) == jax_configs.cells(include_skipped=True)
    assert len(configs.cells(include_skipped=True)) == 40


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_equal_jax(arch, shape_name):
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    shape, jshape = configs.SHAPES[shape_name], jax_configs.SHAPES[shape_name]
    assert torch_leaves(torch_params(arch)) == jax_leaves(jax_params(arch))
    if shape.kind == "decode":
        tok, cache = specs.decode_specs(cfg, shape)
        jtok, jcache = jax_specs.decode_specs(jcfg, jshape)
        assert torch_leaves({"t": tok}) == jax_leaves({"t": jtok})
        assert torch_leaves(cache) == jax_leaves(jcache)
        assert all(t.device.type == "meta" for t in bridge.tree_leaves(cache))
    else:
        batch = specs.batch_specs(cfg, shape)
        assert torch_leaves(batch) == jax_leaves(jax_specs.batch_specs(jcfg, jshape))
        assert all(t.device.type == "meta" for t in batch.values())


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_model_flops_equal_jax(arch, shape_name):
    got = analyze.model_flops_for(configs.get_config(arch), configs.SHAPES[shape_name],
                                  torch_params(arch))
    want = jax_analyze.model_flops_for(jax_configs.get_config(arch),
                                       jax_configs.SHAPES[shape_name], jax_params(arch))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_matmul_param_counts_equal_jax(arch):
    got = analyze.matmul_param_counts(torch_params(arch))
    want = jax_analyze.matmul_param_counts(jax_params(arch))
    assert got == pytest.approx(want, rel=1e-12)


# --- JAX's tests/test_specs_analyze.py on the port ---------------------------

def test_input_specs_train_shapes():
    b = specs.input_specs("smollm-135m", "train_4k")["batch"]
    assert b["tokens"].shape == (256, 4096)
    assert b["labels"].shape == (256, 4096)


def test_input_specs_decode_shapes():
    out = specs.input_specs("qwen2.5-32b", "decode_32k")
    assert out["tokens"].shape == (128, 1)
    assert out["cache"]["segments"][0]["k"].shape == (64, 128, 32768, 8, 128)


def test_swa_cache_is_ring_capped():
    k = specs.input_specs("h2o-danube-1.8b", "long_500k")["cache"]["segments"][0]["k"]
    assert k.shape[2] == 4096


def test_mla_cache_is_latent():
    lat = specs.input_specs("deepseek-v3-671b", "decode_32k")["cache"]["segments"][1]["latent"]
    assert lat.shape[-1] == 576


def test_rwkv_state_o1():
    wkv = specs.input_specs("rwkv6-3b", "long_500k")["cache"]["layers"][0]["wkv"]
    assert wkv.shape == (1, 40, 64, 64)


def test_vlm_and_whisper_stub_embeds():
    v = specs.input_specs("qwen2-vl-2b", "train_4k")["batch"]
    assert "embeds" in v and v["embeds"].shape[-1] == 1536
    assert v["embeds"].shape[1] + v["tokens"].shape[1] == 4096
    w = specs.input_specs("whisper-base", "train_4k")["batch"]
    assert w["embeds"].shape == (256, 4096, 512)
    assert w["tokens"].shape == (256, 1024)


def test_model_flops_accounting():
    cfg = configs.get_config("mixtral-8x7b")
    ps = specs.params_specs(cfg)
    shape = configs.SHAPES["train_4k"]
    mf = analyze.model_flops_for(cfg, shape, ps)
    n_active = mf / (6 * shape.global_batch * shape.seq_len)
    assert 11e9 < n_active < 16e9
    mf_dec = analyze.model_flops_for(cfg, configs.SHAPES["decode_32k"], ps)
    assert mf_dec == pytest.approx(2 * n_active * 128, rel=1e-6)


def test_peaks_are_the_h100s():
    assert (analyze.PEAK_FLOPS, analyze.HBM_BW, analyze.LINK_BW) == (989e12, 3.35e12, 450e9)
    roof = analyze.roofline_from_trace(
        {"flops": 989e12, "bytes": 6.7e12, "collectives": {"total": 450e9},
         "arg_bytes": 1, "temp_bytes": 2, "out_bytes": 3}, 989e12 * 8, 4)
    assert (roof.t_compute, roof.t_memory, roof.t_collective) == (1.0, 2.0, 1.0)
    assert roof.bottleneck == "memory" and roof.model_flops_ratio == 2.0


# --- the traced cells, in one subprocess ---------------------------------------

CHILD = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives as coll

    out_dir, cells = sys.argv[1], json.loads(sys.argv[2])
    dryrun.OUT_DIR = out_dir
    res = {"records": [dryrun.run_cell(a, s, m, overrides=o, verbose=False)
                       for a, s, m, o in cells]}
    if sys.argv[3] == "cells":
        print("RESULT" + json.dumps(res, default=float))
        sys.exit(0)

    # the byte counter: each collective's result bytes, on a fake (2, 2) mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = make_mesh((2, 2), ("data", "model"), backend="fake", device_type="cpu")
    rows = []

    def seen(op, fn):
        coll.reset()
        y = fn()
        rows.append((op, coll.BYTES[op], y.nbytes, coll.collective_bytes()["total"]))
        return y

    x = torch.randn(4, 6)
    seen("all-reduce", lambda: coll.all_reduce(x.clone(), mesh))
    seen("all-reduce", lambda: coll.all_max(x.clone(), mesh, "data"))
    seen("all-gather", lambda: coll.all_gather(x, mesh, "model", dim=1))
    seen("all-gather", lambda: coll.all_gather(x, mesh, ("data", "model"), dim=0))
    seen("all-to-all", lambda: coll.all_to_all(x, mesh, ("data", "model")))
    seen("broadcast", lambda: coll.broadcast(x.clone(), mesh))
    def backward(op, fwd):      # the backward's bytes alone: the forward runs first
        w = torch.randn(4, 6, requires_grad=True)
        y = fwd(w)
        seen(op, lambda: (y.sum().backward(), w.grad)[1])

    backward("all-reduce", lambda w: coll.copy_to(w, mesh))
    backward("reduce-scatter", lambda w: coll.all_gather(w, mesh, "data", dim=0,
                                                         backward="reduce_scatter"))
    backward("all-to-all", lambda w: coll.all_to_all(w, mesh, "model"))
    # a held FSDP block (4 rows of 16 over ("data", "model")) to its TP block
    held = lambda w: coll.gather_held(w, mesh, (("data", "model"), None), ("model", None),
                                      ("data",))
    with torch.no_grad():
        y = seen("all-gather", lambda: held(torch.randn(4, 6)))
    backward("reduce-scatter", held)
    res["bytes"] = rows
    res["tp_block_rows"] = y.shape[0]
    dist.destroy_process_group()

    # a cache_seq_shard decode cell the port refuses: recorded failed
    try:
        dryrun.main(json.loads(sys.argv[3]))
        res["exit"] = 0
    except SystemExit as e:
        res["exit"] = str(e.code)
    with open(out_dir + "/seqshard.json", "w") as f:
        json.dump(json.load(open(out_dir + "/whisper-base__decode_32k__single__seqshard.json")), f)
    print("RESULT" + json.dumps(res, default=float))
""")


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Every subprocess's result and records' directory, all run at once:
    `RUN_CELLS` with the counter and the refused cell, then each of
    `DECODE_GROUPS`."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for i, cells in enumerate([RUN_CELLS, *DECODE_GROUPS]):
        out = tmp_path_factory.mktemp(f"dryrun_torch{i}")
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", CHILD, str(out), json.dumps(cells),
             "cells" if i else json.dumps(FAILING)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)))
    got = []
    for out, proc in procs:
        so, se = proc.communicate(timeout=600)
        assert proc.returncode == 0, se[-4000:]
        line = next(ln for ln in so.splitlines() if ln.startswith("RESULT"))
        got.append((json.loads(line[len("RESULT"):]), out))
    return got


@pytest.fixture(scope="module")
def traced(children):
    return children[0]


def _spec_axes(spec) -> list:
    out = []
    for a in spec:
        out.append(() if a is None else ((a,) if isinstance(a, str) else tuple(a)))
    return out


def _local_bytes(shape, spec, sizes) -> int:
    n = 1
    for d, axes in zip(shape, _spec_axes(spec) + [()] * (len(shape) - len(spec))):
        n *= d // math.prod(sizes[a] for a in axes)
    return n


def jax_argument_bytes(arch, shape_name, mesh_kind, overrides) -> int:
    """The per-device bytes of a cell's inputs under JAX's own specs."""
    pol = dryrun.arch_policy(arch)
    shape = jax_configs.SHAPES[shape_name]
    kw = {"remat": "dots"} if shape.kind == "train" else {}
    if shape.seq_len >= 32768:
        kw["attn_chunk"] = 2048
    cfg = jax_configs.get_config(arch).replace(**kw, **overrides)
    dims, names = dryrun.production_shape(mesh_kind == "multi")
    sizes = dict(zip(names, dims))
    mesh = AbstractMesh(dims, names)
    pspec = jax_specs.params_specs(cfg)
    pmap = jax_sharding.param_spec_map(mesh, pspec, pol["fsdp"])

    def nbytes(tree, spec_of):
        total = 0
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            total += _local_bytes(x.shape, spec_of(path, x), sizes) * np.dtype(x.dtype).itemsize
        return total

    def by_sharding(shardings):
        flat = {jax.tree_util.keystr(p): s for p, s in
                jax.tree_util.tree_flatten_with_path(shardings)[0]}
        return lambda path, x: flat[jax.tree_util.keystr(path)].spec

    def by_path(path, x):
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        return pmap["/".join(map(str, keys))]

    total = nbytes(pspec, by_path)
    if shape.kind == "train":
        ocfg = jax_opt.OptimizerConfig(name=pol["optimizer"])
        ospec = jax.eval_shape(lambda: jax_opt.init_opt(ocfg, pspec))
        osh = jax_sharding.optimizer_shardings(mesh, pspec, {"inner": ospec}, pol["fsdp"])
        total += nbytes({"inner": ospec}, by_sharding(osh))
    if shape.kind == "decode":
        tspec, cspec = jax_specs.decode_specs(cfg, shape)
        total += nbytes({"t": tspec}, by_sharding(jax_sharding.data_shardings(mesh, {"t": tspec})))
        total += nbytes(cspec, by_sharding(jax_sharding.cache_shardings(
            mesh, cspec, cfg.kv_heads, shape.global_batch, seq_shard=cfg.cache_seq_shard)))
    else:
        b = jax_specs.batch_specs(cfg, shape)
        total += nbytes(b, by_sharding(jax_sharding.data_shardings(mesh, b)))
    return total


@pytest.mark.parametrize("i", range(len(RUN_CELLS)))
def test_run_cell_record_ok_with_jax_keys(traced, i):
    rec = traced[0]["records"][i]
    assert rec["ok"], rec.get("traceback")
    assert JAX_KEYS | {"trace_s", "route", "hold"} <= set(rec)
    assert rec["route"] == "plain" and rec["trace_s"] > 0
    arch, shape_name, mesh, _ = RUN_CELLS[i]
    assert rec["n_devices"] == (512 if mesh == "multi" else 256)
    assert rec["hold"] == ("fsdp" if arch == "mixtral-8x7b" else "jax")
    rf = rec["roofline"]
    assert rf["flops_per_device"] > 0 and rf["bytes_per_device"] > 0
    assert rf["bottleneck"] in ("compute", "memory", "collective")
    assert set(jax_analyze.COLLECTIVE_OPS) <= set(rf["collectives"])
    assert rf["t_compute"] == pytest.approx(rf["flops_per_device"] / 989e12)
    ma = rec["memory_analysis"]
    assert set(ma) >= {"argument_size_in_bytes", "output_size_in_bytes",
                       "temp_size_in_bytes", "alias_size_in_bytes"}
    if shape_name == "train_4k":
        assert rf["collectives"]["all-reduce"] > 0
    if arch == "mixtral-8x7b":      # FSDP: the layers gather, the gradients reduce-scatter
        assert rf["collectives"]["all-gather"] > 0 and rf["collectives"]["reduce-scatter"] > 0


@pytest.mark.parametrize("i", range(len(RUN_CELLS)))
def test_run_cell_argument_bytes_equal_jax_specs(traced, i):
    rec = traced[0]["records"][i]
    want = jax_argument_bytes(*RUN_CELLS[i])
    assert rec["memory_analysis"]["argument_size_in_bytes"] == want
    if RUN_CELLS[i][1] != "prefill_32k":
        # donated: the params and the optimizer state (train), the cache (decode)
        assert 0 < rec["memory_analysis"]["alias_size_in_bytes"] <= want


def test_collective_byte_counter(traced):
    rows = traced[0]["bytes"]
    assert len(rows) == 11
    for op, counted, result, total in rows:
        assert counted == result == total, (op, counted, result, total)
    assert traced[0]["tp_block_rows"] == 8        # 16 rows over "model" 2


def test_cache_seq_shard_cell_is_recorded_failed(traced):
    res, out = traced
    assert res["exit"] not in (0, "0", None)
    rec = json.load(open(out / "seqshard.json"))
    assert not rec["ok"] and "heads a rank" in rec["error"] and rec["traceback"]
    assert rec["arch"] == "whisper-base" and rec["overrides"]["cache_seq_shard"] is True


def _cell_ids(cells) -> list:
    """"arch-shape-mesh", its overrides' names added where that repeats."""
    out: list = []
    for a, s, m, ov in cells:
        cid = f"{a}-{s}-{m}"
        out.append(cid + "".join(f"-{k}" for k in ov) if cid in out else cid)
    return out


@pytest.mark.parametrize("i", range(len(DECODE_CELLS)), ids=_cell_ids(DECODE_CELLS))
def test_jax_layout_cell_argument_bytes_equal_jax_specs(children, i):
    """The decode cells (and the pod shard_map MoE cell) that hold JAX's
    layout: ok, held as JAX's blocks, argument bytes JAX's."""
    g = next(j for j, grp in enumerate(DECODE_GROUPS) if DECODE_CELLS[i] in grp)
    rec = children[1 + g][0]["records"][DECODE_GROUPS[g].index(DECODE_CELLS[i])]
    assert rec["ok"], rec.get("traceback")
    arch, shape_name, mesh, ov = DECODE_CELLS[i]
    assert rec["hold"] == ("fsdp" if dryrun.arch_policy(arch)["fsdp"] else "jax")
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        jax_argument_bytes(arch, shape_name, mesh, ov)


def test_report_renders_both_tables(traced):
    _, out = traced
    table = report.roofline_table("single", directory=str(out))
    assert "H100 SXM data sheet, 700 W" in table and "smollm-135m | decode_32k" in table
    assert "mixtral-8x7b | train_4k" in report.roofline_table("multi", directory=str(out))
    cells = report.dryrun_table(directory=str(out))
    assert cells.count("| yes |") == len(RUN_CELLS) and "FAIL" not in cells
    assert "| mixtral-8x7b | train_4k | fsdp | yes |" in cells
