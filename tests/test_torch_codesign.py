"""The port's codesign stack (`repro_torch.core`) against the JAX
package's (`repro.core`) on the CPU: the batched perf-model columns, the
iso-latency solvers (dense, hull sweep, generation-batched, host hull),
the GA and the SA give the reference's values bit for bit for the same
inputs, and the option-cache transport round-trips exactly."""
import math
import random

import numpy as np
import pytest
import torch

from repro.core import convexhull as jch
from repro.core import costmodel as jcost
from repro.core import engine as jengine
from repro.core import fusion as jfusion
from repro.core import operators as jops
from repro.core import perfmodel as jpm
from repro.core import pool as jpool
from repro.core.chiplets import Chiplet as JChiplet
from repro.core.chiplets import default_pool as jdefault_pool
from repro.core.memory import HBM3 as JHBM3
from repro_torch.core import convexhull as tch
from repro_torch.core import costmodel as tcost
from repro_torch.core import engine as tengine
from repro_torch.core import fusion as tfusion
from repro_torch.core import operators as tops
from repro_torch.core import perfmodel as tpm
from repro_torch.core import pool as tpool
from repro_torch.core.chiplets import Chiplet as TChiplet
from repro_torch.core.chiplets import default_pool as tdefault_pool
from repro_torch.core.memory import HBM3 as THBM3

CPU = "cpu"
OBJECTIVES = ("energy", "edp", "energy_cost", "edp_cost")


@pytest.fixture(autouse=True)
def _clean_state():
    """Both engines on with empty caches; one torch thread (these tensors
    are small, and a loaded host's thread pool costs more than it buys)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jengine.set_engine_enabled(True)
    tengine.set_engine_enabled(True)
    jengine.clear_all_caches()
    tengine.clear_all_caches()
    yield
    jengine.clear_all_caches()
    tengine.clear_all_caches()
    torch.set_num_threads(threads)


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, dtype=np.float64).view(np.uint64)


def _same_bits(a, b) -> bool:
    return np.array_equal(_bits(a), _bits(b))


# -- the perf model -------------------------------------------------------------


def _groups(pkg, graph, pool):
    """Fusion groups of the two roofline seeds and a few mutations."""
    fusion = jfusion if pkg == "jax" else tfusion
    cfg = fusion.GAConfig(population=6)
    genomes = fusion.initial_population(graph, pool, cfg)
    out = {}
    for g in genomes:
        for gr in fusion.groups_from_genome(graph, g):
            out[(gr.name, gr.memory.name, gr.repeat)] = gr
    return out


@pytest.mark.parametrize("workload", sorted(jops.paper_workloads(seq=512)))
def test_group_columns_bit_equal(workload):
    """`_group_numeric` / `evaluate_group_columns` of every fusion group
    the GA seeds for each paper workload, over `default_pool()` and every
    memory: the four columns bit-equal to the reference's, configs equal."""
    jg = jops.paper_workloads(seq=512)[workload]
    tg = tops.paper_workloads(seq=512)[workload]
    jgroups, tgroups = _groups("jax", jg, jdefault_pool()), _groups("torch", tg, tdefault_pool())
    assert list(jgroups) == list(tgroups)
    for key in jgroups:
        jgr, tgr = jgroups[key], tgroups[key]
        jgrid = jpm.config_grid(jgr.ops, jdefault_pool())
        tgrid = tpm.config_grid(tgr.ops, tdefault_pool())
        assert [c.label for c in jgrid.cfgs] == [c.label for c in tgrid.cfgs]
        for a, b in zip(jpm._group_numeric(jgr.ops, jgrid),
                        tpm._group_numeric(tgr.ops, tgrid, torch.device(CPU))):
            assert _same_bits(a, b), key
        jc = jpm.evaluate_group_columns(jgr.ops, jgrid, name=jgr.name,
                                        cost_fn=jcost.stage_hw_cost, repeat=jgr.repeat)
        tc = tpm.evaluate_group_columns(tgr.ops, tgrid, name=tgr.name,
                                        cost_fn=tcost.stage_hw_cost, repeat=tgr.repeat,
                                        device=CPU)
        for f in ("t_cmp", "e_dyn", "p_static", "hw_cost_usd"):
            assert _same_bits(getattr(jc, f), getattr(tc, f)), (key, f)
        assert jc.flops_per_sample == tc.flops_per_sample


def test_enumeration_paths_agree():
    """The batched enumeration (per SKU, as option objects) equals the
    scalar host path and the reference's, field for field."""
    tg = tops.paper_workloads(seq=512)["opt66b_decode"]
    jg = jops.paper_workloads(seq=512)["opt66b_decode"]
    ops_t, ops_j = tg.operators[1:4], jg.operators[1:4]
    pool_t, pool_j = tdefault_pool()[:3], jdefault_pool()[:3]
    batched = tpm.enumerate_stage_options_by_chiplet(
        ops_t, pool_t, cost_fn=tcost.stage_hw_cost, repeat=3, device=CPU)
    scalar = tpm.enumerate_stage_options(ops_t, pool_t, vectorize=False,
                                         cost_fn=tcost.stage_hw_cost, repeat=3)
    ref = jpm.enumerate_stage_options(ops_j, pool_j, vectorize=True,
                                      cost_fn=jcost.stage_hw_cost, repeat=3)
    flat = [o.to_dict() for c in pool_t for o in batched[c]]
    assert flat == [o.to_dict() for o in scalar] == [o.to_dict() for o in ref]


def test_envelope_keep_mask_and_sweep_match_reference():
    for seed in range(6):
        rng = np.random.default_rng(seed)
        m = int(rng.integers(1, 60))
        t, s, c = (np.round(rng.uniform(0.1, 4.0, m), 1) for _ in range(3))
        lat = np.sort(rng.uniform(0.0, 5.0, int(rng.integers(1, 40))))
        tt, ts, tc = (torch.from_numpy(x) for x in (t, s, c))
        assert np.array_equal(jpm.envelope_keep_mask(t, s, c),
                              tpm.envelope_keep_mask(tt, ts, tc).numpy())
        assert _same_bits(jch.stage_envelope_sweep(t, s, c, lat),
                          tch.stage_envelope_sweep(tt, ts, tc, torch.from_numpy(lat)))


# -- the solvers ------------------------------------------------------------------


def _rand_jobs(seed: int, as_sets: bool):
    """The same random jobs in both packages: ragged stages, empty stages,
    exact duplicates, every constraint; each option has its own config."""
    out = {}
    for pkg in ("jax", "torch"):
        rng = random.Random(seed)
        ch, pm, chip, hbm = ((jch, jpm, JChiplet, JHBM3) if pkg == "jax"
                             else (tch, tpm, TChiplet, THBM3))

        def opt(k):
            return pm.StageOption(
                t_cmp=rng.uniform(0.05, 10.0), e_dyn=rng.uniform(0.1, 100.0),
                p_static=rng.uniform(0.01, 5.0), hw_cost_usd=rng.uniform(1.0, 1000.0),
                cfg=pm.StageConfig(chip(), hbm, k + 1, 1, 1))

        def as_set(opts):
            return pm.StageOptionSet(opts) if pkg == "jax" else pm.StageOptionSet(opts, CPU)

        jobs = []
        for _ in range(rng.randint(1, 8)):
            stages = []
            for _ in range(rng.randint(1, 5)):
                lo = 0 if rng.random() < 0.15 else 1
                stages.append([opt(k) for k in range(rng.randint(lo, 15))])
            if rng.random() < 0.3 and stages[0]:
                stages[0] = stages[0] + [stages[0][0]]   # exact duplicate
            if as_sets:
                stages = [as_set(s) for s in stages]
            lat = sorted(rng.uniform(0.01, 15.0) for _ in range(rng.randint(1, 25)))
            jobs.append(ch.PipelineJob(stages, lat, max_interval=rng.choice([None, 5.0]),
                                       max_e2e=rng.choice([None, 30.0]),
                                       n_stages=rng.choice([None, len(stages) * 2])))
        out[pkg] = jobs
    return out["jax"], out["torch"]


def _assert_same_solution(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert a.to_dict() == b.to_dict()   # value, T, every stage: exact


@pytest.mark.parametrize("engine", ["numpy", "hullvec", "hull"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_solve_pipeline_matches_reference(objective, engine):
    """Same winner, same value bits, for the dense tensor sweep, the
    forced hull sweep and the host hull."""
    for seed in range(6):
        jjobs, tjobs = _rand_jobs(seed, as_sets=seed % 2 == 0)
        for j, t in zip(jjobs, tjobs):
            kw = dict(objective=objective, max_interval=j.max_interval,
                      max_e2e=j.max_e2e, n_stages=j.n_stages, engine=engine)
            _assert_same_solution(jch.solve_pipeline(j.stage_options, j.latencies, **kw),
                                  tch.solve_pipeline(t.stage_options, t.latencies,
                                                     device=CPU, **kw))


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_solve_pipeline_batch_matches_reference(objective, monkeypatch):
    """The generation-batched solve against the reference's, with a batch
    big enough to be chunked and a crossover low enough that dense and
    hull-sweep stages mix; `batch_solve=False` gives the same."""
    for mod in (jch, tch):
        monkeypatch.setattr(mod, "HULLVEC_MIN_CELLS", 120)
        monkeypatch.setattr(mod, "BATCH_MAX_CELLS", 400)
    for seed in range(5):
        jjobs, tjobs = _rand_jobs(seed + 10, as_sets=seed % 2 == 1)
        want = jch.solve_pipeline_batch(jjobs, objective=objective)
        got = tch.solve_pipeline_batch(tjobs, objective=objective, device=CPU)
        loop = tch.solve_pipeline_batch(tjobs, objective=objective, device=CPU,
                                        batch_solve=False)
        assert len(got) == len(want) == len(loop)
        for a, b, c in zip(want, got, loop):
            _assert_same_solution(a, b)
            _assert_same_solution(a, c)


def test_default_latency_grid_matches_reference():
    for seed in range(4):
        jjobs, tjobs = _rand_jobs(seed, as_sets=True)
        for j, t in zip(jjobs, tjobs):
            if all(len(s) for s in j.stage_options):
                assert (jch.default_latency_grid(j.stage_options, n=16)
                        == tch.default_latency_grid(t.stage_options, n=16))


# -- Layer 2 and Layer 1 ----------------------------------------------------------

TINY_GA = dict(population=4, generations=2)
TINY_SA = dict(iterations=1)


def _opt_dec(ops):
    return ops.lm_operator_graph(ops.OPT_1_3B, 512, "decode", cache_len=512)


def test_evaluate_genomes_matches_reference():
    jg, tg = jops.paper_workloads(seq=512)["resnet50"], tops.paper_workloads(seq=512)["resnet50"]
    jp, tp = jdefault_pool()[:4], tdefault_pool()[:4]
    jcfg, tcfg = jfusion.GAConfig(population=8), tfusion.GAConfig(population=8)
    rng = random.Random(7)
    genomes = list(jfusion.initial_population(jg, jp, jcfg))
    while len(genomes) < 16:
        genomes.append(jfusion._mutate(rng.choice(genomes[:8]), rng, 0.25))
    tgenomes = [tfusion.Genome.from_dict(g.to_dict()) for g in genomes]
    want = jfusion.evaluate_genomes(jg, genomes, jp, "energy_cost",
                                    jfusion.Requirement(e2e=0.033), jcfg, {})
    got = tfusion.evaluate_genomes(tg, tgenomes, tp, "energy_cost",
                                   tfusion.Requirement(e2e=0.033), tcfg, {}, device=CPU)
    for g, tgn in zip(genomes, tgenomes):
        _assert_same_solution(None if want[g] is None else want[g].solution,
                              None if got[tgn] is None else got[tgn].solution)


@pytest.mark.parametrize("objective,e2e", [("energy", None), ("energy_cost", 2.5)])
def test_optimize_fusion_matches_reference(objective, e2e):
    """The whole GA at the tests' budget, fixed seed: the same FusionResult."""
    want = jfusion.optimize_fusion(_opt_dec(jops), jdefault_pool()[:4], objective=objective,
                                   req=jfusion.Requirement(e2e=e2e),
                                   cfg=jfusion.GAConfig(**TINY_GA))
    got = tfusion.optimize_fusion(_opt_dec(tops), tdefault_pool()[:4], objective=objective,
                                  req=tfusion.Requirement(e2e=e2e),
                                  cfg=tfusion.GAConfig(**TINY_GA), device=CPU)
    assert want.to_dict() == got.to_dict()


def test_optimize_fusion_engine_off_matches_reference():
    """The seed path (engine off: scalar enumeration, host hull) too."""
    jengine.set_engine_enabled(False)
    tengine.set_engine_enabled(False)
    try:
        want = jfusion.optimize_fusion(jops.paper_workloads(seq=512)["vit_b16"],
                                       jdefault_pool()[:3], "edp",
                                       cfg=jfusion.GAConfig(**TINY_GA))
        got = tfusion.optimize_fusion(tops.paper_workloads(seq=512)["vit_b16"],
                                      tdefault_pool()[:3], "edp",
                                      cfg=tfusion.GAConfig(**TINY_GA), device=CPU)
    finally:
        jengine.set_engine_enabled(True)
        tengine.set_engine_enabled(True)
    assert want.to_dict() == got.to_dict()


def test_anneal_pool_matches_reference():
    """Layer 1 at the tests' budget, fixed seed: the same pool, score and
    per-network designs, with the full-budget re-evaluation."""
    jn = {"resnet50": jops.paper_workloads(seq=512)["resnet50"], "opt_dec": _opt_dec(jops)}
    tn = {"resnet50": tops.paper_workloads(seq=512)["resnet50"], "opt_dec": _opt_dec(tops)}
    want = jpool.anneal_pool(jn, "energy_cost", pool_size=4,
                             cfg=jpool.SAConfig(inner_ga=jfusion.GAConfig(population=3,
                                                                           generations=1),
                                                **TINY_SA),
                             final_ga=jfusion.GAConfig(**TINY_GA))
    got = tpool.anneal_pool(tn, "energy_cost", pool_size=4,
                            cfg=tpool.SAConfig(inner_ga=tfusion.GAConfig(population=3,
                                                                          generations=1),
                                               **TINY_SA),
                            final_ga=tfusion.GAConfig(**TINY_GA), device=CPU)
    assert want.to_dict() == got.to_dict()


# -- the option-cache transport and the device keys -------------------------------


def test_export_import_option_columns_bit_exact():
    graph = tops.paper_workloads(seq=512)["resnet50"]
    pool = tdefault_pool()[:3]
    cfg = tfusion.GAConfig(population=4, generations=1)
    pop = tfusion.initial_population(graph, pool, cfg)
    tfusion.prefetch_population_options(graph, pop, pool, cfg, device=CPU)
    keys = tfusion.matching_option_keys(pool, cfg, torch.device(CPU))
    assert keys and all(k[-1] == CPU for k in keys)
    before = {k: tfusion._chiplet_option_cache[k] for k in keys}
    meta, matrix = tfusion.export_option_columns(keys)
    assert matrix.dtype == np.float64 and matrix.shape[1] == 4
    tfusion.clear_option_caches()
    assert tfusion.import_option_columns(meta, matrix.copy(), CPU) == len(keys)
    matrix[:] = math.nan          # the installed blocks hold their own copy
    for k in keys:
        a, b = before[k], tfusion._chiplet_option_cache[k]
        for f in ("t_cmp", "e_dyn", "p_static", "hw_cost_usd"):
            assert _same_bits(getattr(a, f), getattr(b, f))
        assert a.options() == b.options()
    assert tfusion.import_option_columns(meta, matrix, CPU) == 0


def test_caches_are_keyed_by_device():
    """A block enumerated for one device is never served for another: the
    option cache, the chip rows and the engine memo all carry the device."""
    graph = tops.paper_workloads(seq=512)["mobilenetv3"]
    pool = tdefault_pool()[:2]
    cfg = tfusion.GAConfig(population=2, generations=0)
    tfusion.prefetch_population_options(graph, tfusion.initial_population(graph, pool, cfg),
                                        pool, cfg, device=CPU)
    assert tfusion._chiplet_option_cache
    assert not tfusion.matching_option_keys(pool, cfg, torch.device("meta"))
    assert all(b.device == torch.device(CPU) for b in tfusion._chiplet_option_cache.values())
    key = tengine.EvaluationEngine._key(pool, graph, "energy", tfusion.Requirement(), cfg,
                                        torch.device(CPU))
    assert key[-1] == CPU


def test_engine_defaults_and_stats():
    ev = tengine.EvaluationEngine()
    assert (ev.workers, ev.executor, ev.warmup) == (0, "thread", True)
    assert ev.stats() == {"hits": 0, "misses": 0, "warmup_hits": 0,
                          "worker_enumerations": 0, "thread_fallbacks": 0}
