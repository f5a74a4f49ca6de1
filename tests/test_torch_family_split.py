"""whisper's and recurrentgemma's decode attention over a cache length
split over ranks, and recurrentgemma's state held where JAX's
`cache_shardings` places it, the port's against the JAX package's on
the CPU, float32.

One spawn of gloo ranks (`_torch_mesh.run`) on a (2, 2) ("data",
"model") mesh and a (1, 3) mesh at once; each rank prefills under the
mesh, cuts the whole cache to its blocks of `sharding.cache_specs`
(`sharding.local_tree`) and decodes greedily under the split those
specs imply (`sharding.decode_split`), smoke widths:

* recurrentgemma-2b (2 recurrent layers and 1 attention layer) with
  `cache_seq_shard`, 4 slots on (2, 2), the weights held as FSDP's
  blocks: the ring's length over "model", the slots over "data"; the
  70-token prompts pass the 64-slot window, so the ring wraps at the
  prefill and again while decoding; `h` and the conv window held whole
  on "model" (JAX's layout) and moved to the recurrent block's channels
  while it runs;
* recurrentgemma-2b, one sequence on (2, 2) under `hold="jax"`: the
  ring's length and `h`'s channels over "data" (SP);
* whisper-base with `cache_seq_shard` on (1, 3), n_heads = kv_heads = 4
  (they do not split over 3): the self KV's length (48) and the cross
  KV's (30 frames) over "model".

For each case the greedy tokens over 10 decode steps equal JAX's unsplit
`prefill` + `decode_step` on the same weights (bridged from JAX's
`init_params`) and the port's unsplit run's (this process, no mesh);
every step's logits are within 1e-5 of the port's unsplit run and 1e-4
of JAX's (the tolerances of `test_torch_seq_model.py` and
`test_torch_recurrent.py`); each rank's cache leaf has exactly its block
of the whole leaf under JAX's spec, and the split leaves are split.
"""
import concurrent.futures
import math

import jax
import numpy as np
import pytest
import torch

import _torch_mesh
from repro import configs as jax_configs
from repro.models import api as jax_api
from repro_torch import bridge, configs
from repro_torch.models import api

PORT_TOL, JAX_TOL = 1e-5, 1e-4
STEPS = 10
F32 = dict(dtype="float32", param_dtype="float32")
MESHES = {(4, 2): {"data": 2, "model": 2}, (3, 3): {"data": 1, "model": 3}}
# name -> (arch, config switches, (rows, prompt length), max_len, hold, mesh)
CASES = {
    "recurrentgemma_seq_shard": ("recurrentgemma-2b", dict(n_layers=3, cache_seq_shard=True),
                                 (4, 70), 96, "fsdp", (4, 2)),
    "recurrentgemma_one_seq": ("recurrentgemma-2b", dict(n_layers=3), (1, 70), 96, "jax",
                               (4, 2)),
    "whisper_seq_shard": ("whisper-base", dict(kv_heads=4, cache_seq_shard=True), (2, 10), 48,
                          "tp", (3, 3)),
}
FRAMES = 30
# name -> {leaf: (the dim whose length splits, the axis it splits over)}
SPLIT = {"recurrentgemma_seq_shard": {"k": (1, "model"), "v": (1, "model")},
         "recurrentgemma_one_seq": {"k": (1, ("data",)), "v": (1, ("data",)),
                                    "h": (1, ("data",))},
         "whisper_seq_shard": {"k": (1, "model"), "v": (1, "model"), "ck": (1, "model"),
                               "cv": (1, "model")}}

_PREFILL = jax.jit(jax_api.prefill, static_argnums=(0, 3))
_DECODE = jax.jit(jax_api.decode_step, static_argnums=0)


def _configs(name):
    arch, kw, _, _, _, _ = CASES[name]
    return (jax_configs.get_smoke_config(arch).replace(**F32, **kw),
            configs.get_smoke_config(arch).replace(**F32, **kw))


def _batch(name, cfg):
    rows, plen = CASES[name][2]
    rng = np.random.default_rng(5)
    out = {"tokens": rng.integers(0, cfg.vocab, (rows, plen)).astype(np.int32)}
    if cfg.family == "whisper":
        out["embeds"] = rng.standard_normal((rows, FRAMES, cfg.d_model)).astype(np.float32)
    return out


def _jax_run(name, w, batch):
    jcfg, _ = _configs(name)
    last, cache = _PREFILL(jcfg, w, batch, CASES[name][3])
    tok = np.asarray(last)[:, -1].argmax(-1)[:, None]
    logits, tokens = [], [tok]
    for _ in range(STEPS):
        lg, cache = _DECODE(jcfg, w, tok, cache)
        lg = np.asarray(lg)
        logits.append(lg)
        tok = lg[:, -1].argmax(-1)[:, None]
        tokens.append(tok)
    return np.stack(logits), np.concatenate(tokens, 1)


def _port_unsplit(name, w, batch):
    _, tcfg = _configs(name)
    params = bridge.tree_to_torch(w)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        last, cache = api.prefill(tcfg, params, tb, CASES[name][3])
        tok = last[:, -1].argmax(-1, keepdim=True)
        logits, tokens = [], [tok]
        for _ in range(STEPS):
            lg, cache = api.decode_step(tcfg, params, tok, cache)
            logits.append(lg)
            tok = lg[:, -1].argmax(-1, keepdim=True)
            tokens.append(tok)
    return torch.stack(logits).numpy(), torch.cat(tokens, 1).numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs, refs = [], []
    for name, (_, _, _, max_len, hold, mesh) in CASES.items():
        jcfg, tcfg = _configs(name)
        w = jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(0)))
        batch = _batch(name, tcfg)
        jobs.append((name, "split_decode", dict(
            cfg=tcfg, params=bridge.tree_to_torch(w),
            batch={k: torch.from_numpy(v) for k, v in batch.items()}, max_len=max_len,
            steps=STEPS, hold=hold), [mesh]))
        refs.append((name, w, batch))

    def meanwhile():            # JAX's references compile in threads of their own
        with concurrent.futures.ThreadPoolExecutor(len(refs)) as pool:
            futs = {n: pool.submit(_jax_run, n, w, b) for n, w, b in refs}
            unsplit = {n: _port_unsplit(n, w, b) for n, w, b in refs}
            return {n: (f.result(), unsplit[n]) for n, f in futs.items()}

    want, got = _torch_mesh.run(tmp_path_factory.mktemp("family_split"), list(MESHES), jobs,
                                meanwhile=meanwhile)
    return {n: (want[n], got[CASES[n][5]][n]) for n in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_split_tokens_equal_jax(runs, name):
    ((_, jax_tokens), (_, port_tokens)), got = runs[name]
    assert got["tokens"].shape == (CASES[name][2][0], STEPS + 1)
    np.testing.assert_array_equal(got["tokens"].numpy(), jax_tokens)
    np.testing.assert_array_equal(got["tokens"].numpy(), port_tokens)


@pytest.mark.parametrize("name", list(CASES))
def test_split_logits_equal_unsplit_and_jax(runs, name):
    ((jax_logits, _), (port_logits, _)), got = runs[name]
    split = got["logits"].numpy()
    assert split.shape == port_logits.shape == jax_logits.shape
    np.testing.assert_allclose(split, port_logits, rtol=PORT_TOL, atol=PORT_TOL)
    np.testing.assert_allclose(split, jax_logits, rtol=JAX_TOL, atol=JAX_TOL)
    assert got["counts"]["all_reduce"] > 0          # the partial softmaxes combined


def _names(a) -> tuple:
    return () if a is None else ((a,) if isinstance(a, str) else tuple(a))


@pytest.mark.parametrize("name", list(CASES))
def test_split_rank_holds_its_block(runs, name):
    _, got = runs[name]
    sizes = MESHES[CASES[name][5]]
    split = got["split"]
    assert split["seq_split"] == ("model" if CASES[name][1].get("cache_seq_shard") else True)
    assert set(split["seq_leaves"]) == {k for k in SPLIT[name] if k in ("k", "v", "ck", "cv")}
    seen = set()
    for path, whole, local, spec in got["leaves"]:
        spec = list(spec) + [None] * (len(whole) - len(spec))
        block = tuple(n // math.prod(sizes[a] for a in _names(s)) for n, s in zip(whole, spec))
        assert local == block, (path, whole, local, spec)
        leaf = path.split("/")[-1]
        if leaf in SPLIT[name]:
            dim, axis = SPLIT[name][leaf]
            assert spec[dim] == axis and local[dim] < whole[dim], (path, spec, local)
            seen.add(leaf)
    assert seen == set(SPLIT[name])
