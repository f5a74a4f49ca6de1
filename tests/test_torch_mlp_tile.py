"""The tile plan of the port's gated-MLP kernels (`kernels/_mlp_plan.py`,
mirrored by `tc_plan` in `csrc/mlp_tile.cuh`) and the arithmetic of the
bfloat16 cluster tile, on the CPU.

* The plan routes bfloat16 to the cluster tile and float32 to the FMA
  tile, fills the card at mixtral-8x7b's shapes, allocates no workspace
  there when the card holds a cluster an item, bounds it elsewhere, and
  refuses a bfloat16 d or F that is not a multiple of 8.
* The clusters' segments cover every (item, ff chunk) once, with about the
  same number of chunks a cluster.
* A plain emulation of the tile -- chunk by chunk, in the segments'
  order, h rounded once to bfloat16 before the down projection (the
  rounding the tile adds to the plain version, which keeps h in float32),
  leftover parts summed in part order -- stays within the bfloat16
  tolerance of 2.5e-2 of the JAX `moe_mlp_ref` and `fused_mlp_ref` on
  seeded numpy inputs.  The kernel itself runs only on the card
  (`chip_smoke.py` holds it against the plain version there).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.fused_mlp.ref import fused_mlp_ref as jax_mlp_ref
from repro.kernels.moe_mlp.ref import moe_mlp_ref as jax_moe_ref
from repro_torch import configs
from repro_torch.kernels._mlp_plan import cluster_segments, mlp_plan

TOL = 2.5e-2                        # bfloat16, as the JAX kernel tests
MIXTRAL = (8, 4096, 14336)          # experts, d, F
SMOLLM = (576, 1536)


def test_plan_routes_by_dtype():
    bf = mlp_plan(8, 8, *MIXTRAL[1:], "bfloat16")
    f32 = mlp_plan(8, 8, *MIXTRAL[1:], "float32")
    assert bf.route == "cluster" and bf.cl in (8, 16) and bf.fc == 0
    assert f32.route == "fma" and f32.fc == 128 and f32.cl == 0
    assert mlp_plan(1, 4, *SMOLLM, "float32").fc == 32      # narrow decode chunks
    assert mlp_plan(1, 4, *SMOLLM, "float16") == mlp_plan(1, 4, *SMOLLM, "bfloat16")
    with pytest.raises(ValueError, match="not supported"):
        mlp_plan(1, 4, *SMOLLM, "float64")


@pytest.mark.parametrize("c", [8, 12, 80, 96])
def test_plan_fills_the_card_at_mixtral_shapes(c):
    """One cluster of 16 an expert, one token tile (capacity up to 96):
    128 blocks, each weight byte read by one block, no workspace."""
    p = mlp_plan(MIXTRAL[0], c, *MIXTRAL[1:], "bfloat16")
    assert (p.cl, p.tiles, p.clusters, p.rounds, p.leftover) == (16, 1, 8, 1, 0)
    assert p.blocks >= 128 and p.workspace_bytes == 0
    assert p.nt >= c and p.stages >= 3 and p.smem_bytes <= 232192


def test_plan_on_a_card_that_holds_seven_clusters():
    """Seven clusters of 16 at once: each takes one expert whole and a
    seventh of the eighth; the leftover partials stay far under 64 MB."""
    p = mlp_plan(MIXTRAL[0], 96, *MIXTRAL[1:], "bfloat16", capacity=7)
    assert (p.clusters, p.rounds, p.leftover, p.parts) == (7, 1, 1, 7)
    assert p.workspace_bytes == 7 * 96 * MIXTRAL[1] * 4 <= 64e6
    walked = [sum(s[2] for s in cluster_segments(p, k)) for k in range(7)]
    assert walked == [16] * 7


@pytest.mark.parametrize("n", [1, 4, 5, 16, 256, 300])
def test_plan_bounds_the_smollm_workspace(n):
    p = mlp_plan(1, n, *SMOLLM, "bfloat16")
    assert p.cl == 8 and p.workspace_bytes <= 8 * n * SMOLLM[0] * 4
    assert p.clusters <= 8 and p.leftover * p.parts <= 9


@pytest.mark.parametrize("d,f", [(572, 1536), (576, 1532), (4100, 14336)])
def test_plan_refuses_bf16_widths_off_16_bytes(d, f):
    with pytest.raises(ValueError, match="multiples of 8"):
        mlp_plan(1, 4, d, f, "bfloat16")
    assert mlp_plan(1, 4, d, f, "float32").route == "fma"    # any width


@pytest.mark.parametrize("arch", ["smollm-135m", "internlm2-1.8b",
                                  "qwen2.5-32b", "mixtral-8x7b"])
@pytest.mark.parametrize("n", [1, 4, 96, 256, 512])
def test_plan_takes_every_registry_width(arch, n):
    cfg = configs.get_config(arch)
    e, f = (cfg.n_experts, cfg.routed_ff) if cfg.n_experts else (1, cfg.d_ff)
    p = mlp_plan(e, n, cfg.d_model, f, "bfloat16")
    assert p.route == "cluster" and 3 <= p.stages <= 8
    assert p.nt * p.tiles >= n and p.smem_bytes <= 232192


@pytest.mark.parametrize("e,n,d,f,cap", [
    (8, 96, 4096, 14336, 7), (8, 8, 4096, 14336, None), (1, 300, 576, 1536, None),
    (1, 4, 5120, 27648, 7), (3, 20, 64, 200, 2), (5, 130, 128, 520, 3)])
def test_segments_cover_every_chunk_once(e, n, d, f, cap):
    p = mlp_plan(e, n, d, f, "bfloat16", capacity=cap)
    seen = {}
    for k in range(p.clusters):
        for item, c0, nch, part in cluster_segments(p, k):
            assert nch >= 1 and (part < 0) == (item < p.rounds * p.clusters)
            for c in range(c0, c0 + nch):
                seen[item, c] = seen.get((item, c), 0) + 1
    assert seen == {(i, c): 1 for i in range(e * p.tiles) for c in range(p.chunks)}
    walked = [sum(s[2] for s in cluster_segments(p, k)) for k in range(p.clusters)]
    assert max(walked) - min(walked) <= max(1, -(-p.chunks // max(1, p.parts)))


def _tile_emulation(x, wg, wi, wo, swiglu, capacity):
    """The cluster tile's arithmetic in plain torch: x (E, n, d) bf16; each
    segment walks its ff chunks in order with float32 sums, h rounded once
    to bf16; leftover parts summed in part order; one rounding at the end."""
    e, n, d = x.shape
    f = wi.shape[-1]
    p = mlp_plan(e, n, d, f, "bfloat16", swiglu=swiglu, capacity=capacity)
    fc = p.cl * 64
    out = torch.zeros((e, n, d), dtype=torch.float32)
    parts = {}
    for k in range(p.clusters):
        for item, c0, nch, part in cluster_segments(p, k):
            ex, t0 = item // p.tiles, item % p.tiles * p.nt
            xs = x[ex, t0:t0 + p.nt].float()
            acc = torch.zeros((xs.shape[0], d))
            for c in range(c0, c0 + nch):
                cols = slice(c * fc, min(f, (c + 1) * fc))
                u = xs @ wi[ex][:, cols].float()
                h = F.silu(xs @ wg[ex][:, cols].float()) * u if swiglu else \
                    F.gelu(u, approximate="tanh")
                acc += h.to(torch.bfloat16).float() @ wo[ex][cols].float()
            if part < 0:
                out[ex, t0:t0 + p.nt] = acc
            else:
                parts[part] = (ex, t0, acc)
    for g in sorted(parts):          # the fix-up pass: part order
        ex, t0, acc = parts[g]
        if g % p.parts == 0:
            out[ex, t0:t0 + p.nt] = 0
        out[ex, t0:t0 + p.nt] += acc
    return out.to(torch.bfloat16)


def _inputs(seed, e, n, d, f):
    rng = np.random.default_rng(seed)
    shapes = ((e, n, d), (e, d, f), (e, d, f), (e, f, d))
    scales = (1.0, d ** -0.5, d ** -0.5, f ** -0.5)
    return [(rng.standard_normal(s) * sc).astype(np.float32)
            for s, sc in zip(shapes, scales)]


def _close(port: torch.Tensor, ref) -> None:
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("e,n,d,f,swiglu,cap", [
    (4, 8, 64, 1024, True, None),      # decode capacity, one cluster an item
    (3, 21, 128, 1280, True, 2),       # ragged rows, one item left over
    (2, 12, 64, 640, False, None),     # GELU experts (no gate)
    (8, 40, 64, 512, True, 7),         # mixtral's item count on 7 clusters
])
def test_tile_rounding_matches_jax_moe_ref(e, n, d, f, swiglu, cap):
    arrs = _inputs(e * n + d, e, n, d, f)
    xj, gj, ij, oj = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    xt, gt, it, ot = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    got = _tile_emulation(xt, gt, it, ot, swiglu, cap)
    _close(got, jax_moe_ref(xj, gj, ij, oj, swiglu=swiglu))


@pytest.mark.parametrize("n,d,f,swiglu", [
    (4, 576, 1536, True),              # smollm's width at decode: F split 3 ways
    (5, 576, 1536, False),             # ragged token count, GELU
    (37, 64, 1000, True),              # F off the chunk, rows off the tile
])
def test_tile_rounding_matches_jax_fused_mlp_ref(n, d, f, swiglu):
    arrs = _inputs(n + d, 1, n, d, f)
    xj, gj, ij, oj = (jnp.asarray(a[0], jnp.bfloat16) for a in arrs)
    xt, gt, it, ot = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    got = _tile_emulation(xt, gt, it, ot, swiglu, None)[0]
    _close(got, jax_mlp_ref(xj, gj, ij, oj, swiglu=swiglu))
