"""The tensor-core flash attention tile (`flash_tc_kernel` in
`csrc/flash_attention.cu`, plan in `kernels/_attn_plan.py`) and the
vectorised fused norm (`csrc/fused_norm.cu`), on the CPU.

* The tile plan covers every (batch, head, 16 query positions) once; a
  query tile walks every key tile that holds a valid pair and no other;
  a tile is skipped only where every pair is masked, every tile holding a
  masked pair is an edge tile and interior (full) tiles hold none, all
  against a brute-force (Sq, Sk) mask; the heavy-first launch order is a
  permutation whose walks never grow.
* A plain emulation of the tile's arithmetic -- per 16-row warp, the key
  tiles in order with an online max and sum in float32 (the scale in an
  exp2), the mask only on edge tiles, P rounded to bfloat16 before P V,
  a float32 O -- stays within the bfloat16 tolerance of 2.5e-2 of the JAX
  `flash_attention_ref` and of `flash_attention_bhsd` in interpret mode.
* An emulation of the vectorised norm's fixed sum order (each thread over
  its chunks of `norm_layout`, the xor butterfly, the warps in order)
  matches the JAX `fused_rmsnorm_ref` and `fused_rmsnorm_residual_ref` in
  float32 at 1e-5.  That tolerance admits any order: it checks the
  emulation and that the layout's walk reads every value of a row once,
  not the kernel's bits.

The kernels themselves run only on the card (`chip_smoke.py` holds them
against their plain versions there).
"""
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.kernels.fused_norm.ref import fused_rmsnorm_ref as jax_norm_ref
from repro.kernels.fused_norm.ref import fused_rmsnorm_residual_ref as jax_norm_res_ref
from repro_torch.kernels import _attn_plan as ap
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.fused_norm.kernel import norm_layout

TOL = 2.5e-2                      # bfloat16, as the JAX kernel tests
SMOLLM = (9, 3, 64)               # query heads, kv heads, head dim
MIXTRAL = (32, 8, 128)
DANUBE = (32, 8, 80)


def _mask(sq, sk, causal, window):
    qpos, kpos = np.arange(sq)[:, None], np.arange(sk)[None, :]
    m = np.ones((sq, sk), bool)
    if causal:
        m &= kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


# -- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (100, 100, True, None),       # Sq, Sk off the tiles
    (300, 300, True, 48),         # window under a tile: skips and edges
    (200, 200, True, 130),        # window across two tiles
    (77, 77, False, None),
    (90, 40, True, 8),            # rows past Sk have no valid key
    (65, 129, True, None),        # Sk > Sq
])
def test_tile_classes_against_the_mask(hd, sq, sk, causal, window):
    mask = _mask(sq, sk, causal, window)
    plan = ap.flash_plan(1, 32, 8, sq, hd)
    for qt in range(plan.grid[1]):
        q0 = qt * plan.bq
        first, last = ap.kv_range(q0, plan.bq, sq, sk, causal, window)
        for kt in range(-(-sk // ap.BK)):
            k0 = kt * ap.BK
            block = mask[q0:q0 + plan.bq, k0:k0 + ap.BK]
            if not first <= kt <= last:
                assert not block.any(), (q0, kt)       # never loaded
            for wq0 in range(q0, q0 + plan.bq, 16):
                tile = mask[wq0:wq0 + 16, k0:k0 + ap.BK]
                cls = ap.tile_class(wq0, 16, k0, ap.BK, sq, sk, causal, window)
                if cls == ap.SKIP:
                    assert not tile.any()
                    continue
                assert first <= kt <= last
                # keys past sk are masked pairs of the tile
                full = tile.all() and k0 + ap.BK <= sk
                assert (cls == ap.FULL) == full, (wq0, k0, cls)


@pytest.mark.parametrize("b,heads,sq", [(1, SMOLLM, 512), (2, SMOLLM, 100),
                                        (1, MIXTRAL, 300), (1, MIXTRAL, 4352),
                                        (1, DANUBE, 300), (3, (8, 1, 64), 70)])
def test_plan_covers_every_row_once_heaviest_first(b, heads, sq):
    h, hkv, hd = heads
    plan = ap.flash_plan(b, h, hkv, sq, hd)
    order = list(ap.block_order(plan, h))
    assert len(order) == len(set(order)) == plan.blocks
    rows = [(bb, hh, q0 + w * 16) for bb, hh, q0 in order for w in range(plan.warps)]
    assert len(set(rows)) == len(rows)               # padding rows past sq aside
    assert {r for r in rows if r[2] < sq} == set(itertools.product(
        range(b), range(h), range(0, sq, 16)))
    walks = [(lambda f, l: l - f + 1)(*ap.kv_range(q0, plan.bq, sq, sq, True, None))
             for _, _, q0 in order]
    assert walks == sorted(walks, reverse=True)
    assert plan.smem_bytes <= 232448 and plan.grid[1] <= 65535


def test_plan_shapes_on_the_served_paths():
    """Blocks of 4 warps at smollm-135m's bucket-512 prefill (72 blocks;
    36 of 8 would leave most SMs idle); blocks of 8 warps at
    mixtral-8x7b's 300- and 4352-token prompts, where they still give
    at least half the SMs one."""
    p = ap.flash_plan(1, *SMOLLM[:2], 512, 64)
    assert (p.warps, p.bq, p.blocks) == (4, 64, 72)
    p = ap.flash_plan(1, *MIXTRAL[:2], 4352, 128)
    assert (p.warps, p.bq, p.blocks) == (8, 128, 1088)
    p = ap.flash_plan(1, *MIXTRAL[:2], 300, 128)
    assert (p.warps, p.blocks) == (8, 96)
    assert ap.flash_plan(2, *SMOLLM[:2], 100, 64).warps == 4
    with pytest.raises(ValueError, match="head dim"):
        ap.flash_plan(1, 8, 2, 64, 100)                  # not a kernel's width
    with pytest.raises(ValueError, match="multiple"):
        ap.flash_plan(1, 9, 2, 64, 64)
    assert flash_kernel.HEAD_DIMS == (32, 64, 80, 96, 128, 160, 192, 256)
    assert [ap.padded_head_dim(hd) for hd in (1, 64, 65, 100, 200, 256)] == \
        [32, 64, 80, 128, 256, 256]
    # past 256 every hd runs at its own width on the column split
    assert [ap.padded_head_dim(hd) for hd in (257, 288, 512)] == [257, 288, 512]
    assert [ap.flash_column_blocks(hd) for hd in (256, 257, 512, 513)] == [1, 2, 2, 3]
    assert ap.PAGED_MAX_HD == 4096


# -- the tile's arithmetic -------------------------------------------------------

def _tile_emulation(q, k, v, *, causal=True, window=None):
    """flash_tc_kernel's arithmetic in plain torch: q (B, Sq, H, hd), k/v
    (B, Sk, Hkv, hd) bfloat16 -> (B, Sq, H, hd) bfloat16."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    sl2 = math.log2(math.e) / math.sqrt(hd)
    plan = ap.flash_plan(b, h, hkv, sq, hd)
    qf = q.float().permute(0, 2, 1, 3)                        # (B, H, Sq, hd)
    kf = k.float().repeat_interleave(group, 2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(group, 2).permute(0, 2, 1, 3)
    out = torch.zeros((b, h, sq, hd))
    for qt in range(plan.grid[1]):
        q0 = qt * plan.bq
        first, last = ap.kv_range(q0, plan.bq, sq, sk, causal, window)
        for wq0 in range(q0, min(q0 + plan.bq, sq), 16):
            rows = torch.arange(wq0, min(wq0 + 16, sq))
            m = torch.full((b, h, len(rows), 1), -math.inf)
            l = torch.zeros((b, h, len(rows), 1))
            acc = torch.zeros((b, h, len(rows), hd))
            for kt in range(first, last + 1):
                k0 = kt * ap.BK
                cls = ap.tile_class(wq0, 16, k0, ap.BK, sq, sk, causal, window)
                if cls == ap.SKIP:
                    continue
                keys = torch.arange(k0, k0 + ap.BK)
                kk = torch.zeros((b, h, ap.BK, hd))
                vv = torch.zeros((b, h, ap.BK, hd))
                n = min(ap.BK, sk - k0)
                kk[:, :, :n], vv[:, :, :n] = kf[:, :, k0:k0 + n], vf[:, :, k0:k0 + n]
                s = qf[:, :, rows] @ kk.transpose(-1, -2)
                if cls == ap.EDGE:
                    ok = keys[None] < sk
                    if causal:
                        ok = ok & (keys[None] <= rows[:, None])
                    if window:
                        ok = ok & (keys[None] > rows[:, None] - window)
                    s = s.masked_fill(~ok, -math.inf)
                mx = torch.maximum(m, s.amax(-1, keepdim=True))
                ms = torch.where(mx == -math.inf, torch.zeros_like(mx), mx * sl2)
                corr = torch.exp2(m * sl2 - ms)
                p = torch.exp2(s * sl2 - ms)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p.to(torch.bfloat16).float() @ vv
                m = mx
            out[:, :, rows] = acc / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _qkv(seed, b, sq, sk, h, hkv, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hd))]


def _bhsd(a):
    return a.transpose(0, 2, 1, 3).reshape(-1, a.shape[1], a.shape[3])


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,heads,window", [
    (1, 100, SMOLLM, None),          # smollm heads, S off the tiles
    (1, 150, MIXTRAL, 48),           # mixtral heads, window under a tile
    (1, 70, DANUBE, None),           # danube's head dim 80
    (2, 37, (4, 2, 32), 20),         # ragged batch of two
])
def test_tile_emulation_matches_jax(b, s, heads, window):
    h, hkv, hd = heads
    arrs = _qkv(s + hd, b, s, s, h, hkv, hd)
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    got = _tile_emulation(qt, kt, vt, window=window)
    ref = jax_flash_ref(_bhsd(qj), _bhsd(kj), _bhsd(vj), causal=True,
                        window=window).reshape(b, h, s, hd).transpose(0, 2, 1, 3)
    _close(got, ref)
    pallas = flash_attention_bhsd(_bhsd(qj), _bhsd(kj), _bhsd(vj), causal=True,
                                  window=window, bq=64, bk=64, interpret=True)
    _close(got, pallas.reshape(b, h, s, hd).transpose(0, 2, 1, 3))


def test_tile_emulation_padded_bucket():
    """A 20-token prompt in its 32 bucket: the real rows equal the
    unpadded attention's."""
    plen, bucket = 20, 32
    arrs = _qkv(7, 1, bucket, bucket, *SMOLLM)
    for a in arrs:
        a[:, plen:] = 0
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    full = _tile_emulation(qt, kt, vt)
    real = _tile_emulation(qt[:, :plen], kt[:, :plen], vt[:, :plen])
    assert torch.equal(full[:, :plen], real)
    qj, kj, vj = (jnp.asarray(a[:, :plen], jnp.bfloat16) for a in arrs)
    _close(real, jax_flash_ref(_bhsd(qj), _bhsd(kj), _bhsd(vj))
           .reshape(1, SMOLLM[0], plen, 64).transpose(0, 2, 1, 3))


def test_tile_emulation_row_without_valid_key():
    """Sq > Sk with a window: rows from Sk + window - 1 on see no key and
    come out as 0, as the JAX kernel's do."""
    sq, sk, window = 40, 20, 8
    arrs = _qkv(11, 1, sq, sk, 4, 2, 64)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    got = _tile_emulation(qt, kt, vt, window=window)
    assert not got[:, sk + window - 1:].any()
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    pallas = flash_attention_bhsd(_bhsd(qj), _bhsd(kj), _bhsd(vj), causal=True,
                                  window=window, bq=16, bk=16, interpret=True)
    _close(got, pallas.reshape(1, 4, sq, 64).transpose(0, 2, 1, 3))


def _window_rows_rms_err(out, ref, window):
    """chip_smoke.py's check of the rows q >= window: max |out - ref| over
    each row's RMS of ref."""
    ref = torch.as_tensor(np.asarray(ref, np.float32))[:, window:]
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    return float(((out.float()[:, window:] - ref).abs() / rms).max())


def test_window_rows_bound_sees_the_window_edge():
    """Rows past a window average over `window` keys, so their values are
    small against the bfloat16 tolerance; held to 2.5e-2 of their own RMS
    of the float32 JAX ref, the tile's rounding passes and a window edge
    one key off fails."""
    s, window, (h, hkv, hd) = 384, 256, (4, 2, 128)
    arrs = _qkv(5, 1, s, s, h, hkv, hd)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    qj, kj, vj = (jnp.asarray(t.float().numpy()) for t in (qt, kt, vt))
    ref = jax_flash_ref(_bhsd(qj), _bhsd(kj), _bhsd(vj), causal=True, window=window)
    ref = np.asarray(ref).reshape(1, h, s, hd).transpose(0, 2, 1, 3)
    assert _window_rows_rms_err(_tile_emulation(qt, kt, vt, window=window), ref,
                                window) <= TOL
    for off in (-1, 1):
        wrong = _tile_emulation(qt, kt, vt, window=window + off)
        assert _window_rows_rms_err(wrong, ref, window) > 4 * TOL


# -- the vectorised norm's sum order ---------------------------------------------

def _norm_emulation(x, scale, *, eps=1e-6, vec=None):
    """csrc/fused_norm.cu's sum order in float32 numpy: x (n, d) float32."""
    n, d = x.shape
    vec = vec or (4 if d % 4 == 0 else 1)
    lay = norm_layout(d, vec)
    nc = d // vec
    f32 = np.float32
    out = np.empty_like(x)
    for row in range(n):
        parts = np.zeros(lay.threads, f32)
        for t in range(lay.threads):
            ss = f32(0)
            for i in range(lay.chunks):
                c = t + lay.threads * i
                if c < nc:
                    for a in x[row, c * vec:(c + 1) * vec]:
                        ss = f32(np.float64(a) * a + ss)          # one fma
            parts[t] = ss
        warps = parts.reshape(-1, 32)
        for off in (16, 8, 4, 2, 1):                              # xor butterfly
            warps = warps + warps[:, np.arange(32) ^ off]
        tot = f32(0)
        for w in warps[:, 0]:                                     # warps in order
            tot = f32(tot + w)
        inv = f32(1) / np.sqrt(f32(tot / f32(d) + f32(eps)))
        out[row] = x[row] * inv * (f32(1) + scale)
    return out


@pytest.mark.parametrize("n,d", [(4, 576), (3, 600), (2, 578), (2, 4096), (2, 5120),
                                 (1, 1030)])
def test_norm_sum_order_matches_jax(n, d):
    """Widths of both forms (one warp a row to d 1024, a block above),
    rows whose chunks fill the lanes unevenly (600: 150 chunks of 4 over
    32 lanes), and odd widths read a value at a time (578: scalar)."""
    rng = np.random.default_rng(n * d)
    x, r = (rng.standard_normal((n, d)).astype(np.float32) for _ in range(2))
    g = (rng.standard_normal(d) * 0.1).astype(np.float32)
    got = _norm_emulation(x, g)
    np.testing.assert_allclose(got, np.asarray(jax_norm_ref(jnp.asarray(x), jnp.asarray(g))),
                               rtol=1e-5, atol=1e-5)
    s = x + r                          # the sum, rounded to float32
    sj, yj = jax_norm_res_ref(jnp.asarray(x), jnp.asarray(r), jnp.asarray(g))
    np.testing.assert_array_equal(s, np.asarray(sj))
    np.testing.assert_allclose(_norm_emulation(s, g), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("d,vec,threads,chunks", [
    (576, 8, 32, 3), (576, 4, 32, 6), (578, 1, 32, 24), (1024, 8, 32, 4),
    (1030, 1, 256, 8), (4096, 8, 256, 2), (5120, 8, 256, 3), (8192, 4, 256, 8)])
def test_norm_layout(d, vec, threads, chunks):
    lay = norm_layout(d, vec)
    assert (lay.threads, lay.vec, lay.chunks) == (threads, vec, chunks)
    assert lay.threads * lay.chunks * lay.vec >= d          # the row fits
    assert lay.chunks * lay.vec <= 32                       # values a thread



@pytest.mark.parametrize("d,vec", [(578, 8), (8196, 8), (0, 1)])
def test_norm_layout_refuses(d, vec):
    with pytest.raises(ValueError, match="no layout"):
        norm_layout(d, vec)
