"""The widths past the kernels' register tiles (`csrc/flash_attention.cu`
hd > 256, `csrc/paged_decode.cu` hd > 1024, the 16-bit MLP tile d > 6144),
on the CPU.

Each is a split of the *output* columns: a block recomputes what every
column needs (the full-hd scores; the hidden activation h) in the same
order, and keeps only its own columns.  Here plain emulations of those
orders run against the unsplit plain versions and the JAX kernels
(interpret mode) and refs on the same seed-made inputs; the column blocks
must hold the same softmax max and sum bit for bit; the plans are checked
to cover every column once; and each CUDA wrapper, its launcher replaced
by a recorder, hands the C entry the split it plans.

Tolerances: 3e-5 (flash, the JAX kernel test's), 2e-5 (paged decode),
float32; the MLP groups give the ungrouped emulation's bits exactly.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import paged_decode_attention_hp
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import \
    paged_decode_attention_ref as jax_paged_ref
from repro.kernels.fused_mlp.ref import fused_mlp_ref as jax_mlp_ref
from repro_torch.kernels import _attn_plan as ap
from repro_torch.kernels import _build
from repro_torch.kernels import _mlp_plan as mp
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     paged_decode_attention_ref)
from repro_torch.kernels.fused_mlp import kernel as mlp_kernel
from repro_torch.kernels.moe_mlp import kernel as moe_kernel

LOG2E = 1.4426950408889634


# -- flash attention, hd > 256 --------------------------------------------------

def _flash_wide_emulation(q, k, v, *, window=None, cols=ap.WIDE_COLS):
    """flash_wide_kernel's order in float32: each query row walks its
    valid keys one at a time, the full-hd score (times log2(e) / sqrt(hd))
    and the online max and sum in base 2, accumulating only its block's
    `cols` output columns.  Returns (out, the (m, l) of each block)."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    sl2 = LOG2E / math.sqrt(hd)
    out = torch.zeros(q.shape)
    stats = []
    for c0 in range(0, hd, cols):
        block_stats = []
        for bi in range(b):
            for hh in range(h):
                g = hh // (h // hkv)
                for p in range(sq):
                    lo = max(0, p - window + 1) if window else 0
                    m, l, acc = -math.inf, 0.0, torch.zeros(min(cols, hd - c0))
                    for kp in range(lo, min(p, sk - 1) + 1):
                        s = float(q[bi, p, hh] @ k[bi, kp, g]) * sl2
                        mn = max(m, s)
                        corr, pw = 2.0 ** (m - mn), 2.0 ** (s - mn)
                        m, l = mn, l * corr + pw
                        acc = acc * corr + pw * v[bi, kp, g, c0:c0 + cols]
                    out[bi, p, hh, c0:c0 + cols] = acc / max(l, 1e-30)
                    block_stats.append((m, l))
        stats.append(block_stats)
    return out, stats


@pytest.mark.parametrize("hd,window", [(288, None), (300, 6), (512, None)])
def test_flash_column_split_matches_ref_and_jax(hd, window):
    rng = np.random.default_rng(hd)
    b, s, h, hkv = 1, 12, 2, 1
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd))]
    q, k, v = (torch.from_numpy(a) for a in arrs)
    got, stats = _flash_wide_emulation(q, k, v, window=window)
    assert len(stats) == ap.flash_column_blocks(hd) > 1
    assert all(st == stats[0] for st in stats)     # one max and sum per row
    torch.testing.assert_close(got, flash_attention_ref(q, k, v, window=window),
                               rtol=3e-5, atol=3e-5)
    want = jax_flash(*(jnp.asarray(a) for a in arrs), causal=True, window=window,
                     bq=8, bk=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)


def test_flash_plan_runs_wide_heads_at_their_width():
    for hd in (257, 288, 512, 1000):
        assert ap.padded_head_dim(hd) == hd
        n = ap.flash_column_blocks(hd)
        assert (n - 1) * ap.WIDE_COLS < hd <= n * ap.WIDE_COLS


# -- paged decode, hd > 1024 -------------------------------------------------------

def _paged_cols_emulation(q, kp, vp, tables, lengths, pages, rows, cols):
    """paged_split_kernel's split-and-combine order with the output
    columns cut into blocks of `cols`: in every block each split walks its
    live positions in tiles of `rows` with the full-hd scores (base 2) and
    the online max and sum, accumulating only the block's columns; the
    partials merge in split order.  Returns (out, per block the (m, l) of
    every (slot, head, split))."""
    b, _, h, hd = q.shape
    _, ps, hkv, _ = kp.shape
    npp = tables.shape[1]
    splits = -(-npp // pages)
    sl2 = LOG2E / math.sqrt(hd)
    out = torch.zeros((b, 1, h, hd))
    stats = []
    for c0 in range(0, hd, cols):
        c1 = min(hd, c0 + cols)
        block = []
        for bi in range(b):
            ln = int(lengths[bi])
            for hh in range(h):
                g = hh // (h // hkv)
                parts = []
                for s in range(splits):
                    lo, hi = s * pages * ps, min(ln, min(npp, (s + 1) * pages) * ps)
                    if lo >= hi:
                        parts.append((None, 0.0, None))
                        continue
                    m, l, acc = -math.inf, 0.0, torch.zeros(c1 - c0)
                    for t0 in range(lo, hi, rows):
                        pos = torch.arange(t0, min(t0 + rows, hi))
                        pg = tables[bi, pos // ps].long()
                        kk, vv = kp[pg, pos % ps, g], vp[pg, pos % ps, g, c0:c1]
                        sc = (kk @ q[bi, 0, hh]) * sl2
                        mx = max(m, float(sc.max()))
                        corr = 2.0 ** (m - mx) if m > -math.inf else 0.0
                        p = torch.exp2(sc - mx)
                        l = l * corr + float(p.sum())
                        acc = acc * corr + p @ vv
                        m = mx
                    parts.append((m, l, acc))
                block.append([(m, l) for m, l, _ in parts])
                mx = max(m for m, l, _ in parts if l > 0)
                lsum, a = 0.0, torch.zeros(c1 - c0)
                for m, l, acc in parts:
                    if l > 0:
                        f = 2.0 ** (m - mx)
                        lsum += l * f
                        a = a + f * acc
                out[bi, 0, hh, c0:c1] = a / max(lsum, 1e-30)
        stats.append(block)
    return out, stats


def _paged_case(seed, b, h, hkv, hd, ps, npp, lens):
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * npp
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, hkv, hd)).astype(np.float32)
    kp[0] = vp[0] = 1e4          # garbage in the null page (masked in the refs)
    tables = np.zeros((b, npp), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    off = 0
    for i, ln in enumerate(lens):
        n = -(-ln // ps)
        tables[i, :n] = perm[off:off + n]
        off += n
    return q, kp, vp, tables, np.asarray(lens, np.int32)


@pytest.mark.parametrize("hd,cols,pages", [(1152, ap.PAGED_COL_BLOCK, 2),
                                           (2048, ap.PAGED_COL_BLOCK, 1),
                                           (40, 16, 2)])
def test_paged_column_split_matches_ref_and_jax(hd, cols, pages):
    b, h, hkv, ps, npp = 2, 2, 1, 4, 4
    arrays = _paged_case(hd, b, h, hkv, hd, ps, npp, [13, 4])
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in arrays)
    got, stats = _paged_cols_emulation(q, kp, vp, tables, lengths, pages, 4, cols)
    assert len(stats) == -(-hd // cols) > 1
    assert all(st == stats[0] for st in stats)
    torch.testing.assert_close(got, paged_decode_attention_ref(q, kp, vp, tables, lengths),
                               rtol=2e-5, atol=2e-5)
    qj, kj, vj, tj, lj = (jnp.asarray(a) for a in arrays)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_paged_ref(qj, kj, vj, tj, lj)),
                               rtol=2e-5, atol=2e-5)
    hp = paged_decode_attention_hp(qj[:, 0], jnp.transpose(kj, (2, 0, 1, 3)),
                                   jnp.transpose(vj, (2, 0, 1, 3)), tj, lj, interpret=True)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(hp), rtol=2e-5, atol=2e-5)


def test_paged_plan_cuts_wide_heads_into_column_blocks():
    for hd, n in ((1024, 1), (1025, 2), (1152, 2), (2048, 2), (4096, 4)):
        for es in (2, 4):
            p = ap.paged_plan(4, 8, 2, 32, 16, hd, es)
            assert p.col_blocks == n and p.route == "fma"
            assert p.heads == (1 if hd > 256 else p.heads)
            assert p.blocks == p.grid[0] * p.grid[1] * n
            assert p.rows == ap.FMA_THREADS // 32 * (2 if es == 2 and hd <= 1024 else 1)
    with pytest.raises(ValueError, match="head dim"):
        ap.paged_plan(4, 8, 2, 32, 16, 4097, 2)


# -- the MLP tile, d > 6144 ---------------------------------------------------------

@pytest.mark.parametrize("d,groups,gcols,mw", [(6144, 1, 6144, 3), (7168, 2, 3584, 2),
                                               (8192, 2, 4096, 2), (12288, 2, 6144, 3),
                                               (12800, 3, 4288, 3)])
def test_mlp_plan_cuts_d_into_column_groups(d, groups, gcols, mw):
    for dt in mp.HALF_DTYPES:
        p = mp.mlp_plan(8, 8, d, 2048, dt)
        assert (p.groups, p.gcols, p.mw) == (groups, gcols, mw)
        assert p.gcols <= mp.MAX_COLS and (p.groups - 1) * p.gcols < d <= p.groups * p.gcols
        cpb = -(-(-(-p.gcols // p.cl)) // mp.BOX) * mp.BOX
        assert cpb * p.cl >= p.gcols and p.stages >= 3 and p.smem_bytes <= mp.SMEM_MAX
        assert p.workspace_bytes == 4 * p.leftover * p.parts * min(p.nt, 8) * d


def _tile_emulation(x, wg, wi, wo, groups):
    """The cluster tile's rounding: h = silu(x wg) * (x wi) in float32,
    rounded once to bf16, then h wo in float32 and the output rounded to
    bf16 -- one group of output columns at a time, h recomputed for
    each."""
    xf = x.float()
    outs = []
    for cols in groups:
        h = (torch.nn.functional.silu(xf @ wg.float()) * (xf @ wi.float())).bfloat16()
        outs.append((h.float() @ wo[:, cols].float()))
    return torch.cat(outs, -1).bfloat16()


def test_mlp_column_groups_give_the_ungrouped_bits():
    rng = np.random.default_rng(9)
    n, d, f = 5, 96, 64
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).bfloat16()
    wg, wi = (torch.from_numpy((rng.standard_normal((d, f)) / 10).astype(np.float32))
              .bfloat16() for _ in range(2))
    wo = torch.from_numpy((rng.standard_normal((f, d)) / 8).astype(np.float32)).bfloat16()
    whole = _tile_emulation(x, wg, wi, wo, [slice(0, d)])
    grouped = _tile_emulation(x, wg, wi, wo, [slice(0, 48), slice(48, 96)])
    assert torch.equal(whole, grouped)
    want = jax_mlp_ref(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (x, wg, wi, wo)))
    np.testing.assert_allclose(grouped.float().numpy(), np.asarray(want, np.float32),
                               rtol=2.5e-2, atol=2.5e-2)


# -- the wrappers hand the C entries the split ---------------------------------------

class _Recorder:
    def __init__(self):
        self.calls = []
        self.launches = 0

    def __call__(self, *args):
        self.calls.append(args)
        self.launches += 1


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(_build, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(flash_kernel, "_sm_count", lambda index: ap.SMS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("hd", [288, 512])
def test_flash_wrapper_launches_the_column_split(monkeypatch, no_card, dtype, hd):
    rec = _Recorder()
    monkeypatch.setattr(flash_kernel, "FLASH", rec)
    q = torch.zeros((1, 30, 4, hd), dtype=dtype)
    kv = torch.zeros((1, 30, 2, hd), dtype=dtype)
    assert flash_kernel.flash_attention_cuda(q, kv, kv).shape == q.shape
    args = rec.calls[-1]
    assert args[9] == hd                                      # no padding
    assert args[21] == pytest.approx(1.0 / math.sqrt(hd))
    assert args[22:26] == (0, 0, ap.flash_column_blocks(hd), _build.DTYPE_CODES[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("hd", [1152, 2048])
def test_paged_wrapper_launches_the_column_split(monkeypatch, no_card, dtype, hd):
    rec = _Recorder()
    monkeypatch.setattr(flash_kernel, "PAGED", rec)
    b, h, hkv, ps, npp = 4, 8, 2, 16, 8
    q = torch.zeros((b, 1, h, hd), dtype=dtype)
    pool = torch.zeros((1 + b * npp, ps, hkv, hd), dtype=dtype)
    flash_kernel.paged_decode_attention_cuda(
        q, pool, pool, torch.zeros((b, npp), dtype=torch.int32),
        torch.full((b,), 5, dtype=torch.int32))
    args = rec.calls[-1]
    plan = ap.paged_plan(b, h, hkv, npp, ps, hd, q.element_size())
    assert args[7:18] == (b, h, hkv, hd, ps, npp, plan.pages, plan.splits, 1,
                          plan.head_chunks, -(-hd // ap.PAGED_COL_BLOCK))


@pytest.mark.parametrize("which", ["fused", "moe"])
@pytest.mark.parametrize("d", [7168, 8192])
def test_mlp_wrappers_take_wide_d(monkeypatch, no_card, which, d):
    mod, name = (mlp_kernel, "MLP") if which == "fused" else (moe_kernel, "MOE")
    rec = _Recorder()
    monkeypatch.setattr(mod, name, rec)
    monkeypatch.setattr(mod, "launch_plan", lambda lib, e, n, d, f, dt, sw:
                        mp.mlp_plan(e, n, d, f, dt, swiglu=sw))
    lead = () if which == "fused" else (8,)
    x = torch.zeros(lead + (8, d), dtype=torch.bfloat16)
    w = torch.zeros(lead + (d, 2048), dtype=torch.bfloat16)
    wo = torch.zeros(lead + (2048, d), dtype=torch.bfloat16)
    call = mlp_kernel.fused_mlp_cuda if which == "fused" else moe_kernel.moe_mlp_cuda
    assert call(x, w, w, wo).shape == x.shape
    args = rec.calls[-1]
    assert args[6 + len(lead):9 + len(lead)] == (8, d, 2048)
    assert args[-5] == 1                                     # bfloat16: the cluster tile
