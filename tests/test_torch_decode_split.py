"""The split-position paged decode (`csrc/paged_decode.cu`, plan in
`kernels/_attn_plan.py:paged_plan`) on the CPU.

* The plan: the splits of a slot cover [0, npp * ps) once, in whole pages;
  the grid reads no lengths (two calls with other lengths launch the same
  grid); it fills the card at smollm-135m's and internlm2-1.8b's decode
  shapes; its routes and head chunks.
* A float32 emulation of the kernels' order -- each split walks its live
  positions in tiles with an online max and sum in base 2, writes a
  partial (m, l, acc), empty splits l = 0, and the combine merges the
  partials in split order with weights 2^(m - max), skipping only the
  empty ones (a NaN partial enters every sum) -- against the plain
  `paged_decode_attention_ref`, the JAX `paged_decode_attention_ref` and
  `paged_decode_attention_hp` in interpret mode, at split counts 1, 2 and
  5, lengths that end mid-page and on a page edge, head dims 80, 96, 256.
* A NaN in a live page (K, V, both, or an int8 page's scale) makes the
  slot's output non-finite on every head at split counts 1, 2 and 8, as
  in the plain version and the JAX ref, and leaves the other slots'
  outputs unchanged; a NaN in the null page or past each length changes
  no bit of the emulation's output.
* The launch wrapper takes the widened head dims and both dtypes at
  validation and hands the kernel the plan (the launcher is replaced by a
  recorder here: the CUDA call itself runs only on the card).

Tolerance 2e-5, float32 (the JAX paged kernel test's).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import paged_decode_attention_hp
from repro.kernels.flash_attention.ref import \
    paged_decode_attention_ref as jax_paged_ref
from repro_torch.kernels import _attn_plan as ap
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ref import paged_decode_attention_ref

TOL = dict(rtol=2e-5, atol=2e-5)
LOG2E = 1.4426950408889634


# -- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("b,h,hkv,npp,ps,hd,es", [
    (4, 9, 3, 32, 16, 64, 2),       # smollm-135m's decode
    (16, 9, 3, 128, 16, 64, 2),     # its 2048-position row
    (8, 16, 8, 128, 16, 128, 2),    # internlm2-1.8b's
    (4, 9, 3, 32, 16, 64, 4),       # float32: the FMA route
    (2, 40, 2, 7, 8, 256, 2),       # hd 256 (FMA), a group cut in head chunks
    (3, 20, 2, 5, 4, 80, 2),
    (1, 4, 4, 4000, 16, 96, 2),     # long: 64 pages a split at most
])
def test_paged_plan_splits_cover_every_page_once(b, h, hkv, npp, ps, hd, es):
    p = ap.paged_plan(b, h, hkv, npp, ps, hd, es)
    covered = np.zeros(npp * ps, int)
    for s in range(p.splits):
        lo, hi = s * p.pages * ps, min(npp, (s + 1) * p.pages) * ps
        assert lo < hi and lo % ps == 0
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert p.pages <= ap.PAGED_MAX_PAGES
    assert p.grid == (b * hkv * p.head_chunks, p.splits)
    assert p.heads * p.head_chunks >= h // hkv > p.heads * (p.head_chunks - 1)
    assert p.heads <= (ap.TC_MAX_HEADS if p.route == "tc" else ap.FMA_MAX_HEADS)


def test_paged_plan_routes():
    assert ap.paged_plan(4, 9, 3, 32, 16, 64, 2).route == "tc"
    for hd in (32, 80, 96, 128):
        assert ap.paged_plan(4, 8, 2, 32, 16, hd, 2).route == "tc"
    for hd, es in ((64, 4), (256, 2), (40, 2), (8, 2), (136, 2), (84, 2), (100, 4),
                   (264, 2), (576, 2), (1024, 4)):
        assert ap.paged_plan(4, 8, 2, 32, 16, hd, es).route == "fma"
    assert ap.paged_plan(4, 8, 2, 32, 16, 64, 2, aligned=False).route == "fma"
    p = ap.paged_plan(2, 40, 2, 8, 16, 64, 2)           # a group of 20
    assert (p.head_chunks, p.heads) == (2, 10)
    p = ap.paged_plan(2, 40, 2, 8, 16, 64, 4)
    assert (p.head_chunks, p.heads) == (3, 7)
    p = ap.paged_plan(2, 128, 1, 8, 16, 576, 2)         # absorbed MLA: a head a block
    assert (p.head_chunks, p.heads) == (128, 1)
    for bad in (dict(hd=4097), dict(hd=0)):
        with pytest.raises(ValueError, match="head dim"):
            ap.paged_plan(2, 4, 2, 8, 16, bad["hd"], 2)
    with pytest.raises(ValueError, match="multiple"):
        ap.paged_plan(2, 9, 2, 8, 16, 64, 2)


@pytest.mark.parametrize("b,h,hkv,npp,hd", [
    (4, 9, 3, 32, 64),        # smollm-135m: 4 slots of max_len 512
    (16, 9, 3, 128, 64),
    (4, 16, 8, 32, 128),      # internlm2-1.8b
    (8, 16, 8, 128, 128),
])
def test_paged_plan_fills_the_card(b, h, hkv, npp, hd):
    p = ap.paged_plan(b, h, hkv, npp, 16, hd, 2)
    assert p.blocks >= ap.SMS
    assert p.pages * 16 >= p.rows        # a split holds at least one tile


# -- the split-and-combine order ------------------------------------------------

def _split_emulation(q, kp, vp, tables, lengths, pages, rows):
    """Per (slot, query head): each split of `pages` pages walks its live
    positions in tiles of `rows` with an online max and sum in base 2
    (scores times log2(e) / sqrt(hd)), giving (m, l, acc); an empty split
    gives l = 0; then the partials merge in split order."""
    b, _, h, hd = q.shape
    _, ps, hkv, _ = kp.shape
    npp = tables.shape[1]
    group = h // hkv
    splits = -(-npp // pages)
    sl2 = LOG2E / math.sqrt(hd)
    out = torch.zeros((b, 1, h, hd))
    for bi in range(b):
        ln = int(lengths[bi])
        for hh in range(h):
            g = hh // group
            parts = []
            for s in range(splits):
                lo, hi = s * pages * ps, min(ln, min(npp, (s + 1) * pages) * ps)
                if lo >= hi:
                    parts.append((None, 0.0, None))
                    continue
                m, l, acc = -math.inf, 0.0, torch.zeros(hd)
                for t0 in range(lo, hi, rows):
                    pos = torch.arange(t0, min(t0 + rows, hi))
                    pg = tables[bi, pos // ps].long()
                    kk, vv = kp[pg, pos % ps, g], vp[pg, pos % ps, g]
                    sc = (kk @ q[bi, 0, hh]) * sl2
                    # fmaxf: a NaN score stays out of the max, but its
                    # weight 2^(NaN - mx) puts the NaN into l and acc
                    mx = max(m, float(sc.nan_to_num(nan=-math.inf).max()))
                    corr = 2.0 ** (m - mx) if m > -math.inf else 0.0
                    p = torch.exp2(sc - mx)
                    l = l * corr + float(p.sum())
                    acc = acc * corr + p @ vv
                    m = mx
                parts.append((m, l, acc))
            # only an empty split (l == 0) is left out: a NaN l is live
            mx = max(m for m, l, _ in parts if l != 0)
            lsum, a = 0.0, torch.zeros(hd)
            for m, l, acc in parts:               # split order
                if l != 0:
                    f = 2.0 ** (m - mx)
                    lsum += l * f
                    a = a + f * acc
            out[bi, 0, hh] = a / (lsum if math.isnan(lsum) else max(lsum, 1e-30))
    return out


def _case(seed, b, h, hkv, hd, ps, npp, lens):
    rng = np.random.default_rng(seed)
    pages = 1 + b * npp
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    kp = rng.standard_normal((pages, ps, hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((pages, ps, hkv, hd)).astype(np.float32)
    tables = np.zeros((b, npp), np.int32)
    perm = rng.permutation(np.arange(1, pages))
    off = 0
    for i, ln in enumerate(lens):
        n = -(-ln // ps)
        tables[i, :n] = perm[off:off + n]
        off += n
    return q, kp, vp, tables, np.asarray(lens, np.int32)


@pytest.mark.parametrize("hd,pages,lens", [
    (64, 8, [30, 17]),        # 1 split (8 pages of 4 cover the 8-page slots)
    (64, 4, [32, 9]),         # 2 splits; a length on a page edge (32)
    (80, 2, [29, 8]),         # 4 splits
    (96, 1, [20, 13]),        # 8 splits, most of slot 1's empty
    (256, 2, [27, 12]),
])
def test_split_emulation_matches_ref_and_jax(hd, pages, lens):
    b, h, hkv, ps, npp = 2, 4, 2, 4, 8
    arrays = _case(hd + pages, b, h, hkv, hd, ps, npp, lens)
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in arrays)
    got = _split_emulation(q, kp, vp, tables, lengths, pages, rows=8)
    torch.testing.assert_close(got, paged_decode_attention_ref(q, kp, vp, tables, lengths),
                               **TOL)
    qj, kj, vj, tj, lj = (jnp.asarray(a) for a in arrays)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_paged_ref(qj, kj, vj, tj, lj)),
                               **TOL)
    # the TPU kernel's own layout: q (B, H, hd), pools (Hkv, P, ps, hd)
    hp = paged_decode_attention_hp(qj[:, 0], jnp.transpose(kj, (2, 0, 1, 3)),
                                   jnp.transpose(vj, (2, 0, 1, 3)), tj, lj, interpret=True)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(hp), **TOL)


@pytest.mark.parametrize("splits", [1, 2, 5])
def test_split_counts_give_one_function(splits):
    """Split counts 1, 2 and 5 over the same 10-page slots (lengths
    ending mid-page and on a page edge) agree with each other and with
    the plain version."""
    b, h, hkv, hd, ps, npp = 3, 6, 2, 32, 4, 10
    arrays = _case(7, b, h, hkv, hd, ps, npp, [40, 23, 4])
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in arrays)
    pages = -(-npp // splits)
    assert -(-npp // pages) == splits
    got = _split_emulation(q, kp, vp, tables, lengths, pages, rows=4)
    torch.testing.assert_close(got, paged_decode_attention_ref(q, kp, vp, tables, lengths),
                               **TOL)


# -- a NaN in a live page reaches the output; a masked one does not -------------

def _poison_case(seed=3):
    """2 slots (lengths 21 and 30) over 8 pages of 4, 8 / 2 heads of 32;
    slot 0's second page and slot 1's pages are live."""
    b, h, hkv, hd, ps, npp = 2, 8, 2, 32, 4, 8
    arrays = _case(seed, b, h, hkv, hd, ps, npp, [21, 30])
    return tuple(torch.from_numpy(a) for a in arrays)


def _nonfinite_heads(o):
    """(slots, heads) mask of heads with a non-finite value: o (B, 1, H, hd)."""
    return (~torch.isfinite(o[:, 0])).any(-1)


@pytest.mark.parametrize("pages", [8, 4, 1], ids=["1split", "2splits", "8splits"])
@pytest.mark.parametrize("what", ["k", "v", "kv"])
def test_nan_in_a_live_page_reaches_the_slot(what, pages):
    q, kp, vp, tables, lengths = _poison_case()
    clean = _split_emulation(q, kp, vp, tables, lengths, pages, rows=4)
    live = int(tables[0, 1])                    # slot 0's second page
    if "k" in what:
        kp[live] = float("nan")
    if "v" in what:
        vp[live] = float("nan")
    got = _split_emulation(q, kp, vp, tables, lengths, pages, rows=4)
    assert _nonfinite_heads(got)[0].all()
    assert torch.equal(got[1], clean[1])
    # the plain version and the JAX ref agree: the whole slot, every head
    for ref in (paged_decode_attention_ref(q, kp, vp, tables, lengths),
                torch.tensor(np.asarray(jax_paged_ref(
                    *(jnp.asarray(t.numpy()) for t in (q, kp, vp, tables, lengths)))))):
        assert torch.equal(_nonfinite_heads(ref), _nonfinite_heads(got))


@pytest.mark.parametrize("pages", [8, 4, 1], ids=["1split", "2splits", "8splits"])
def test_nan_in_an_int8_page_scale_reaches_the_slot(pages):
    """The int8 route runs the same split-and-combine over codes times
    their page's scale, the current token's k/v from beside the pool."""
    from repro_torch.kernels.flash_attention.ref import paged_decode_attention_int8_ref

    q, kp, vp, tables, lengths = _poison_case(5)
    g = torch.Generator().manual_seed(0)
    kq, vq = (torch.randint(-127, 128, kp.shape, generator=g, dtype=torch.int8)
              for _ in range(2))
    ks, vs = (torch.rand((kp.shape[0], 1, kp.shape[2], 1), generator=g) * 0.02 + 1e-3
              for _ in range(2))
    kn, vn = (torch.randn((2, kp.shape[2], kp.shape[3]), generator=g) for _ in range(2))

    def run():
        rows = torch.arange(2)
        last = lengths.long() - 1
        pg, off = tables.long()[rows, last // 4], last % 4
        kd, vd = kq.float() * ks, vq.float() * vs
        kd[pg, off], vd[pg, off] = kn, vn
        return _split_emulation(q, kd, vd, tables, lengths, pages, rows=4)

    clean = run()
    ks[int(tables[0, 1])] = float("nan")
    got = run()
    assert _nonfinite_heads(got)[0].all() and torch.equal(got[1], clean[1])
    ref = paged_decode_attention_int8_ref(q, kq, vq, ks, vs, tables, lengths, kn, vn)
    assert torch.equal(_nonfinite_heads(ref), _nonfinite_heads(got))


@pytest.mark.parametrize("pages", [8, 4, 1], ids=["1split", "2splits", "8splits"])
def test_nan_in_the_null_page_or_past_a_length_changes_no_bit(pages):
    q, kp, vp, tables, lengths = _poison_case(9)
    clean = _split_emulation(q, kp, vp, tables, lengths, pages, rows=4)
    kp[0], vp[0] = float("nan"), float("nan")   # the null page
    for i, ln in enumerate(lengths.tolist()):   # past each length, in its last page
        last = int(tables[i, (ln - 1) // 4])
        kp[last, ln % 4 or 4:], vp[last, ln % 4 or 4:] = float("nan"), float("nan")
    got = _split_emulation(q, kp, vp, tables, lengths, pages, rows=4)
    assert torch.equal(got, clean)


# -- the wrapper: validation and the plan it launches ---------------------------

class _Recorder:
    def __init__(self):
        self.calls = []
        self.launches = 0

    def __call__(self, *args):
        self.calls.append(args)
        self.launches += 1


@pytest.fixture
def recorded(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(flash_kernel, "PAGED", rec)
    monkeypatch.setattr(flash_kernel, "_sm_count", lambda index: ap.SMS)
    return rec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,hd", [(32, 8, 80), (16, 4, 96), (8, 1, 256), (9, 3, 64),
                                      (4, 2, 40)])
def test_wrapper_takes_widened_head_dims(recorded, dtype, h, hkv, hd):
    b, ps, npp = 4, 16, 32
    q = torch.zeros((b, 1, h, hd), dtype=dtype)
    pool = torch.zeros((2, 1 + b * npp, ps, hkv, hd), dtype=dtype)
    tables = torch.zeros((b, npp), dtype=torch.int32)
    out = flash_kernel.paged_decode_attention_cuda(
        q, pool[1], pool[1], tables, torch.full((b,), 5, dtype=torch.int32))
    assert out.shape == q.shape and out.dtype == dtype
    args = recorded.calls[-1]
    plan = ap.paged_plan(b, h, hkv, npp, ps, hd, q.element_size())
    # b, h, hkv, hd, ps, npp, pages, splits, heads, head chunks
    assert args[7:17] == (b, h, hkv, hd, ps, npp, plan.pages, plan.splits,
                          plan.heads, plan.head_chunks)
    assert (args[6] is None) == (plan.splits == 1)
    assert args[-2] == _build.DTYPE_CODES[dtype]
    assert args[-3] == pytest.approx(LOG2E / math.sqrt(hd))


def test_wrapper_grid_ignores_lengths(recorded):
    b, h, hkv, hd, ps, npp = 4, 9, 3, 64, 16, 32
    q = torch.zeros((b, 1, h, hd), dtype=torch.bfloat16)
    pool = torch.zeros((1 + b * npp, ps, hkv, hd), dtype=torch.bfloat16)
    tables = torch.zeros((b, npp), dtype=torch.int32)
    for lens in ([1, 2, 3, 4], [512, 300, 17, 16]):
        flash_kernel.paged_decode_attention_cuda(
            q, pool, pool, tables, torch.tensor(lens, dtype=torch.int32))
    first, second = recorded.calls
    assert first[7:] == second[7:]


@pytest.mark.parametrize("hd,match", [(0, "head dim"), (4104, "head dim")])
def test_wrapper_refuses_what_the_kernel_does_not_take(recorded, hd, match):
    q = torch.zeros((2, 1, 4, hd))
    pool = torch.zeros((5, 4, 2, hd))
    with pytest.raises(ValueError, match=match):
        flash_kernel.paged_decode_attention_cuda(
            q, pool, pool, torch.zeros((2, 2), dtype=torch.int32),
            torch.ones(2, dtype=torch.int32))
    assert not recorded.calls
