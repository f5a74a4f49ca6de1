// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paged_decode_attention_hp
// (src/repro/kernels/flash_attention/kernel.py:190): one query token a
// slot attends to its K/V through a page table,
//     out[b, h] = softmax(q[b, h] . K[b, :len] / sqrt(hd)) @ V[b, :len]
// where position j of slot b lives at page tables[b, j / ps], offset
// j % ps, and len = lengths[b] counts the current token, whose k/v are
// already in the pool.
//
// What bounds it on the H100: bytes.  Each live K/V row is read once and
// costs 4 * hd FLOPs a query head, a few FLOPs a byte.  At smollm-135m's
// decode (4 slots, 3 kv heads) a block a (slot, kv head) leaves 120 of
// 132 SMs idle and the call is one long latency chain, so the design
// spreads the positions over the card:
//   * Split positions across blocks.  The grid is (slot x kv head x head
//     chunk, split); a split is a fixed run of `pps` whole pages, chosen
//     by kernels/_attn_plan.py:paged_plan from the shapes alone (never
//     the lengths: no host read, and the launch can be captured in a
//     CUDA graph).  A split that starts at or past its slot's length
//     writes an empty partial (l = 0) and exits.
//   * Load bytes the way the card wants them.  A block reads its split's
//     page ids once into shared memory, then streams tiles of K and V rows
//     through a 3-stage ring with 16-byte cp.async: only live pages are
//     read (never the null page), and rows past the length in the last
//     tile are zero-filled and masked.
//   * The kv group is scored together: each K/V row is read once for the
//     up-to-8 query heads of a block.  A row's hd values are split over
//     `LN` lanes (one 8-value chunk each); each group of LN lanes walks
//     its own positions with an online softmax in registers (q, the max,
//     the sum and its output chunk stay there), so the only traffic in
//     the loop is one xor-butterfly a score.  FMA, not tensor cores: the
//     work is byte-bound.  Scores carry log2(e) / sqrt(hd) and use exp2.
//   * A fixed-order combine.  A block merges its position groups (xor
//     butterfly, then its warps in order) into one float32 partial (m, l,
//     acc[hd]) a query head; a second small kernel, launched by the same
//     C call, merges the splits in split order.  So the output is
//     bit-identical across launches of one plan.  With one split the
//     block writes the output itself.
//   * A NaN that a live position reads reaches the output, as in the plain
//     version and the JAX engine, whose NaN guard depends on it.  fmaxf
//     drops a NaN score from the running max, but its weight exp2(NaN -
//     m) is NaN, so l and acc carry it; a NaN in V reaches acc through
//     p * v.  The final division keeps a NaN sum (`denom`), and the
//     combine skips only empty splits (l == 0), never a NaN one.  Masked
//     positions are never read (zero-filled rows, -inf scores), so a NaN
//     in the null page or past a length still leaves the output's bits
//     unchanged.
// The pool is read in its stored (P, ps, Hkv, hd) layout, one layer's
// slice of the (L, P, ps, Hkv, hd) pool, through strides: no copy, no
// transpose.  Any hd up to 4096: an hd that is not a multiple of 8 masks
// its last lane chunk (a zeroed tail in shared memory), pools whose rows
// are not on 16-byte steps are read value by value (the pool cannot be
// padded without a copy of all of it), above 256 a lane walks hd in up to
// four 8-value chunks (one query head a block; deepseek-v3's absorbed-MLA
// latent is 576 = 512 + 64), and above 1024 the output columns are cut
// into blocks of 1024 (a third grid dimension), each recomputing the
// full-hd scores in the same order (the split-and-combine order is
// unchanged, so every block holds the same max and sum).
// Types: float32, bfloat16 and float16 (the tensor-core route takes both
// 16-bit types).  The int8 pool route (paged_decode_int8, the port of the
// JAX engine's quantized decode) runs the float32 FMA kernel with int8
// pages dequantized (code * the page's float32 scale) into a float32
// ring as a tile loads (16 codes a 16-byte load where the pool's rows
// allow it), and the current token's k/v, not yet quantized into the
// pool, read from beside it; q, the current k/v and out in any of the
// three types.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "warp_ops.cuh"

namespace {

using namespace mz::warp;

constexpr int kThreads = 128;   // threads a block (4 warps)
constexpr int kStages = 3;      // K/V ring stages (2 in the column-split form)
constexpr int kMaxPages = 64;   // pages a split, at most (page ids in shared memory)
constexpr int kMaxHeads = 8;    // query heads a block, at most (hd <= 256)
constexpr int kColBlock = 1024; // output columns a block (32 lanes x 4 chunks of 8)
constexpr int kMaxHd = 4096;    // widest head: column blocks of 1024 past 1024
constexpr int kCombineThreads = 64;

using mz::load8;

// the softmax's denominator: a zero sum is clamped (a row with nothing
// live gives 0), a NaN one kept, so that a NaN a live position read
// reaches the output (fmaxf would drop it)
__device__ __forceinline__ float denom(float l) { return isnan(l) ? l : fmaxf(l, 1e-30f); }

struct Pool {
  long long sp, so, sh;   // element strides of page, offset, head (hd: 1)
};

// The int8 pool's extra inputs: one float32 scale a (page, kv head) of
// each pool, element (page, g) at page * sp + g * sh, and the current
// token's k and v (b, g, hd) in q's type at b * n_sb + g * n_sh, which
// the pool does not hold yet (it is quantized after the step attends).
struct Q8 {
  const float* ks;
  const float* vs;
  long long sp, sh;
  const void* kn;
  const void* vn;
  long long n_sb, n_sh;
};

// T: element type of q and out, and of the shared ring but on the int8
// route (float32 there); LN: lanes a position;
// NC: 8-value chunks of a row a lane (<= 8 * LN * NC values: NC > 1 only
// at LN 32, hd > 256); GM: query heads a block holds in registers (>= the
// plan's heads).  A position's K row sits in shared memory at a stride of
// hd rounded up to 8 (hks), its V row at hvs, the tails zeroed once, so
// the last lane chunk of an hd that is not a multiple of 8 reads zeros.
// vec: rows copied by 16-byte cp.async (pool rows and strides on 16-byte
// steps); else value by value.
//   WIDE (hd > 1024; LN 32, GM 1, NC 4): blockIdx.z is a block of 1024
//     output columns.  K rows are held whole and every column block
//     recomputes the full-hd scores, in the same order, from q staged in
//     shared memory (so every block holds the same max and sum); V rows
//     only the block's columns.  Two ring stages, one row a group a tile.
//   INT8: the pools are int8 codes with a float32 scale a (page, kv
//     head); a tile's rows are dequantized (code * scale) into the
//     float32 ring as they load, and the row of the current token
//     (position length - 1) comes from the k/v inputs (in T) instead.
// (a minimum of one block in the launch bounds: without it ptxas picked
// spilling register counts for GM = 2)
template <typename T, int LN, int GM, int NC, bool WIDE, bool INT8>
__global__ void __launch_bounds__(kThreads, 1)
paged_split_kernel(const T* __restrict__ q, const void* __restrict__ kp_raw,
                   const void* __restrict__ vp_raw, const int* __restrict__ tables,
                   const int* __restrict__ lengths, T* __restrict__ out,
                   float* __restrict__ ws, int h, int hkv, int hd, int ps,
                   int npp, int pps, int heads, int hchunks, long long q_sb,
                   long long q_sh, Pool kpool, Pool vpool, float scale_log2,
                   int vec, Q8 q8) {
  static_assert(!WIDE || (LN == 32 && GM == 1 && NC == 4), "column split: one head, 1024 columns");
  using P = typename std::conditional<INT8, int8_t, T>::type;   // pool element
  using RT = typename std::conditional<INT8, float, T>::type;   // ring element
  constexpr int EPC = 16 / sizeof(RT);       // elements a 16-byte copy
  constexpr int NPG = kThreads / LN;         // position groups a block
  constexpr int R = sizeof(RT) == 2 && !WIDE ? 2 : 1;  // rows a group a tile
  constexpr int TP = NPG * R;                // rows a tile
  constexpr int HDMAX = 8 * LN * NC;         // columns a block holds
  constexpr int STAGES = WIDE ? 2 : kStages;
  extern __shared__ __align__(16) unsigned char smem[];   // the ring, then the merge area
  __shared__ int pid_s[kMaxPages];
  __shared__ float ksc_s[INT8 ? kMaxPages : 1], vsc_s[INT8 ? kMaxPages : 1];
  __shared__ float mw_s[kThreads / 32][GM], lw_s[kThreads / 32][GM];
  const P* kp = static_cast<const P*>(kp_raw);
  const P* vp = static_cast<const P*>(vp_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hc = blockIdx.x % hchunks;
  const int g = (blockIdx.x / hchunks) % hkv;
  const int b = blockIdx.x / (hchunks * hkv);
  const int split = blockIdx.y, splits = gridDim.y;
  const int col0 = WIDE ? blockIdx.z * kColBlock : 0;     // first output column
  const int vw = WIDE ? min(kColBlock, hd - col0) : hd;   // output columns
  const int group = h / hkv;
  const int h0 = g * group + hc * heads;          // this block's first query head
  const int nh = min(heads, group - hc * heads);  // and its count
  const int len = lengths[b];
  const int pos0 = split * pps * ps;
  const int pos_end = min(len, min(npp, (split + 1) * pps) * ps);
  const int hks = (hd + 7) & ~7;                  // shared K row stride
  const int hvs = WIDE ? kColBlock : hks;         // shared V row stride
  const size_t ring_elems = static_cast<size_t>(STAGES) * TP * (hks + hvs);
  RT* ring = reinterpret_cast<RT*>(smem);
  float* merge = reinterpret_cast<float*>(smem);

  if (pos0 >= pos_end) {          // nothing live: an empty partial
    for (int e = tid; e < nh * vw; e += kThreads) {
      const int head = h0 + e / vw, d = e % vw;
      if (splits == 1)
        out[(static_cast<size_t>(b) * h + head) * hd + col0 + d] = mz::from_f<T>(0.f);
      else if (d == 0 && col0 == 0)
        ws[((static_cast<size_t>(b) * h + head) * splits + split) * (hd + 2) + 1] = 0.f;
    }
    return;
  }

  const int npages = (pos_end - pos0 + ps - 1) / ps;   // live pages of the split
  const int* trow = tables + static_cast<size_t>(b) * npp + split * pps;
  for (int i = tid; i < npages; i += kThreads) {
    const int page = trow[i];
    pid_s[i] = page;
    if constexpr (INT8) {
      ksc_s[i] = q8.ks[page * q8.sp + g * q8.sh];
      vsc_s[i] = q8.vs[page * q8.sp + g * q8.sh];
    }
  }
  {                                   // zero the rows' tails, once
    const int kt = hks - hd, vt = ((vw + 7) & ~7) - vw;
    for (int e = tid; e < STAGES * TP * (kt + vt); e += kThreads) {
      const int r = e / (kt + vt), x = e % (kt + vt);   // r: (stage, row)
      RT* row = ring + (r / TP) * TP * (hks + hvs) + (x < kt ? (r % TP) * hks + hd
                                                            : TP * hks + (r % TP) * hvs + vw - kt);
      row[x] = mz::from_f<RT>(0.f);
    }
  }

  const int c = lane % LN;            // this lane's chunk of a row (of each part)
  const int pg = tid / LN;            // its position group
  bool active[NC];
#pragma unroll
  for (int p = 0; p < NC; ++p) active[p] = (p * LN + c) * 8 < vw;

  // q, scaled by log2(e) / sqrt(hd): in registers, or (WIDE) the whole
  // row in shared memory past the ring and the merge area
  float qf[WIDE ? 1 : GM][WIDE ? 1 : NC][8];
  float* q_s = reinterpret_cast<float*>(smem) + (WIDE ? ring_elems * sizeof(RT) / 4 : 0);
  if constexpr (WIDE) {
    const T* qr = q + b * q_sb + static_cast<long long>(h0) * q_sh;
    for (int d = tid; d < hks; d += kThreads)
      q_s[d] = d < hd ? mz::to_f(qr[d]) * scale_log2 : 0.f;
  } else {
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
#pragma unroll
      for (int p = 0; p < NC; ++p) {
        const int d0 = (p * LN + c) * 8;
        const T* qr = q + b * q_sb + static_cast<long long>(h0 + gi) * q_sh + d0;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          qf[gi][p][e] = gi < nh && d0 + e < hd ? mz::to_f(qr[e]) * scale_log2 : 0.f;
      }
    }
  }
  float m[GM], l[GM], acc[GM][NC][8];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) {
    m[gi] = mz::kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int p = 0; p < NC; ++p)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[gi][p][e] = 0.f;
  }
  __syncthreads();                    // page ids, scales, zeroed tails, q

  auto load_tile = [&](int t) {
    RT* ks = ring + (t % STAGES) * TP * (hks + hvs);
    RT* vs = ks + TP * hks;
    if constexpr (INT8) {
      // K rows whole, V rows the block's columns: code * the page's scale,
      // the current token's row from its inputs (in T); 16 codes a
      // 16-byte load where the pool's rows are on 16-byte steps (vec)
      if (vec) {
        const int cpk = hd / 16, cpv = vw / 16;
        for (int e = tid; e < TP * (cpk + cpv); e += kThreads) {
          const bool is_k = e < TP * cpk;
          const int r = is_k ? e / cpk : (e - TP * cpk) / cpv;
          const int d = (is_k ? e % cpk : (e - TP * cpk) % cpv) * 16 + (is_k ? 0 : col0);
          const int lp = t * TP + r, pos = pos0 + lp;
          float4 x[4] = {};
          if (pos < pos_end && pos == len - 1) {
            const T* src = static_cast<const T*>(is_k ? q8.kn : q8.vn) + b * q8.n_sb +
                           g * q8.n_sh + d;
            float f[2][8];
            load8(src, f[0]);
            load8(src + 8, f[1]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              x[i] = make_float4(f[i / 2][4 * (i % 2)], f[i / 2][4 * (i % 2) + 1],
                                 f[i / 2][4 * (i % 2) + 2], f[i / 2][4 * (i % 2) + 3]);
          } else if (pos < pos_end) {
            const long long page = pid_s[lp / ps], off = lp % ps;
            const Pool& pl = is_k ? kpool : vpool;
            const uint4 u = *reinterpret_cast<const uint4*>(
                (is_k ? kp : vp) + page * pl.sp + off * pl.so + g * pl.sh + d);
            const float sc = (is_k ? ksc_s : vsc_s)[lp / ps];
            const int8_t* c8 = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              x[i] = make_float4(c8[4 * i] * sc, c8[4 * i + 1] * sc, c8[4 * i + 2] * sc,
                                 c8[4 * i + 3] * sc);
          }
          float4* dst = reinterpret_cast<float4*>(is_k ? ks + r * hks + d
                                                       : vs + r * hvs + d - col0);
#pragma unroll
          for (int i = 0; i < 4; ++i) dst[i] = x[i];
        }
        return;
      }
      for (int e = tid; e < TP * (hd + vw); e += kThreads) {
        const bool is_k = e < TP * hd;
        const int r = is_k ? e / hd : (e - TP * hd) / vw;
        const int d = is_k ? e % hd : (e - TP * hd) % vw + col0;
        const int lp = t * TP + r, pos = pos0 + lp;
        float x = 0.f;
        if (pos < pos_end && pos == len - 1) {
          x = mz::to_f(static_cast<const T*>(is_k ? q8.kn : q8.vn)[b * q8.n_sb +
                                                                  g * q8.n_sh + d]);
        } else if (pos < pos_end) {
          const long long page = pid_s[lp / ps], off = lp % ps;
          const Pool& pl = is_k ? kpool : vpool;
          x = static_cast<float>((is_k ? kp : vp)[page * pl.sp + off * pl.so + g * pl.sh + d]) *
              (is_k ? ksc_s : vsc_s)[lp / ps];
        }
        if (is_k) ks[r * hks + d] = x;
        else vs[r * hvs + d - col0] = x;
      }
    } else if (vec) {
      const int cpk = hd / EPC, cpv = vw / EPC;   // 16-byte copies a row
      for (int e = tid; e < TP * (cpk + cpv); e += kThreads) {
        const bool is_k = e < TP * cpk;
        const int r = is_k ? e / cpk : (e - TP * cpk) / cpv;
        const int cc = is_k ? e % cpk : (e - TP * cpk) % cpv;
        const int lp = t * TP + r;    // position inside the split
        const bool ok = pos0 + lp < pos_end;
        const P* src = is_k ? kp : vp;
        if (ok) {
          const long long page = pid_s[lp / ps], off = lp % ps;
          const Pool& pl = is_k ? kpool : vpool;
          src += page * pl.sp + off * pl.so + g * pl.sh + (is_k ? 0 : col0) + cc * EPC;
        }
        cp_async16(smem_addr(is_k ? ks + r * hks + cc * EPC : vs + r * hvs + cc * EPC),
                   src, ok);
      }
    } else {
      for (int e = tid; e < TP * (hd + vw); e += kThreads) {
        const bool is_k = e < TP * hd;
        const int r = is_k ? e / hd : (e - TP * hd) / vw;
        const int d = is_k ? e % hd : (e - TP * hd) % vw + col0;
        const int lp = t * TP + r;
        T x = mz::from_f<T>(0.f);
        if (pos0 + lp < pos_end) {
          const long long page = pid_s[lp / ps], off = lp % ps;
          const Pool& pl = is_k ? kpool : vpool;
          x = (is_k ? kp : vp)[page * pl.sp + off * pl.so + g * pl.sh + d];
        }
        if (is_k) ks[r * hks + d] = x;
        else vs[r * hvs + d - col0] = x;
      }
    }
  };

  const int ntiles = (pos_end - pos0 + TP - 1) / TP;
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_wait<STAGES - 2>();
    __syncthreads();                  // tile t landed; tile t-1's slot is free
    if (t + STAGES - 1 < ntiles) load_tile(t + STAGES - 1);
    cp_commit();
    const RT* ks = ring + (t % STAGES) * TP * (hks + hvs);
    const RT* vs = ks + TP * hks;
    float s[R][GM];
    bool valid[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int row = pg + NPG * rr;
      valid[rr] = pos0 + t * TP + row < pos_end;
      float part[GM];
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) part[gi] = 0.f;
      if constexpr (WIDE) {
        // the full-hd score: 8-value chunks c, c + 32, ... of the row
        for (int d0 = c * 8; d0 < hks; d0 += 8 * LN) {
          float kf[8], qv[8];
          load8(ks + row * hks + d0, kf);
          load8(q_s + d0, qv);
#pragma unroll
          for (int e = 0; e < 8; ++e) part[0] = fmaf(qv[e], kf[e], part[0]);
        }
      } else {
#pragma unroll
        for (int p = 0; p < NC; ++p) {
          float kf[8];
          if (active[p]) load8(ks + row * hks + (p * LN + c) * 8, kf);
          else {
#pragma unroll
            for (int e = 0; e < 8; ++e) kf[e] = 0.f;
          }
#pragma unroll
          for (int gi = 0; gi < GM; ++gi)
#pragma unroll
            for (int e = 0; e < 8; ++e) part[gi] = fmaf(qf[gi][p][e], kf[e], part[gi]);
        }
      }
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
        float sc = 0.f;
        if (gi < nh) {
          sc = part[gi];
#pragma unroll
          for (int o = LN / 2; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
        }
        s[rr][gi] = sc;
      }
    }
    float pw[GM][R], corr[GM];
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      corr[gi] = 1.f;
#pragma unroll
      for (int rr = 0; rr < R; ++rr) pw[gi][rr] = 0.f;
      if (gi >= nh) continue;
      float mx = m[gi];
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
        if (valid[rr]) mx = fmaxf(mx, s[rr][gi]);
      corr[gi] = exp2f(m[gi] - mx);
      float psum = 0.f;
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        pw[gi][rr] = valid[rr] ? exp2f(s[rr][gi] - mx) : 0.f;
        psum += pw[gi][rr];
      }
      m[gi] = mx;
      l[gi] = l[gi] * corr[gi] + psum;
    }
#pragma unroll
    for (int p = 0; p < NC; ++p) {       // each V chunk read once for every head
      float vf[R][8];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        if (active[p]) load8(vs + (pg + NPG * rr) * hvs + (p * LN + c) * 8, vf[rr]);
        else {
#pragma unroll
          for (int e = 0; e < 8; ++e) vf[rr][e] = 0.f;
        }
      }
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
        if (gi >= nh) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float a = acc[gi][p][e] * corr[gi];
#pragma unroll
          for (int rr = 0; rr < R; ++rr) a = fmaf(pw[gi][rr], vf[rr][e], a);
          acc[gi][p][e] = a;
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();                    // the ring becomes the merge area

  // merge the position groups of each warp (xor over the lane bits above LN)
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) {
    if (gi >= nh) continue;
    float mw = m[gi];
#pragma unroll
    for (int o = LN; o < 32; o <<= 1) mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
    const float f = exp2f(m[gi] - mw);
    float lw = l[gi] * f;
#pragma unroll
    for (int o = LN; o < 32; o <<= 1) lw += __shfl_xor_sync(0xffffffffu, lw, o);
#pragma unroll
    for (int p = 0; p < NC; ++p) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float a = acc[gi][p][e] * f;
#pragma unroll
        for (int o = LN; o < 32; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        acc[gi][p][e] = a;
      }
      if (lane < LN && active[p]) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          merge[(warp * GM + gi) * HDMAX + (p * LN + c) * 8 + e] = acc[gi][p][e];
      }
    }
    if (lane == 0) {
      mw_s[warp][gi] = mw;
      lw_s[warp][gi] = lw;
    }
  }
  __syncthreads();
  // then the warps, in order; one thread a (query head, column)
  for (int e = tid; e < nh * vw; e += kThreads) {
    const int gi = e / vw, d = e % vw;
    float mx = mz::kNegInf;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) mx = fmaxf(mx, mw_s[w][gi]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const float f = exp2f(mw_s[w][gi] - mx);
      lsum += lw_s[w][gi] * f;
      a += merge[(w * GM + gi) * HDMAX + d] * f;
    }
    const size_t bh = static_cast<size_t>(b) * h + h0 + gi;
    if (splits == 1) {
      out[bh * hd + col0 + d] = mz::from_f<T>(a / denom(lsum));
    } else {
      float* wp = ws + (bh * splits + split) * (hd + 2);
      wp[2 + col0 + d] = a;
      if (d == 0 && col0 == 0) {
        wp[0] = mx;
        wp[1] = lsum;
      }
    }
  }
}

// dynamic shared memory of a split block at head dim hd: the K/V ring, or
// (after it) the merge area, whichever is larger, and (WIDE) q's row
template <typename T, int LN, int GM, int NC, bool WIDE>
int split_smem_bytes(int hd) {
  const int tp = (kThreads / LN) * (sizeof(T) == 2 && !WIDE ? 2 : 1);
  const int hks = WIDE ? (hd + 7) & ~7 : 8 * LN * NC;
  const int hvs = WIDE ? kColBlock : hks;
  const int ring = (WIDE ? 2 : kStages) * tp * (hks + hvs) * static_cast<int>(sizeof(T));
  const int merge = (kThreads / 32) * GM * 8 * LN * NC * 4;
  return WIDE ? ring + hks * 4 : (ring > merge ? ring : merge);
}

// ---- bfloat16 and float16, head dims 32-128 in steps of 16: tensor cores --

constexpr int kTcRows = 32;       // positions a tile
constexpr int kTcStages = 3;
constexpr int kTcMaxHeads = 16;   // the m16 rows of mma.m16n8k16

// q values d, d + 1 of one head as a 16-bit pair (0 past the block's heads)
template <typename T>
__device__ __forceinline__ uint32_t q_pair(const T* row, int d, bool ok) {
  if (!ok) return 0u;
  const unsigned short* p = reinterpret_cast<const unsigned short*>(row + d);
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 16);
}

__host__ __device__ constexpr int tc_smem_bytes(int hd) {
  return kTcStages * 2 * kTcRows * (hd + 8) * 2;
}

// One warp a block: the query heads of a head chunk are the rows of S =
// Q K^T (mma.m16n8k16, Q in registers, K through ldmatrix), with the
// online softmax on the S fragments (quad shuffles along a row) and P fed
// back in registers as the A operand of P V (V through ldmatrix.trans),
// float32 sums; K/V tiles of 32 positions through a 3-stage cp.async ring.
template <typename T, int HD>
__global__ void __launch_bounds__(32, 1)
paged_tc_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                const T* __restrict__ vp, const int* __restrict__ tables,
                const int* __restrict__ lengths, T* __restrict__ out,
                float* __restrict__ ws, int h, int hkv, int ps, int ps_shift,
                int npp, int pps, int heads, int hchunks, long long q_sb,
                long long q_sh, Pool kpool, Pool vpool, float sl2) {
  constexpr int ST = HD + 8;       // shared row stride: ldmatrix rows on distinct banks
  constexpr int CPR = HD / 8;      // 16-byte chunks a row
  constexpr int KSTEPS = HD / 16;
  constexpr int NT = HD / 8;       // 8-wide n tiles of O
  constexpr int SN = kTcRows / 8;  // 8-wide n tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);   // [stages][kTcRows][ST]
  T* Vs = Ks + kTcStages * kTcRows * ST;
  __shared__ int pid_s[kMaxPages];

  const int lane = threadIdx.x;
  const int hc = blockIdx.x % hchunks;
  const int g = (blockIdx.x / hchunks) % hkv;
  const int b = blockIdx.x / (hchunks * hkv);
  const int split = blockIdx.y, splits = gridDim.y;
  const int group = h / hkv;
  const int h0 = g * group + hc * heads;
  const int nh = min(heads, group - hc * heads);
  const int len = lengths[b];
  const int pos0 = split * pps * ps;
  const int pos_end = min(len, min(npp, (split + 1) * pps) * ps);

  if (pos0 >= pos_end) {          // nothing live: an empty partial
    for (int e = lane; e < nh * HD; e += 32) {
      const int head = h0 + e / HD, d = e % HD;
      if (splits == 1)
        out[(static_cast<size_t>(b) * h + head) * HD + d] = mz::from_f<T>(0.f);
      else if (d == 0)
        ws[((static_cast<size_t>(b) * h + head) * splits + split) * (HD + 2) + 1] = 0.f;
    }
    return;
  }
  const int npages = (pos_end - pos0 + ps - 1) / ps;
  const int* trow = tables + static_cast<size_t>(b) * npp + split * pps;
  for (int i = lane; i < npages; i += 32) pid_s[i] = trow[i];
  __syncwarp();

  const T* kb = kp + g * kpool.sh;
  const T* vb = vp + g * vpool.sh;
  auto load_tile = [&](int t, int stage) {
    T* kd = Ks + stage * kTcRows * ST;
    T* vd = Vs + stage * kTcRows * ST;
#pragma unroll
    for (int e = lane; e < kTcRows * CPR; e += 32) {
      const int r = e / CPR, ch = e % CPR, lp = t * kTcRows + r;
      const bool ok = pos0 + lp < pos_end;
      const T* ksrc = kp;
      const T* vsrc = vp;
      if (ok) {
        int pi, off;
        if (ps_shift >= 0) {
          pi = lp >> ps_shift;
          off = lp & (ps - 1);
        } else {
          pi = lp / ps;
          off = lp - pi * ps;
        }
        const long long page = pid_s[pi];
        ksrc = kb + page * kpool.sp + off * kpool.so + ch * 8;
        vsrc = vb + page * vpool.sp + off * vpool.so + ch * 8;
      }
      cp_async16(smem_addr(kd + r * ST + ch * 8), ksrc, ok);
      cp_async16(smem_addr(vd + r * ST + ch * 8), vsrc, ok);
    }
  };
  const int ntiles = (pos_end - pos0 + kTcRows - 1) / kTcRows;
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_commit();
  }

  const int r4 = lane >> 2, c4 = (lane & 3) * 2;   // this lane's row and column pair
  const T* q0r = q + b * q_sb + static_cast<long long>(h0 + r4) * q_sh;
  const T* q1r = q + b * q_sb + static_cast<long long>(h0 + r4 + 8) * q_sh;
  const bool ok0 = r4 < nh, ok1 = r4 + 8 < nh;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    qf[kk][0] = q_pair(q0r, kk * 16 + c4, ok0);
    qf[kk][1] = q_pair(q1r, kk * 16 + c4, ok1);
    qf[kk][2] = q_pair(q0r, kk * 16 + 8 + c4, ok0);
    qf[kk][3] = q_pair(q1r, kk * 16 + 8 + c4, ok1);
  }
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * ST + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * ST + (lane >> 4) * 8;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max of rows r4, r4 + 8 (raw scores)
  float l0 = 0.f, l1 = 0.f;               // this lane's part of the running sums

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<kTcStages - 2>();
    __syncwarp();                 // tile `it` is in; tile it - 1 is consumed
    if (it + kTcStages - 1 < ntiles) load_tile(it + kTcStages - 1, (it + kTcStages - 1) % kTcStages);
    cp_commit();
    const int stage = it % kTcStages;
    const uint32_t kbase = smem_addr(Ks + stage * kTcRows * ST + k_off);
    const uint32_t vbase = smem_addr(Vs + stage * kTcRows * ST + v_off);
    float s[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < SN / 2; ++jp) {
        uint32_t bb[4];
        ldsm_x4(bb, kbase + (jp * 16 * ST + kk * 16) * 2);
        mz::mma16<T>(s[2 * jp], qf[kk], bb[0], bb[1]);
        mz::mma16<T>(s[2 * jp + 1], qf[kk], bb[2], bb[3]);
      }
    }
    const int base = pos0 + it * kTcRows;
    if (base + kTcRows > pos_end) {   // the tail of the last page
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (base + j * 8 + c4 + (e & 1) >= pos_end) s[j][e] = -INFINITY;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float ms0 = mx0 == -INFINITY ? 0.f : mx0 * sl2;
    const float ms1 = mx1 == -INFINITY ? 0.f : mx1 * sl2;
    const float cr0 = exp2f(m0 * sl2 - ms0), cr1 = exp2f(m1 * sl2 - ms1);
    m0 = mx0;
    m1 = mx1;
    l0 *= cr0;
    l1 *= cr1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= cr0;
      acc[n][1] *= cr0;
      acc[n][2] *= cr1;
      acc[n][3] *= cr1;
    }
    uint32_t pa[SN / 2][4];
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      const float p0 = exp2f(fmaf(s[j][0], sl2, -ms0));
      const float p1 = exp2f(fmaf(s[j][1], sl2, -ms0));
      const float p2 = exp2f(fmaf(s[j][2], sl2, -ms1));
      const float p3 = exp2f(fmaf(s[j][3], sl2, -ms1));
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = mz::pack2<T>(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = mz::pack2<T>(p2, p3);
    }
#pragma unroll
    for (int kk = 0; kk < SN / 2; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vbase + (kk * 16 * ST + np * 16) * 2);
        mz::mma16<T>(acc[2 * np], pa[kk], bb[0], bb[1]);
        mz::mma16<T>(acc[2 * np + 1], pa[kk], bb[2], bb[3]);
      }
    }
  }
  cp_wait<0>();
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  // rows r4 and r4 + 8: the heads h0 + r4 and h0 + r4 + 8 of this block
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r4 + 8 * half;
    if (row >= nh) continue;
    const float l = half ? l1 : l0, m = half ? m1 : m0;
    const size_t bh = static_cast<size_t>(b) * h + h0 + row;
    if (splits == 1) {
      const float inv = 1.f / denom(l);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<uint32_t*>(out + bh * HD + n * 8 + c4) =
            mz::pack2<T>(acc[n][2 * half] * inv, acc[n][2 * half + 1] * inv);
    } else {
      float* wp = ws + (bh * splits + split) * (HD + 2);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        wp[2 + n * 8 + c4] = acc[n][2 * half];
        wp[3 + n * 8 + c4] = acc[n][2 * half + 1];
      }
      if (c4 == 0) {
        wp[0] = m * sl2;
        wp[1] = l;
      }
    }
  }
}

template <typename T, int HD>
int tc_smem_set[mz::kDevices] = {};

// merges the splits' partials of one (slot, query head) in a fixed order:
// the max over the splits (a fixed tree), each split's weight exp2(m - max),
// then per d the weighted sums in split order.  Only an empty split (l ==
// 0, its acc never written) is left out: a split whose l or acc is NaN
// enters every sum, so the NaN reaches the output.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
paged_combine_kernel(const float* __restrict__ ws, T* __restrict__ out, int hd,
                     int splits) {
  extern __shared__ float w_s[];     // [2][splits]: weight, weight * l; then [splits] live
  __shared__ float red[kCombineThreads];
  unsigned char* live_s = reinterpret_cast<unsigned char*>(w_s + 2 * splits);
  const int tid = threadIdx.x;
  const size_t bh = blockIdx.x;
  const float* wp = ws + bh * splits * (hd + 2);
  constexpr int U = 8;               // partials read at once (loads in flight)
  float mx = mz::kNegInf;
  for (int s0 = tid * U; s0 < splits; s0 += kCombineThreads * U) {
    float m[U], l[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = s0 + u < splits;
      m[u] = ok ? wp[(s0 + u) * (hd + 2)] : 0.f;
      l[u] = ok ? wp[(s0 + u) * (hd + 2) + 1] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (l[u] != 0.f) mx = fmaxf(mx, m[u]);
  }
  red[tid] = mx;
  __syncthreads();
#pragma unroll
  for (int o = kCombineThreads / 2; o > 0; o >>= 1) {
    if (tid < o) red[tid] = fmaxf(red[tid], red[tid + o]);
    __syncthreads();
  }
  mx = red[0];
  for (int s = tid; s < splits; s += kCombineThreads) {
    const float l = wp[s * (hd + 2) + 1];
    const bool live = l != 0.f;      // true for a NaN l
    const float f = live ? exp2f(wp[s * (hd + 2)] - mx) : 0.f;
    w_s[s] = f;
    w_s[splits + s] = live ? f * l : 0.f;
    live_s[s] = live;
  }
  __syncthreads();
  float lsum = 0.f;
  for (int s = 0; s < splits; ++s) lsum += w_s[splits + s];
  for (int d = tid; d < hd; d += kCombineThreads) {
    float a = 0.f;
    for (int s0 = 0; s0 < splits; s0 += U) {
      float x[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        x[u] = s0 + u < splits ? wp[(s0 + u) * (hd + 2) + 2 + d] : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u)   // in split order; an empty split's acc is never used
        if (s0 + u < splits && live_s[s0 + u]) a = fmaf(w_s[s0 + u], x[u], a);
    }
    out[bh * hd + d] = mz::from_f<T>(a / denom(lsum));
  }
}

template <typename T, int LN, int GM, int NC, bool WIDE, bool INT8>
int split_smem_set[mz::kDevices] = {};

// The arguments every launch of a call shares.
struct Call {
  const void* q;
  const void* kp;
  const void* vp;
  const int* tables;
  const int* lengths;
  void* out;
  float* ws;
  int b, h, hkv, hd, ps, npp, pps, splits, heads, hchunks, cblocks;
  long long q_sb, q_sh;
  Pool kpool, vpool;
  float scale_log2;
  int vec;
  Q8 q8;
};

template <typename T, int LN, int GM, int NC, bool WIDE, bool INT8>
cudaError_t launch_split(const Call& c, cudaStream_t st) {
  auto kern = paged_split_kernel<T, LN, GM, NC, WIDE, INT8>;
  using RT = typename std::conditional<INT8, float, T>::type;   // the ring's type
  const int smem = split_smem_bytes<RT, LN, GM, NC, WIDE>(c.hd);
  cudaError_t e = mz::opt_in(kern, split_smem_set<T, LN, GM, NC, WIDE, INT8>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(c.b * c.hkv * c.hchunks, c.splits, c.cblocks);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(c.q), c.kp, c.vp, c.tables, c.lengths, static_cast<T*>(c.out),
      c.ws, c.h, c.hkv, c.hd, c.ps, c.npp, c.pps, c.heads, c.hchunks, c.q_sb, c.q_sh,
      c.kpool, c.vpool, c.scale_log2, c.vec, c.q8);
  return cudaGetLastError();
}

// hd <= 256: one 8-value chunk a lane, `gm` heads a block; 256 < hd <=
// 1024: 32 lanes, `nc` chunks a lane, one head a block; hd > 1024: the
// column split (32 lanes, 4 chunks, one head)
template <typename T, int LN, bool INT8>
cudaError_t launch_ln(const Call& c, int gm, int nc, cudaStream_t st) {
#define MZ_PD(GMV, NCV, W) return launch_split<T, LN, GMV, NCV, W, INT8>(c, st)
  if (nc == 1) {
    if (gm == 1) MZ_PD(1, 1, false);
    if (gm == 2) MZ_PD(2, 1, false);
    if (gm == 4) MZ_PD(4, 1, false);
    if (gm == 8) MZ_PD(8, 1, false);
  } else if constexpr (LN == 32) {
    if (gm == 1 && nc == 2) MZ_PD(1, 2, false);
    if (gm == 1 && nc == 3) MZ_PD(1, 3, false);
    if (gm == 1 && nc == 4) MZ_PD(1, 4, false);
    if (gm == 1 && nc > 4) MZ_PD(1, 4, true);
  }
#undef MZ_PD
  return cudaErrorInvalidValue;
}

template <typename T, int HD>
cudaError_t launch_tc(const Call& c, cudaStream_t st) {
  const int smem = tc_smem_bytes(HD);
  cudaError_t e = mz::opt_in(paged_tc_kernel<T, HD>, tc_smem_set<T, HD>, smem);
  if (e != cudaSuccess) return e;
  const int ps_shift = (c.ps & (c.ps - 1)) == 0 ? __builtin_ctz(c.ps) : -1;
  const dim3 grid(c.b * c.hkv * c.hchunks, c.splits);
  paged_tc_kernel<T, HD><<<grid, 32, smem, st>>>(
      static_cast<const T*>(c.q), static_cast<const T*>(c.kp), static_cast<const T*>(c.vp),
      c.tables, c.lengths, static_cast<T*>(c.out), c.ws, c.h, c.hkv, c.ps, ps_shift, c.npp,
      c.pps, c.heads, c.hchunks, c.q_sb, c.q_sh, c.kpool, c.vpool, c.scale_log2);
  return cudaGetLastError();
}

// the tensor-core route: bfloat16 or float16, hd in {32, 48, ..., 128},
// 16-byte rows (kernels/_attn_plan.py: paged_plan's route "tc")
bool tc_route(int dtype, int hd, bool vec) {
  return (dtype == 1 || dtype == 2) && vec && hd % 16 == 0 && hd >= 32 && hd <= 128;
}

// T: q's and out's type; the splits' partials merged by
// paged_combine_kernel when there is more than one.  The int8 route
// always takes the FMA kernel (its ring is float32).
// dynamic shared memory of the combine: two floats and a live flag a split
size_t combine_smem(int splits) { return splits * (2 * sizeof(float) + 1); }

template <typename T, bool INT8>
cudaError_t launch(const Call& c, cudaStream_t st) {
  cudaError_t e;
  if constexpr (sizeof(T) == 2 && !INT8) {
    if (tc_route(1, c.hd, c.vec)) {
      switch (c.hd) {
        case 32: e = launch_tc<T, 32>(c, st); break;
        case 48: e = launch_tc<T, 48>(c, st); break;
        case 64: e = launch_tc<T, 64>(c, st); break;
        case 80: e = launch_tc<T, 80>(c, st); break;
        case 96: e = launch_tc<T, 96>(c, st); break;
        case 112: e = launch_tc<T, 112>(c, st); break;
        default: e = launch_tc<T, 128>(c, st); break;
      }
      if (e != cudaSuccess || c.splits == 1) return e;
      paged_combine_kernel<T><<<c.b * c.h, kCombineThreads, combine_smem(c.splits), st>>>(
          c.ws, static_cast<T*>(c.out), c.hd, c.splits);
      return cudaGetLastError();
    }
  }
  int gm = 1;
  while (gm < c.heads) gm *= 2;
  int ln = 4;
  while (ln * 8 < c.hd && ln < 32) ln *= 2;
  const int nc = (c.hd + 8 * ln - 1) / (8 * ln);
  if (ln == 4) e = launch_ln<T, 4, INT8>(c, gm, nc, st);
  else if (ln == 8) e = launch_ln<T, 8, INT8>(c, gm, nc, st);
  else if (ln == 16) e = launch_ln<T, 16, INT8>(c, gm, nc, st);
  else e = launch_ln<T, 32, INT8>(c, gm, nc, st);
  if (e != cudaSuccess || c.splits == 1) return e;
  paged_combine_kernel<T><<<c.b * c.h, kCombineThreads, combine_smem(c.splits), st>>>(
      c.ws, static_cast<T*>(c.out), c.hd, c.splits);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the checks both entries share; the plan is kernels/_attn_plan.py's
bool valid_call(const Call& c, int max_heads) {
  return c.b >= 1 && c.hkv >= 1 && c.h % c.hkv == 0 && c.ps >= 1 && c.npp >= 1 &&
         c.hd >= 1 && c.hd <= kMaxHd && c.pps >= 1 && c.pps <= kMaxPages &&
         c.splits == (c.npp + c.pps - 1) / c.pps && c.heads >= 1 && c.heads <= max_heads &&
         c.hchunks >= 1 && c.hchunks * c.heads >= c.h / c.hkv &&
         (c.hchunks - 1) * c.heads < c.h / c.hkv && c.splits <= 4096 &&
         (c.splits == 1 || c.ws != nullptr) &&
         c.cblocks == (c.hd > kColBlock ? (c.hd + kColBlock - 1) / kColBlock : 1);
}

}  // namespace

// q: (b, h, hd) with strides q_sb, q_sh (unit stride on hd); k/v pools:
// one layer's (P, ps, hkv, hd) with strides (page, offset, head), unit
// stride on hd; tables: (b, npp) int32 contiguous; lengths: (b,) int32;
// out: (b, h, hd) contiguous; ws: b*h*splits*(hd+2) float32 when splits >
// 1.  Any hd up to 4096; past 1024, cblocks = ceil(hd / 1024) blocks of
// output columns (a grid dimension), else 1.  The plan (pps pages a split,
// splits, heads a block, hchunks head chunks a kv head) is
// kernels/_attn_plan.py's paged_plan; its route is "tc" where tc_route
// holds with the pools' rows on 16-byte steps (vec).  scale_log2 = log2(e)
// / sqrt(hd).  dtype 0 float32, 1 bfloat16, 2 float16.
extern "C" int paged_decode(const void* q, const void* kp, const void* vp,
                            const void* tables, const void* lengths, void* out,
                            void* ws, int b, int h, int hkv, int hd, int ps,
                            int npp, int pps, int splits, int heads, int hchunks,
                            int cblocks, long long q_sb, long long q_sh,
                            long long k_sp, long long k_so, long long k_sh,
                            long long v_sp, long long v_so, long long v_sh,
                            float scale_log2, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int epc = dtype == 0 ? 4 : 8;   // elements a 16-byte row copy
  const int vec = hd % epc == 0 && aligned16(kp) && aligned16(vp) && k_sp % epc == 0 &&
                  k_so % epc == 0 && k_sh % epc == 0 && v_sp % epc == 0 &&
                  v_so % epc == 0 && v_sh % epc == 0;
  const Call c{q, kp, vp, static_cast<const int*>(tables), static_cast<const int*>(lengths),
               out, static_cast<float*>(ws), b, h, hkv, hd, ps, npp, pps, splits, heads,
               hchunks, cblocks, q_sb, q_sh, {k_sp, k_so, k_sh}, {v_sp, v_so, v_sh},
               scale_log2, vec, {}};
  const int max_heads = tc_route(dtype, hd, vec) ? kTcMaxHeads : hd > 256 ? 1 : kMaxHeads;
  if (!valid_call(c, max_heads)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(mz::by_dtype(dtype, [&](auto t) {
    return launch<decltype(t), false>(c, st);
  }));
}

// The int8 pool route: k/v pools of int8 codes with float32 scales
// k_scales / v_scales, element (page, kv head) at page * s_sp + head *
// s_sh, read for every live position < lengths - 1; the current token's
// k and v (position lengths - 1, not in the pool yet) from k_new / v_new,
// (b, hkv, hd) in q's type at b * n_sb + head * n_sh (unit stride on hd).
// q, k_new, v_new and out in `dtype` (0 float32, 1 bfloat16, 2 float16),
// the arithmetic in float32; the rest as paged_decode, on the FMA route.
extern "C" int paged_decode_int8(const void* q, const void* kp, const void* vp,
                                 const void* tables, const void* lengths, void* out,
                                 void* ws, int b, int h, int hkv, int hd, int ps,
                                 int npp, int pps, int splits, int heads, int hchunks,
                                 int cblocks, long long q_sb, long long q_sh,
                                 long long k_sp, long long k_so, long long k_sh,
                                 long long v_sp, long long v_so, long long v_sh,
                                 const void* k_scales, const void* v_scales,
                                 long long s_sp, long long s_sh, const void* k_new,
                                 const void* v_new, long long n_sb, long long n_sh,
                                 float scale_log2, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Q8 q8{static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
              s_sp, s_sh, k_new, v_new, n_sb, n_sh};
  const int epc = dtype == 0 ? 4 : 8;   // elements of k_new / v_new a 16 bytes
  // 16 int8 codes a load where every row starts on a 16-byte step
  const int vec = hd % 16 == 0 && aligned16(kp) && aligned16(vp) && k_sp % 16 == 0 &&
                  k_so % 16 == 0 && k_sh % 16 == 0 && v_sp % 16 == 0 && v_so % 16 == 0 &&
                  v_sh % 16 == 0 && aligned16(k_new) && aligned16(v_new) && n_sb % epc == 0 &&
                  n_sh % epc == 0;
  const Call c{q, kp, vp, static_cast<const int*>(tables), static_cast<const int*>(lengths),
               out, static_cast<float*>(ws), b, h, hkv, hd, ps, npp, pps, splits, heads,
               hchunks, cblocks, q_sb, q_sh, {k_sp, k_so, k_sh}, {v_sp, v_so, v_sh},
               scale_log2, vec, q8};
  if (!valid_call(c, hd > 256 ? 1 : kMaxHeads) || !k_scales || !v_scales || !k_new ||
      !v_new)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(mz::by_dtype(dtype, [&](auto t) {
    return launch<decltype(t), true>(c, st);
  }));
}

MZ_ERROR_STRING(paged_decode)
