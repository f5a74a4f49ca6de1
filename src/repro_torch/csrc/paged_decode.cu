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
// The pool is read in its stored (P, ps, Hkv, hd) layout, one layer's
// slice of the (L, P, ps, Hkv, hd) pool, through strides: no copy, no
// transpose.  Any hd up to 1024: an hd that is not a multiple of 8 masks
// its last lane chunk (a zeroed tail in shared memory), pools whose rows
// are not on 16-byte steps are read value by value (the pool cannot be
// padded without a copy of all of it), and above 256 a lane walks hd in
// up to four 8-value chunks (one query head a block; deepseek-v3's
// absorbed-MLA latent is 576 = 512 + 64).
#include <cstdint>

#include "common.cuh"
#include "warp_ops.cuh"

namespace {

using namespace mz::warp;

constexpr int kThreads = 128;   // threads a block (4 warps)
constexpr int kStages = 3;      // K/V ring stages
constexpr int kMaxPages = 64;   // pages a split, at most (page ids in shared memory)
constexpr int kMaxHeads = 8;    // query heads a block, at most (hd <= 256)
constexpr int kMaxHd = 1024;    // widest head (32 lanes x 4 chunks of 8)
constexpr int kCombineThreads = 64;

// 8 consecutive values from shared memory, as float32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h2[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

struct Pool {
  long long sp, so, sh;   // element strides of page, offset, head (hd: 1)
};

// T: element type; LN: lanes a position; NC: 8-value chunks of hd a lane
// (hd <= 8 * LN * NC: NC > 1 only at LN 32, hd > 256); GM: query heads a
// block holds in registers (>= the plan's heads).  A position's row sits
// in shared memory at a stride of hd rounded up to 8 (hds), the tail
// zeroed once, so the last lane chunk of an hd that is not a multiple of
// 8 reads zeros past hd.  vec: rows copied by 16-byte cp.async (pool
// rows and strides on 16-byte steps); else value by value.
// (a minimum of one block in the launch bounds: without it ptxas picked
// spilling register counts for GM = 2)
template <typename T, int LN, int GM, int NC>
__global__ void __launch_bounds__(kThreads, 1)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ tables,
                   const int* __restrict__ lengths, T* __restrict__ out,
                   float* __restrict__ ws, int h, int hkv, int hd, int ps,
                   int npp, int pps, int heads, int hchunks, long long q_sb,
                   long long q_sh, Pool kpool, Pool vpool, float scale_log2,
                   int vec) {
  constexpr int EPC = 16 / sizeof(T);        // elements a 16-byte copy
  constexpr int NPG = kThreads / LN;         // position groups a block
  constexpr int R = sizeof(T) == 2 ? 2 : 1;  // rows a group a tile
  constexpr int TP = NPG * R;                // rows a tile
  constexpr int HDMAX = 8 * LN * NC;
  extern __shared__ __align__(16) unsigned char smem[];   // the ring, then the merge area
  __shared__ int pid_s[kMaxPages];
  __shared__ float mw_s[kThreads / 32][GM], lw_s[kThreads / 32][GM];
  T* ring = reinterpret_cast<T*>(smem);
  float* merge = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hc = blockIdx.x % hchunks;
  const int g = (blockIdx.x / hchunks) % hkv;
  const int b = blockIdx.x / (hchunks * hkv);
  const int split = blockIdx.y, splits = gridDim.y;
  const int group = h / hkv;
  const int h0 = g * group + hc * heads;          // this block's first query head
  const int nh = min(heads, group - hc * heads);  // and its count
  const int len = lengths[b];
  const int pos0 = split * pps * ps;
  const int pos_end = min(len, min(npp, (split + 1) * pps) * ps);
  const int hds = (hd + 7) & ~7;                  // shared row stride

  if (pos0 >= pos_end) {          // nothing live: an empty partial
    for (int e = tid; e < nh * hd; e += kThreads) {
      const int head = h0 + e / hd, d = e % hd;
      if (splits == 1)
        out[(static_cast<size_t>(b) * h + head) * hd + d] = mz::from_f<T>(0.f);
      else if (d == 0)
        ws[((static_cast<size_t>(b) * h + head) * splits + split) * (hd + 2) + 1] = 0.f;
    }
    return;
  }

  const int npages = (pos_end - pos0 + ps - 1) / ps;   // live pages of the split
  const int* trow = tables + static_cast<size_t>(b) * npp + split * pps;
  for (int i = tid; i < npages; i += kThreads) pid_s[i] = trow[i];
  if (hds != hd)                      // zero the rows' tails past hd, once
    for (int e = tid; e < kStages * 2 * TP * (hds - hd); e += kThreads)
      ring[(e / (hds - hd)) * hds + hd + e % (hds - hd)] = mz::from_f<T>(0.f);

  const int c = lane % LN;            // this lane's chunk of hd (of each part)
  const int pg = tid / LN;            // its position group
  bool active[NC];
#pragma unroll
  for (int p = 0; p < NC; ++p) active[p] = (p * LN + c) * 8 < hd;

  float qf[GM][NC][8];
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
  __syncthreads();                    // page ids, zeroed tails

  auto load_tile = [&](int t) {
    T* ks = ring + (t % kStages) * 2 * TP * hds;
    T* vs = ks + TP * hds;
    if (vec) {
      const int cpr = hd / EPC;       // 16-byte copies a row
      for (int e = tid; e < TP * cpr; e += kThreads) {
        const int r = e / cpr, cc = e % cpr;
        const int lp = t * TP + r;    // position inside the split
        const bool ok = pos0 + lp < pos_end;
        const T* ksrc = kp;
        const T* vsrc = vp;
        if (ok) {
          const long long page = pid_s[lp / ps], off = lp % ps;
          ksrc = kp + page * kpool.sp + off * kpool.so + g * kpool.sh + cc * EPC;
          vsrc = vp + page * vpool.sp + off * vpool.so + g * vpool.sh + cc * EPC;
        }
        cp_async16(smem_addr(ks + r * hds + cc * EPC), ksrc, ok);
        cp_async16(smem_addr(vs + r * hds + cc * EPC), vsrc, ok);
      }
    } else {
      for (int e = tid; e < TP * hd; e += kThreads) {
        const int r = e / hd, d = e % hd;
        const int lp = t * TP + r;
        T kv = mz::from_f<T>(0.f), vv = kv;
        if (pos0 + lp < pos_end) {
          const long long page = pid_s[lp / ps], off = lp % ps;
          kv = kp[page * kpool.sp + off * kpool.so + g * kpool.sh + d];
          vv = vp[page * vpool.sp + off * vpool.so + g * vpool.sh + d];
        }
        ks[r * hds + d] = kv;
        vs[r * hds + d] = vv;
      }
    }
  };

  const int ntiles = (pos_end - pos0 + TP - 1) / TP;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_wait<kStages - 2>();
    __syncthreads();                  // tile t landed; tile t-1's slot is free
    if (t + kStages - 1 < ntiles) load_tile(t + kStages - 1);
    cp_commit();
    const T* ks = ring + (t % kStages) * 2 * TP * hds;
    const T* vs = ks + TP * hds;
    float s[R][GM];
    bool valid[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int row = pg + NPG * rr;
      valid[rr] = pos0 + t * TP + row < pos_end;
      float part[GM];
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) part[gi] = 0.f;
#pragma unroll
      for (int p = 0; p < NC; ++p) {
        float kf[8];
        if (active[p]) load8(ks + row * hds + (p * LN + c) * 8, kf);
        else {
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[e] = 0.f;
        }
#pragma unroll
        for (int gi = 0; gi < GM; ++gi)
#pragma unroll
          for (int e = 0; e < 8; ++e) part[gi] = fmaf(qf[gi][p][e], kf[e], part[gi]);
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
        if (active[p]) load8(vs + (pg + NPG * rr) * hds + (p * LN + c) * 8, vf[rr]);
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
  // then the warps, in order; one thread a (query head, d)
  for (int e = tid; e < nh * hd; e += kThreads) {
    const int gi = e / hd, d = e % hd;
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
      out[bh * hd + d] = mz::from_f<T>(a / fmaxf(lsum, 1e-30f));
    } else {
      float* wp = ws + (bh * splits + split) * (hd + 2);
      wp[2 + d] = a;
      if (d == 0) {
        wp[0] = mx;
        wp[1] = lsum;
      }
    }
  }
}

// dynamic shared memory of a split block: the K/V ring, or (after it) the
// merge area, whichever is larger
template <typename T, int LN, int GM, int NC>
constexpr int split_smem_bytes() {
  constexpr int ring = kStages * 2 * (kThreads / LN) * (sizeof(T) == 2 ? 2 : 1) *
                       8 * LN * NC * static_cast<int>(sizeof(T));
  constexpr int merge = (kThreads / 32) * GM * 8 * LN * NC * 4;
  return ring > merge ? ring : merge;
}

// ---- bfloat16, head dims 32-128 in steps of 16: tensor cores -------------

using bf16 = __nv_bfloat16;
constexpr int kTcRows = 32;       // positions a tile
constexpr int kTcStages = 3;
constexpr int kTcMaxHeads = 16;   // the m16 rows of mma.m16n8k16

// q values d, d + 1 of one head as a bf16 pair (0 past the block's heads)
__device__ __forceinline__ uint32_t q_pair(const bf16* row, int d, bool ok) {
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
template <int HD>
__global__ void __launch_bounds__(32, 1)
paged_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                const bf16* __restrict__ vp, const int* __restrict__ tables,
                const int* __restrict__ lengths, bf16* __restrict__ out,
                float* __restrict__ ws, int h, int hkv, int ps, int ps_shift,
                int npp, int pps, int heads, int hchunks, long long q_sb,
                long long q_sh, Pool kpool, Pool vpool, float sl2) {
  constexpr int ST = HD + 8;       // shared row stride: ldmatrix rows on distinct banks
  constexpr int CPR = HD / 8;      // 16-byte chunks a row
  constexpr int KSTEPS = HD / 16;
  constexpr int NT = HD / 8;       // 8-wide n tiles of O
  constexpr int SN = kTcRows / 8;  // 8-wide n tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [stages][kTcRows][ST]
  bf16* Vs = Ks + kTcStages * kTcRows * ST;
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
        out[(static_cast<size_t>(b) * h + head) * HD + d] = __float2bfloat16_rn(0.f);
      else if (d == 0)
        ws[((static_cast<size_t>(b) * h + head) * splits + split) * (HD + 2) + 1] = 0.f;
    }
    return;
  }
  const int npages = (pos_end - pos0 + ps - 1) / ps;
  const int* trow = tables + static_cast<size_t>(b) * npp + split * pps;
  for (int i = lane; i < npages; i += 32) pid_s[i] = trow[i];
  __syncwarp();

  const bf16* kb = kp + g * kpool.sh;
  const bf16* vb = vp + g * vpool.sh;
  auto load_tile = [&](int t, int stage) {
    bf16* kd = Ks + stage * kTcRows * ST;
    bf16* vd = Vs + stage * kTcRows * ST;
#pragma unroll
    for (int e = lane; e < kTcRows * CPR; e += 32) {
      const int r = e / CPR, ch = e % CPR, lp = t * kTcRows + r;
      const bool ok = pos0 + lp < pos_end;
      const bf16* ksrc = kp;
      const bf16* vsrc = vp;
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
  const bf16* q0r = q + b * q_sb + static_cast<long long>(h0 + r4) * q_sh;
  const bf16* q1r = q + b * q_sb + static_cast<long long>(h0 + r4 + 8) * q_sh;
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
        mma_bf16(s[2 * jp], qf[kk], bb[0], bb[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], bb[2], bb[3]);
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
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int kk = 0; kk < SN / 2; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vbase + (kk * 16 * ST + np * 16) * 2);
        mma_bf16(acc[2 * np], pa[kk], bb[0], bb[1]);
        mma_bf16(acc[2 * np + 1], pa[kk], bb[2], bb[3]);
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
      const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<uint32_t*>(out + bh * HD + n * 8 + c4) =
            pack_bf16(acc[n][2 * half] * inv, acc[n][2 * half + 1] * inv);
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

template <int HD>
int tc_smem_set[mz::kDevices] = {};

// merges the splits' partials of one (slot, query head) in a fixed order:
// the max over the splits (a fixed tree), each split's weight exp2(m - max)
// (0 for an empty split, l = 0), then per d the weighted sums in split order
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
paged_combine_kernel(const float* __restrict__ ws, T* __restrict__ out, int hd,
                     int splits) {
  extern __shared__ float w_s[];     // [2][splits]: weight, weight * l
  __shared__ float red[kCombineThreads];
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
      if (l[u] > 0.f) mx = fmaxf(mx, m[u]);
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
    const float f = l > 0.f ? exp2f(wp[s * (hd + 2)] - mx) : 0.f;
    w_s[s] = f;
    w_s[splits + s] = f * l;
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
        if (s0 + u < splits && w_s[s0 + u] > 0.f) a = fmaf(w_s[s0 + u], x[u], a);
    }
    out[bh * hd + d] = mz::from_f<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int LN, int GM, int NC>
int split_smem_set[mz::kDevices] = {};

template <typename T, int LN, int GM, int NC>
cudaError_t launch_split(dim3 grid, const T* q, const T* kp, const T* vp,
                         const int* tables, const int* lengths, T* out, float* ws,
                         int h, int hkv, int hd, int ps, int npp, int pps, int heads,
                         int hchunks, long long q_sb, long long q_sh, Pool kpool,
                         Pool vpool, float scale_log2, int vec, cudaStream_t st) {
  auto kern = paged_split_kernel<T, LN, GM, NC>;
  constexpr int smem = split_smem_bytes<T, LN, GM, NC>();
  cudaError_t e = mz::opt_in(kern, split_smem_set<T, LN, GM, NC>, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, st>>>(q, kp, vp, tables, lengths, out, ws, h, hkv, hd,
                                     ps, npp, pps, heads, hchunks, q_sb, q_sh, kpool,
                                     vpool, scale_log2, vec);
  return cudaGetLastError();
}

// hd <= 256: one 8-value chunk a lane, `gm` heads a block; hd > 256: 32
// lanes, `nc` chunks a lane, one head a block
template <typename T, int LN>
cudaError_t launch_ln(dim3 grid, int gm, int nc, const T* q, const T* kp, const T* vp,
                      const int* tables, const int* lengths, T* out, float* ws,
                      int h, int hkv, int hd, int ps, int npp, int pps,
                      int heads, int hchunks, long long q_sb, long long q_sh,
                      Pool kpool, Pool vpool, float scale_log2, int vec, cudaStream_t st) {
#define MZ_PD(GMV, NCV) return launch_split<T, LN, GMV, NCV>(                    \
      grid, q, kp, vp, tables, lengths, out, ws, h, hkv, hd, ps, npp, pps, heads, \
      hchunks, q_sb, q_sh, kpool, vpool, scale_log2, vec, st)
  if (nc == 1) {
    if (gm == 1) MZ_PD(1, 1);
    if (gm == 2) MZ_PD(2, 1);
    if (gm == 4) MZ_PD(4, 1);
    if (gm == 8) MZ_PD(8, 1);
  } else if constexpr (LN == 32) {
    if (gm == 1 && nc == 2) MZ_PD(1, 2);
    if (gm == 1 && nc == 3) MZ_PD(1, 3);
    if (gm == 1 && nc == 4) MZ_PD(1, 4);
  }
#undef MZ_PD
  return cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_tc(dim3 grid, const bf16* q, const bf16* kp, const bf16* vp,
                      const int* tables, const int* lengths, bf16* out, float* ws,
                      int h, int hkv, int ps, int npp, int pps, int heads,
                      int hchunks, long long q_sb, long long q_sh, Pool kpool,
                      Pool vpool, float scale_log2, cudaStream_t st) {
  const int smem = tc_smem_bytes(HD);
  cudaError_t e = mz::opt_in(paged_tc_kernel<HD>, tc_smem_set<HD>, smem);
  if (e != cudaSuccess) return e;
  const int ps_shift = (ps & (ps - 1)) == 0 ? __builtin_ctz(ps) : -1;
  paged_tc_kernel<HD><<<grid, 32, smem, st>>>(q, kp, vp, tables, lengths, out, ws,
                                               h, hkv, ps, ps_shift, npp, pps, heads,
                                               hchunks, q_sb, q_sh, kpool, vpool,
                                               scale_log2);
  return cudaGetLastError();
}

// the tensor-core route: bfloat16, hd in {32, 48, ..., 128}, 16-byte rows
// (kernels/_attn_plan.py: paged_plan's route "tc")
bool tc_route(int dtype, int hd, bool vec) {
  return dtype == 1 && vec && hd % 16 == 0 && hd >= 32 && hd <= 128;
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* tables, const int* lengths, void* out, void* ws,
                   int b, int h, int hkv, int hd, int ps, int npp, int pps,
                   int splits, int heads, int hchunks, long long q_sb,
                   long long q_sh, Pool kpool, Pool vpool, float scale_log2,
                   int vec, cudaStream_t st) {
  const dim3 grid(b * hkv * hchunks, splits);
  T* op = static_cast<T*>(out);
  float* wsp = static_cast<float*>(ws);
  cudaError_t e;
  if constexpr (sizeof(T) == 2) {
    if (tc_route(1, hd, vec)) {
      const bf16* qp = static_cast<const bf16*>(q);
      const bf16* kpp = static_cast<const bf16*>(kp);
      const bf16* vpp = static_cast<const bf16*>(vp);
#define MZ_TC(HDV) e = launch_tc<HDV>(grid, qp, kpp, vpp, tables, lengths, op, wsp, h, \
      hkv, ps, npp, pps, heads, hchunks, q_sb, q_sh, kpool, vpool, scale_log2, st)
      switch (hd) {
        case 32: MZ_TC(32); break;
        case 48: MZ_TC(48); break;
        case 64: MZ_TC(64); break;
        case 80: MZ_TC(80); break;
        case 96: MZ_TC(96); break;
        case 112: MZ_TC(112); break;
        default: MZ_TC(128); break;
      }
#undef MZ_TC
      if (e != cudaSuccess || splits == 1) return e;
      paged_combine_kernel<T><<<b * h, kCombineThreads, 2 * splits * sizeof(float), st>>>(
          wsp, op, hd, splits);
      return cudaGetLastError();
    }
  }
  int gm = 1;
  while (gm < heads) gm *= 2;
  int ln = 4;
  while (ln * 8 < hd && ln < 32) ln *= 2;
  const int nc = (hd + 8 * ln - 1) / (8 * ln);
  const T* qp = static_cast<const T*>(q);
  const T* kpp = static_cast<const T*>(kp);
  const T* vpp = static_cast<const T*>(vp);
#define MZ_LN(LNV) e = launch_ln<T, LNV>(grid, gm, nc, qp, kpp, vpp, tables, lengths, \
      op, wsp, h, hkv, hd, ps, npp, pps, heads, hchunks, q_sb, q_sh, kpool,          \
      vpool, scale_log2, vec, st)
  if (ln == 4) MZ_LN(4);
  else if (ln == 8) MZ_LN(8);
  else if (ln == 16) MZ_LN(16);
  else MZ_LN(32);
#undef MZ_LN
  if (e != cudaSuccess || splits == 1) return e;
  paged_combine_kernel<T><<<b * h, kCombineThreads, 2 * splits * sizeof(float), st>>>(
      wsp, op, hd, splits);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// q: (b, h, hd) with strides q_sb, q_sh (unit stride on hd); k/v pools:
// one layer's (P, ps, hkv, hd) with strides (page, offset, head), unit
// stride on hd; tables: (b, npp) int32 contiguous; lengths: (b,) int32;
// out: (b, h, hd) contiguous; ws: b*h*splits*(hd+2) float32 when splits >
// 1.  Any hd up to 1024.  The plan (pps pages a split, splits, heads a
// block, hchunks head chunks a kv head) is kernels/_attn_plan.py's
// paged_plan; its route is "tc" where tc_route holds with the pools' rows
// on 16-byte steps (vec).  scale_log2 = log2(e) / sqrt(hd).
extern "C" int paged_decode(const void* q, const void* kp, const void* vp,
                            const void* tables, const void* lengths, void* out,
                            void* ws, int b, int h, int hkv, int hd, int ps,
                            int npp, int pps, int splits, int heads, int hchunks,
                            long long q_sb, long long q_sh, long long k_sp,
                            long long k_so, long long k_sh, long long v_sp,
                            long long v_so, long long v_sh, float scale_log2,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int epc = dtype == 1 ? 8 : 4;   // elements a 16-byte row copy
  const int vec = hd % epc == 0 && aligned16(kp) && aligned16(vp) && k_sp % epc == 0 &&
                  k_so % epc == 0 && k_sh % epc == 0 && v_sp % epc == 0 &&
                  v_so % epc == 0 && v_sh % epc == 0;
  const int max_heads = tc_route(dtype, hd, vec) ? kTcMaxHeads : hd > 256 ? 1 : kMaxHeads;
  if (b < 1 || hkv < 1 || h % hkv || ps < 1 || npp < 1 || hd < 1 || hd > kMaxHd ||
      pps < 1 || pps > kMaxPages || splits != (npp + pps - 1) / pps ||
      heads < 1 || heads > max_heads || hchunks < 1 ||
      hchunks * heads < h / hkv || (hchunks - 1) * heads >= h / hkv ||
      splits > 4096 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* tp = static_cast<const int*>(tables);
  const int* lp = static_cast<const int*>(lengths);
  const Pool kpool{k_sp, k_so, k_sh}, vpool{v_sp, v_so, v_sh};
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(q, kp, vp, tp, lp, out, ws, b, h, hkv, hd, ps, npp, pps,
                      splits, heads, hchunks, q_sb, q_sh, kpool, vpool,
                      scale_log2, vec, st);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(q, kp, vp, tp, lp, out, ws, b, h, hkv, hd, ps,
                              npp, pps, splits, heads, hchunks, q_sb, q_sh,
                              kpool, vpool, scale_log2, vec, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

MZ_ERROR_STRING(paged_decode)
