// Flash-attention forward pass for Hopper (sm_90a): kernel K7.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py flash_attention_pallas (body
//   _flash_kernel) -> flash_attention
// and computes what it computes: for every (batch b, head h, query i)
//   s_ij = <q_i, k_j> / sqrt(d) over the keys j of kv head h / (H / K),
//   masked to NEG_INF = -1e30 (finite, never -inf) unless j < Sk and, with
//   rel = i - (j + k_offset), if causal, rel >= 0 and, if window > 0,
//   rel < window: query positions count from 0 and key j sits at position
//   j + k_offset (k_offset >= 0, 0 but for kv-SP, where a rank holds the
//   keys of one block of the sequence; not right-aligned when Sq != Sk);
//   an online softmax over key tiles with an fp32 running max m, sum l and
//   accumulator; out = acc / max(l, 1e-30) in q's dtype; and, where the
//   caller passes a buffer for it, each row's fp32 log-sum-exp of its
//   scaled scores, (B, H, Sq), which the backward K7b (flash_bwd.cu)
//   recomputes the softmax from and kv-SP merges the ranks' blocks by.
//   Without the buffer the sm_80-unit designs add one null test per row
//   at the end; the Hopper design takes it as a template argument, so its
//   launches without it run the code they ran before the output existed,
//   and the key offset likewise (ProblemOff): a launch at offset 0 runs
//   the kernels it ran before the offset existed.
// Key tiles that no query of the CTA's tile can see (causal or window) are
// skipped whole, as the Pallas kernel skips its grid steps; a CTA may see
// none (a kv-SP rank's later keys under the causal mask). A row that sees
// no key at all (its running max still the mask value) writes out 0 and
// lse NEG_INF: both finite, and a weight of exactly 0 in kv-SP's merge.
//
// Layout: q (B, Sq, H, d), k and v (B, Sk, K, d), out (B, Sq, H, d), read
// and written where they lie through their batch, sequence and head
// strides (in elements; the d stride is 1; the others multiples of 8, the
// pointers 16-byte aligned, so a K or V row is whole 16-byte copies and a
// TMA stride a multiple of 16 bytes). No transposed copy is made, and d
// is not padded to 128 lanes as on the TPU.
//
// What bounds it on an H100: operations, at the shapes that matter. The
// two products take 4 * Sq * Sk * d flops per head (about half that under
// the causal mask) against (q + k + v + out) bytes read or written once:
// at (1, 4096, 32, 4, 64) bf16 causal, 6.87e10 flops (0.069 ms at 989
// TFLOP/s bf16) against 37.7 MB (0.011 ms at 3.35 TB/s). At d = 64 the
// softmax is a second floor of about the same size: 2.7e8 exp2 at 16 MUFU
// results per clock per SM is ~0.065 ms, so a design that does not overlap
// one tile's exponentials with another tile's products stays above ~0.13.
// Three designs, chosen by dtype and d alone:
//   * bf16 at d = 64 and 128, `flash_wgmma` (Hopper units): one CTA of
//     three warpgroups per (128-query tile, head, batch). Warpgroup 0 is
//     the producer: it gives up registers (setmaxnreg), and one of its
//     threads brings the Q tile and a 4-stage ring of K/V tiles (128 keys
//     at d = 64, 64 at d = 128) into shared memory by TMA
//     (cp.async.bulk.tensor over a (B, S, heads, d) tensor map per input,
//     encoded on the host through the strides, 128-byte swizzle; the rows
//     past Sq / Sk are the TMA's zero fill), with a full and an empty
//     mbarrier per stage. Warpgroups 1 and 2 each own 64 query rows. Each
//     issues S_t = Q K_t^T on wgmma (Q and K from shared memory, K-major),
//     then O += P_{t-1} V_{t-1} on wgmma m64n64k16 with P from registers
//     (bf16) and V from shared memory as an MN-major B, runs the online
//     softmax of S_t, and releases the stage of t - 1. The two warpgroups
//     take turns to issue their products (ping-pong on named barriers), so
//     one's softmax runs under the other's products, and the next tiles'
//     copies run under both. The tiles that need the per-element mask are
//     walked by loops of their own. The q tiles with the most key tiles
//     start first (the grid's slowest axis is the q tile, reversed under
//     the causal mask). What still bounds it: ptxas waits for P_{t-1}
//     V_{t-1} before the exponentials of S_t (it places the wgmma wait
//     early), so within a warpgroup the softmax overlaps only the copies.
//   * bf16 at the other head sizes (16 ... 112), `flash_bf16` (sm_80
//     units): one CTA of 4 warps per 64-query tile; each warp owns 16 rows,
//     keeps its Q tile as mma.sync A fragments, stages each 64-key K/V tile
//     by cp.async (16-byte copies, all in flight at once, rows padded by 8
//     elements against bank conflicts), runs mma.sync m16n8k16 and reads
//     V's fragments by transposed ldmatrix.
//   * fp32 stays IEEE fp32 (no TF32), `flash_f32`: one CTA of 4 warps per
//     16-query tile; a lane owns one key of each 32-key tile for the scores
//     and d / 32 output columns for the accumulator, plain fmaf throughout.
// The bf16 designs share their arithmetic: scores scaled by log2(e) /
// sqrt(d) and exponentiated in base 2 (the same softmax; flash_bf16 with
// exp2f, flash_wgmma with the MUFU's ex2 flushing results below 2^-126 to
// zero, the same value wherever it is larger, and, in tiles without a
// mask, the scale folded into the exponent's fma), the per-element mask
// only in tiles that are not wholly visible, P rounded to bf16 for the
// second product, m, l and the accumulator in fp32 registers. No atomics
// and a fixed order of every sum: repeat launches are bit-identical.
// Not done yet (later work): the overlap of a warpgroup's exponentials
// with its own P V product, a persistent grid, a TMA store of the output,
// fp8.
// Each launcher returns cudaGetLastError(); the Python wrapper raises if it
// is not 0. Launches go to the caller's stream and do not synchronise.

#include "hopper.cuh"

namespace {

using namespace flash;

struct Problem {
  int Sq, Sk, H, rep, causal, window;
  float scale;                       // 1 / sqrt(d)
  float scale_log2;                  // log2(e) / sqrt(d) (bf16 path)
  Strides q, k, v, o;
  static constexpr bool kLse = false;
  static constexpr bool kOff = false;
};

// The Hopper design's problem when it writes the log-sum-exp. A type of its
// own: the launches without it keep Problem's layout as their parameter
// (one more field in it cost those launches 4-5% on the card, PERF.md §6).
struct ProblemLse : Problem {
  float* lse;                        // (B, H, Sq) fp32
  static constexpr bool kLse = true;
};

// A problem whose key j sits at position j + k_offset (kv-SP), with the
// log-sum-exp (the merge needs it): a type of its own for the same reason,
// so that every launch at offset 0 keeps its parameter and its code.
struct ProblemOff : ProblemLse {
  int k_offset;                      // > 0
  static constexpr bool kOff = true;
};

// The position of key 0: 0 unless the problem carries an offset.
template <class P>
__device__ __forceinline__ int key_offset(const P& p) {
  if constexpr (P::kOff) {
    return p.k_offset;
  } else {
    return 0;
  }
}

// The row's log-sum-exp of its scaled scores, ln sum_j exp(s_ij), from the
// running max m and sum l of an online softmax kept in log2 units (the
// bf16 designs): (m + log2 l) ln 2. K7b recomputes P from it.
__device__ __forceinline__ float lse_of_log2(float m, float l) {
  return (m + log2f(fmaxf(l, 1e-30f))) * 0.6931471805599453f;
}

// Some query row of [q0, q0 + bq) sees some key of [k0, k0 + bk) (key
// indices; their positions start at k0 + the offset).
template <class P>
__device__ __forceinline__ bool visible_tile(const P& p, int q0, int bq,
                                             int k0, int bk) {
  const int kp = k0 + key_offset(p);
  bool vis = true;
  if (p.causal) vis = q0 + bq - 1 >= kp;
  if (p.window > 0) vis = vis && (kp + bk - 1 > q0 - p.window);
  return vis;
}

// Every query row of [q0, q0 + bq) sees every key of [k0, k0 + bk): the
// tile needs no per-element mask.
template <class P>
__device__ __forceinline__ bool whole_tile(const P& p, int q0, int bq,
                                           int k0, int bk) {
  const int kp = k0 + key_offset(p);
  return k0 + bk <= p.Sk && (!p.causal || kp + bk - 1 <= q0) &&
         (p.window <= 0 || q0 + bq - 1 - kp < p.window);
}

template <class P>
__device__ __forceinline__ bool visible(const P& p, int qi, int kj) {
  const int rel = qi - (kj + key_offset(p));
  bool m = kj < p.Sk;
  if (p.causal) m = m && rel >= 0;
  if (p.window > 0) m = m && rel < p.window;
  return m;
}

// A row whose running max is still the mask value saw no key.
__device__ __forceinline__ bool saw_none(float m) { return m == kNegInf; }

// ---------------------------------------------------------------- bf16 --

constexpr int kBQ = 64;              // query rows per CTA (16 per warp)
constexpr int kBK = 64;              // keys per tile
constexpr int kThreads = 128;

// (mma m16n8k16 fragment layouts: flash.cuh)
template <int D, class P>
__global__ void __launch_bounds__(kThreads)
flash_bf16(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           __nv_bfloat16* __restrict__ o, P p,
           float* __restrict__ lse) {
  constexpr int kLd = D + 8;                 // padded smem row (elements)
  constexpr int kNT = kBK / 8;               // 8-key column tiles of S
  constexpr int kKD = D / 16;                // 16-deep steps over d
  constexpr int kDT = D / 8;                 // 8-wide column tiles of O
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK * kLd];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kh = h / p.rep;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_a = q0 + warp * 16 + g;      // rows of c0, c1 / c2, c3
  const int row_b = row_a + 8;

  const __nv_bfloat16* qb = q + b * p.q.b + (long long)h * p.q.h;
  const __nv_bfloat16* kb = k + b * p.k.b + (long long)kh * p.k.h;
  const __nv_bfloat16* vb = v + b * p.v.b + (long long)kh * p.v.h;

  // Q tile as A fragments (rows past Sq are zero and never stored)
  uint32_t qf[kKD][4];
#pragma unroll
  for (int kk = 0; kk < kKD; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = (r & 1) ? row_b : row_a;
      const int col = kk * 16 + 2 * t + ((r & 2) ? 8 : 0);
      qf[kk][r] = row < p.Sq
          ? *reinterpret_cast<const uint32_t*>(qb + row * p.q.s + col)
          : 0u;
    }
  }

  float acc[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float m_a = kNegInf, m_b = kNegInf;        // running max of rows a / b
  float l_a = 0.f, l_b = 0.f;                // this thread's share of l

  const int n_tiles = (p.Sk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    if (!visible_tile(p, q0, kBQ, k0, kBK)) continue;   // uniform per CTA
    // stage the K and V tiles, 8 elements per asynchronous 16-byte copy,
    // all of a thread's copies in flight at once; rows past Sk zero-filled
#pragma unroll
    for (int i = 0; i < kBK * D / 8 / kThreads; ++i) {
      const int w = threadIdx.x + i * kThreads;
      const int r = w / (D / 8);
      const int c = (w - r * (D / 8)) * 8;
      const bool in = k0 + r < p.Sk;
      const long long row = in ? k0 + r : 0;
      cp_async16(ks + r * kLd + c, kb + row * p.k.s + c, in);
      cp_async16(vs + r * kLd + c, vb + row * p.v.s + c, in);
    }
    cp_async_wait();
    __syncthreads();

    // S = Q K^T (B[k = d][n = key] = K[key][d]: two adjacent d of a K row)
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
      const __nv_bfloat16* krow = ks + (nt * 8 + g) * kLd + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(s[nt], qf[kk], b0, b1);
      }
    }

    // scale (in log2 units: the softmax is the same with exp2 of
    // log2(e) * s), mask where the tile is not wholly visible, online
    // softmax (rows a: s[.][0..1], rows b: s[.][2..3])
    const bool masked = !whole_tile(p, q0, kBQ, k0, kBK);
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[nt][j] *= p.scale_log2;
        if (masked) {
          const int row = j < 2 ? row_a : row_b;
          const int col = k0 + nt * 8 + 2 * t + (j & 1);
          if (!visible(p, row, col)) s[nt][j] = kNegInf;
        }
      }
      mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn_a);
      s[nt][1] = exp2f(s[nt][1] - mn_a);
      s[nt][2] = exp2f(s[nt][2] - mn_b);
      s[nt][3] = exp2f(s[nt][3] - mn_b);
      sum_a += s[nt][0] + s[nt][1];
      sum_b += s[nt][2] + s[nt][3];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      acc[dt][0] *= corr_a;
      acc[dt][1] *= corr_a;
      acc[dt][2] *= corr_b;
      acc[dt][3] *= corr_b;
    }

    // O += P V: P's C fragments of two adjacent key tiles are the A
    // fragment of one 16-key step; B[k = key][n = d] = V[key][d], two
    // 8-wide d tiles per transposed ldmatrix: matrix i of lane L covers keys
    // 16 kk + 8 (i & 1) + L % 8 and d 8 (dt + (i >> 1)) onwards
    const int v_key = ((lane >> 3) & 1) * 8 + (lane & 7);
    const int v_col = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vrow = vs + (kk * 16 + v_key) * kLd + v_col;
#pragma unroll
      for (int dt = 0; dt < kDT; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + dt * 8);
        mma_bf16(acc[dt], pa, b[0], b[1]);
        mma_bf16(acc[dt + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();                          // before the next tile lands
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = saw_none(m_a) ? 0.f : 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = saw_none(m_b) ? 0.f : 1.f / fmaxf(l_b, 1e-30f);
  if (lse != nullptr && t == 0) {
    float* lb = lse + (b * p.H + h) * (long long)p.Sq;
    if (row_a < p.Sq)
      lb[row_a] = saw_none(m_a) ? kNegInf : lse_of_log2(m_a, l_a);
    if (row_b < p.Sq)
      lb[row_b] = saw_none(m_b) ? kNegInf : lse_of_log2(m_b, l_b);
  }
  __nv_bfloat16* ob = o + b * p.o.b + (long long)h * p.o.h;
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row_a < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + row_a * p.o.s + col) =
          pack_bf16(acc[dt][0] * inv_a, acc[dt][1] * inv_a);
    if (row_b < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + row_b * p.o.s + col) =
          pack_bf16(acc[dt][2] * inv_b, acc[dt][3] * inv_b);
  }
}

// ---------------------------------------------------------------- fp32 --

constexpr int kFBQ = 16;             // query rows per CTA (4 per warp)
constexpr int kFBK = 32;             // keys per tile (one per lane)

template <int D, class P>
__global__ void __launch_bounds__(kThreads)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, P p,
          float* __restrict__ lse) {
  constexpr int kCols = (D + 31) / 32;       // output columns per lane
  constexpr int kRows = kFBQ / (kThreads / 32);
  __shared__ float qs[kFBQ][D];
  __shared__ float ks[kFBK][D + 1];          // +1: lane j reads row j
  __shared__ float vs[kFBK][D];

  const int q0 = blockIdx.x * kFBQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kh = h / p.rep;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* qb = q + b * p.q.b + (long long)h * p.q.h;
  const float* kb = k + b * p.k.b + (long long)kh * p.k.h;
  const float* vb = v + b * p.v.b + (long long)kh * p.v.h;

  for (int w = threadIdx.x; w < kFBQ * D; w += kThreads) {
    const int r = w / D, c = w - (w / D) * D;
    qs[r][c] = q0 + r < p.Sq ? qb[(long long)(q0 + r) * p.q.s + c] : 0.f;
  }
  float acc[kRows][kCols];
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int n_tiles = (p.Sk + kFBK - 1) / kFBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kFBK;
    if (!visible_tile(p, q0, kFBQ, k0, kFBK)) continue;
    __syncthreads();                          // previous tile consumed
    for (int w = threadIdx.x; w < kFBK * D; w += kThreads) {
      const int r = w / D, c = w - (w / D) * D;
      const bool in = k0 + r < p.Sk;
      ks[r][c] = in ? kb[(long long)(k0 + r) * p.k.s + c] : 0.f;
      vs[r][c] = in ? vb[(long long)(k0 + r) * p.v.s + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qr = warp * kRows + r;
      float dot = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) dot = fmaf(qs[qr][c], ks[lane][c], dot);
      const float sc = visible(p, q0 + qr, k0 + lane) ? dot * p.scale
                                                      : kNegInf;
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[r], mx);
      const float corr = expf(m[r] - mn);
      const float pj = expf(sc - mn);
      float sum = pj;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      m[r] = mn;
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        float pv = 0.f;
#pragma unroll 8
        for (int j = 0; j < kFBK; ++j) {
          const float pjj = __shfl_sync(0xffffffffu, pj, j);
          if (col < D) pv = fmaf(pjj, vs[j][col], pv);
        }
        acc[r][c] = acc[r][c] * corr + pv;
      }
    }
  }

  float* ob = o + b * p.o.b + (long long)h * p.o.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= p.Sq) continue;
    const bool none = saw_none(m[r]);
    const float inv = none ? 0.f : 1.f / fmaxf(l[r], 1e-30f);
    if (lse != nullptr && lane == 0)
      lse[(b * p.H + h) * (long long)p.Sq + row] =
          none ? kNegInf : m[r] + logf(fmaxf(l[r], 1e-30f));
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) ob[(long long)row * p.o.s + col] = acc[r][c] * inv;
    }
  }
}

// ------------------------------------------------- bf16, d 64 / 128, sm_90a --

namespace hopper {

constexpr int kRows = 64;            // query rows per consumer warpgroup
constexpr int kBQ = 2 * kRows;       // query rows per CTA
constexpr int kThreads = 384;        // producer + two consumer warpgroups
constexpr int kRowBytes = 128;       // one swizzled smem row: 64 bf16
constexpr int kStages = 4;           // K/V tiles in the ring

// The tile shapes of head size D, and the shared memory of one CTA (byte
// offsets from a 1024-aligned base, as the 128-byte swizzle needs). A tile
// of R rows x D columns is D / 64 panels of R rows x 128 bytes, each
// written by one TMA box. Key tiles are 128 keys at d = 64 and 64 at
// d = 128, so that a warpgroup's scores, P and O (64 + 32 + 32 or 32 + 16
// + 64 registers) stay in registers while two products are in flight.
template <int D>
struct Smem {
  static constexpr int kBK = D == 64 ? 128 : 64;             // keys per tile
  static constexpr int kPanels = D / 64;
  static constexpr int kQTile = kPanels * kRows * kRowBytes;   // one wg's Q
  static constexpr int kKVTile = kPanels * kBK * kRowBytes;    // K or V
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + 2 * kQTile;
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kBar = kV + kStages * kKVTile;  // full, empty, q
  static constexpr int kAlloc = kBar + (2 * kStages + 1) * 8 + 1024;
};

// S = Q K^T for one tile of BK keys: 16-deep steps over d, 32 bytes apart
// inside a panel row (issued and committed, not waited for).
template <int D, int BK>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t qs,
                                        uint32_t ks) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da =
        sw128_desc(qs + (kk >> 2) * kRows * kRowBytes + (kk & 3) * 32);
    const uint64_t db =
        sw128_desc(ks + (kk >> 2) * BK * kRowBytes + (kk & 3) * 32);
    if constexpr (BK == 128) {
      wgmma_ss_n128(s, da, db, kk > 0);
    } else {
      wgmma_ss_n64(s, da, db, kk > 0);
    }
  }
  wgmma_commit();
}

// O = O * corr + P V over the V tile at `vs`: the kk-th 16-key step of V
// starts 16 rows (2048 bytes) into each panel (issued and committed, not
// waited for).
template <int NP, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[NP][32],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t vs, float corr_a,
                                         float corr_b) {
#pragma unroll
  for (int pn = 0; pn < NP; ++pn) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[pn][4 * n] *= corr_a;
      acc[pn][4 * n + 1] *= corr_a;
      acc[pn][4 * n + 2] *= corr_b;
      acc[pn][4 * n + 3] *= corr_b;
    }
    fence_regs(acc[pn]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
      wgmma_rs_n64(acc[pn], pa[kk],
                   sw128_desc(vs + pn * BK * kRowBytes + kk * 16 * kRowBytes));
  wgmma_commit();
}

// The state of one consumer warpgroup: O, the running max and sum of its
// two rows per thread, the scores of the current tile and P of the
// previous one, and its place in the ring.
template <int D>
struct Consumer {
  using L = Smem<D>;
  static constexpr int BK = L::kBK;
  float acc[L::kPanels][32];
  float s[BK / 2];                   // scores, then P (fp32)
  uint32_t pa[BK / 16][4];           // P of the previous tile (bf16)
  float m_a, m_b, l_a, l_b;          // rows a: s[4n + 0, 1]; b: s[4n + 2, 3]
  float corr_a, corr_b;              // O's rescale before P_prev V_prev
  int stage, prev;
  uint32_t phase;
  uint32_t base, full, empty, qs;
  int lane, t, row_a, row_b, cw;

  // The online softmax of s in place (s becomes P in fp32) in log2 units,
  // masked per element if kMasked (the scale applied first, masked scores
  // set to the finite -1e30), else with the scale in the exponent's fma;
  // updates m and l and returns in c_a, c_b the factors O must be scaled
  // by before this tile's P V. No branch depends on the data: a wgmma may
  // be in flight.
  template <bool kMasked, class P>
  __device__ __forceinline__ void softmax(const P& p, int k0,
                                          float& c_a, float& c_b) {
    const float scale = p.scale_log2;
    if constexpr (kMasked) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + n * 8 + 2 * t + (j & 1);
          s[4 * n + j] = visible(p, j < 2 ? row_a : row_b, col)
                             ? s[4 * n + j] * scale
                             : kNegInf;
        }
    }
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * n], s[4 * n + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    // unmasked, s is still unscaled: max(s * c) = max(s) * c for c > 0,
    // and the scale goes into the exponent's fma
    const float sc = kMasked ? 1.f : scale;
    const float mn_a = fmaxf(m_a, mx_a * sc), mn_b = fmaxf(m_b, mx_b * sc);
    c_a = exp2_ftz(m_a - mn_a);
    c_b = exp2_ftz(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[4 * n] = exp2_ftz(fmaf(s[4 * n], sc, -mn_a));
      s[4 * n + 1] = exp2_ftz(fmaf(s[4 * n + 1], sc, -mn_a));
      s[4 * n + 2] = exp2_ftz(fmaf(s[4 * n + 2], sc, -mn_b));
      s[4 * n + 3] = exp2_ftz(fmaf(s[4 * n + 3], sc, -mn_b));
      sum_a += s[4 * n] + s[4 * n + 1];
      sum_b += s[4 * n + 2] + s[4 * n + 3];
    }
    l_a = l_a * c_a + sum_a;
    l_b = l_b * c_b + sum_b;
  }

  // P rounded to bf16, as the A operand of the 16-key steps of P V.
  __device__ __forceinline__ void pack_p() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }

  // This warp is done with stage `st` (its products have completed).
  __device__ __forceinline__ void release(int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  __device__ __forceinline__ void advance() {
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // The first tile: S_0 and its softmax (nothing else in flight, so the
  // mask may be chosen at run time).
  template <class P>
  __device__ __forceinline__ void first(const P& p, int k0, bool masked) {
    mbar_wait(full + 8 * stage, phase);
    named_sync(1 + cw);
    issue_s<D, BK>(s, qs, base + L::kK + stage * L::kKVTile);
    named_arrive(2 - cw);
    wgmma_wait<0>();
    fence_regs(s);
    if (masked) {
      softmax<true>(p, k0, corr_a, corr_b);
    } else {
      softmax<false>(p, k0, corr_a, corr_b);
    }
    pack_p();
    advance();
  }

  // A later tile: S_t and P_{t-1} V_{t-1} in flight, the softmax of S_t
  // under the second product, then the stage of t - 1 released.
  template <bool kMasked, class P>
  __device__ __forceinline__ void next(const P& p, int k0) {
    mbar_wait(full + 8 * stage, phase);
    named_sync(1 + cw);
    issue_s<D, BK>(s, qs, base + L::kK + stage * L::kKVTile);
    issue_pv<L::kPanels, BK>(acc, pa, base + L::kV + prev * L::kKVTile,
                             corr_a, corr_b);
    named_arrive(2 - cw);
    wgmma_wait<1>();
    fence_regs(s);
    float c_a, c_b;
    softmax<kMasked, P>(p, k0, c_a, c_b);
    fence_regs(s);                   // P is computed before the wait below
    wgmma_wait<0>();
#pragma unroll
    for (int pn = 0; pn < L::kPanels; ++pn) fence_regs(acc[pn]);
    release(prev);
    pack_p();
    corr_a = c_a;
    corr_b = c_b;
    advance();
  }

  // The last tile's P V.
  __device__ __forceinline__ void last() {
    issue_pv<L::kPanels, BK>(acc, pa, base + L::kV + prev * L::kKVTile,
                             corr_a, corr_b);
    wgmma_wait<0>();
#pragma unroll
    for (int pn = 0; pn < L::kPanels; ++pn) fence_regs(acc[pn]);
    release(prev);
  }
};

// The producer: one thread brings Q, then the K/V tiles [lo, hi) into the
// ring, each stage once the consumers have released it.
template <int D>
__device__ __forceinline__ void produce(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const Problem& p, uint32_t base, uint32_t full, uint32_t empty,
    uint32_t qbar, int q0, int h, int b, int lo, int hi) {
  using L = Smem<D>;
  constexpr int BK = L::kBK;
  constexpr int kPanelQ = kRows * kRowBytes;        // bytes of a Q panel
  constexpr int kPanelKV = BK * kRowBytes;          // bytes of a K/V panel
  prefetch_map(&tq);
  prefetch_map(&tk);
  prefetch_map(&tv);
  const int kh = h / p.rep;
  mbar_expect_tx(qbar, 2 * L::kQTile);
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int pn = 0; pn < L::kPanels; ++pn)
      tma_load(base + L::kQ + w * L::kQTile + pn * kPanelQ, &tq, qbar,
               pn * 64, h, q0 + w * kRows, b);
  int stage = 0;
  uint32_t phase = 1;                  // the ring starts empty
  for (int kt = lo; kt < hi; ++kt) {
    mbar_wait(empty + 8 * stage, phase);
    const uint32_t bar = full + 8 * stage;
    mbar_expect_tx(bar, 2 * L::kKVTile);
#pragma unroll
    for (int pn = 0; pn < L::kPanels; ++pn) {
      tma_load(base + L::kK + stage * L::kKVTile + pn * kPanelKV, &tk, bar,
               pn * 64, kh, kt * BK, b);
      tma_load(base + L::kV + stage * L::kKVTile + pn * kPanelKV, &tv, bar,
               pn * 64, kh, kt * BK, b);
    }
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// A consumer warpgroup cw: query rows q0 + 64 cw ... + 63 over the key
// tiles [lo, hi), of which [ulo, uhi) need no mask; then O to memory, and
// with P::kLse each row's log-sum-exp.
template <int D, class P>
__device__ __forceinline__ void consume(const P& p,
                                        __nv_bfloat16* __restrict__ o,
                                        uint32_t base, uint32_t full,
                                        uint32_t empty, uint32_t qbar, int q0,
                                        int h, int b, int cw, int lo, int hi,
                                        int ulo, int uhi) {
  using L = Smem<D>;
  constexpr int BK = L::kBK;
  Consumer<D> c;
  c.cw = cw;
  const int tid = threadIdx.x & 127;
  c.lane = tid & 31;
  c.t = c.lane & 3;
  c.row_a = q0 + c.cw * kRows + (tid >> 5) * 16 + (c.lane >> 2);
  c.row_b = c.row_a + 8;
  c.base = base;
  c.full = full;
  c.empty = empty;
  c.qs = base + L::kQ + c.cw * L::kQTile;
#pragma unroll
  for (int pn = 0; pn < L::kPanels; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) c.acc[pn][i] = 0.f;
  c.m_a = c.m_b = kNegInf;
  c.l_a = c.l_b = 0.f;
  c.stage = 0;
  c.phase = 0;

  if (c.cw == 1) named_arrive(1);                  // warpgroup 0 goes first
  mbar_wait(qbar, 0);
  if (hi > lo) {
    c.first(p, lo * BK, lo < ulo || lo >= uhi);
    for (int kt = lo + 1; kt < ulo; ++kt) c.template next<true>(p, kt * BK);
    for (int kt = max(lo + 1, ulo); kt < uhi; ++kt)
      c.template next<false>(p, kt * BK);
    for (int kt = max(lo + 1, uhi); kt < hi; ++kt)
      c.template next<true>(p, kt * BK);
    c.last();
  }
  if (c.cw == 0) named_sync(1);                    // warpgroup 1's last turn

  float l_a = c.l_a, l_b = c.l_b;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = saw_none(c.m_a) ? 0.f : 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = saw_none(c.m_b) ? 0.f : 1.f / fmaxf(l_b, 1e-30f);
  if constexpr (P::kLse) {
    if (c.t == 0) {
      float* lb = p.lse + ((long long)b * p.H + h) * p.Sq;
      if (c.row_a < p.Sq)
        lb[c.row_a] = saw_none(c.m_a) ? kNegInf : lse_of_log2(c.m_a, l_a);
      if (c.row_b < p.Sq)
        lb[c.row_b] = saw_none(c.m_b) ? kNegInf : lse_of_log2(c.m_b, l_b);
    }
  }
  __nv_bfloat16* ob = o + (long long)b * p.o.b + (long long)h * p.o.h;
#pragma unroll
  for (int pn = 0; pn < L::kPanels; ++pn)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = pn * 64 + n * 8 + 2 * c.t;
      if (c.row_a < p.Sq)
        *reinterpret_cast<uint32_t*>(ob + c.row_a * p.o.s + col) =
            pack_bf16(c.acc[pn][4 * n] * inv_a, c.acc[pn][4 * n + 1] * inv_a);
      if (c.row_b < p.Sq)
        *reinterpret_cast<uint32_t*>(ob + c.row_b * p.o.s + col) =
            pack_bf16(c.acc[pn][4 * n + 2] * inv_b,
                      c.acc[pn][4 * n + 3] * inv_b);
    }
}

// Fragment layouts of wgmma m64nNk16 per warp w of the warpgroup (rows
// 16 w ...; g = lane / 4, t = lane % 4), as mma.sync m16n8k16's:
//   accumulator: d[4 n + 2 i + j] = D[16 w + g + 8 i][8 n + 2 t + j]
//   A in registers: a[0] = A[g][2t, 2t+1], a[1] = A[g+8][2t, 2t+1],
//     a[2] = A[g][2t+8, 2t+9], a[3] = A[g+8][2t+8, 2t+9]
// so the score accumulator of keys 16 kk ... 16 kk + 15, packed to bf16,
// is the A operand of the kk-th 16-key step of P V.
//
// Each consumer warpgroup runs a two-tile software pipeline: at tile t it
// issues S_t = Q K_t^T, then O = O * corr_{t-1} + P_{t-1} V_{t-1}, and
// runs the softmax of S_t while the second product is in flight; the
// stage of tile t - 1 is released when that product has completed. The
// order of the arithmetic on O is that of the plain loop (rescale, then
// add P V, tile after tile). The two warpgroups take turns to issue their
// products (named barriers 1 and 2, ping-pong), so one's softmax runs
// under the other's products. The tiles that need the per-element mask
// (the causal diagonal, a window's edge, the ragged end of Sk) are walked
// by loops of their own, so no branch on the mask sits where a product is
// in flight. P is Problem, ProblemLse to write the log-sum-exp, or
// ProblemOff for keys at an offset (types, so that the launches without
// them run the code and take the parameters they did before they existed).
// A CTA whose queries see no key tile (hi == lo) loads Q, runs no product
// and writes zeros: the producer's loop is empty, and the ping-pong's one
// arrival and one wait still pair.
template <int D, class P>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            __nv_bfloat16* __restrict__ o, P p) {
  using L = Smem<D>;
  constexpr int BK = L::kBK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + L::kBar;             // full[s]: + 8 s
  const uint32_t empty = full + 8 * kStages;        // empty[s]: + 8 s
  const uint32_t qbar = empty + 8 * kStages;

  const int nq = gridDim.z;
  const int q0 = (p.causal ? nq - 1 - (int)blockIdx.z : (int)blockIdx.z) * kBQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // the warpgroup, read from lane 0 so the compiler knows it is the same
  // across the warp (role branches and setmaxnreg need warp-uniform paths)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  // the CTA's run [lo, hi) of key tiles that some query of its tile can
  // see, and within it the run [ulo, uhi) that all of them see whole
  const int n_tiles = (p.Sk + BK - 1) / BK;
  int lo = 0;
  while (lo < n_tiles && !visible_tile(p, q0, kBQ, lo * BK, BK)) ++lo;
  int hi = lo;
  while (hi < n_tiles && visible_tile(p, q0, kBQ, hi * BK, BK)) ++hi;
  int ulo = lo;
  while (ulo < hi && !whole_tile(p, q0, kBQ, ulo * BK, BK)) ++ulo;
  int uhi = ulo;
  while (uhi < hi && whole_tile(p, q0, kBQ, uhi * BK, BK)) ++uhi;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);       // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0)
      produce<D>(tq, tk, tv, p, base, full, empty, qbar, q0, h, b, lo, hi);
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume<D, P>(p, o, base, full, empty, qbar, q0, h, b, wg - 1, lo, hi,
                  ulo, uhi);
  }
}

}  // namespace hopper


template <int D, class P>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int K, const P& p, cudaStream_t st) {
  using L = hopper::Smem<D>;
  const int nq = (p.Sq + hopper::kBQ - 1) / hopper::kBQ;
  CUtensorMap mq, mk, mv;
  if (nq > 65535 || B > 65535 ||
      !encode_map(&mq, q, D, p.H, p.Sq, B, p.q, hopper::kRows) ||
      !encode_map(&mk, k, D, K, p.Sk, B, p.k, L::kBK) ||
      !encode_map(&mv, v, D, K, p.Sk, B, p.v, L::kBK))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      hopper::flash_wgmma<D, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return (int)err;
  hopper::flash_wgmma<D, P><<<dim3(p.H, B, nq), hopper::kThreads,
                              L::kAlloc, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), p);
  return (int)cudaGetLastError();
}

template <int D, class P>
void launch_d(int dtype, const void* q, const void* k, const void* v, void* o,
              int B, const P& p, float* lse, cudaStream_t st) {
  if (dtype == 1) {
    const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, B);
    flash_bf16<D, P><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), p, lse);
  } else {
    const dim3 grid((p.Sq + kFBQ - 1) / kFBQ, p.H, B);
    flash_f32<D, P><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), p, lse);
  }
}

Problem make_problem(int Sq, int Sk, int H, int K, int d, long long qsb,
                     long long qss, long long qsh, long long ksb,
                     long long kss, long long ksh, long long vsb,
                     long long vss, long long vsh, long long osb,
                     long long oss, long long osh, int causal, int window) {
  Problem p;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.rep = H / K;
  p.causal = causal;
  p.window = window;
  p.scale = (float)(1.0 / sqrt((double)d));
  p.scale_log2 = (float)(1.4426950408889634 / sqrt((double)d));
  p.q = {qsb, qss, qsh};
  p.k = {ksb, kss, ksh};
  p.v = {vsb, vss, vsh};
  p.o = {osb, oss, osh};
  return p;
}

// `p` with keys at position j + k_offset (> 0) and the log-sum-exp buffer.
ProblemOff with_offset(const Problem& p, int k_offset, void* lse) {
  ProblemOff po;
  static_cast<Problem&>(po) = p;
  po.lse = static_cast<float*>(lse);
  po.k_offset = k_offset;
  return po;
}

template <class P>
int launch_all(int dtype, const void* q, const void* k, const void* v,
               void* o, int B, int d, const P& p, float* lse,
               cudaStream_t st) {
  switch (d) {
    case 16: launch_d<16>(dtype, q, k, v, o, B, p, lse, st); break;
    case 32: launch_d<32>(dtype, q, k, v, o, B, p, lse, st); break;
    case 48: launch_d<48>(dtype, q, k, v, o, B, p, lse, st); break;
    case 64: launch_d<64>(dtype, q, k, v, o, B, p, lse, st); break;
    case 80: launch_d<80>(dtype, q, k, v, o, B, p, lse, st); break;
    case 96: launch_d<96>(dtype, q, k, v, o, B, p, lse, st); break;
    case 112: launch_d<112>(dtype, q, k, v, o, B, p, lse, st); break;
    case 128: launch_d<128>(dtype, q, k, v, o, B, p, lse, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides in elements, (batch, seq, head)
// for each of q, k, v, out. k_offset >= 0: the position of key 0. lse: a
// (B, H, Sq) fp32 buffer for each row's log-sum-exp, or null (then nothing
// else changes). d in {16, 32, ..., 128}; H % K == 0. The sm_80-unit
// designs: flash_f32 (float32), flash_bf16 (bfloat16).
extern "C" int flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* o, int B,
    int Sq, int Sk, int H, int K, int d, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, int causal, int window, int k_offset,
    void* lse, void* stream) {
  const Problem p = make_problem(Sq, Sk, H, K, d, qsb, qss, qsh, ksb, kss,
                                 ksh, vsb, vss, vsh, osb, oss, osh, causal,
                                 window);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (k_offset < 0) return (int)cudaErrorInvalidValue;
  if (k_offset == 0) return launch_all(dtype, q, k, v, o, B, d, p, l, st);
  return launch_all(dtype, q, k, v, o, B, d, with_offset(p, k_offset, lse),
                    l, st);
}

// The Hopper design, flash_wgmma: bfloat16 (dtype 1) at d 64 or 128 only;
// the same arguments as flash_attention, but a nonzero k_offset needs the
// lse buffer.
extern "C" int flash_attention_wgmma(
    int dtype, const void* q, const void* k, const void* v, void* o, int B,
    int Sq, int Sk, int H, int K, int d, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, int causal, int window, int k_offset,
    void* lse, void* stream) {
  const Problem p = make_problem(Sq, Sk, H, K, d, qsb, qss, qsh, ksb, kss,
                                 ksh, vsb, vss, vsh, osb, oss, osh, causal,
                                 window);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1 || k_offset < 0 || (k_offset > 0 && lse == nullptr))
    return (int)cudaErrorInvalidValue;
  if (k_offset > 0) {
    const ProblemOff po = with_offset(p, k_offset, lse);
    if (d == 64) return launch_wgmma<64>(q, k, v, o, B, K, po, st);
    if (d == 128) return launch_wgmma<128>(q, k, v, o, B, K, po, st);
    return (int)cudaErrorInvalidValue;
  }
  ProblemLse pl;
  static_cast<Problem&>(pl) = p;
  pl.lse = static_cast<float*>(lse);
  if (d == 64)
    return lse ? launch_wgmma<64>(q, k, v, o, B, K, pl, st)
               : launch_wgmma<64>(q, k, v, o, B, K, p, st);
  if (d == 128)
    return lse ? launch_wgmma<128>(q, k, v, o, B, K, pl, st)
               : launch_wgmma<128>(q, k, v, o, B, K, p, st);
  return (int)cudaErrorInvalidValue;
}
