// Flash-attention forward pass for Hopper (sm_90a): kernel K7.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py flash_attention_pallas (body
//   _flash_kernel) -> flash_attention
// and computes what it computes: for every (batch b, head h, query i)
//   s_ij = <q_i, k_j> / sqrt(d) over the keys j of kv head h / (H / K),
//   masked to NEG_INF = -1e30 (finite, never -inf) unless j < Sk and, if
//   causal, i - j >= 0 and, if window > 0, i - j < window, with query and
//   key positions both counted from 0 (not right-aligned when Sq != Sk);
//   an online softmax over key tiles with an fp32 running max m, sum l and
//   accumulator; out = acc / max(l, 1e-30) in q's dtype.
// Key tiles that no query of the CTA's tile can see (causal or window) are
// skipped whole, as the Pallas kernel skips its grid steps. A row that sees
// no key at all gets the mean of V over the keys of its visible tiles, as
// the online softmax gives it there (finite; outside the contract).
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

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {                     // in elements; the d stride is 1
  long long b, s, h;
};

struct Problem {
  int Sq, Sk, H, rep, causal, window;
  float scale;                       // 1 / sqrt(d)
  float scale_log2;                  // log2(e) / sqrt(d) (bf16 path)
  Strides q, k, v, o;
};

__device__ __forceinline__ bool visible_tile(const Problem& p, int q0, int bq,
                                             int k0, int bk) {
  bool vis = true;
  if (p.causal) vis = q0 + bq - 1 >= k0;
  if (p.window > 0) vis = vis && (k0 + bk - 1 > q0 - p.window);
  return vis;
}

// Every query row of [q0, q0 + bq) sees every key of [k0, k0 + bk): the
// tile needs no per-element mask.
__device__ __forceinline__ bool whole_tile(const Problem& p, int q0, int bq,
                                           int k0, int bk) {
  return k0 + bk <= p.Sk && (!p.causal || k0 + bk - 1 <= q0) &&
         (p.window <= 0 || q0 + bq - 1 - k0 < p.window);
}

__device__ __forceinline__ bool visible(const Problem& p, int qi, int kj) {
  const int rel = qi - kj;
  bool m = kj < p.Sk;
  if (p.causal) m = m && rel >= 0;
  if (p.window > 0) m = m && rel < p.window;
  return m;
}

// ---------------------------------------------------------------- bf16 --

constexpr int kBQ = 64;              // query rows per CTA (16 per warp)
constexpr int kBK = 64;              // keys per tile
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// Asynchronous 16-byte copy global -> shared (both 16-byte aligned);
// `valid` false fills zeros (nothing is read). The thread's copies
// complete at cp_async_wait().
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 b16 matrices from shared memory, transposed: lane L names row
// L % 8 of matrix L / 8; register i receives matrix i's fragment
// (M[2t][g], M[2t+1][g]).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layouts of mma m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major): reg 0 = A[g][2t, 2t+1], reg 1 = A[g+8][2t, 2t+1],
//     reg 2 = A[g][2t+8, 2t+9], reg 3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, "col"): reg 0 = B[2t, 2t+1][g], reg 1 = B[2t+8, 2t+9][g]
//   C (16 x 8): c0, c1 = C[g][2t, 2t+1]; c2, c3 = C[g+8][2t, 2t+1]
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bf16(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           __nv_bfloat16* __restrict__ o, Problem p) {
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
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, Problem p) {
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
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
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

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}

// Wait until the phase of `bar` with parity `parity` has completed (the
// phase before the first one counts as completed). A wait that lasts 2^32
// clocks (~2 s) traps: a fault in the pipeline becomes a launch error, not
// a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// One TMA box (coordinates innermost first: d, head, row, batch) into
// shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset 16 (unused by these layouts), stride byte
// offset 1024 (from one 8-row group to the next), layout 1 = SWIZZLE_128B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Named barriers 1 and 2 over the two consumer warpgroups (256 threads):
// a warpgroup syncs on its own id and arrives on the other's.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// Keep the compiler from moving accesses to an accumulator register across
// the asynchronous wgmma that writes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define ACC8(r, i)                                                         \
  "+f"(r[i + 0]), "+f"(r[i + 1]), "+f"(r[i + 2]), "+f"(r[i + 3]),          \
      "+f"(r[i + 4]), "+f"(r[i + 5]), "+f"(r[i + 6]), "+f"(r[i + 7])

// d[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B from shared memory,
// both K-major; `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32),
        ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], as wgmma_ss_n128.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (the mma.sync
// A-fragment layout per warp), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC8

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

// 2^x on the MUFU unit, denormal results flushed to zero: the same value
// as exp2f wherever 2^x >= 2^-126, in one instruction instead of four.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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
  template <bool kMasked>
  __device__ __forceinline__ void softmax(const Problem& p, int k0,
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
  __device__ __forceinline__ void first(const Problem& p, int k0,
                                        bool masked) {
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
  template <bool kMasked>
  __device__ __forceinline__ void next(const Problem& p, int k0) {
    mbar_wait(full + 8 * stage, phase);
    named_sync(1 + cw);
    issue_s<D, BK>(s, qs, base + L::kK + stage * L::kKVTile);
    issue_pv<L::kPanels, BK>(acc, pa, base + L::kV + prev * L::kKVTile,
                             corr_a, corr_b);
    named_arrive(2 - cw);
    wgmma_wait<1>();
    fence_regs(s);
    float c_a, c_b;
    softmax<kMasked>(p, k0, c_a, c_b);
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
// tiles [lo, hi), of which [ulo, uhi) need no mask; then O to memory.
template <int D>
__device__ __forceinline__ void consume(const Problem& p,
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
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
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
// in flight.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            __nv_bfloat16* __restrict__ o, Problem p) {
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
    consume<D>(p, o, base, full, empty, qbar, q0, h, b, wg - 1, lo, hi, ulo,
               uhi);
  }
}

}  // namespace hopper

// cuTensorMapEncodeTiled, found through the runtime's driver entry point so
// that the library links against nothing but the CUDA runtime.
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// The tensor map of a bf16 (batch, seq, heads, d) view through its element
// strides: dimensions innermost first (d, heads, seq, batch), boxes of 64
// columns x 1 head x `rows` rows x 1 batch, 128-byte swizzle, zero fill
// out of bounds. A dimension of extent 1 is never stepped: it gets the
// packed stride (TMA wants every stride a multiple of 16 bytes).
bool encode_map(CUtensorMap* map, const void* ptr, int d, int heads, int seq,
                int batch, const Strides& st, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const long long elem[3] = {st.h, st.s, st.b};
  cuuint64_t strides[3];
  cuuint64_t packed = 2ull * d;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] > 1 ? (cuuint64_t)(2 * elem[i]) : packed;
    packed = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int K, const Problem& p, cudaStream_t st) {
  using L = hopper::Smem<D>;
  const int nq = (p.Sq + hopper::kBQ - 1) / hopper::kBQ;
  CUtensorMap mq, mk, mv;
  if (nq > 65535 || B > 65535 ||
      !encode_map(&mq, q, D, p.H, p.Sq, B, p.q, hopper::kRows) ||
      !encode_map(&mk, k, D, K, p.Sk, B, p.k, L::kBK) ||
      !encode_map(&mv, v, D, K, p.Sk, B, p.v, L::kBK))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      hopper::flash_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kAlloc);
  if (err != cudaSuccess) return (int)err;
  hopper::flash_wgmma<D><<<dim3(p.H, B, nq), hopper::kThreads, L::kAlloc,
                           st>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o),
                                 p);
  return (int)cudaGetLastError();
}

template <int D>
void launch_d(int dtype, const void* q, const void* k, const void* v, void* o,
              int B, const Problem& p, cudaStream_t st) {
  if (dtype == 1) {
    const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, B);
    flash_bf16<D><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), p);
  } else {
    const dim3 grid((p.Sq + kFBQ - 1) / kFBQ, p.H, B);
    flash_f32<D><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), p);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides in elements, (batch, seq, head)
// for each of q, k, v, out. d in {16, 32, ..., 128}; H % K == 0. The
// sm_80-unit designs: flash_f32 (float32), flash_bf16 (bfloat16).
extern "C" int flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* o, int B,
    int Sq, int Sk, int H, int K, int d, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, int causal, int window, void* stream) {
  const Problem p = make_problem(Sq, Sk, H, K, d, qsb, qss, qsh, ksb, kss,
                                 ksh, vsb, vss, vsh, osb, oss, osh, causal,
                                 window);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: launch_d<16>(dtype, q, k, v, o, B, p, st); break;
    case 32: launch_d<32>(dtype, q, k, v, o, B, p, st); break;
    case 48: launch_d<48>(dtype, q, k, v, o, B, p, st); break;
    case 64: launch_d<64>(dtype, q, k, v, o, B, p, st); break;
    case 80: launch_d<80>(dtype, q, k, v, o, B, p, st); break;
    case 96: launch_d<96>(dtype, q, k, v, o, B, p, st); break;
    case 112: launch_d<112>(dtype, q, k, v, o, B, p, st); break;
    case 128: launch_d<128>(dtype, q, k, v, o, B, p, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The Hopper design, flash_wgmma: bfloat16 (dtype 1) at d 64 or 128 only;
// the same arguments as flash_attention.
extern "C" int flash_attention_wgmma(
    int dtype, const void* q, const void* k, const void* v, void* o, int B,
    int Sq, int Sk, int H, int K, int d, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, int causal, int window, void* stream) {
  const Problem p = make_problem(Sq, Sk, H, K, d, qsb, qss, qsh, ksb, kss,
                                 ksh, vsb, vss, vsh, osb, oss, osh, causal,
                                 window);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (d == 64) return launch_wgmma<64>(q, k, v, o, B, K, p, st);
  if (d == 128) return launch_wgmma<128>(q, k, v, o, B, K, p, st);
  return (int)cudaErrorInvalidValue;
}
