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
// pointers 16-byte aligned, so a K or V row is whole 16-byte copies). No
// transposed copy is made, and d is not padded to 128 lanes as on the TPU.
//
// What bounds it on an H100: operations, at the shapes that matter. The
// two products take 4 * Sq * Sk * d flops per head (about half that under
// the causal mask) against (q + k + v + out) bytes read or written once:
// at (1, 4096, 32, 4, 64) bf16 causal, 6.87e10 flops (0.069 ms at 989
// TFLOP/s bf16) against 37.7 MB (0.011 ms at 3.35 TB/s). The design:
//   * bf16: one CTA of 4 warps per (64-query tile, head, batch); each warp
//     owns 16 query rows, keeps its Q tile as mma.sync A fragments in
//     registers, and walks the 64-key tiles in order. K and V tiles are
//     staged in shared memory by cp.async, every copy of a tile in flight
//     at once (rows padded by 8 elements against bank conflicts). S = Q K^T and O += P V run on the tensor cores with
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate); V's fragments come
//     from transposed ldmatrix loads; P is rounded to bf16 for the second
//     product, as flash-attention kernels do; m, l and the accumulator
//     stay fp32 in registers. The non-matrix work per score is what the
//     tensor cores wait on, so it is kept small: scores are scaled by
//     log2(e) / sqrt(d) and exponentiated with exp2 (the same softmax),
//     and the per-element mask runs only in tiles that are not wholly
//     visible (the causal diagonal, the window's edges, the last key
//     tile).
//   * fp32 stays IEEE fp32 (no TF32): one CTA of 4 warps per 16-query
//     tile; a lane owns one key of each 32-key tile for the scores and
//     d / 32 output columns for the accumulator, plain fmaf throughout.
//   * No atomics and a fixed order of every sum: repeat launches are
//     bit-identical.
// Not done yet (later work): double buffering of the K/V tiles (the next
// tile's copies overlapping this tile's products), ldmatrix for K, TMA,
// wgmma, a persistent grid.
// Each launcher returns cudaGetLastError(); the Python wrapper raises if it
// is not 0. Launches go to the caller's stream and do not synchronise.

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides in elements, (batch, seq, head)
// for each of q, k, v, out. d in {16, 32, ..., 128}; H % K == 0.
extern "C" int flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* o, int B,
    int Sq, int Sk, int H, int K, int d, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, int causal, int window, void* stream) {
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
