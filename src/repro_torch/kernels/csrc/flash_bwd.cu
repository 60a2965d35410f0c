// Flash-attention backward pass for Hopper (sm_90a): kernel K7b.
//
// The reference has no Pallas backward for attention: it trains through
// its jnp online-softmax core (src/repro/models/attention.py
// blockwise_attention) and lets jax.grad differentiate it. K7b is the
// port's counterpart of that gradient, behind the forward K7 (flash.cu).
// For every (batch b, head h), query i and key j, with K7's mask (key j
// seen by query i when i < Sq, j < Sk and, if causal, i - j >= 0 and, if
// window > 0, i - j < window) and K7's log-sum-exp LSE_i of the row's
// scaled scores:
//   s_ij = <q_i, k_j> / sqrt(d),  P_ij = exp(s_ij - LSE_i) where seen, else 0
//   D_i = sum_c dO_ic O_ic
//   dV_j = sum_i P_ij dO_i,       dP_ij = <dO_i, v_j>
//   dS_ij = P_ij (dP_ij - D_i)
//   dQ_i = sum_j dS_ij k_j / sqrt(d),  dK_j = sum_i dS_ij q_i / sqrt(d)
// with dK and dV of kv head g summed over its H / K query heads.
//
// One call of the C entry point launches three kernels in order on the
// caller's stream, and the Python wrapper counts it as one K7b launch:
//   1. delta: D (B, H, Sq) fp32, one warp per query row.
//   2. dK/dV: one CTA per (key tile, kv head, batch). The K and V tiles
//      stay in shared memory while the CTA walks the group's query heads
//      and, for each, the query tiles that see its keys (the causal and
//      window bounds skip the rest); it recomputes S^T and dP^T for its
//      keys and keeps dK and dV in registers until the end. The group sum
//      over query heads is a loop inside the CTA, not a reduction across
//      CTAs.
//   3. dQ: one CTA per (query tile, head, batch), walking the key tiles
//      its queries see, dQ in registers.
// No float atomics and a fixed order of every sum: repeat launches are
// bit-identical (the Trainer's graphed-equals-eager check and its
// bit-exact resume rely on this). Each pass recomputes P from q, k and
// the LSE instead of storing it.
//
// Two designs, chosen by dtype; both take d = 16 ... 128 in steps of 16:
//   * bf16, mma.sync m16n8k16 (bf16 inputs, fp32 accumulate): 4 warps,
//     16 rows each (64 keys per dK/dV CTA over 32-query tiles; 64 queries
//     per dQ CTA over 32-key tiles). Tiles are staged by cp.async in
//     16-byte copies into rows padded by 8 elements; operands whose
//     reduction runs along the tile's rows (dO and Q for dV and dK, K for
//     dQ) are read by transposed ldmatrix. P and dS are rounded to bf16
//     for the second products, as K7 rounds P; the exponentials are exp2f
//     of log2-scaled scores.
//   * fp32, IEEE fmaf throughout (no TF32): 4 warps over 32-key x 16-query
//     tiles, each score a dot product of two shared-memory rows.
//
// What bounds it on an H100: operations. The five products (S, dP, dV,
// dK, dQ) take 10 d flops per seen (i, j) pair and head, 2.5 times the
// forward's four; at (2, 4096, 32, 4, 64) bf16 causal that is 0.35 ms at
// 989 TFLOP/s against 0.07 ms for its 216 MB of q, k, v, O, dO, dq, dk,
// dv and the two (B, H, Sq) vectors at 3.35 TB/s. This first design is
// far from that bound: mma.sync rather than wgmma, staging that the warps
// wait for, S and dP recomputed in both passes, one CTA of 128 threads.
// Later work: wgmma with TMA staging, a pipelined ring of tiles, one pass.
// The launcher returns cudaGetLastError() after each kernel; the Python
// wrapper raises if it is not 0. Nothing is synchronised.

#include "flash.cuh"

namespace {

using namespace flash;

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
// bf16 design
constexpr int kKeys = 64;            // keys per dK/dV CTA (16 per warp)
constexpr int kQT = 32;              // queries per dK/dV inner tile
constexpr int kQRows = 64;           // queries per dQ CTA (16 per warp)
constexpr int kKT = 32;              // keys per dQ inner tile
// fp32 design
constexpr int kFK = 32;              // keys per dK/dV CTA / dQ inner tile
constexpr int kFQ = 16;              // queries per dK/dV inner tile / dQ CTA

struct Bwd {
  int Sq, Sk, H, rep, causal, window;
  float scale;                       // 1 / sqrt(d)
  float scale_log2;                  // log2(e) / sqrt(d)
  Strides q, k, v, o, g, dq, dk, dv;  // g: dO
  const float* lse;                  // (B, H, Sq), natural log
  float* delta;                      // (B, H, Sq)
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ bool seen(const Bwd& p, int qi, int kj) {
  const int rel = qi - kj;
  bool m = qi < p.Sq && kj < p.Sk;
  if (p.causal) m = m && rel >= 0;
  if (p.window > 0) m = m && rel < p.window;
  return m;
}

// [lo, hi): the queries that see some key of [k0, k0 + bk)
__device__ __forceinline__ void query_range(const Bwd& p, int k0, int bk,
                                            int& lo, int& hi) {
  lo = p.causal ? k0 : 0;
  hi = p.window > 0 ? min(p.Sq, k0 + bk - 1 + p.window) : p.Sq;
}

// [lo, hi): the keys that some query of [q0, q0 + bq) sees
__device__ __forceinline__ void key_range(const Bwd& p, int q0, int bq,
                                          int& lo, int& hi) {
  lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  hi = p.causal ? min(p.Sk, q0 + bq) : p.Sk;
}

__device__ __forceinline__ long long row_base(long long b, int h,
                                              const Bwd& p) {
  return (b * p.H + h) * (long long)p.Sq;
}

// 1. D_i = sum_c dO_ic O_ic in fp32, one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_delta(const T* __restrict__ o, const T* __restrict__ g, Bwd p, int d) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  if (row >= p.Sq) return;                    // uniform per warp
  const T* orow = o + b * p.o.b + row * p.o.s + (long long)h * p.o.h;
  const T* grow = g + b * p.g.b + row * p.g.s + (long long)h * p.g.h;
  float s = 0.f;
  for (int c = lane; c < d; c += 32)
    s = fmaf(to_float(orow[c]), to_float(grow[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) p.delta[row_base(b, h, p) + row] = s;
}

// ---------------------------------------------------------------- bf16 --

// Stage `rows` rows of D bf16 elements (row r at src + r * stride; rows at
// or past `valid` zero-filled) into shared rows of kLd elements, by
// 16-byte cp.async; complete at cp_async_wait().
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int ld,
                                      const __nv_bfloat16* src,
                                      long long stride, int rows, int valid) {
  for (int w = threadIdx.x; w < rows * (D / 8); w += kThreads) {
    const int r = w / (D / 8);
    const int c = (w - r * (D / 8)) * 8;
    const bool in = r < valid;
    cp_async16(dst + r * ld + c, src + (in ? r : 0) * stride + c, in);
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// The A fragment (16 rows x 16 columns, mma.sync layout) whose thread rows
// start at `row` (row g of the warp's 16, column 2t already added): rows
// g and g + 8, columns 2t and 2t + 8.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const __nv_bfloat16* row, int ld) {
  a[0] = ld32(row);
  a[1] = ld32(row + 8 * ld);
  a[2] = ld32(row + 8);
  a[3] = ld32(row + 8 * ld + 8);
}

// The C fragments of n tiles 2 kk and 2 kk + 1, rounded to bf16: the A
// fragment of the kk-th 16-deep step.
template <int N>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4],
                                       const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// acc[dt] += A * M over 16 rows of M (row-major in shared memory, the
// reduction along its rows): B[k][n] = M[k][n] by transposed ldmatrix,
// two 8-wide column tiles per load. `m16` points at the 16 rows.
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4],
                                         const uint32_t (&a)[4],
                                         const __nv_bfloat16* m16, int ld,
                                         int lane) {
  const __nv_bfloat16* row =
      m16 + (((lane >> 3) & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; dt += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, row + dt * 8);
    mma_bf16(acc[dt], a, b[0], b[1]);
    mma_bf16(acc[dt + 1], a, b[2], b[3]);
  }
}

template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long rs,
                                           const float (&acc)[D / 8][4],
                                           int row_a, int n, int t,
                                           float scale) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row_a < n)
      *reinterpret_cast<uint32_t*>(base + row_a * rs + col) =
          pack_bf16(acc[dt][0] * scale, acc[dt][1] * scale);
    if (row_a + 8 < n)
      *reinterpret_cast<uint32_t*>(base + (row_a + 8) * rs + col) =
          pack_bf16(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

// 2. dK and dV of 64 keys of one kv head, over its query heads.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ g,
              __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, Bwd p) {
  constexpr int kLd = D + 8;                 // padded smem row (elements)
  constexpr int kNT = kQT / 8;               // 8-query column tiles
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* vs = ks + kKeys * kLd;
  __nv_bfloat16* qs = vs + kKeys * kLd;
  __nv_bfloat16* gs = qs + kQT * kLd;
  float* lse_s = reinterpret_cast<float*>(gs + kQT * kLd);  // log2 units
  float* del_s = lse_s + kQT;

  const int k0 = blockIdx.x * kKeys;
  const int kh = blockIdx.y;
  const long long b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g4 = lane >> 2;
  const int t = lane & 3;
  const int key_a = k0 + warp * 16 + g4;     // rows of c0, c1 / c2, c3

  stage<D>(ks, kLd, k + b * p.k.b + (long long)kh * p.k.h + k0 * p.k.s,
           p.k.s, kKeys, p.Sk - k0);
  stage<D>(vs, kLd, v + b * p.v.b + (long long)kh * p.v.h + k0 * p.v.s,
           p.v.s, kKeys, p.Sk - k0);
  cp_async_wait();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  int qlo, qhi;
  query_range(p, k0, kKeys, qlo, qhi);
  qlo = qlo / kQT * kQT;
  const __nv_bfloat16* krow = ks + (warp * 16 + g4) * kLd + 2 * t;
  const __nv_bfloat16* vrow = vs + (warp * 16 + g4) * kLd + 2 * t;
  for (int r = 0; r < p.rep; ++r) {
    const int h = kh * p.rep + r;
    const __nv_bfloat16* qb = q + b * p.q.b + (long long)h * p.q.h;
    const __nv_bfloat16* gb = g + b * p.g.b + (long long)h * p.g.h;
    const float* lb = p.lse + row_base(b, h, p);
    const float* db = p.delta + row_base(b, h, p);
    for (int q0 = qlo; q0 < qhi; q0 += kQT) {
      __syncthreads();                        // the previous tile is used
      stage<D>(qs, kLd, qb + q0 * p.q.s, p.q.s, kQT, p.Sq - q0);
      stage<D>(gs, kLd, gb + q0 * p.g.s, p.g.s, kQT, p.Sq - q0);
      if (threadIdx.x < kQT) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < p.Sq ? lb[qi] * kLog2e : 0.f;
        del_s[threadIdx.x] = qi < p.Sq ? db[qi] : 0.f;
      }
      cp_async_wait();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x 32 queries
      // (B[k = d][n = query] = Q[query][d]: two adjacent d of a Q row)
      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        a_frag(ka, krow + kk * 16, kLd);
        a_frag(va, vrow + kk * 16, kLd);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const __nv_bfloat16* qr = qs + (nt * 8 + g4) * kLd + kk * 16 + 2 * t;
          const __nv_bfloat16* gr = gs + (nt * 8 + g4) * kLd + kk * 16 + 2 * t;
          mma_bf16(s[nt], ka, ld32(qr), ld32(qr + 8));
          mma_bf16(dp[nt], va, ld32(gr), ld32(gr + 8));
        }
      }
      // P^T (in s) and dS^T (in dp)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ql = nt * 8 + 2 * t + (j & 1);
          const int key = j < 2 ? key_a : key_a + 8;
          const float pv =
              seen(p, q0 + ql, key)
                  ? exp2f(fmaf(s[nt][j], p.scale_log2, -lse_s[ql]))
                  : 0.f;
          s[nt][j] = pv;
          dp[nt][j] = pv * (dp[nt][j] - del_s[ql]);
        }
      // dV += P^T dO, dK += dS^T Q (the reduction along the 32 query rows)
#pragma unroll
      for (int kk = 0; kk < kQT / 16; ++kk) {
        uint32_t pa[4], sa[4];
        c_to_a(pa, s, kk);
        c_to_a(sa, dp, kk);
        mma_rows<D>(dva, pa, gs + kk * 16 * kLd, kLd, lane);
        mma_rows<D>(dka, sa, qs + kk * 16 * kLd, kLd, lane);
      }
    }
  }
  store_rows<D>(dk + b * p.dk.b + (long long)kh * p.dk.h, p.dk.s, dka, key_a,
                p.Sk, t, p.scale);
  store_rows<D>(dv + b * p.dv.b + (long long)kh * p.dv.h, p.dv.s, dva, key_a,
                p.Sk, t, 1.f);
}

// 3. dQ of 64 queries of one head.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const __nv_bfloat16* __restrict__ g,
            __nv_bfloat16* __restrict__ dq, Bwd p) {
  constexpr int kLd = D + 8;
  constexpr int kNT = kKT / 8;               // 8-key column tiles
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* vs = ks + kKT * kLd;

  const int q0 = blockIdx.x * kQRows;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kh = h / p.rep;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g4 = lane >> 2;
  const int t = lane & 3;
  const int row_a = q0 + warp * 16 + g4;
  const int row_b = row_a + 8;

  const __nv_bfloat16* qb = q + b * p.q.b + (long long)h * p.q.h;
  const __nv_bfloat16* gb = g + b * p.g.b + (long long)h * p.g.h;
  const __nv_bfloat16* kb = k + b * p.k.b + (long long)kh * p.k.h;
  const __nv_bfloat16* vb = v + b * p.v.b + (long long)kh * p.v.h;

  // Q and dO as A fragments (rows past Sq are zero and never stored)
  uint32_t qf[D / 16][4], gf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = (r & 1) ? row_b : row_a;
      const int col = kk * 16 + 2 * t + ((r & 2) ? 8 : 0);
      qf[kk][r] = row < p.Sq ? ld32(qb + row * p.q.s + col) : 0u;
      gf[kk][r] = row < p.Sq ? ld32(gb + row * p.g.s + col) : 0u;
    }
  const float* lb = p.lse + row_base(b, h, p);
  const float* db = p.delta + row_base(b, h, p);
  const float lse_a = row_a < p.Sq ? lb[row_a] * kLog2e : 0.f;
  const float lse_b = row_b < p.Sq ? lb[row_b] * kLog2e : 0.f;
  const float del_a = row_a < p.Sq ? db[row_a] : 0.f;
  const float del_b = row_b < p.Sq ? db[row_b] : 0.f;

  float dqa[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dqa[i][j] = 0.f;

  int klo, khi;
  key_range(p, q0, kQRows, klo, khi);
  klo = klo / kKT * kKT;
  for (int k0 = klo; k0 < khi; k0 += kKT) {
    __syncthreads();                          // the previous tile is used
    stage<D>(ks, kLd, kb + k0 * p.k.s, p.k.s, kKT, p.Sk - k0);
    stage<D>(vs, kLd, vb + k0 * p.v.s, p.v.s, kKT, p.Sk - k0);
    cp_async_wait();
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 queries x 32 keys
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
      const __nv_bfloat16* kr = ks + (nt * 8 + g4) * kLd + 2 * t;
      const __nv_bfloat16* vr = vs + (nt * 8 + g4) * kLd + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(s[nt], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
        mma_bf16(dp[nt], gf[kk], ld32(vr + kk * 16), ld32(vr + kk * 16 + 8));
      }
    }
    // dS (in s)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + nt * 8 + 2 * t + (j & 1);
        const bool a = j < 2;
        const float pv =
            seen(p, a ? row_a : row_b, key)
                ? exp2f(fmaf(s[nt][j], p.scale_log2, -(a ? lse_a : lse_b)))
                : 0.f;
        s[nt][j] = pv * (dp[nt][j] - (a ? del_a : del_b));
      }
    // dQ += dS K (the reduction along the 32 key rows)
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk) {
      uint32_t sa[4];
      c_to_a(sa, s, kk);
      mma_rows<D>(dqa, sa, ks + kk * 16 * kLd, kLd, lane);
    }
  }
  store_rows<D>(dq + b * p.dq.b + (long long)h * p.dq.h, p.dq.s, dqa, row_a,
                p.Sq, t, p.scale);
}

// ---------------------------------------------------------------- fp32 --

// Load `rows` rows of D floats (row r at src + r * stride; rows at or past
// `valid` zero) into shared rows of kLd floats.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, long long stride,
                                          int rows, int valid) {
  for (int w = threadIdx.x; w < rows * D; w += kThreads) {
    const int r = w / D;
    const int c = w - r * D;
    dst[r * ld + c] = r < valid ? src[r * stride + c] : 0.f;
  }
}

// 2. dK and dV of 32 keys of one kv head, over its query heads. Thread t
// owns key t % 32 and columns t / 32 + 4 j of dK and dV.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ g,
             float* __restrict__ dk, float* __restrict__ dv, Bwd p) {
  constexpr int kLd = D + 1;                 // lane j reads row j
  constexpr int kPs = kFQ + 1;
  constexpr int kCols = D / 4;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* ks = reinterpret_cast<float*>(bwd_smem);
  float* vs = ks + kFK * kLd;
  float* qs = vs + kFK * kLd;
  float* gs = qs + kFQ * kLd;
  float* pt = gs + kFQ * kLd;                // P^T  [key][query]
  float* st = pt + kFK * kPs;                // dS^T [key][query]
  float* lse_s = st + kFK * kPs;
  float* del_s = lse_s + kFQ;

  const int k0 = blockIdx.x * kFK;
  const int kh = blockIdx.y;
  const long long b = blockIdx.z;
  const int kr = threadIdx.x & 31;
  const int c0 = threadIdx.x >> 5;
  load_rows<D>(ks, kLd, k + b * p.k.b + (long long)kh * p.k.h + k0 * p.k.s,
               p.k.s, kFK, p.Sk - k0);
  load_rows<D>(vs, kLd, v + b * p.v.b + (long long)kh * p.v.h + k0 * p.v.s,
               p.v.s, kFK, p.Sk - k0);
  float dka[kCols], dva[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) dka[j] = dva[j] = 0.f;

  int qlo, qhi;
  query_range(p, k0, kFK, qlo, qhi);
  qlo = qlo / kFQ * kFQ;
  for (int r = 0; r < p.rep; ++r) {
    const int h = kh * p.rep + r;
    const float* qb = q + b * p.q.b + (long long)h * p.q.h;
    const float* gb = g + b * p.g.b + (long long)h * p.g.h;
    const float* lb = p.lse + row_base(b, h, p);
    const float* db = p.delta + row_base(b, h, p);
    for (int q0 = qlo; q0 < qhi; q0 += kFQ) {
      __syncthreads();                        // the previous tile is used
      load_rows<D>(qs, kLd, qb + q0 * p.q.s, p.q.s, kFQ, p.Sq - q0);
      load_rows<D>(gs, kLd, gb + q0 * p.g.s, p.g.s, kFQ, p.Sq - q0);
      if (threadIdx.x < kFQ) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < p.Sq ? lb[qi] : 0.f;
        del_s[threadIdx.x] = qi < p.Sq ? db[qi] : 0.f;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < kFK * kFQ; e += kThreads) {
        const int key = e / kFQ;
        const int ql = e - key * kFQ;
        float sd = 0.f, pd = 0.f;
#pragma unroll 16
        for (int c = 0; c < D; ++c) {
          sd = fmaf(ks[key * kLd + c], qs[ql * kLd + c], sd);
          pd = fmaf(vs[key * kLd + c], gs[ql * kLd + c], pd);
        }
        const float pv = seen(p, q0 + ql, k0 + key)
                             ? expf(sd * p.scale - lse_s[ql])
                             : 0.f;
        pt[key * kPs + ql] = pv;
        st[key * kPs + ql] = pv * (pd - del_s[ql]);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = c0 + 4 * j;
        float av = dva[j], ak = dka[j];
#pragma unroll
        for (int ql = 0; ql < kFQ; ++ql) {
          av = fmaf(pt[kr * kPs + ql], gs[ql * kLd + c], av);
          ak = fmaf(st[kr * kPs + ql], qs[ql * kLd + c], ak);
        }
        dva[j] = av;
        dka[j] = ak;
      }
    }
  }
  if (k0 + kr < p.Sk) {
    float* dkr = dk + b * p.dk.b + (long long)kh * p.dk.h +
                 (long long)(k0 + kr) * p.dk.s;
    float* dvr = dv + b * p.dv.b + (long long)kh * p.dv.h +
                 (long long)(k0 + kr) * p.dv.s;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dkr[c0 + 4 * j] = dka[j] * p.scale;
      dvr[c0 + 4 * j] = dva[j];
    }
  }
}

// 3. dQ of 16 queries of one head. Thread t owns query t % 16 and columns
// t / 16 + 8 j of dQ.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ g,
           float* __restrict__ dq, Bwd p) {
  constexpr int kLd = D + 1;
  constexpr int kSs = kFK + 1;
  constexpr int kCols = D / 8;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* qs = reinterpret_cast<float*>(bwd_smem);
  float* gs = qs + kFQ * kLd;
  float* ks = gs + kFQ * kLd;
  float* vs = ks + kFK * kLd;
  float* ss = vs + kFK * kLd;                // dS [query][key]
  float* lse_s = ss + kFQ * kSs;
  float* del_s = lse_s + kFQ;

  const int q0 = blockIdx.x * kFQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kh = h / p.rep;
  const int qr = threadIdx.x & 15;
  const int c0 = threadIdx.x >> 4;
  load_rows<D>(qs, kLd, q + b * p.q.b + (long long)h * p.q.h + q0 * p.q.s,
               p.q.s, kFQ, p.Sq - q0);
  load_rows<D>(gs, kLd, g + b * p.g.b + (long long)h * p.g.h + q0 * p.g.s,
               p.g.s, kFQ, p.Sq - q0);
  if (threadIdx.x < kFQ) {
    const int qi = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qi < p.Sq ? p.lse[row_base(b, h, p) + qi] : 0.f;
    del_s[threadIdx.x] = qi < p.Sq ? p.delta[row_base(b, h, p) + qi] : 0.f;
  }
  const float* kb = k + b * p.k.b + (long long)kh * p.k.h;
  const float* vb = v + b * p.v.b + (long long)kh * p.v.h;
  float dqa[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) dqa[j] = 0.f;

  int klo, khi;
  key_range(p, q0, kFQ, klo, khi);
  klo = klo / kFK * kFK;
  for (int k0 = klo; k0 < khi; k0 += kFK) {
    __syncthreads();                          // the previous tile is used
    load_rows<D>(ks, kLd, kb + k0 * p.k.s, p.k.s, kFK, p.Sk - k0);
    load_rows<D>(vs, kLd, vb + k0 * p.v.s, p.v.s, kFK, p.Sk - k0);
    __syncthreads();
    for (int e = threadIdx.x; e < kFQ * kFK; e += kThreads) {
      const int ql = e / kFK;
      const int key = e - ql * kFK;
      float sd = 0.f, pd = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) {
        sd = fmaf(qs[ql * kLd + c], ks[key * kLd + c], sd);
        pd = fmaf(gs[ql * kLd + c], vs[key * kLd + c], pd);
      }
      const float pv = seen(p, q0 + ql, k0 + key)
                           ? expf(sd * p.scale - lse_s[ql])
                           : 0.f;
      ss[ql * kSs + key] = pv * (pd - del_s[ql]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = c0 + 8 * j;
      float a = dqa[j];
#pragma unroll 8
      for (int key = 0; key < kFK; ++key)
        a = fmaf(ss[qr * kSs + key], ks[key * kLd + c], a);
      dqa[j] = a;
    }
  }
  if (q0 + qr < p.Sq) {
    float* dqr = dq + b * p.dq.b + (long long)h * p.dq.h +
                 (long long)(q0 + qr) * p.dq.s;
#pragma unroll
    for (int j = 0; j < kCols; ++j) dqr[c0 + 8 * j] = dqa[j] * p.scale;
  }
}

// Launch `kern` with `smem` bytes of dynamic shared memory (raising the
// per-kernel cap above 48 KB first where needed).
template <typename Kern, typename... Args>
cudaError_t launch(Kern kern, dim3 grid, size_t smem, cudaStream_t st,
                   Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, kThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <int D>
int launch_bwd(int dtype, const void* q, const void* k, const void* v,
               const void* o, const void* g, void* dq, void* dk, void* dv,
               int B, int K, const Bwd& p, cudaStream_t st) {
  const dim3 rows((p.Sq + kThreads / 32 - 1) / (kThreads / 32), p.H, B);
  cudaError_t err;
  if (dtype == 1) {
    using T = __nv_bfloat16;
    err = launch(bwd_delta<T>, rows, 0, st, static_cast<const T*>(o),
                 static_cast<const T*>(g), p, D);
    if (err != cudaSuccess) return (int)err;
    const size_t sm_kv =
        (2 * kKeys + 2 * kQT) * (D + 8) * sizeof(T) + 2 * kQT * sizeof(float);
    err = launch(bwd_dkdv_bf16<D>, dim3((p.Sk + kKeys - 1) / kKeys, K, B),
                 sm_kv, st, static_cast<const T*>(q),
                 static_cast<const T*>(k), static_cast<const T*>(v),
                 static_cast<const T*>(g), static_cast<T*>(dk),
                 static_cast<T*>(dv), p);
    if (err != cudaSuccess) return (int)err;
    const size_t sm_q = 2 * kKT * (D + 8) * sizeof(T);
    err = launch(bwd_dq_bf16<D>, dim3((p.Sq + kQRows - 1) / kQRows, p.H, B),
                 sm_q, st, static_cast<const T*>(q), static_cast<const T*>(k),
                 static_cast<const T*>(v), static_cast<const T*>(g),
                 static_cast<T*>(dq), p);
    return (int)err;
  }
  err = launch(bwd_delta<float>, rows, 0, st, static_cast<const float*>(o),
               static_cast<const float*>(g), p, D);
  if (err != cudaSuccess) return (int)err;
  const size_t sm_kv = ((2 * kFK + 2 * kFQ) * (D + 1) +
                        2 * kFK * (kFQ + 1) + 2 * kFQ) * sizeof(float);
  err = launch(bwd_dkdv_f32<D>, dim3((p.Sk + kFK - 1) / kFK, K, B), sm_kv,
               st, static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(g),
               static_cast<float*>(dk), static_cast<float*>(dv), p);
  if (err != cudaSuccess) return (int)err;
  const size_t sm_q = ((2 * kFQ + 2 * kFK) * (D + 1) + kFQ * (kFK + 1) +
                       2 * kFQ) * sizeof(float);
  err = launch(bwd_dq_f32<D>, dim3((p.Sq + kFQ - 1) / kFQ, p.H, B), sm_q, st,
               static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(g),
               static_cast<float*>(dq), p);
  return (int)err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for every tensor but lse and delta
// (fp32). q, dq (B, Sq, H, d); k, v, dk, dv (B, Sk, K, d); o, dO (B, Sq, H,
// d); lse and delta (B, H, Sq) contiguous, lse from K7's forward, delta
// scratch. Strides in elements, (batch, seq, head) for each of q, k, v,
// o, dO, dq, dk, dv (the d stride is 1; in bf16 the q, k, v and dO row
// strides multiples of 8 and their pointers 16-byte aligned, for the
// cp.async staging). d in {16, 32, ..., 128}; H % K == 0.
extern "C" int flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int K, int d, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, long long gsb,
    long long gss, long long gsh, long long dqsb, long long dqss,
    long long dqsh, long long dksb, long long dkss, long long dksh,
    long long dvsb, long long dvss, long long dvsh, int causal, int window,
    void* stream) {
  Bwd p;
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
  p.g = {gsb, gss, gsh};
  p.dq = {dqsb, dqss, dqsh};
  p.dk = {dksb, dkss, dksh};
  p.dv = {dvsb, dvss, dvsh};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch_bwd<16>(dtype, q, k, v, o, dout, dq, dk, dv, B, K, p, st);
    case 32: return launch_bwd<32>(dtype, q, k, v, o, dout, dq, dk, dv, B, K, p, st);
    case 48: return launch_bwd<48>(dtype, q, k, v, o, dout, dq, dk, dv, B, K, p, st);
    case 64: return launch_bwd<64>(dtype, q, k, v, o, dout, dq, dk, dv, B, K, p, st);
    case 80: return launch_bwd<80>(dtype, q, k, v, o, dout, dq, dk, dv, B, K, p, st);
    case 96: return launch_bwd<96>(dtype, q, k, v, o, dout, dq, dk, dv, B, K, p, st);
    case 112: return launch_bwd<112>(dtype, q, k, v, o, dout, dq, dk, dv, B, K, p, st);
    case 128: return launch_bwd<128>(dtype, q, k, v, o, dout, dq, dk, dv, B, K, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
