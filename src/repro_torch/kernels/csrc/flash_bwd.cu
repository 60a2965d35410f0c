// Flash-attention backward pass for Hopper (sm_90a): kernel K7b.
//
// The reference has no Pallas backward for attention: it trains through
// its jnp online-softmax core (src/repro/models/attention.py
// blockwise_attention) and lets jax.grad differentiate it. K7b is the
// port's counterpart of that gradient, behind the forward K7 (flash.cu).
// For every (batch b, head h), query i and key j, with K7's mask (key j
// seen by query i when i < Sq, j < Sk and, with rel = i - (j + k_offset),
// if causal, rel >= 0 and, if window > 0, rel < window: key j sits at
// position j + k_offset, 0 but for kv-SP) and a log-sum-exp LSE_i of the
// row's scaled scores (K7's; kv-SP passes the one merged over every
// rank's keys, and D from the merged output, so that P is the global
// softmax restricted to the rank's keys, dK and dV are whole for them and
// dQ is the rank's part of a sum):
//   s_ij = <q_i, k_j> / sqrt(d),  P_ij = exp(s_ij - LSE_i) where seen, else 0
//   (a row that sees no key: P 0, so dQ 0, whatever its LSE)
//   D_i = sum_c dO_ic O_ic
//   dV_j = sum_i P_ij dO_i,       dP_ij = <dO_i, v_j>
//   dS_ij = P_ij (dP_ij - D_i)
//   dQ_i = sum_j dS_ij k_j / sqrt(d),  dK_j = sum_i dS_ij q_i / sqrt(d)
// with dK and dV of kv head g summed over its H / K query heads.
//
// One call of a C entry point launches three kernels in order on the
// caller's stream, and the Python wrapper counts it as one K7b launch:
//   1. the rows: D (B, H, Sq) fp32, one warp per query row (the Hopper
//      design's also each row's LSE in log2 units, both padded).
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
// the LSE instead of storing it: 14 d flops a seen pair and head against
// the 10 d of one pass whose dQ adds across key tiles, which would need
// atomics (their order changes from run to run) or a fixed-order
// reduction.
//
// Three designs, chosen by dtype and d alone (the wrapper's uses_wgmma):
//   * bf16 at d = 64 and 128, the Hopper design (flash_attention_bwd_wgmma:
//     bwd_rows_wgmma, bwd_dkdv_wgmma, bwd_dq_wgmma), built from K7's pieces
//     (hopper.cuh: TMA, mbarriers, wgmma, the operand layouts). Both
//     passes are CTAs of two consumer warpgroups, each owning 64 rows of
//     the CTA's 128, and one producer warp, one thread of which issues
//     every copy; the consumers take turns to issue their products
//     (ping-pong on named barriers), so one's exponentials run under the
//     other's products. dK/dV: the K and V tiles by TMA once, then a
//     4-stage ring of (Q, dO) tiles (64 queries at d = 64, 16 at d = 128)
//     for every query head of the group, each with its LSE and D slices by
//     a bulk copy; per stage each consumer issues S^T = K Q^T and
//     dP^T = V dO^T (wgmma SS, K-major), computes P^T and dS^T, then issues
//     dV += bf16(P^T) dO and dK += bf16(dS^T) Q (wgmma RS, dO and Q as
//     MN-major B, as K7 reads V). dQ: Q and dO by TMA once, a 4-stage ring
//     of 64-key (K, V) tiles; S = Q K^T and dP = dO V^T on wgmma SS, dQ +=
//     bf16(dS) K on wgmma RS, at d = 64 pipelined as K7 is (the dQ
//     product of one stage under the exponentials of the next). The tiles
//     that need the per-element mask (the causal diagonal, a window's
//     edge, the ragged ends of Sq and Sk) are walked by loops of their
//     own. The heaviest CTAs start first: dK/dV's key blocks lowest first,
//     dQ's query blocks reversed under the causal mask.
//     Registers decide the shapes: a thread of a CTA of 9 or 12 warps gets
//     at most 168 (an SM sub-partition holds 3 of its warps), and ptxas
//     holds K7's setmaxnreg shape to that budget as well. dK and dV take 64
//     (d = 64) or 128 (d = 128) fp32 registers a thread, so the dK/dV pass
//     waits for each group of products (pipelined as dQ is, it spilled and
//     ran 1.6 times slower) and takes 16-query steps at d = 128. The
//     producer is one warp, not K7's producer warpgroup: the three idle
//     warps and setmaxnreg bought nothing here and cost 3% (PERF.md §6).
//   * bf16 at the other head sizes (16, 32, 48, 80, 96, 112), mma.sync
//     m16n8k16 (bf16 inputs, fp32 accumulate): 4 warps, 16 rows each (64
//     keys per dK/dV CTA over 32-query tiles; 64 queries per dQ CTA over
//     32-key tiles).
//     Tiles are staged by cp.async in 16-byte copies into rows padded by 8
//     elements; operands whose reduction runs along the tile's rows (dO
//     and Q for dV and dK, K for dQ) are read by transposed ldmatrix.
//   * fp32, IEEE fmaf throughout (no TF32): 4 warps over 32-key x 16-query
//     tiles, each score a dot product of two shared-memory rows.
// The bf16 designs round P and dS to bf16 for the second products, as K7
// rounds P; the exponentials are of log2-scaled scores (exp2f; the Hopper
// design the MUFU's ex2, flushing results below 2^-126 to zero).
//
// What bounds it on an H100: operations. The five products (S, dP, dV,
// dK, dQ) take 10 d flops per seen (i, j) pair and head, 2.5 times the
// forward's four; at (2, 4096, 32, 4, 64) bf16 causal that is 0.35 ms at
// 989 TFLOP/s against 0.07 ms for its 216 MB of q, k, v, O, dO, dq, dk,
// dv and the two (B, H, Sq) vectors at 3.35 TB/s. The two passes' 14 d
// flops put a ceiling of 71% of that bound on this structure; at d = 64
// the exponentials (2 x 5.4e8 at the LM shape, ~0.14 ms a pass at 16 MUFU
// results per clock per SM) are a second floor that the ping-pong hides
// under the other warpgroup's products.
// Each launcher returns cudaGetLastError() after each kernel; the Python
// wrapper raises if it is not 0. Nothing is synchronised.

#include "hopper.cuh"

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
  float* delta;                      // (B, H, Sq); the Hopper design's:
                                     // (B, H, 2, Sq padded), LSE_2 and D
  int k_offset;                      // the position of key 0 (>= 0)
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ bool seen(const Bwd& p, int qi, int kj) {
  const int rel = qi - (kj + p.k_offset);
  bool m = qi < p.Sq && kj < p.Sk;
  if (p.causal) m = m && rel >= 0;
  if (p.window > 0) m = m && rel < p.window;
  return m;
}

// [lo, hi): the queries that see some key of [k0, k0 + bk) (empty, lo >=
// hi, where none does: the CTA writes dK = dV = 0)
__device__ __forceinline__ void query_range(const Bwd& p, int k0, int bk,
                                            int& lo, int& hi) {
  const int kp = k0 + p.k_offset;
  lo = p.causal ? kp : 0;
  hi = p.window > 0 ? min(p.Sq, kp + bk - 1 + p.window) : p.Sq;
}

// [lo, hi): the keys that some query of [q0, q0 + bq) sees (empty where
// none does: the CTA writes dQ = 0)
__device__ __forceinline__ void key_range(const Bwd& p, int q0, int bq,
                                          int& lo, int& hi) {
  lo = p.window > 0 ? max(0, q0 - p.window + 1 - p.k_offset) : 0;
  hi = p.causal ? min(p.Sk, q0 + bq - p.k_offset) : p.Sk;
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

// ------------------------------------------------- bf16, d 64 / 128, sm_90a --

namespace hopper {

constexpr int kRows = 64;            // rows per consumer warpgroup: keys in
                                     // the dK/dV pass, queries in the dQ pass
constexpr int kBlock = 2 * kRows;    // rows per CTA
constexpr int kThreads = 288;        // two consumer warpgroups, a producer
constexpr int kProducer = 2;         // warp 8 (threadIdx.x >> 7 == 2)
constexpr int kRowBytes = 128;       // one swizzled smem row: 64 bf16
constexpr int kStages = 4;           // ring stages
constexpr int kPad = 128;            // LSE and D rows padded to a multiple

// The shared memory of one dK/dV CTA (byte offsets from a 1024-aligned
// base, as the 128-byte swizzle needs; a tile of R rows x D columns is
// D / 64 panels of R rows x 128 bytes, one TMA box each): K and V of its
// 128 keys, one 64-row tile per consumer warpgroup, loaded once; a ring of
// (Q, dO) tiles of BQ queries with their slices of LSE (log2 units) and D.
// BQ is 64 at d = 64 and 16 at d = 128, so that dK and dV (2 x 32 or 2 x
// 64 fp32 registers) and S^T and dP^T (2 x BQ / 2) fit the 168 registers
// a thread of a 9-warp CTA can have.
template <int D>
struct KvSmem {
  static constexpr int kBQ = D == 64 ? 64 : 16;
  static constexpr int kPanels = D / 64;
  static constexpr int kKTile = kPanels * kRows * kRowBytes;   // K or V
  static constexpr int kQTile = kPanels * kBQ * kRowBytes;     // Q or dO
  static constexpr int kVec = 2 * kBQ * 4;                     // LSE, D
  static constexpr int kK = 0;
  static constexpr int kV = kK + 2 * kKTile;
  static constexpr int kQ = kV + 2 * kKTile;
  static constexpr int kG = kQ + kStages * kQTile;
  static constexpr int kL = kG + kStages * kQTile;
  static constexpr int kBar = kL + kStages * kVec;     // full, empty, kv
  static constexpr int kAlloc = kBar + (2 * kStages + 1) * 8 + 1024;
};

// The shared memory of one dQ CTA: Q and dO of its 128 queries (one
// 64-row tile each per consumer warpgroup), loaded once; a ring of (K, V)
// tiles of 64 keys.
template <int D>
struct QSmem {
  static constexpr int kBK = 64;
  static constexpr int kPanels = D / 64;
  static constexpr int kQTile = kPanels * kRows * kRowBytes;   // Q or dO
  static constexpr int kKVTile = kPanels * kBK * kRowBytes;    // K or V
  static constexpr int kQ = 0;
  static constexpr int kG = kQ + 2 * kQTile;
  static constexpr int kK = kG + 2 * kQTile;
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kBar = kV + kStages * kKVTile;  // full, empty, q
  static constexpr int kAlloc = kBar + (2 * kStages + 1) * 8 + 1024;
};

// Some pair of [q0, q0 + bq) x [k0, k0 + bk) is seen (K7's visible_tile;
// key indices, their positions from k0 + the offset).
__device__ __forceinline__ bool tile_seen(const Bwd& p, int q0, int bq,
                                          int k0, int bk) {
  const int kp = k0 + p.k_offset;
  bool vis = true;
  if (p.causal) vis = q0 + bq - 1 >= kp;
  if (p.window > 0) vis = vis && (kp + bk - 1 > q0 - p.window);
  return vis;
}

// Every pair is seen: the tile needs no per-element mask (K7's whole_tile,
// with the ragged end of Sq as well).
__device__ __forceinline__ bool tile_whole(const Bwd& p, int q0, int bq,
                                           int k0, int bk) {
  const int kp = k0 + p.k_offset;
  return q0 + bq <= p.Sq && k0 + bk <= p.Sk &&
         (!p.causal || kp + bk - 1 <= q0) &&
         (p.window <= 0 || q0 + bq - 1 - kp < p.window);
}

// The run [lo, hi) of n tiles of `step` rows (tile i at i * step; queries
// if `queries`, else keys) that see the CTA's fixed rows [r0, r0 + 128),
// and within it the run [ulo, uhi) that needs no mask.
__device__ __forceinline__ void tile_runs(const Bwd& p, bool queries, int r0,
                                          int step, int n, int& lo, int& hi,
                                          int& ulo, int& uhi) {
  auto seen_at = [&](int i) {
    return queries ? tile_seen(p, i * step, step, r0, kBlock)
                   : tile_seen(p, r0, kBlock, i * step, step);
  };
  auto whole_at = [&](int i) {
    return queries ? tile_whole(p, i * step, step, r0, kBlock)
                   : tile_whole(p, r0, kBlock, i * step, step);
  };
  lo = 0;
  while (lo < n && !seen_at(lo)) ++lo;
  hi = lo;
  while (hi < n && seen_at(hi)) ++hi;
  ulo = lo;
  while (ulo < hi && !whole_at(ulo)) ++ulo;
  uhi = ulo;
  while (uhi < hi && whole_at(uhi)) ++uhi;
}

// C (+)= A B^T over d: A a 64-row tile at `a` (K-major, panels of kRows
// rows), B an N-row tile at `b` (K-major, panels of N rows); 16-deep steps
// over d, 32 bytes apart inside a panel row. Neither fenced nor committed.
template <int D, int N>
__device__ __forceinline__ void ss_rows(float (&c)[N / 2], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da =
        sw128_desc(a + (kk >> 2) * kRows * kRowBytes + (kk & 3) * 32);
    const uint64_t db =
        sw128_desc(b + (kk >> 2) * N * kRowBytes + (kk & 3) * 32);
    if constexpr (N == 64) {
      wgmma_ss_n64(c, da, db, kk > 0);
    } else {
      wgmma_ss_n16(c, da, db, kk > 0);
    }
  }
}

// acc += A M, the sum over the N rows of M: A from registers (pack_a), M an
// N-row tile at `m` read as an MN-major B (K7's V in P V): the kk-th
// 16-row step starts 16 rows (2048 bytes) into each 64-column panel.
// Neither fenced nor committed.
template <int NP, int N>
__device__ __forceinline__ void rs_rows(float (&acc)[NP][32],
                                        const uint32_t (&a)[N / 16][4],
                                        uint32_t m) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
      wgmma_rs_n64(acc[pn], a[kk],
                   sw128_desc(m + pn * N * kRowBytes + kk * 16 * kRowBytes));
}

// A 64 x N fp32 accumulator (wgmma layout: c[4 n + 2 i + j] at row
// 16 w + g + 8 i, column 8 n + 2 t + j) rounded to bf16, as the A operand
// of the N / 16 16-deep steps of a product over its columns (K7's pack_p).
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4],
                                       const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// A consumer warpgroup's place in the ring, its barriers and its turn.
struct Ring {
  int stage, prev;
  uint32_t phase;
  uint32_t full, empty;
  int lane, cw;

  __device__ __forceinline__ void init(uint32_t full_bar, uint32_t empty_bar,
                                       int warpgroup) {
    stage = prev = 0;
    phase = 0;
    full = full_bar;
    empty = empty_bar;
    lane = threadIdx.x & 31;
    cw = warpgroup;
  }
  __device__ __forceinline__ void wait_full() {
    mbar_wait(full + 8 * stage, phase);
  }
  // This warp is done with stage `prev` (its products have completed).
  __device__ __forceinline__ void release() {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * prev);
  }
  __device__ __forceinline__ void advance() {
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // Ping-pong: a warpgroup issues its products between its own named
  // barrier and the other's (1 + cw, 2 - cw; warpgroup 1 arrives once
  // first, warpgroup 0 syncs once last), so the two warpgroups' products
  // alternate and one's exponentials run under the other's products.
  __device__ __forceinline__ void turn() { named_sync(1 + cw); }
  __device__ __forceinline__ void pass() { named_arrive(2 - cw); }
};

// One consumer warpgroup of the dK/dV pass: 64 keys (rows a: key_a, rows
// b: key_a + 8), dK and dV in fp32 registers over every step. A step is
// one (Q, dO) stage of BQ queries of one head:
//   S^T = K Q^T and dP^T = V dO^T (wgmma SS, both operands K-major);
//   P^T = exp2(S^T log2(e) / sqrt(d) - LSE_col log2(e)), 0 where not seen;
//   dS^T = P^T (dP^T - D_col);
//   dV += bf16(P^T) dO and dK += bf16(dS^T) Q (wgmma RS, dO and Q as
//   MN-major B).
// The warpgroup waits for each group of products: the two pipelined (the
// second products of one step under the exponentials of the next) would
// hold 32 more registers than a thread has, and the other warpgroup's
// products fill the wait.
template <int D>
struct KvConsumer {
  using L = KvSmem<D>;
  static constexpr int BQ = L::kBQ;
  float dk[L::kPanels][32], dv[L::kPanels][32];
  float s[BQ / 2], dp[BQ / 2];       // S^T, dP^T; then P^T, dS^T (fp32)
  uint32_t pa[BQ / 16][4];           // P^T (bf16)
  uint32_t sa[BQ / 16][4];           // dS^T (bf16)
  Ring r;
  uint32_t base, ks, vs;
  const float* vec;                  // the ring's LSE / D slices (generic)
  int t, key_a;

  // P^T and dS^T in place of S^T and dP^T for the step at q0, the LSE and
  // D of its columns read from the stage's slices.
  template <bool kMasked>
  __device__ __forceinline__ void grads(const Bwd& p, int q0) {
    const float* lv = vec + r.stage * (2 * BQ);
    const float scale = p.scale_log2;
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(lv + 8 * n + 2 * t);
      const float2 e =
          *reinterpret_cast<const float2*>(lv + BQ + 8 * n + 2 * t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pv = exp2_ftz(fmaf(s[4 * n + j], scale, (j & 1) ? -l.y : -l.x));
        if constexpr (kMasked)
          pv = seen(p, q0 + 8 * n + 2 * t + (j & 1), key_a + 8 * (j >> 1))
                   ? pv
                   : 0.f;
        s[4 * n + j] = pv;
        dp[4 * n + j] = pv * (dp[4 * n + j] - ((j & 1) ? e.y : e.x));
      }
    }
  }

  template <bool kMasked>
  __device__ __forceinline__ void step(const Bwd& p, int q0) {
    const uint32_t qs = base + L::kQ + r.stage * L::kQTile;
    const uint32_t gs = base + L::kG + r.stage * L::kQTile;
    r.wait_full();
    r.turn();
    wgmma_fence();
    ss_rows<D, BQ>(s, ks, qs);
    ss_rows<D, BQ>(dp, vs, gs);
    wgmma_commit();
    r.pass();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    grads<kMasked>(p, q0);
    pack_a<BQ>(pa, s);
    pack_a<BQ>(sa, dp);
    r.turn();
    wgmma_fence();
    rs_rows<L::kPanels, BQ>(dv, pa, gs);
    rs_rows<L::kPanels, BQ>(dk, sa, qs);
    wgmma_commit();
    r.pass();
    wgmma_wait<0>();
#pragma unroll
    for (int pn = 0; pn < L::kPanels; ++pn) {
      fence_regs(dk[pn]);
      fence_regs(dv[pn]);
    }
    r.advance();
    r.release();
  }
};

// The dK/dV producer: one thread brings K and V of the CTA's keys, then
// for every query head of the group the (Q, dO) tiles [lo, hi) and their
// LSE / D slices into the ring, each stage once the consumers released it.
template <int D>
__device__ __forceinline__ void produce_kv(
    const CUtensorMap& tq, const CUtensorMap& tg, const CUtensorMap& tk,
    const CUtensorMap& tv, const Bwd& p, int sq_pad, uint32_t base,
    uint32_t full, uint32_t empty, uint32_t kvbar, int k0, int kh, int b,
    int lo, int hi) {
  using L = KvSmem<D>;
  constexpr int BQ = L::kBQ;
  prefetch_map(&tq);
  prefetch_map(&tg);
  prefetch_map(&tk);
  prefetch_map(&tv);
  mbar_expect_tx(kvbar, 4 * L::kKTile);
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int pn = 0; pn < L::kPanels; ++pn) {
      const int off = w * L::kKTile + pn * kRows * kRowBytes;
      tma_load(base + L::kK + off, &tk, kvbar, pn * 64, kh, k0 + w * kRows, b);
      tma_load(base + L::kV + off, &tv, kvbar, pn * 64, kh, k0 + w * kRows, b);
    }
  int stage = 0;
  uint32_t phase = 1;                  // the ring starts empty
  for (int r = 0; r < p.rep; ++r) {
    const int h = kh * p.rep + r;
    const float* lv = p.delta + ((long long)b * p.H + h) * 2 * sq_pad;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * BQ;
      mbar_wait(empty + 8 * stage, phase);
      const uint32_t bar = full + 8 * stage;
      mbar_expect_tx(bar, 2 * L::kQTile + L::kVec);
#pragma unroll
      for (int pn = 0; pn < L::kPanels; ++pn) {
        const int off = stage * L::kQTile + pn * BQ * kRowBytes;
        tma_load(base + L::kQ + off, &tq, bar, pn * 64, h, q0, b);
        tma_load(base + L::kG + off, &tg, bar, pn * 64, h, q0, b);
      }
      const uint32_t vs = base + L::kL + stage * L::kVec;
      bulk_load(vs, lv + q0, BQ * 4, bar);
      bulk_load(vs + BQ * 4, lv + sq_pad + q0, BQ * 4, bar);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// 2. dK and dV of 128 keys of one kv head, over its query heads: one CTA
// per (key block, kv head, batch) of two consumer warpgroups (64 keys
// each) and one producer warp. The key blocks with the most queries start
// first (the grid's slowest axis is the key block, lowest first). p.delta
// holds LSE in log2 units and D, (B, H, 2, sq_pad).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tg,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               Bwd p, int sq_pad) {
  using L = KvSmem<D>;
  constexpr int BQ = L::kBQ;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full = base + L::kBar;             // full[s]: + 8 s
  const uint32_t empty = full + 8 * kStages;        // empty[s]: + 8 s
  const uint32_t kvbar = empty + 8 * kStages;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kBlock;
  // the warpgroup, read from lane 0 so the compiler knows it is the same
  // across the warp (role branches need warp-uniform paths)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  int lo, hi, ulo, uhi;
  tile_runs(p, true, k0, BQ, (p.Sq + BQ - 1) / BQ, lo, hi, ulo, uhi);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);       // one arrival per consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kProducer) {
    if ((threadIdx.x & 31) == 0)
      produce_kv<D>(tq, tg, tk, tv, p, sq_pad, base, full, empty, kvbar, k0,
                    kh, b, lo, hi);
    return;
  }
  KvConsumer<D> c;
  const int tid = threadIdx.x & 127;
  c.r.init(full, empty, wg);
  c.t = c.r.lane & 3;
  c.key_a = k0 + wg * kRows + (tid >> 5) * 16 + (c.r.lane >> 2);
  c.base = base;
  c.ks = base + L::kK + wg * L::kKTile;
  c.vs = base + L::kV + wg * L::kKTile;
  c.vec = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::kL);
#pragma unroll
  for (int pn = 0; pn < L::kPanels; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) c.dk[pn][i] = c.dv[pn][i] = 0.f;

  if (wg == 1) c.r.pass();                          // warpgroup 0 goes first
  mbar_wait(kvbar, 0);
  for (int h = 0; h < p.rep; ++h) {
    for (int qt = lo; qt < ulo; ++qt) c.template step<true>(p, qt * BQ);
    for (int qt = ulo; qt < uhi; ++qt) c.template step<false>(p, qt * BQ);
    for (int qt = uhi; qt < hi; ++qt) c.template step<true>(p, qt * BQ);
  }
  if (wg == 0) c.r.turn();                          // warpgroup 1's last pass

  __nv_bfloat16* kb = dk + (long long)b * p.dk.b + (long long)kh * p.dk.h;
  __nv_bfloat16* vb = dv + (long long)b * p.dv.b + (long long)kh * p.dv.h;
#pragma unroll
  for (int pn = 0; pn < L::kPanels; ++pn)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = pn * 64 + n * 8 + 2 * c.t;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long key = c.key_a + 8 * i;
        if (key < p.Sk) {
          *reinterpret_cast<uint32_t*>(kb + key * p.dk.s + col) =
              pack_bf16(c.dk[pn][4 * n + 2 * i] * p.scale,
                        c.dk[pn][4 * n + 2 * i + 1] * p.scale);
          *reinterpret_cast<uint32_t*>(vb + key * p.dv.s + col) =
              pack_bf16(c.dv[pn][4 * n + 2 * i], c.dv[pn][4 * n + 2 * i + 1]);
        }
      }
    }
}

// One consumer warpgroup of the dQ pass: 64 queries (rows a: row_a, rows
// b: row_a + 8), dQ in fp32 registers over every (K, V) stage of 64 keys:
//   S = Q K^T and dP = dO V^T (wgmma SS, both operands K-major);
//   dS = exp2(S log2(e) / sqrt(d) - LSE log2(e)) (dP - D), 0 where not seen;
//   dQ += bf16(dS) K (wgmma RS, K as MN-major B).
// At d = 64 a two-stage software pipeline (K7's): at stage t it issues S_t
// and dP_t, then dQ += dS_{t-1} K_{t-1}, and computes dS_t while the
// second product runs. At d = 128 dQ's 64 registers leave no room for
// that: each group of products is waited for, as in the dK/dV pass.
template <int D>
struct QConsumer {
  using L = QSmem<D>;
  static constexpr int BK = L::kBK;
  static constexpr bool kPipelined = D == 64;
  float dq[L::kPanels][32];
  float s[BK / 2], dp[BK / 2];       // S, dP; then dS in dp (fp32)
  uint32_t sa[BK / 16][4];           // dS (bf16), of the previous stage
                                     // while pipelined
  Ring r;
  uint32_t base, qs, gs;
  float lse_a, lse_b, del_a, del_b;  // log2 units / D of rows a and b
  int t, row_a;

  __device__ __forceinline__ void issue_sdp() {
    wgmma_fence();
    ss_rows<D, BK>(s, qs, base + L::kK + r.stage * L::kKVTile);
    ss_rows<D, BK>(dp, gs, base + L::kV + r.stage * L::kKVTile);
    wgmma_commit();
  }

  // dQ += dS K over the stage `prev`.
  __device__ __forceinline__ void issue_dq() {
    wgmma_fence();
    rs_rows<L::kPanels, BK>(dq, sa, base + L::kK + r.prev * L::kKVTile);
    wgmma_commit();
  }

  template <bool kMasked>
  __device__ __forceinline__ void grads(const Bwd& p, int k0) {
    const float scale = p.scale_log2;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool a = j < 2;
        float pv = exp2_ftz(fmaf(s[4 * n + j], scale, a ? -lse_a : -lse_b));
        if constexpr (kMasked)
          pv = seen(p, a ? row_a : row_a + 8, k0 + 8 * n + 2 * t + (j & 1))
                   ? pv
                   : 0.f;
        dp[4 * n + j] = pv * (dp[4 * n + j] - (a ? del_a : del_b));
      }
  }

  __device__ __forceinline__ void fence_acc() {
#pragma unroll
    for (int pn = 0; pn < L::kPanels; ++pn) fence_regs(dq[pn]);
  }

  // One stage, unpipelined: its products waited for.
  template <bool kMasked>
  __device__ __forceinline__ void step(const Bwd& p, int k0) {
    r.wait_full();
    r.turn();
    issue_sdp();
    r.pass();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    grads<kMasked>(p, k0);
    pack_a<BK>(sa, dp);
    r.advance();
    r.turn();
    issue_dq();
    r.pass();
    wgmma_wait<0>();
    fence_acc();
    r.release();
  }

  // The first stage: S, dP and dS (nothing else in flight, so the mask may
  // be chosen at run time).
  __device__ __forceinline__ void first(const Bwd& p, int k0, bool masked) {
    if constexpr (!kPipelined) {
      if (masked) {
        step<true>(p, k0);
      } else {
        step<false>(p, k0);
      }
    } else {
      r.wait_full();
      r.turn();
      issue_sdp();
      r.pass();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (masked) {
        grads<true>(p, k0);
      } else {
        grads<false>(p, k0);
      }
      pack_a<BK>(sa, dp);
      r.advance();
    }
  }

  // A later stage: S_t, dP_t and dQ += dS_{t-1} K_{t-1} in flight, dS_t
  // under the second product, then the stage of t - 1 released.
  template <bool kMasked>
  __device__ __forceinline__ void next(const Bwd& p, int k0) {
    if constexpr (!kPipelined) {
      step<kMasked>(p, k0);
    } else {
      r.wait_full();
      r.turn();
      issue_sdp();
      issue_dq();
      r.pass();
      wgmma_wait<1>();
      fence_regs(s);
      fence_regs(dp);
      grads<kMasked>(p, k0);
      fence_regs(dp);                // computed before the wait below
      wgmma_wait<0>();
      fence_acc();
      r.release();
      pack_a<BK>(sa, dp);
      r.advance();
    }
  }

  // The last stage's dQ product.
  __device__ __forceinline__ void last() {
    if constexpr (kPipelined) {
      issue_dq();
      wgmma_wait<0>();
      fence_acc();
      r.release();
    }
  }
};

// The dQ producer: one thread brings Q and dO of the CTA's queries, then
// the (K, V) tiles [lo, hi) into the ring.
template <int D>
__device__ __forceinline__ void produce_q(
    const CUtensorMap& tq, const CUtensorMap& tg, const CUtensorMap& tk,
    const CUtensorMap& tv, const Bwd& p, uint32_t base, uint32_t full,
    uint32_t empty, uint32_t qbar, int q0, int h, int b, int lo, int hi) {
  using L = QSmem<D>;
  constexpr int BK = L::kBK;
  prefetch_map(&tq);
  prefetch_map(&tg);
  prefetch_map(&tk);
  prefetch_map(&tv);
  const int kh = h / p.rep;
  mbar_expect_tx(qbar, 4 * L::kQTile);
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int pn = 0; pn < L::kPanels; ++pn) {
      const int off = w * L::kQTile + pn * kRows * kRowBytes;
      tma_load(base + L::kQ + off, &tq, qbar, pn * 64, h, q0 + w * kRows, b);
      tma_load(base + L::kG + off, &tg, qbar, pn * 64, h, q0 + w * kRows, b);
    }
  int stage = 0;
  uint32_t phase = 1;                  // the ring starts empty
  for (int kt = lo; kt < hi; ++kt) {
    mbar_wait(empty + 8 * stage, phase);
    const uint32_t bar = full + 8 * stage;
    mbar_expect_tx(bar, 2 * L::kKVTile);
#pragma unroll
    for (int pn = 0; pn < L::kPanels; ++pn) {
      const int off = stage * L::kKVTile + pn * BK * kRowBytes;
      tma_load(base + L::kK + off, &tk, bar, pn * 64, kh, kt * BK, b);
      tma_load(base + L::kV + off, &tv, bar, pn * 64, kh, kt * BK, b);
    }
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// 3. dQ of 128 queries of one head: one CTA per (query block, head,
// batch), laid out as dK/dV's; the query blocks with the most keys start
// first (reversed under the causal mask, as K7's).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tg,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             __nv_bfloat16* __restrict__ dq, Bwd p, int sq_pad) {
  using L = QSmem<D>;
  constexpr int BK = L::kBK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + L::kBar;
  const uint32_t empty = full + 8 * kStages;
  const uint32_t qbar = empty + 8 * kStages;
  const int nq = gridDim.z;
  const int q0 =
      (p.causal ? nq - 1 - (int)blockIdx.z : (int)blockIdx.z) * kBlock;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  int lo, hi, ulo, uhi;
  tile_runs(p, false, q0, BK, (p.Sk + BK - 1) / BK, lo, hi, ulo, uhi);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kProducer) {
    if ((threadIdx.x & 31) == 0)
      produce_q<D>(tq, tg, tk, tv, p, base, full, empty, qbar, q0, h, b, lo,
                   hi);
    return;
  }
  QConsumer<D> c;
  const int tid = threadIdx.x & 127;
  c.r.init(full, empty, wg);
  c.t = c.r.lane & 3;
  c.row_a = q0 + wg * kRows + (tid >> 5) * 16 + (c.r.lane >> 2);
  c.base = base;
  c.qs = base + L::kQ + wg * L::kQTile;
  c.gs = base + L::kG + wg * L::kQTile;
  const float* lv = p.delta + ((long long)b * p.H + h) * 2 * sq_pad;
  c.lse_a = lv[c.row_a];                 // rows past Sq: the zero padding
  c.lse_b = lv[c.row_a + 8];
  c.del_a = lv[sq_pad + c.row_a];
  c.del_b = lv[sq_pad + c.row_a + 8];
#pragma unroll
  for (int pn = 0; pn < L::kPanels; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) c.dq[pn][i] = 0.f;

  if (wg == 1) c.r.pass();
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
  if (wg == 0) c.r.turn();

  __nv_bfloat16* qb = dq + (long long)b * p.dq.b + (long long)h * p.dq.h;
#pragma unroll
  for (int pn = 0; pn < L::kPanels; ++pn)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = pn * 64 + n * 8 + 2 * c.t;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long row = c.row_a + 8 * i;
        if (row < p.Sq)
          *reinterpret_cast<uint32_t*>(qb + row * p.dq.s + col) =
              pack_bf16(c.dq[pn][4 * n + 2 * i] * p.scale,
                        c.dq[pn][4 * n + 2 * i + 1] * p.scale);
      }
    }
}

// 1. LSE in log2 units and D = sum_c dO_ic O_ic of every row, into (B, H,
// 2, sq_pad) with the rows past Sq zero (the dK/dV ring copies whole
// slices): D / 8 threads per row, one 16-byte load of O and of dO each.
template <int D>
__global__ void __launch_bounds__(128)
bwd_rows_wgmma(const __nv_bfloat16* __restrict__ o,
               const __nv_bfloat16* __restrict__ g, Bwd p, int sq_pad) {
  constexpr int kLanes = D / 8;               // a power of two <= 32
  const int row = blockIdx.x * (128 / kLanes) + threadIdx.x / kLanes;
  const int c = (threadIdx.x % kLanes) * 8;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  float s = 0.f, l = 0.f;
  if (row < p.Sq) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * p.o.b + row * p.o.s + (long long)h * p.o.h + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        g + b * p.g.b + row * p.g.s + (long long)h * p.g.h + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(o2[i]);
      const float2 gf = __bfloat1622float2(g2[i]);
      s = fmaf(of.x, gf.x, s);
      s = fmaf(of.y, gf.y, s);
    }
    l = p.lse[row_base(b, h, p) + row] * kLog2e;
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (threadIdx.x % kLanes == 0) {
    float* lv = p.delta + (b * p.H + h) * 2 * sq_pad;
    lv[row] = l;
    lv[sq_pad + row] = s;
  }
}

}  // namespace hopper

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
    if constexpr (D == 64 || D == 128) {
      return (int)cudaErrorInvalidValue;   // flash_attention_bwd_wgmma's
    } else {
      using T = __nv_bfloat16;
      err = launch(bwd_delta<T>, rows, 0, st, static_cast<const T*>(o),
                   static_cast<const T*>(g), p, D);
      if (err != cudaSuccess) return (int)err;
      const size_t sm_kv = (2 * kKeys + 2 * kQT) * (D + 8) * sizeof(T) +
                           2 * kQT * sizeof(float);
      err = launch(bwd_dkdv_bf16<D>, dim3((p.Sk + kKeys - 1) / kKeys, K, B),
                   sm_kv, st, static_cast<const T*>(q),
                   static_cast<const T*>(k), static_cast<const T*>(v),
                   static_cast<const T*>(g), static_cast<T*>(dk),
                   static_cast<T*>(dv), p);
      if (err != cudaSuccess) return (int)err;
      const size_t sm_q = 2 * kKT * (D + 8) * sizeof(T);
      err = launch(bwd_dq_bf16<D>,
                   dim3((p.Sq + kQRows - 1) / kQRows, p.H, B), sm_q, st,
                   static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<const T*>(g),
                   static_cast<T*>(dq), p);
      return (int)err;
    }
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

template <int D>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* o, const void* g, void* dq, void* dk,
                     void* dv, int B, int K, const Bwd& p, cudaStream_t st) {
  using KL = hopper::KvSmem<D>;
  using QL = hopper::QSmem<D>;
  constexpr int BQ = KL::kBQ;
  const int sq_pad = (p.Sq + hopper::kPad - 1) / hopper::kPad * hopper::kPad;
  const int nkb = (p.Sk + hopper::kBlock - 1) / hopper::kBlock;
  const int nqb = sq_pad / hopper::kBlock;
  CUtensorMap mq, mg, mk, mv, mq64, mg64;
  if (nkb > 65535 || nqb > 65535 || B > 65535 || K > 65535 ||
      !encode_map(&mq, q, D, p.H, p.Sq, B, p.q, BQ) ||
      !encode_map(&mg, g, D, p.H, p.Sq, B, p.g, BQ) ||
      !encode_map(&mk, k, D, K, p.Sk, B, p.k, hopper::kRows) ||
      !encode_map(&mv, v, D, K, p.Sk, B, p.v, hopper::kRows) ||
      !encode_map(&mq64, q, D, p.H, p.Sq, B, p.q, hopper::kRows) ||
      !encode_map(&mg64, g, D, p.H, p.Sq, B, p.g, hopper::kRows))
    return (int)cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  hopper::bwd_rows_wgmma<D><<<dim3(sq_pad / (128 / (D / 8)), p.H, B), 128,
                              0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(g), p, sq_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(hopper::bwd_dkdv_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KL::kAlloc);
  if (err != cudaSuccess) return (int)err;
  hopper::bwd_dkdv_wgmma<D><<<dim3(K, B, nkb), hopper::kThreads, KL::kAlloc,
                              st>>>(mq, mg, mk, mv, static_cast<T*>(dk),
                                    static_cast<T*>(dv), p, sq_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(hopper::bwd_dq_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             QL::kAlloc);
  if (err != cudaSuccess) return (int)err;
  hopper::bwd_dq_wgmma<D><<<dim3(p.H, B, nqb), hopper::kThreads, QL::kAlloc,
                            st>>>(mq64, mg64, mk, mv, static_cast<T*>(dq), p,
                                  sq_pad);
  return (int)cudaGetLastError();
}

Bwd make_bwd(int Sq, int Sk, int H, int K, int d, int causal, int window,
             int k_offset, const long long* st, const void* lse,
             void* delta) {
  Bwd p;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.rep = H / K;
  p.causal = causal;
  p.window = window;
  p.scale = (float)(1.0 / sqrt((double)d));
  p.scale_log2 = (float)(1.4426950408889634 / sqrt((double)d));
  Strides* all[8] = {&p.q, &p.k, &p.v, &p.o, &p.g, &p.dq, &p.dk, &p.dv};
  for (int i = 0; i < 8; ++i)
    *all[i] = {st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.k_offset = k_offset;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for every tensor but lse and delta
// (fp32). q, dq (B, Sq, H, d); k, v, dk, dv (B, Sk, K, d); o, dO (B, Sq, H,
// d); lse and delta (B, H, Sq) contiguous, lse from K7's forward, delta
// scratch. Strides in elements, (batch, seq, head) for each of q, k, v,
// o, dO, dq, dk, dv (the d stride is 1; in bf16 the q, k, v and dO row
// strides multiples of 8 and their pointers 16-byte aligned, for the
// cp.async staging). d in {16, 32, ..., 128}, but bfloat16 at d 64 and
// 128 is refused: flash_attention_bwd_wgmma serves it. H % K == 0.
// k_offset >= 0: the position of key 0 (K7's).
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
    int k_offset, void* stream) {
  const long long st3[24] = {qsb,  qss,  qsh,  ksb,  kss,  ksh,  vsb,  vss,
                             vsh,  osb,  oss,  osh,  gsb,  gss,  gsh,  dqsb,
                             dqss, dqsh, dksb, dkss, dksh, dvsb, dvss, dvsh};
  const Bwd p = make_bwd(Sq, Sk, H, K, d, causal, window, k_offset, st3, lse,
                         delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || k_offset < 0)
    return (int)cudaErrorInvalidValue;
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

// The Hopper design (TMA rings, wgmma, warp-specialised): bfloat16 (dtype
// 1) at d 64 or 128 only; the same arguments as flash_attention_bwd, but
// `delta` is (B, H, 2, Sq rounded up to 128) fp32 scratch: each row's LSE
// in log2 units, then D, the rows past Sq zero. The q, k, v, o and dO
// strides multiples of 8 elements and their pointers 16-byte aligned (TMA).
extern "C" int flash_attention_bwd_wgmma(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int K, int d, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, long long gsb,
    long long gss, long long gsh, long long dqsb, long long dqss,
    long long dqsh, long long dksb, long long dkss, long long dksh,
    long long dvsb, long long dvss, long long dvsh, int causal, int window,
    int k_offset, void* stream) {
  const long long st3[24] = {qsb,  qss,  qsh,  ksb,  kss,  ksh,  vsb,  vss,
                             vsh,  osb,  oss,  osh,  gsb,  gss,  gsh,  dqsb,
                             dqss, dqsh, dksb, dkss, dksh, dvsb, dvss, dvsh};
  const Bwd p = make_bwd(Sq, Sk, H, K, d, causal, window, k_offset, st3, lse,
                         delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1 || k_offset < 0) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return launch_bwd_wgmma<64>(q, k, v, o, dout, dq, dk, dv, B, K, p, st);
  if (d == 128)
    return launch_bwd_wgmma<128>(q, k, v, o, dout, dq, dk, dv, B, K, p, st);
  return (int)cudaErrorInvalidValue;
}
