// Per-leaf (flat) DMD data passes over a snapshot ring buffer, for Hopper
// (sm_90a).
//
// Replaces the three Pallas TPU kernels of the reference's per-leaf route:
//   K4 src/repro/kernels/gram_row.py gram_row_pallas (_gram_row_kernel)
//        -> flat_gram_row
//   K5 src/repro/kernels/combine.py  combine_pallas  (_combine_kernel)
//        -> flat_combine
//   K6 src/repro/kernels/gram.py     gram_pallas     (_gram_kernel)
//        -> flat_gram
//
// Layout. A per-leaf buffer is (m, S, n): m snapshot rows of S stacked
// systems (S = 1 for an unstacked leaf) of n lanes each, read where it lies:
// lane stride 1, system stride ss and row stride rs in elements (for a
// contiguous (m, S, n) buffer ss = n and rs = S * n). The snapshot axis
// leads, so this is NOT the block-major (nb, m, bn) arena layout of
// arena.cu, and no copy into that layout is made.
//
// What bounds these passes on an H100: bytes. Each reads the buffer once
// (149.5 MB for the paper MLP's largest leaf) and does 2 to 2m flops per
// element read. The design:
//   * K4 (the pass of every recorded step) and K5 (the jump blend) size
//     their grid to the card: CTAS_PER_SM CTAs per SM over all systems
//     (gram_row.py, combine.py), each striding over its system's lanes, so
//     the grid is one wave and K4's CTAs pay their reduction tail once.
//   * Loads (lanes.cuh): where every row starts 16-byte aligned and n is
//     whole 16-byte units (the wrapper decides per call: /l3/w does, the
//     ragged n = 2670 leaf does not) a thread reads 16 bytes per row per
//     step (4 fp32 or 8 bf16 lanes), else one lane. The 16-byte loads skip
//     L1 and ask L2 to fetch the 256 bytes around them (the next lanes of
//     the same row). MMAX >= m is a template argument, so all m row loads
//     of a step are in flight before the first FMA.
//   * K4 reads each of the m rows once: the anchor (row 0) once, its own
//     term (zero) skipped, and the query once when it is the buffer's own
//     slot, as it always is on the main path.
//   * K5 keeps its system's m coefficients in registers, sums the rows in
//     order j = 0..m-1 and writes its output with streaming stores: the
//     host's write-back is the next reader.
//   * K6 splits n into chunks of `chunk` lanes, one CTA per (chunk,
//     system): the largest leaf has 2.67M lanes, and one CTA per system
//     would leave most of the 132 SMs idle.
//   * Consecutive threads read consecutive lanes of each row, so every row
//     read is coalesced.
//   * K4 and K6 write one partial per CTA (m or m*m floats), summed per
//     system in a fixed order: K4 in the same launch, by the system's last
//     CTA (picked by an integer ticket), K6 by a second pass. No fp32
//     atomics: repeat launches are bit-identical and integer data is exact.
//   * The anchor (row 0) is subtracted in registers (K4) or shared memory
//     (K6), never as a second pass over device memory.
//   * Ragged leaves (n = 40, 200, 240, 2670 at the paper MLP) are handled
//     by guarding l < n; nothing is padded.
//   * bf16 buffers are upcast per element; all sums are fp32 (IEEE, no
//     TF32).
// Left for later: K6 on K4's grid and loads (it is at a third of its bound).
// Each launcher returns cudaGetLastError(); the Python wrapper raises if it
// is not 0. Launches go to the caller's stream and do not synchronise.

#include "lanes.cuh"

namespace {

constexpr int kMaxM = 32;
constexpr int kThreads = 256;                        // K5
constexpr int kRowThreads = 256;                     // K4 pass 1
constexpr int kSumThreads = 1024;                    // pass 2
constexpr int kGramThreads = 256;                    // K6 pass 1
constexpr int kGramTile = 256;                       // lanes staged per step
constexpr int kGramMaxPairs =                        // upper-triangle (j, k)
    (kMaxM * (kMaxM + 1) / 2 + kGramThreads - 1) / kGramThreads;  // per thread

// K4: out[s, j] = <q_s - x_0s, x_js - x_0s>, one launch; x_0s := 0
// without the anchor. CTA c of system s first writes part[s, c, j], its
// sum over the units it strides over (u = c * kRowThreads + tid, then
// + gridDim.x * kRowThreads; a unit is Lanes::kPer lanes). The query is row `qslot` of x when qslot >= 0, else q. MMAX >= m
// keeps the m running sums in registers; rows j >= m are never read or
// written. Each thread sums its units in order, then the CTA's threads in
// a fixed tree: the result does not depend on timing.
template <typename T, int MMAX, bool VEC>
__global__ void __launch_bounds__(kRowThreads)
row_part(const T* __restrict__ x, long long rs, long long ss,
         const T* __restrict__ q, long long qs, int qslot,
         float* __restrict__ part, unsigned* __restrict__ tickets,
         float* __restrict__ out, int m, int units, int anchor_first) {
  using Ln = Lanes<T, VEC>;
  constexpr int P = Ln::kPer;
  const long long s = blockIdx.y;
  const T* xs = x + s * ss;
  const T* qq = qslot >= 0 ? xs + qslot * rs : q + s * qs;
  const int skip = anchor_first ? 0 : -1;     // row whose term is 0
  float acc[MMAX];
#pragma unroll
  for (int j = 0; j < MMAX; ++j) acc[j] = 0.f;
  for (int u = blockIdx.x * kRowThreads + threadIdx.x; u < units;
       u += gridDim.x * kRowThreads) {
    // every load of the step first: the anchor, the query, the other rows
    typename Ln::Raw r0{}, rq, rows[MMAX];
    if (anchor_first) r0 = Ln::load(xs, u);
    rq = (anchor_first && qslot == 0) ? r0 : Ln::load(qq, u);
#pragma unroll
    for (int j = 0; j < MMAX; ++j)
      if (j < m && j != skip && j != qslot) rows[j] = Ln::load(xs + j * rs, u);
    float x0[P], qa[P];
    Ln::unpack(r0, x0);
    Ln::unpack(rq, qa);
#pragma unroll
    for (int e = 0; e < P; ++e) qa[e] -= x0[e];
#pragma unroll
    for (int j = 0; j < MMAX; ++j) {
      if (j < m && j != skip) {
        float xj[P];
        Ln::unpack(j == qslot ? rq : rows[j], xj);
#pragma unroll
        for (int e = 0; e < P; ++e) acc[j] = fmaf(qa[e], xj[e] - x0[e], acc[j]);
      }
    }
  }
  __shared__ float red[kRowThreads / 32][MMAX];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < MMAX; ++j) {
    float v = acc[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  float* ps = part + s * gridDim.x * m;       // this system's partials
  if (threadIdx.x < m) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kRowThreads / 32; ++w) sum += red[w][threadIdx.x];
    ps[blockIdx.x * m + threadIdx.x] = sum;
  }

  // The system's last CTA to finish (an integer ticket, which it resets
  // for the next launch) sums the partials in CTA order: thread t = r * m
  // + j owns column j of CTAs r, r + stripes, ...; the stripes are then
  // summed in order. No fp32 atomics: the result does not depend on which
  // CTA came last.
  __shared__ int last;
  __shared__ float stripe[kRowThreads];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tickets + s, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int stripes = kRowThreads / m;
  const int r = threadIdx.x / m;
  const int j = threadIdx.x - r * m;
  float sum = 0.f;
  if (r < stripes) {
#pragma unroll 8
    for (int c = r; c < gridDim.x; c += stripes) sum += __ldcg(ps + c * m + j);
  }
  stripe[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x < m) {
    float total = 0.f;
    for (int k = 0; k < stripes; ++k) total += stripe[k * m + threadIdx.x];
    out[s * m + threadIdx.x] = total;
  }
  if (threadIdx.x == 0) tickets[s] = 0;
}

// Pass 2 of K6: out[s, w] = sum over the nc chunks of system s of
// part[s, c, w], for w < width (width = m or m*m, at most kSumThreads).
// Thread t = r * width + w owns column w of chunks r, r + stripes, ...; the
// stripes are then summed in a fixed order.
__global__ void __launch_bounds__(kSumThreads)
chunk_sum(const float* __restrict__ part, float* __restrict__ out, int nc,
          int width) {
  const long long s = blockIdx.x;
  const int stripes = kSumThreads / width;
  const int t = threadIdx.x;
  const int r = t / width;
  const int w = t - r * width;
  __shared__ float red[kSumThreads];
  float acc = 0.f;
  if (r < stripes) {
    for (int c = r; c < nc; c += stripes) acc += part[(s * nc + c) * width + w];
  }
  red[t] = acc;
  __syncthreads();
  if (t < width) {
    float sum = 0.f;
    for (int k = 0; k < stripes; ++k) sum += red[k * width + t];
    out[s * width + t] = sum;
  }
}

// K6 pass 1: part[s, c] = D D^T over chunk c of system s, D = x minus row
// 0 when anchored. The chunk is staged through shared memory kGramTile lanes
// at a time and anchored there; each thread owns up to kGramMaxPairs
// entries (j <= k) of the upper triangle and mirrors them, so the result is
// exactly symmetric. Rows are padded to kGramTile + 1 floats: threads
// reading lane l of different rows then hit different banks.
template <typename T>
__global__ void __launch_bounds__(kGramThreads)
gram_part(const T* __restrict__ x, long long rs, long long ss,
          float* __restrict__ part, int m, int n, int chunk,
          int anchor_first) {
  __shared__ float tile[kMaxM][kGramTile + 1];
  const int c = blockIdx.x;
  const long long s = blockIdx.y;
  const T* xs = x + s * ss;
  const int npairs = m * (m + 1) / 2;
  int pj[kGramMaxPairs], pk[kGramMaxPairs];
  float acc[kGramMaxPairs];
#pragma unroll
  for (int p = 0; p < kGramMaxPairs; ++p) {
    acc[p] = 0.f;
    int rem = threadIdx.x + p * kGramThreads;
    int j = 0;
    if (rem < npairs) {
      while (rem >= m - j) {
        rem -= m - j;
        ++j;
      }
    } else {
      rem = 0;
    }
    pj[p] = j;
    pk[p] = j + rem;
  }
  const int l1 = min(n, (c + 1) * chunk);
  for (int l0 = c * chunk; l0 < l1; l0 += kGramTile) {
    const int w = min(kGramTile, l1 - l0);
    for (int l = threadIdx.x; l < w; l += kGramThreads) {
      const float a = anchor_first ? to_f32(xs[l0 + l]) : 0.f;
      for (int j = 0; j < m; ++j) tile[j][l] = to_f32(xs[j * rs + l0 + l]) - a;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kGramMaxPairs; ++p) {
      if (threadIdx.x + p * kGramThreads < npairs) {
        const float* rj = tile[pj[p]];
        const float* rk = tile[pk[p]];
        float sum = acc[p];
        for (int l = 0; l < w; ++l) sum = fmaf(rj[l], rk[l], sum);
        acc[p] = sum;
      }
    }
    __syncthreads();
  }
  float* pc = part + (s * gridDim.x + c) * m * m;
#pragma unroll
  for (int p = 0; p < kGramMaxPairs; ++p) {
    if (threadIdx.x + p * kGramThreads < npairs) {
      pc[pj[p] * m + pk[p]] = acc[p];
      pc[pk[p] * m + pj[p]] = acc[p];
    }
  }
}

// K5: out[s, l] = sum_j c[s, j] * x[j, s, l]. The grid is sized to the
// card (combine.py CTAS_PER_SM per SM over all systems): CTA (c, s) strides
// over system s's units (u = c * kThreads + tid, then + gridDim.x *
// kThreads; a unit is Lanes::kPer lanes). The system's coefficients sit in
// registers; every row load of a step is issued before the first FMA
// (MMAX >= m); the rows are summed in order j = 0..m-1, so the result does
// not depend on the grid. The output is written with streaming stores.
template <typename T, int MMAX, bool VEC>
__global__ void __launch_bounds__(kThreads)
combine_flat(const T* __restrict__ x, long long rs, long long ss,
             const float* __restrict__ c, float* __restrict__ out, int m,
             int units) {
  using Ln = Lanes<T, VEC>;
  constexpr int P = Ln::kPer;
  const long long s = blockIdx.y;
  const T* xs = x + s * ss;
  float* os = out + s * units * P;
  float cs[MMAX];
#pragma unroll
  for (int j = 0; j < MMAX; ++j) cs[j] = j < m ? __ldg(c + s * m + j) : 0.f;
  for (int u = blockIdx.x * kThreads + threadIdx.x; u < units;
       u += gridDim.x * kThreads) {
    typename Ln::Raw rows[MMAX];
#pragma unroll
    for (int j = 0; j < MMAX; ++j)
      if (j < m) rows[j] = Ln::load(xs + j * rs, u);
    float sum[P];
#pragma unroll
    for (int e = 0; e < P; ++e) sum[e] = 0.f;
#pragma unroll
    for (int j = 0; j < MMAX; ++j) {
      if (j < m) {
        float v[P];
        Ln::unpack(rows[j], v);
#pragma unroll
        for (int e = 0; e < P; ++e) sum[e] = fmaf(cs[j], v[e], sum[e]);
      }
    }
    Ln::store(os, u, sum);
  }
}

inline int n_chunks(int n, int chunk) { return (n + chunk - 1) / chunk; }

template <typename T, bool VEC>
void launch_gram_row(const void* x, long long rs, long long ss, const void* q,
                     long long qs, int qslot, void* part, void* tickets,
                     void* out, int m, int n, int S, int ctas,
                     int anchor_first, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* qt = static_cast<const T*>(q);
  float* pt = static_cast<float*>(part);
  unsigned* tk = static_cast<unsigned*>(tickets);
  float* ot = static_cast<float*>(out);
  const int units = n / Lanes<T, VEC>::kPer;
  const dim3 grid(ctas, S);
  if (m <= 8) {
    row_part<T, 8, VEC><<<grid, kRowThreads, 0, st>>>(xt, rs, ss, qt, qs, qslot, pt, tk, ot, m, units, anchor_first);
  } else if (m <= 16) {
    row_part<T, 16, VEC><<<grid, kRowThreads, 0, st>>>(xt, rs, ss, qt, qs, qslot, pt, tk, ot, m, units, anchor_first);
  } else {
    row_part<T, kMaxM, VEC><<<grid, kRowThreads, 0, st>>>(xt, rs, ss, qt, qs, qslot, pt, tk, ot, m, units, anchor_first);
  }
}

template <typename T, bool VEC>
void launch_combine(const void* x, long long rs, long long ss, const void* c,
                    void* out, int m, int n, int S, int ctas, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const float* ct = static_cast<const float*>(c);
  float* ot = static_cast<float*>(out);
  const int units = n / Lanes<T, VEC>::kPer;
  const dim3 grid(ctas, S);
  if (m <= 8) {
    combine_flat<T, 8, VEC><<<grid, kThreads, 0, st>>>(xt, rs, ss, ct, ot, m, units);
  } else if (m <= 16) {
    combine_flat<T, 16, VEC><<<grid, kThreads, 0, st>>>(xt, rs, ss, ct, ot, m, units);
  } else {
    combine_flat<T, kMaxM, VEC><<<grid, kThreads, 0, st>>>(xt, rs, ss, ct, ot, m, units);
  }
}

template <typename T>
void launch_gram(const void* x, long long rs, long long ss, void* part,
                 void* out, int m, int n, int S, int chunk, int anchor_first,
                 cudaStream_t st) {
  float* pt = static_cast<float*>(part);
  const int nc = n_chunks(n, chunk);
  gram_part<T><<<dim3(nc, S), kGramThreads, 0, st>>>(
      static_cast<const T*>(x), rs, ss, pt, m, n, chunk, anchor_first);
  chunk_sum<<<S, kSumThreads, 0, st>>>(pt, static_cast<float*>(out), nc, m * m);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The wrapper has checked every shape,
// stride, type and pointer: 1 <= m <= 32, n, S >= 1, S <= 65535. K4:
// `ctas` CTAs per system, `part` holds S * ctas partials of m floats,
// `tickets` S zero integers (left zero again); the query is row `qslot`
// of x (q unused) when qslot >= 0; vec = 1 only where every row of x and
// q starts 16-byte aligned and n is whole 16-byte units. K5: `ctas` CTAs
// per system, vec as for K4 (x alone; out is (S, n) contiguous fp32). K6:
// `part` holds S * ceil(n / chunk) partials of m * m floats.
extern "C" int flat_gram_row(int dtype, const void* x, long long rs,
                             long long ss, const void* q, long long qs,
                             int qslot, void* part, void* tickets, void* out,
                             int m, int n, int S, int ctas, int vec,
                             int anchor_first, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec) {
    launch_gram_row<float, true>(x, rs, ss, q, qs, qslot, part, tickets, out, m, n, S, ctas, anchor_first, st);
  } else if (dtype == 0) {
    launch_gram_row<float, false>(x, rs, ss, q, qs, qslot, part, tickets, out, m, n, S, ctas, anchor_first, st);
  } else if (vec) {
    launch_gram_row<__nv_bfloat16, true>(x, rs, ss, q, qs, qslot, part, tickets, out, m, n, S, ctas, anchor_first, st);
  } else {
    launch_gram_row<__nv_bfloat16, false>(x, rs, ss, q, qs, qslot, part, tickets, out, m, n, S, ctas, anchor_first, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flat_gram(int dtype, const void* x, long long rs, long long ss,
                         void* part, void* out, int m, int n, int S,
                         int chunk, int anchor_first, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_gram<float>(x, rs, ss, part, out, m, n, S, chunk, anchor_first, st);
  } else {
    launch_gram<__nv_bfloat16>(x, rs, ss, part, out, m, n, S, chunk, anchor_first, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flat_combine(int dtype, const void* x, long long rs,
                            long long ss, const void* c, void* out, int m,
                            int n, int S, int ctas, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec) {
    launch_combine<float, true>(x, rs, ss, c, out, m, n, S, ctas, st);
  } else if (dtype == 0) {
    launch_combine<float, false>(x, rs, ss, c, out, m, n, S, ctas, st);
  } else if (vec) {
    launch_combine<__nv_bfloat16, true>(x, rs, ss, c, out, m, n, S, ctas, st);
  } else {
    launch_combine<__nv_bfloat16, false>(x, rs, ss, c, out, m, n, S, ctas, st);
  }
  return static_cast<int>(cudaGetLastError());
}
