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
//   * K4 (the pass of every recorded step), K5 (the jump blend) and K6 (the
//     full Gram) size their grid to the card: CTAS_PER_SM CTAs per SM over
//     all systems (gram_row.py, combine.py, gram.py), each striding over
//     its system's lanes, so the grid is one wave and K4's and K6's CTAs
//     pay their reduction tail once.
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
//   * K6 sums gram.cuh's register outer product over its units, each row
//     read once (row 0 is also the anchor). Where 16-byte loads are
//     allowed, its unit is 16 or 8 bytes by gram.cuh's GramLoads.
//   * Consecutive threads read consecutive lanes of each row, so every row
//     read is coalesced.
//   * K4 and K6 write one partial per CTA (m floats, or the m (m + 1) / 2
//     triangle), summed per system in CTA order in the same launch by the
//     system's last CTA (picked by an integer ticket, which it resets). No
//     fp32 atomics: repeat launches are bit-identical and integer data is
//     exact.
//   * The anchor (row 0) is subtracted in registers, never as a second pass
//     over device memory.
//   * Ragged leaves (n = 40, 200, 240, 2670 at the paper MLP) are handled
//     by guarding l < n; nothing is padded.
//   * bf16 buffers are upcast per element; all sums are fp32 (IEEE, no
//     TF32).
// Each launcher returns cudaGetLastError(); the Python wrapper raises if it
// is not 0. Launches go to the caller's stream and do not synchronise.

#include "gram.cuh"

namespace {

constexpr int kMaxM = 32;
constexpr int kThreads = 256;                        // K5
constexpr int kRowThreads = 256;                     // K4

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

// K6's units of one system: CTA c of G takes the chunks of kGramThreads
// units c, c + G, ...; thread tg of T takes units tg, tg + T, ... of each.
template <typename T>
struct ChunkUnits {
  const T* xs;                                // row 0 of the system
  long long rs;
  int n;                                      // lanes

  struct Cursor {
    const T* xs;
    long long row_stride, u0, stride;
    int units, tg, nthr, i;
    __device__ bool ok() const { return u0 + i < units; }
    __device__ const T* base() const { return xs; }
    __device__ long long rs() const { return row_stride; }
    __device__ long long unit() const { return u0 + i; }
    __device__ void next() {
      i += nthr;
      if (i >= kGramThreads) {
        i = tg;
        u0 += stride;
      }
    }
  };
  template <int P>
  __device__ Cursor start(int tg, int nthr) const {
    return {xs, rs, (long long)blockIdx.x * kGramThreads,
            (long long)gridDim.x * kGramThreads, n / P, tg, nthr, tg};
  }
};

// K6: out[s] = D D^T over system s's lanes, D = x minus row 0 when
// anchored, one launch on K4's grid (gram.py grid, CTAS_PER_SM per SM over
// all systems): CTA (c, s) takes the units of ChunkUnits, and gram.cuh's
// gram_cta sums their register outer product. A system of one CTA is
// written at once, mirrored; otherwise each CTA writes its triangle (m (m +
// 1) / 2 floats) to part[s, c] and the system's last CTA (an integer
// ticket, which it resets) sums them in CTA order and writes the system.
template <typename T, int MMAX, bool VEC>
__global__ void __launch_bounds__(kGramThreads, 1)
gram_flat(const T* __restrict__ x, long long rs, long long ss,
          float* __restrict__ part, unsigned* __restrict__ tickets,
          float* __restrict__ out, int m, int n, int anchor_first) {
  const long long s = blockIdx.y;
  const int G = gridDim.x;
  const int nt = tri_size(m);
  __shared__ GramSmem<MMAX> sh;
  const ChunkUnits<T> units{x + s * ss, rs, n};
  gram_cta<T, VEC, MMAX>(units, m, anchor_first, sh);
  float* os = out + s * m * m;
  if (G == 1) {
    write_gram(os, sh.tri, m);
    return;
  }
  float* ps = part + s * G * nt;              // this system's partials
  for (int i = threadIdx.x; i < nt; i += kGramThreads)
    ps[(long long)blockIdx.x * nt + i] = sh.tri[i];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    sh.last[0] = atomicAdd(tickets + s, 1u) == (unsigned)(G - 1);
  __syncthreads();
  if (!sh.last[0]) return;
  __threadfence();
  sum_partials(ps, nt, G, nt, sh);
  write_gram(os, sh.tri, m);
  if (threadIdx.x == 0) tickets[s] = 0;
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

template <typename T, bool VEC>
void launch_gram(const void* x, long long rs, long long ss, void* part,
                 void* tickets, void* out, int m, int n, int S, int ctas,
                 int anchor_first, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  float* pt = static_cast<float*>(part);
  unsigned* tk = static_cast<unsigned*>(tickets);
  float* ot = static_cast<float*>(out);
  const dim3 grid(ctas, S);
  if (m <= 8) {
    gram_flat<T, 8, VEC><<<grid, kGramThreads, 0, st>>>(xt, rs, ss, pt, tk, ot, m, n, anchor_first);
  } else if (m <= 16) {
    gram_flat<T, 16, VEC><<<grid, kGramThreads, 0, st>>>(xt, rs, ss, pt, tk, ot, m, n, anchor_first);
  } else {
    gram_flat<T, kMaxM, VEC><<<grid, kGramThreads, 0, st>>>(xt, rs, ss, pt, tk, ot, m, n, anchor_first);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The wrapper has checked every shape,
// stride, type and pointer: 1 <= m <= 32, n, S >= 1, S <= 65535. K4:
// `ctas` CTAs per system, `part` holds S * ctas partials of m floats,
// `tickets` S zero integers (left zero again); the query is row `qslot`
// of x (q unused) when qslot >= 0; vec = 1 only where every row of x and
// q starts 16-byte aligned and n is whole 16-byte units. K5: `ctas` CTAs
// per system, vec as for K4 (x alone; out is (S, n) contiguous fp32). K6:
// `ctas` CTAs per system, `part` holds S * ctas partial triangles of m (m +
// 1) / 2 floats, `tickets` S zero integers (left zero again), vec as for
// K5.
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
                         void* part, void* tickets, void* out, int m, int n,
                         int S, int ctas, int vec, int anchor_first,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec) {
    launch_gram<float, true>(x, rs, ss, part, tickets, out, m, n, S, ctas, anchor_first, st);
  } else if (dtype == 0) {
    launch_gram<float, false>(x, rs, ss, part, tickets, out, m, n, S, ctas, anchor_first, st);
  } else if (vec) {
    launch_gram<__nv_bfloat16, true>(x, rs, ss, part, tickets, out, m, n, S, ctas, anchor_first, st);
  } else {
    launch_gram<__nv_bfloat16, false>(x, rs, ss, part, tickets, out, m, n, S, ctas, anchor_first, st);
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
