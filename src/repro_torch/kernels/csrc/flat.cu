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
//   * n is split into chunks of `chunk` lanes, one CTA per (chunk, system):
//     the largest leaf has 2.67M lanes, and one CTA per system would leave
//     most of the 132 SMs idle. Consecutive threads read consecutive lanes
//     of each row, so every row read is coalesced.
//   * K4 and K6 write one partial per chunk (m or m*m floats), and a second
//     pass sums each system's partials in a fixed order. No atomics: repeat
//     launches are bit-identical and integer data is exact.
//   * The anchor (row 0) is subtracted in registers (K4) or shared memory
//     (K6), never as a second pass over device memory.
//   * Ragged leaves (n = 40, 200, 240, 2670 at the paper MLP) are handled
//     by guarding l < n; nothing is padded.
//   * bf16 buffers are upcast per element; all sums are fp32 (IEEE, no
//     TF32).
// Each launcher returns cudaGetLastError(); the Python wrapper raises if it
// is not 0. Launches go to the caller's stream and do not synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int kMaxM = 32;
constexpr int kThreads = 256;                        // K4, K5 pass 1
constexpr int kSumThreads = 1024;                    // pass 2
constexpr int kGramThreads = 256;                    // K6 pass 1
constexpr int kGramTile = 256;                       // lanes staged per step
constexpr int kGramMaxPairs =                        // upper-triangle (j, k)
    (kMaxM * (kMaxM + 1) / 2 + kGramThreads - 1) / kGramThreads;  // per thread

// K4 pass 1: part[s, c, j] = <q_s - x_0s, x_js - x_0s> over chunk c of
// system s (x_0s := 0 without the anchor). MMAX >= m keeps the m running
// sums in registers; rows j >= m are never read or written.
template <typename T, int MMAX>
__global__ void __launch_bounds__(kThreads)
row_part(const T* __restrict__ x, long long rs, long long ss,
         const T* __restrict__ q, long long qs, float* __restrict__ part,
         int m, int n, int chunk, int anchor_first) {
  const int c = blockIdx.x;
  const long long s = blockIdx.y;
  const T* xs = x + s * ss;
  const T* qq = q + s * qs;
  const int l1 = min(n, (c + 1) * chunk);
  float acc[MMAX];
#pragma unroll
  for (int j = 0; j < MMAX; ++j) acc[j] = 0.f;
  for (int l = c * chunk + threadIdx.x; l < l1; l += kThreads) {
    const float x0 = anchor_first ? to_f32(xs[l]) : 0.f;
    const float qa = to_f32(qq[l]) - x0;
#pragma unroll
    for (int j = 0; j < MMAX; ++j) {
      if (j < m) acc[j] = fmaf(qa, to_f32(xs[j * rs + l]) - x0, acc[j]);
    }
  }
  __shared__ float red[kThreads / 32][MMAX];
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
  if (threadIdx.x < m) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += red[w][threadIdx.x];
    part[(s * gridDim.x + c) * m + threadIdx.x] = sum;
  }
}

// Pass 2 of K4 and K6: out[s, w] = sum over the nc chunks of system s of
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

// K5: out[s, l] = sum_j c[s, j] * x[j, s, l], one pass, the system's
// coefficient row in shared memory, the rows summed in order j = 0..m-1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_flat(const T* __restrict__ x, long long rs, long long ss,
             const float* __restrict__ c, float* __restrict__ out, int m,
             int n, int chunk) {
  __shared__ float cs[kMaxM];
  const long long s = blockIdx.y;
  if (threadIdx.x < m) cs[threadIdx.x] = c[s * m + threadIdx.x];
  __syncthreads();
  const T* xs = x + s * ss;
  const int l1 = min(n, (int)(blockIdx.x + 1) * chunk);
  for (int l = blockIdx.x * chunk + threadIdx.x; l < l1; l += kThreads) {
    float sum = 0.f;
    for (int j = 0; j < m; ++j) sum = fmaf(cs[j], to_f32(xs[j * rs + l]), sum);
    out[s * n + l] = sum;
  }
}

inline int n_chunks(int n, int chunk) { return (n + chunk - 1) / chunk; }

template <typename T>
void launch_gram_row(const void* x, long long rs, long long ss, const void* q,
                     long long qs, void* part, void* out, int m, int n, int S,
                     int chunk, int anchor_first, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* qt = static_cast<const T*>(q);
  float* pt = static_cast<float*>(part);
  const int nc = n_chunks(n, chunk);
  const dim3 grid(nc, S);
  if (m <= 8) {
    row_part<T, 8><<<grid, kThreads, 0, st>>>(xt, rs, ss, qt, qs, pt, m, n, chunk, anchor_first);
  } else if (m <= 16) {
    row_part<T, 16><<<grid, kThreads, 0, st>>>(xt, rs, ss, qt, qs, pt, m, n, chunk, anchor_first);
  } else {
    row_part<T, kMaxM><<<grid, kThreads, 0, st>>>(xt, rs, ss, qt, qs, pt, m, n, chunk, anchor_first);
  }
  chunk_sum<<<S, kSumThreads, 0, st>>>(pt, static_cast<float*>(out), nc, m);
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
// stride, type and pointer: 1 <= m <= 32, n, S >= 1, S <= 65535, and `part`
// holds S * ceil(n / chunk) partials of m (K4) or m * m (K6) floats.
extern "C" int flat_gram_row(int dtype, const void* x, long long rs,
                             long long ss, const void* q, long long qs,
                             void* part, void* out, int m, int n, int S,
                             int chunk, int anchor_first, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_gram_row<float>(x, rs, ss, q, qs, part, out, m, n, S, chunk, anchor_first, st);
  } else {
    launch_gram_row<__nv_bfloat16>(x, rs, ss, q, qs, part, out, m, n, S, chunk, anchor_first, st);
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
                            int n, int S, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_chunks(n, chunk), S);
  if (dtype == 0) {
    combine_flat<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), rs, ss, static_cast<const float*>(c),
        static_cast<float*>(out), m, n, chunk);
  } else {
    combine_flat<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), rs, ss,
        static_cast<const float*>(c), static_cast<float*>(out), m, n, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
