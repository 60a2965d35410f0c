// Segmented DMD data passes over a block-major arena, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of the reference's
// src/repro/kernels/arena.py:
//   K1 gram_row_pallas (body _row_kernel)      -> arena_gram_row
//   K2 combine_pallas  (body _combine_kernel)  -> arena_combine
//   K3 gram_pallas     (body _gram_kernel)     -> arena_gram
//
// Layout. The snapshot ring buffer x is (nb, m, bn): nb blocks of bn lanes,
// each block holding its m snapshot rows contiguously. block_sys (nb,) maps
// each block to its DMD system and is sorted, so system s owns the
// contiguous block range [sys_off[s], sys_off[s+1]).
//
// What bounds these passes on an H100: bytes. Each reads the whole buffer
// once (161.5 MB at the paper's MLP) and does 2 to 2m flops per element
// read, far below the card's flop-per-byte balance. The design therefore
// reads every element once, coalesced, and keeps everything else on chip:
//   * The TPU kernels accumulate into an output tile that the sequential
//     grid revisits. Hopper's grid is parallel, and one CTA per system would
//     leave most SMs idle (the paper MLP's systems own 1 to 5215 blocks).
//     So the reductions run in two deterministic passes: pass 1 has one CTA
//     per block and writes a per-block partial (m or m*m floats, small next
//     to the block); pass 2 has one CTA per system and sums its contiguous
//     partials in a fixed order. No atomics: results are bit-identical from
//     run to run.
//   * Anchoring (x_j - x_0) happens in registers (K1) or shared memory (K3),
//     never as a second pass over device memory.
//   * bf16 buffers are upcast per element; all sums are fp32 (IEEE, no TF32).
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
constexpr int kRowThreads = 128;
constexpr int kSegThreads = 1024;
constexpr int kGramThreads = 256;
constexpr int kGramTile = 256;                       // lanes staged per chunk
constexpr int kGramMaxPairs =                        // upper-triangle (j, k)
    (kMaxM * (kMaxM + 1) / 2 + kGramThreads - 1) / kGramThreads;  // per thread
constexpr int kCombineThreads = 128;

// K1 pass 1: part[i, j] = <q_i - x_i0, x_ij - x_i0> over block i's lanes
// (x_i0 := 0 without the anchor). MMAX >= m keeps the m running sums in
// registers; rows j >= m stay zero and are never written.
template <typename T, int MMAX>
__global__ void __launch_bounds__(kRowThreads)
gram_row_part(const T* __restrict__ x, const T* __restrict__ q,
              long long q_stride, float* __restrict__ part, int m, int bn,
              int anchor_first) {
  const long long i = blockIdx.x;
  const T* xi = x + i * m * bn;
  const T* qi = q + i * q_stride;
  float acc[MMAX];
#pragma unroll
  for (int j = 0; j < MMAX; ++j) acc[j] = 0.f;
  for (int l = threadIdx.x; l < bn; l += kRowThreads) {
    const float x0 = anchor_first ? to_f32(xi[l]) : 0.f;
    const float qa = to_f32(qi[l]) - x0;
#pragma unroll
    for (int j = 0; j < MMAX; ++j) {
      if (j < m) {
        acc[j] = fmaf(qa, to_f32(xi[(long long)j * bn + l]) - x0, acc[j]);
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
  if (threadIdx.x < m) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kRowThreads / 32; ++w) s += red[w][threadIdx.x];
    part[i * m + threadIdx.x] = s;
  }
}

// Pass 2 of K1 and K3: out[s, c] = sum over blocks b of system s of
// part[b, c], for c < width (width = m or m*m, at most kSegThreads).
// Thread t = r * width + c owns column c of the rows b0 + r, b0 + r +
// stripes, ...: every step of the loop reads one contiguous run of
// stripes * width floats, and the stripes are summed in a fixed order.
__global__ void __launch_bounds__(kSegThreads)
seg_sum(const float* __restrict__ part, const int* __restrict__ sys_off,
        float* __restrict__ out, int width) {
  const int s = blockIdx.x;
  const long long b0 = sys_off[s];
  const long long b1 = sys_off[s + 1];
  const int stripes = kSegThreads / width;
  const int t = threadIdx.x;
  const int r = t / width;
  const int c = t - r * width;
  __shared__ float red[kSegThreads];
  float acc = 0.f;
  if (r < stripes) {
    for (long long b = b0 + r; b < b1; b += stripes) acc += part[b * width + c];
  }
  red[t] = acc;
  __syncthreads();
  if (t < width) {
    float sum = 0.f;
    for (int k = 0; k < stripes; ++k) sum += red[k * width + t];
    out[(long long)s * width + t] = sum;
  }
}

// K3 pass 1: part[i] = D_i D_i^T for block i, D = x_i minus its anchor
// (anchor 0: none, 1: row 0, 2: the per-lane mean over the m rows). The
// block is staged through shared memory kGramTile lanes at a time and
// anchored there; each thread owns up to kGramMaxPairs entries (j <= k) of
// the upper triangle and mirrors them, so the result is exactly symmetric.
// Rows are padded to kGramTile + 1 floats: threads reading column l of
// different rows then hit different banks.
template <typename T>
__global__ void __launch_bounds__(kGramThreads)
gram_part(const T* __restrict__ x, float* __restrict__ part, int m, int bn,
          int anchor) {
  __shared__ float tile[kMaxM][kGramTile + 1];
  const long long i = blockIdx.x;
  const T* xi = x + i * m * bn;
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
  for (int l0 = 0; l0 < bn; l0 += kGramTile) {
    const int w = min(kGramTile, bn - l0);
    for (int l = threadIdx.x; l < w; l += kGramThreads) {
      float a = 0.f;
      if (anchor == 1) {
        a = to_f32(xi[l0 + l]);
      } else if (anchor == 2) {
        float sum = 0.f;
        for (int j = 0; j < m; ++j) sum += to_f32(xi[(long long)j * bn + l0 + l]);
        a = sum / (float)m;
      }
      for (int j = 0; j < m; ++j) {
        tile[j][l] = to_f32(xi[(long long)j * bn + l0 + l]) - a;
      }
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kGramMaxPairs; ++p) {
      if (threadIdx.x + p * kGramThreads < npairs) {
        const float* rj = tile[pj[p]];
        const float* rk = tile[pk[p]];
        float s = acc[p];
        for (int l = 0; l < w; ++l) s = fmaf(rj[l], rk[l], s);
        acc[p] = s;
      }
    }
    __syncthreads();
  }
  float* pi = part + i * m * m;
#pragma unroll
  for (int p = 0; p < kGramMaxPairs; ++p) {
    if (threadIdx.x + p * kGramThreads < npairs) {
      pi[pj[p] * m + pk[p]] = acc[p];
      pi[pk[p] * m + pj[p]] = acc[p];
    }
  }
}

// K2: out[i * bn + l] = sum_j c[block_sys[i], j] * x[i, j, l]. One pass,
// one CTA per block; the block's coefficient row sits in shared memory.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine(const T* __restrict__ x, const float* __restrict__ c,
        const int* __restrict__ block_sys, float* __restrict__ out, int m,
        int bn) {
  __shared__ float cs[kMaxM];
  const long long i = blockIdx.x;
  if (threadIdx.x < m) cs[threadIdx.x] = c[(long long)block_sys[i] * m + threadIdx.x];
  __syncthreads();
  const T* xi = x + i * m * bn;
  for (int l = threadIdx.x; l < bn; l += kCombineThreads) {
    float s = 0.f;
    for (int j = 0; j < m; ++j) s = fmaf(cs[j], to_f32(xi[(long long)j * bn + l]), s);
    out[i * bn + l] = s;
  }
}

template <typename T>
void launch_gram_row(const void* x, const void* q, long long q_stride,
                     void* part, const void* sys_off, void* out, int nb,
                     int m, int bn, int n_sys, int anchor_first,
                     cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* qt = static_cast<const T*>(q);
  float* pt = static_cast<float*>(part);
  if (m <= 8) {
    gram_row_part<T, 8><<<nb, kRowThreads, 0, st>>>(xt, qt, q_stride, pt, m, bn, anchor_first);
  } else if (m <= 16) {
    gram_row_part<T, 16><<<nb, kRowThreads, 0, st>>>(xt, qt, q_stride, pt, m, bn, anchor_first);
  } else {
    gram_row_part<T, kMaxM><<<nb, kRowThreads, 0, st>>>(xt, qt, q_stride, pt, m, bn, anchor_first);
  }
  seg_sum<<<n_sys, kSegThreads, 0, st>>>(
      pt, static_cast<const int*>(sys_off), static_cast<float*>(out), m);
}

template <typename T>
void launch_gram(const void* x, void* part, const void* sys_off, void* out,
                 int nb, int m, int bn, int n_sys, int anchor,
                 cudaStream_t st) {
  float* pt = static_cast<float*>(part);
  gram_part<T><<<nb, kGramThreads, 0, st>>>(static_cast<const T*>(x), pt, m, bn, anchor);
  seg_sum<<<n_sys, kSegThreads, 0, st>>>(
      pt, static_cast<const int*>(sys_off), static_cast<float*>(out), m * m);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The wrapper has checked every shape,
// type and pointer; m <= 32 and nb, n_sys >= 1.
extern "C" int arena_gram_row(int dtype, const void* x, const void* q,
                              long long q_stride, void* part,
                              const void* sys_off, void* out, int nb, int m,
                              int bn, int n_sys, int anchor_first,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_gram_row<float>(x, q, q_stride, part, sys_off, out, nb, m, bn, n_sys, anchor_first, st);
  } else {
    launch_gram_row<__nv_bfloat16>(x, q, q_stride, part, sys_off, out, nb, m, bn, n_sys, anchor_first, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int arena_gram(int dtype, const void* x, void* part,
                          const void* sys_off, void* out, int nb, int m,
                          int bn, int n_sys, int anchor, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_gram<float>(x, part, sys_off, out, nb, m, bn, n_sys, anchor, st);
  } else {
    launch_gram<__nv_bfloat16>(x, part, sys_off, out, nb, m, bn, n_sys, anchor, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int arena_combine(int dtype, const void* x, const void* c,
                             const void* block_sys, void* out, int nb, int m,
                             int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    combine<float><<<nb, kCombineThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(c),
        static_cast<const int*>(block_sys), static_cast<float*>(out), m, bn);
  } else {
    combine<__nv_bfloat16><<<nb, kCombineThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(c),
        static_cast<const int*>(block_sys), static_cast<float*>(out), m, bn);
  }
  return static_cast<int>(cudaGetLastError());
}
