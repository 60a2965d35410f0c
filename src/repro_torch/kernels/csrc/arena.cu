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
//     No fp32 atomics: every sum runs in a fixed order, so results are
//     bit-identical from run to run and exact on integer data.
//   * K1 (the pass of every recorded step) is one launch on a grid sized to
//     the card: two CTAs per SM for m <= 16 (their registers fit; one CTA
//     streams while the other reduces), one above (arena.py grid_ctas).
//     CTA c owns the contiguous
//     block range [nb c / G, nb (c + 1) / G) and cuts it at system
//     boundaries into pieces; its threads stride over a piece's lanes, block
//     by block, and reduce once per piece, so the reduction tails are paid
//     per CTA, not per block. A system inside one range is written at once;
//     only the first and last system of a range can span CTAs, and those
//     write one partial per CTA, summed in CTA order by the last CTA to
//     finish the system (an integer ticket, one round trip per CTA). Loads are those of lanes.cuh: 16 bytes
//     a thread where the rows allow it (always, on an aligned arena: bn is a
//     multiple of 128 lanes), else one lane. Each row is read once: the
//     anchor (row 0) once with its own zero term skipped, and the query once
//     when it is a slot of the buffer, as it always is on the main path.
//   * K3 (the full Gram: the recompute path, mean-anchored buckets) is one
//     launch on the same block ranges and the same pieces, one CTA per SM
//     (arena.py gram_grid: the triangle of sums fills the registers), with
//     the same partials and tickets (an m (m + 1) / 2 triangle per (CTA,
//     system) in place of an m-vector). Each piece is summed as gram.cuh's
//     register outer product; every row is read once (the first and the
//     mean anchor come from the loaded rows), in 16- or 8-byte units by
//     gram.cuh's GramLoads.
//   * K2 runs one CTA per block.
//   * Anchoring (x_j - x_0, or x_j minus the per-lane mean) happens in
//     registers, never as a second pass over device memory.
//   * bf16 buffers are upcast per element; all sums are fp32 (IEEE, no TF32).
// Each launcher returns cudaGetLastError(); the Python wrapper raises if it
// is not 0. Launches go to the caller's stream and do not synchronise.

#include "gram.cuh"

namespace {

constexpr int kMaxM = 32;
constexpr int kRowThreads = 256;                     // K1
constexpr int kRun = 32;                             // K1: units a run
constexpr int kCombineThreads = 128;

// K1: out[s, j] = sum over the blocks i of system s of <q_i - x_i0,
// x_ij - x_i0> (x_i0 := 0 without the anchor), one launch. The query of
// block i is row `qslot` of block i when qslot >= 0, else row i of q (row
// stride qs). A unit is Lanes::kPer lanes of one row; a block row holds
// upb = bn / kPer units. MMAX >= m sizes the m running sums; rows j >= m
// are never read or written.
//
// CTA c walks the systems its block range touches. For each piece (the
// blocks of system s in its range) every thread sums its units in order
// (thread t takes unit t of the piece, then t + kRowThreads, ...; unit k is
// lane unit k % upb of block p0 + k / upb) in two levels: the products of
// kRun units in a register run, the runs in the thread's column of shared
// memory (acc). One running sum over a thread's whole range (27,648
// products on an LM's ring) lost ~u n / 2 of the row where the terms share
// a sign; the longest chain is now kRun P + n / (kRun P). A step loads its
// rows in groups of at most 8 (kLoads) and the query's own term is qa . qa:
// with all 16 rows of m = 14 in flight beside the runs, bf16 and fp32 at
// MMAX 16 spilled at the 128 registers two CTAs per SM allow. Then the CTA
// reduces in a fixed tree. A system that lies wholly in the range is then
// written to out at once. Only the first and the last system of a range
// can span several CTAs: their sums go to part[c + s] (distinct for every
// (CTA, system) pair: the systems of CTA c + 1 start at or after the last
// of CTA c), and after its last piece the CTA takes one integer ticket for
// each. The last of the cnt CTAs that touch such a system sums part[c + s]
// over them in CTA order: thread t = r * m + j owns column j of CTAs r,
// r + stripes, ...; the stripes are then summed in order. A system with no
// block gets zeros from the CTA whose range it falls in (the last CTA for
// systems past the last block).
template <typename T, int MMAX, bool VEC>
__global__ void __launch_bounds__(kRowThreads, MMAX <= 16 ? 2 : 1)
arena_row(const T* __restrict__ x, const T* __restrict__ q, long long qs,
          int qslot, const int* __restrict__ block_sys,
          const int* __restrict__ sys_off, float* __restrict__ part,
          unsigned* __restrict__ tickets, float* __restrict__ out, int nb,
          int m, int bn, int n_sys, int anchor_first) {
  using Ln = Lanes<T, VEC>;
  constexpr int P = Ln::kPer;
  const int G = gridDim.x;
  const int c = blockIdx.x;
  const int b_lo = (int)((long long)nb * c / G);
  const int b_hi = (int)((long long)nb * (c + 1) / G);
  // the CTA that owns block b: the largest c' with nb * c' / G <= b
  auto cta_of = [&](long long b) {
    return (int)(((b + 1) * G + nb - 1) / nb - 1);
  };
  const int upb = bn / P;                     // units per block row
  const int step_b = kRowThreads / upb;       // blocks and units a step
  const int step_w = kRowThreads - step_b * upb;  // advances
  const long long bs = (long long)m * bn;     // block stride, elements
  const int skip = anchor_first ? 0 : -1;     // row whose term is 0
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __shared__ float red[kRowThreads / 32][MMAX];
  __shared__ float stripe[kRowThreads];
  __shared__ float acc[MMAX][kRowThreads];     // each thread's column
  __shared__ int last[2];

  const int s_a = block_sys[b_lo];            // may begin before the range
  const int s_b = block_sys[b_hi - 1];        // may end after it
  const int s_first = c == 0 ? 0 : min(s_a, block_sys[b_lo - 1] + 1);
  const int s_last = c == G - 1 ? n_sys - 1 : s_b;
  for (int s = s_first; s <= s_last; ++s) {
    const int o0 = sys_off[s];
    const int o1 = sys_off[s + 1];
    if (o0 == o1) {                           // a system with no block
      if (threadIdx.x < m) out[(long long)s * m + threadIdx.x] = 0.f;
      continue;
    }
    const int p0 = max(b_lo, o0);
    const int p1 = min(b_hi, o1);
    float run[MMAX];
#pragma unroll
    for (int j = 0; j < MMAX; ++j) acc[j][threadIdx.x] = run[j] = 0.f;
    int blk = p0 + threadIdx.x / upb;
    int w = threadIdx.x - (threadIdx.x / upb) * upb;
    int n_run = 0;
    while (blk < p1) {
      // the anchor and the query first, then the other rows kLoads at a time
      const T* xb = x + blk * bs;
      const T* qq = qslot >= 0 ? xb + qslot * bn : q + blk * qs;
      typename Ln::Raw r0{}, rq;
      if (anchor_first) r0 = Ln::load(xb, w);
      rq = (anchor_first && qslot == 0) ? r0 : Ln::load(qq, w);
      float x0[P], qa[P];
      Ln::unpack(r0, x0);
      Ln::unpack(rq, qa);
#pragma unroll
      for (int e = 0; e < P; ++e) qa[e] -= x0[e];
      constexpr int kLoads = MMAX < 8 ? MMAX : 8;   // rows in flight
#pragma unroll
      for (int h = 0; h < MMAX; h += kLoads) {
        typename Ln::Raw rows[kLoads];
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int j = h + i;
          if (j < m && j != skip && j != qslot) rows[i] = Ln::load(xb + j * bn, w);
        }
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int j = h + i;
          if (j < m && j != skip) {
            if (j == qslot) {                   // x_q - x_0 is qa
#pragma unroll
              for (int e = 0; e < P; ++e) run[j] = fmaf(qa[e], qa[e], run[j]);
            } else {
              float xj[P];
              Ln::unpack(rows[i], xj);
#pragma unroll
              for (int e = 0; e < P; ++e) run[j] = fmaf(qa[e], xj[e] - x0[e], run[j]);
            }
          }
        }
      }
      if (++n_run == kRun) {
#pragma unroll
        for (int j = 0; j < MMAX; ++j) {
          acc[j][threadIdx.x] += run[j];
          run[j] = 0.f;
        }
        n_run = 0;
      }
      blk += step_b;
      w += step_w;
      if (w >= upb) {
        w -= upb;
        ++blk;
      }
    }
#pragma unroll
    for (int j = 0; j < MMAX; ++j) {
      float v = acc[j][threadIdx.x] + run[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp][j] = v;
    }
    __syncthreads();
    if (threadIdx.x < m) {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kRowThreads / 32; ++k) sum += red[k][threadIdx.x];
      const bool whole = o0 >= b_lo && o1 <= b_hi;
      (whole ? out[(long long)s * m + threadIdx.x]
             : part[(long long)(c + s) * m + threadIdx.x]) = sum;
    }
    __syncthreads();                          // red is reused
  }

  // The systems that span CTAs: one ticket each, then the sums of those
  // this CTA finished last. No fp32 atomics: the result does not depend on
  // which CTA came last.
  __threadfence();
  __syncthreads();
  if (threadIdx.x < 2) {
    const int s = threadIdx.x ? s_b : s_a;
    const int o0 = sys_off[s];
    const int o1 = sys_off[s + 1];
    const int cnt = cta_of(o1 - 1) - cta_of(o0) + 1;
    const bool mine = threadIdx.x == 0 || s_b != s_a;
    last[threadIdx.x] = mine && cnt > 1 &&
        atomicAdd(tickets + s, 1u) == (unsigned)(cnt - 1);
  }
  __syncthreads();
  for (int k = 0; k < 2; ++k) {
    if (!last[k]) continue;
    __threadfence();
    const int s = k ? s_b : s_a;
    const int c0 = cta_of(sys_off[s]);
    const int cnt = cta_of(sys_off[s + 1] - 1) - c0 + 1;
    const int stripes = kRowThreads / m;
    const int r = threadIdx.x / m;
    const int j = threadIdx.x - r * m;
    float sum = 0.f;
    if (r < stripes) {
#pragma unroll 4
      for (int i = r; i < cnt; i += stripes)
        sum += __ldcg(part + (long long)(c0 + i + s) * m + j);
    }
    stripe[threadIdx.x] = sum;
    __syncthreads();
    if (threadIdx.x < m) {
      float total = 0.f;
      for (int i = 0; i < stripes; ++i) total += stripe[i * m + threadIdx.x];
      out[(long long)s * m + threadIdx.x] = total;
    }
    if (threadIdx.x == 0) tickets[s] = 0;
    __syncthreads();                          // stripe is reused
  }
}

// K3's units of a piece, blocks [p0, p1) of an arena: thread tg of T takes
// unit tg, then tg + T, ...; unit k is lane unit k % upb of block p0 + k /
// upb, stepped without a division.
template <typename T>
struct BlockUnits {
  const T* x;
  long long bs;                               // block stride, elements
  int bn, p0, p1;

  struct Cursor {
    const T* x;
    long long bs;
    int bn, upb, p1, step_b, step_w, blk, w;
    __device__ bool ok() const { return blk < p1; }
    __device__ const T* base() const { return x + blk * bs; }
    __device__ long long rs() const { return bn; }
    __device__ long long unit() const { return w; }
    __device__ void next() {
      blk += step_b;
      w += step_w;
      if (w >= upb) {
        w -= upb;
        ++blk;
      }
    }
  };
  template <int P>
  __device__ Cursor start(int tg, int nthr) const {
    const int upb = bn / P;                   // units per block row
    const int sb = nthr / upb;                // blocks and units a step
    return {x, bs, bn, upb, p1, sb, nthr - sb * upb, p0 + tg / upb,
            tg - (tg / upb) * upb};
  }
};

// K3: out[s] = D D^T summed over the blocks of system s, D = the block's
// rows minus their anchor (0: none, 1: row 0, 2: the per-lane mean), one
// launch on K1's grid (arena.py grid_ctas, one CTA per SM: the triangle
// fills the registers). CTA c walks the systems of its block range as K1
// does; for each piece its threads stride over the piece's units (thread t
// takes unit t, then t + T, ...; unit k is lane unit k % upb of block p0 +
// k / upb) and gram.cuh's gram_cta sums the register outer product. A
// system inside the range is written at once, mirrored; the first and the
// last system of a range go to part[c + s] (m (m + 1) / 2 floats each) and
// the last of the CTAs that touch the system (an integer ticket, which it
// resets) sums them in CTA order and writes the system.
template <typename T, int MMAX, bool VEC>
__global__ void __launch_bounds__(kGramThreads, 1)
arena_gram_k(const T* __restrict__ x, const int* __restrict__ block_sys,
             const int* __restrict__ sys_off, float* __restrict__ part,
             unsigned* __restrict__ tickets, float* __restrict__ out, int nb,
             int m, int bn, int n_sys, int anchor) {
  const int G = gridDim.x;
  const int c = blockIdx.x;
  const int b_lo = (int)((long long)nb * c / G);
  const int b_hi = (int)((long long)nb * (c + 1) / G);
  auto cta_of = [&](long long b) {
    return (int)(((b + 1) * G + nb - 1) / nb - 1);
  };
  const long long bs = (long long)m * bn;     // block stride, elements
  const int nt = tri_size(m);
  const int mm = m * m;
  __shared__ GramSmem<MMAX> sh;

  const int s_a = block_sys[b_lo];
  const int s_b = block_sys[b_hi - 1];
  const int s_first = c == 0 ? 0 : min(s_a, block_sys[b_lo - 1] + 1);
  const int s_last = c == G - 1 ? n_sys - 1 : s_b;
  for (int s = s_first; s <= s_last; ++s) {
    const int o0 = sys_off[s];
    const int o1 = sys_off[s + 1];
    if (o0 == o1) {                           // a system with no block
      for (int e = threadIdx.x; e < mm; e += kGramThreads)
        out[(long long)s * mm + e] = 0.f;
      continue;
    }
    const int p0 = max(b_lo, o0);
    const int p1 = min(b_hi, o1);
    const BlockUnits<T> units{x, bs, bn, p0, p1};
    gram_cta<T, VEC, MMAX>(units, m, anchor, sh);
    if (o0 >= b_lo && o1 <= b_hi) {
      write_gram(out + (long long)s * mm, sh.tri, m);
    } else {
      for (int i = threadIdx.x; i < nt; i += kGramThreads)
        part[(long long)(c + s) * nt + i] = sh.tri[i];
    }
    __syncthreads();                          // sh is reused
  }

  // The systems that span CTAs, as in K1: one ticket each, then the sums of
  // those this CTA finished last.
  __threadfence();
  __syncthreads();
  if (threadIdx.x < 2) {
    const int s = threadIdx.x ? s_b : s_a;
    const int cnt = cta_of(sys_off[s + 1] - 1) - cta_of(sys_off[s]) + 1;
    const bool mine = threadIdx.x == 0 || s_b != s_a;
    sh.last[threadIdx.x] = mine && cnt > 1 &&
        atomicAdd(tickets + s, 1u) == (unsigned)(cnt - 1);
  }
  __syncthreads();
  for (int k = 0; k < 2; ++k) {
    if (!sh.last[k]) continue;
    __threadfence();
    const int s = k ? s_b : s_a;
    const int c0 = cta_of(sys_off[s]);
    const int cnt = cta_of(sys_off[s + 1] - 1) - c0 + 1;
    sum_partials(part + (long long)(c0 + s) * nt, nt, cnt, nt, sh);
    write_gram(out + (long long)s * mm, sh.tri, m);
    if (threadIdx.x == 0) tickets[s] = 0;
    __syncthreads();                          // sh is reused
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

template <typename T, bool VEC>
void launch_gram_row(const void* x, const void* q, long long qs, int qslot,
                     const void* block_sys, const void* sys_off, void* part,
                     void* tickets, void* out, int nb, int m, int bn,
                     int n_sys, int ctas, int anchor_first, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* qt = static_cast<const T*>(q);
  const int* bt = static_cast<const int*>(block_sys);
  const int* ot = static_cast<const int*>(sys_off);
  float* pt = static_cast<float*>(part);
  unsigned* tk = static_cast<unsigned*>(tickets);
  float* rt = static_cast<float*>(out);
  if (m <= 8) {
    arena_row<T, 8, VEC><<<ctas, kRowThreads, 0, st>>>(xt, qt, qs, qslot, bt, ot, pt, tk, rt, nb, m, bn, n_sys, anchor_first);
  } else if (m <= 16) {
    arena_row<T, 16, VEC><<<ctas, kRowThreads, 0, st>>>(xt, qt, qs, qslot, bt, ot, pt, tk, rt, nb, m, bn, n_sys, anchor_first);
  } else {
    arena_row<T, kMaxM, VEC><<<ctas, kRowThreads, 0, st>>>(xt, qt, qs, qslot, bt, ot, pt, tk, rt, nb, m, bn, n_sys, anchor_first);
  }
}

template <typename T, bool VEC>
void launch_gram(const void* x, const void* block_sys, const void* sys_off,
                 void* part, void* tickets, void* out, int nb, int m, int bn,
                 int n_sys, int ctas, int anchor, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const int* bt = static_cast<const int*>(block_sys);
  const int* ot = static_cast<const int*>(sys_off);
  float* pt = static_cast<float*>(part);
  unsigned* tk = static_cast<unsigned*>(tickets);
  float* rt = static_cast<float*>(out);
  if (m <= 8) {
    arena_gram_k<T, 8, VEC><<<ctas, kGramThreads, 0, st>>>(xt, bt, ot, pt, tk, rt, nb, m, bn, n_sys, anchor);
  } else if (m <= 16) {
    arena_gram_k<T, 16, VEC><<<ctas, kGramThreads, 0, st>>>(xt, bt, ot, pt, tk, rt, nb, m, bn, n_sys, anchor);
  } else {
    arena_gram_k<T, kMaxM, VEC><<<ctas, kGramThreads, 0, st>>>(xt, bt, ot, pt, tk, rt, nb, m, bn, n_sys, anchor);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The wrapper has checked every shape,
// type and pointer; m <= 32 and nb, n_sys >= 1. K1: 1 <= ctas <= nb CTAs,
// `part` holds (ctas + n_sys) * m floats, `tickets` n_sys zero integers
// (left zero again); the query is row `qslot` of each block (q unused) when
// qslot >= 0; vec = 1 only where every row of x and q starts 16-byte
// aligned and bn is whole 16-byte units. K3: the same with x alone, `part`
// holding (ctas + n_sys) * m (m + 1) / 2 floats; anchor 0 none, 1 row 0, 2
// the per-lane mean.
extern "C" int arena_gram_row(int dtype, const void* x, const void* q,
                              long long q_stride, int qslot,
                              const void* block_sys, const void* sys_off,
                              void* part, void* tickets, void* out, int nb,
                              int m, int bn, int n_sys, int ctas, int vec,
                              int anchor_first, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec) {
    launch_gram_row<float, true>(x, q, q_stride, qslot, block_sys, sys_off, part, tickets, out, nb, m, bn, n_sys, ctas, anchor_first, st);
  } else if (dtype == 0) {
    launch_gram_row<float, false>(x, q, q_stride, qslot, block_sys, sys_off, part, tickets, out, nb, m, bn, n_sys, ctas, anchor_first, st);
  } else if (vec) {
    launch_gram_row<__nv_bfloat16, true>(x, q, q_stride, qslot, block_sys, sys_off, part, tickets, out, nb, m, bn, n_sys, ctas, anchor_first, st);
  } else {
    launch_gram_row<__nv_bfloat16, false>(x, q, q_stride, qslot, block_sys, sys_off, part, tickets, out, nb, m, bn, n_sys, ctas, anchor_first, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int arena_gram(int dtype, const void* x, const void* block_sys,
                          const void* sys_off, void* part, void* tickets,
                          void* out, int nb, int m, int bn, int n_sys,
                          int ctas, int vec, int anchor, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec) {
    launch_gram<float, true>(x, block_sys, sys_off, part, tickets, out, nb, m, bn, n_sys, ctas, anchor, st);
  } else if (dtype == 0) {
    launch_gram<float, false>(x, block_sys, sys_off, part, tickets, out, nb, m, bn, n_sys, ctas, anchor, st);
  } else if (vec) {
    launch_gram<__nv_bfloat16, true>(x, block_sys, sys_off, part, tickets, out, nb, m, bn, n_sys, ctas, anchor, st);
  } else {
    launch_gram<__nv_bfloat16, false>(x, block_sys, sys_off, part, tickets, out, nb, m, bn, n_sys, ctas, anchor, st);
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
