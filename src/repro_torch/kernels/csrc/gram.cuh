// The full snapshot Gram as a register outer product, shared by K3
// (arena.cu arena_gram) and K6 (flat.cu flat_gram), for Hopper (sm_90a).
//
// A CTA of kGramThreads threads sums G = D D^T over the units it is given
// (a unit is the Lanes::kPer lanes one load covers, at one lane offset of
// every row), D = the rows minus their anchor (none, row 0 or the per-lane
// mean), and leaves the upper triangle in shared memory (GramSmem::tri,
// entry (j, k), j <= k, at tri_at(j, k, m)). The caller says which units:
// `units.start<P>(tg, T)` gives the cursor of thread tg of T over units of
// P lanes (ok(), base() = row 0, rs() = row stride, unit(), next()).
//
// Design (what bounds the pass is bytes; the m(m+1)/2 FMAs a lane stay
// under them as long as they overlap the loads):
//   * All rows a thread needs for a unit are loaded before the first FMA,
//     and while one unit's products run the next unit's loads are already
//     outstanding where the registers allow it (GramLoads). The anchor is
//     subtracted and the per-lane products summed in registers, lane by
//     lane. Nothing is staged in shared memory and no fp32 atomic is used.
//   * m <= 16 (MMAX 8 or 16): one thread keeps the whole triangle, MMAX
//     (MMAX + 1) / 2 sums, and reads each row once: row 0 is also the
//     anchor (its differences are exactly 0, so its sums stay 0), and the
//     mean is summed from the loaded rows in order j = 0..m-1, divided by
//     m. Columns past m are skipped whole, one uniform test a column.
//   * m in 17..32 (MMAX 32): the rows are cut into blocks of 8 and the
//     triangle into pair groups (I, J), I <= J, of at most 64 sums; warp w
//     takes groups w, w + 8, ... and re-reads only its groups' rows (and
//     row 0, or all rows for the mean, as the anchor) of the same units.
//   * Reduction, once per call of gram_cta: each warp folds its sums with a
//     transpose fold (a lane keeps half of its values at each of the 5
//     shuffle steps, about one shuffle per value instead of five); across
//     warps, one shared-memory step in warp order. Partials of several CTAs
//     are summed in CTA order (sum_partials) by the last of them. Every sum
//     runs in a fixed order, so results are bit-identical from launch to
//     launch and exact on integer data.
//   * The final m x m is written mirrored from the triangle, so it is
//     exactly symmetric.
#pragma once

#include <type_traits>

#include "lanes.cuh"

constexpr int kGramThreads = 256;
constexpr int kGramWarps = kGramThreads / 32;

__host__ __device__ constexpr int tri_size(int m) { return m * (m + 1) / 2; }
__host__ __device__ constexpr int round32(int n) { return (n + 31) / 32 * 32; }

// entry (j, k), j <= k < m, of an upper triangle stored row by row
__device__ __forceinline__ int tri_at(int j, int k, int m) {
  return j * m - j * (j - 1) / 2 + (k - j);
}

// The rows of one pair group: blocks of kRows rows; MMAX <= 16 is one group.
template <int MMAX>
struct GramShape {
  static constexpr bool kOne = MMAX <= 16;             // one group: all rows
  static constexpr int kRows = kOne ? MMAX : 8;        // rows per block
  static constexpr int kWidth = round32(tri_size(kRows));   // sums, padded
};

// The load unit, and how many units a thread keeps in flight (chosen on the
// H100, PERF.md PR 16). Two in flight, so that one unit's loads are
// outstanding while the other's products run: 16-byte units where two fit
// in the registers beside the sums (MMAX <= 8), else 8-byte units. fp32 at
// MMAX 16 instead keeps one 16-byte unit in flight, which ran faster there
// than two 8-byte ones (its products per byte are half of bf16's). Without
// VEC, one element.
template <typename T, bool VEC, int MMAX>
struct GramLoads {
  static constexpr bool kOneWide =
      VEC && (MMAX > 8) && (MMAX <= 16) && std::is_same_v<T, float>;
  static constexpr int kInFlight = kOneWide ? 1 : 2;
  using Ln = std::conditional_t<(VEC && (MMAX > 8) && !kOneWide), Lanes8<T>,
                                Lanes<T, VEC>>;
};

template <int MMAX>
struct GramSmem {
  float red[GramShape<MMAX>::kOne ? kGramWarps : 1][GramShape<MMAX>::kWidth];
  float tri[tri_size(MMAX)];
  float stripe[kGramThreads > tri_size(MMAX) ? kGramThreads : tri_size(MMAX)];
  int last[2];
};

// Sum v over the 32 lanes of the warp: after the step with offset O a lane
// keeps half of its values (the upper half where lane & O), plus its
// partner's. Lane l ends with the sums of entries [l N / 32, (l+1) N / 32).
template <int N, int O = 16>
__device__ __forceinline__ void warp_fold(float (&v)[N], int lane) {
  static_assert(N % 32 == 0, "pad the sums to a multiple of 32");
  constexpr int h = N * O / 32;              // values kept after this step
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < h; ++i) {
    const float send = up ? v[i] : v[i + h];
    const float keep = up ? v[i + h] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) warp_fold<N, O / 2>(v, lane);
}

// Position (j, k) of entry t of a group's sums: the triangle j <= k of B
// rows (DIAG) or the B x B square; false for a pad entry.
template <int B, bool DIAG>
__device__ __forceinline__ bool group_pos(int t, int& j, int& k) {
  if constexpr (DIAG) {
    j = 0;
    while (j < B && t >= B - j) {
      t -= B - j;
      ++j;
    }
    k = j + t;
    return j < B;
  } else {
    j = t / B;
    k = t - j * B;
    return j < B;
  }
}

template <int B, bool DIAG>
__device__ constexpr int group_at(int j, int k) {
  return DIAG ? j * B - j * (j - 1) / 2 + (k - j) : j * B + k;
}

// The loaded rows of one unit of a pair group: rows j0.. and k0.. (B each,
// those below m), and the anchor where it is not among them (row 0, or the
// mean of all m rows, for m > 16 only).
template <typename Ln, int B, bool DIAG, bool ONE>
struct UnitRows {
  typename Ln::Raw j[B], k[DIAG ? 1 : B], a;
  float mean[ONE ? 1 : Ln::kPer];

  template <typename T>
  __device__ __forceinline__ void load(const T* base, long long rs,
                                       long long w, int j0, int k0, int m,
                                       int anchor) {
    const T* p = base + j0 * rs;
#pragma unroll
    for (int r = 0; r < B; ++r, p += rs)
      if (j0 + r < m) j[r] = Ln::load(p, w);
    if constexpr (!DIAG) {
      p = base + k0 * rs;
#pragma unroll
      for (int r = 0; r < B; ++r, p += rs)
        if (k0 + r < m) k[r] = Ln::load(p, w);
    }
    if constexpr (!ONE) {
      if (anchor == 1) a = j0 == 0 ? j[0] : Ln::load(base, w);
      if (anchor == 2) {                      // every row read once more
#pragma unroll
        for (int e = 0; e < Ln::kPer; ++e) mean[e] = 0.f;
        p = base;
        for (int r = 0; r < m; ++r, p += rs) {
          const typename Ln::Raw v = Ln::load(p, w);
#pragma unroll
          for (int e = 0; e < Ln::kPer; ++e) mean[e] += Ln::lane(v, e);
        }
#pragma unroll
        for (int e = 0; e < Ln::kPer; ++e) mean[e] /= (float)m;
      }
    }
  }
};

// One unit's products into a group's sums, lane by lane. anchor: 0 none,
// 1 row 0, 2 the per-lane mean (for m <= 16 summed from the loaded rows in
// order j = 0..m-1).
template <typename Ln, int B, bool DIAG, bool ONE, int N>
__device__ __forceinline__ void add_unit(float (&acc)[N],
                                         const UnitRows<Ln, B, DIAG, ONE>& r,
                                         int k0, int m, int anchor) {
#pragma unroll
  for (int e = 0; e < Ln::kPer; ++e) {
    float a = 0.f;
    if constexpr (ONE) {
      if (anchor == 1) {
        a = Ln::lane(r.j[0], e);
      } else if (anchor == 2) {
#pragma unroll
        for (int j = 0; j < B; ++j)
          if (j < m) a += Ln::lane(r.j[j], e);
        a /= (float)m;
      }
    } else {
      if (anchor == 1) a = Ln::lane(r.a, e);
      if (anchor == 2) a = r.mean[e];
    }
    float dj[B], dk[DIAG ? 1 : B];
#pragma unroll
    for (int j = 0; j < B; ++j) dj[j] = Ln::lane(r.j[j], e) - a;
    if constexpr (!DIAG) {
#pragma unroll
      for (int k = 0; k < B; ++k) dk[k] = Ln::lane(r.k[k], e) - a;
    }
    // column by column, each skipped whole past m (one uniform test a
    // column, none a pair); rows past m meet only columns past m, and the
    // anchored row 0 is exactly 0, so its sums stay 0
#pragma unroll
    for (int k = 0; k < B; ++k) {
      if (k0 + k < m) {
#pragma unroll
        for (int j = 0; j < (DIAG ? k + 1 : B); ++j) {
          float& s = acc[group_at<B, DIAG>(j, k)];
          s = fmaf(dj[j], DIAG ? dj[k] : dk[k], s);
        }
      }
    }
  }
}

// One pair group (rows j0.. x rows k0..) over the units of thread tg of the
// W warps that share it, folded and written into sh.tri.
template <typename T, bool VEC, int MMAX, bool DIAG, int W, class Units>
__device__ __forceinline__ void gram_group(const Units& units, int tg,
                                           int j0, int k0, int m, int anchor,
                                           GramSmem<MMAX>& sh) {
  using Shape = GramShape<MMAX>;
  using Ln = typename GramLoads<T, VEC, MMAX>::Ln;
  constexpr int B = Shape::kRows;
  constexpr int N = round32(DIAG ? tri_size(B) : B * B);
  constexpr int R = N / 32;                  // sums a lane holds after the fold
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  // units are summed in the cursor's order
  UnitRows<Ln, B, DIAG, Shape::kOne> ra, rb;
  auto cur = units.template start<Ln::kPer>(tg, W * 32);
  if constexpr (GramLoads<T, VEC, MMAX>::kInFlight == 1) {
    for (; cur.ok(); cur.next()) {
      ra.load(cur.base(), cur.rs(), cur.unit(), j0, k0, m, anchor);
      add_unit(acc, ra, k0, m, anchor);
    }
  } else {
    bool oka = cur.ok();
    if (oka) ra.load(cur.base(), cur.rs(), cur.unit(), j0, k0, m, anchor);
    cur.next();
    bool okb = cur.ok();
    if (okb) rb.load(cur.base(), cur.rs(), cur.unit(), j0, k0, m, anchor);
    cur.next();
    while (oka) {
      add_unit(acc, ra, k0, m, anchor);
      oka = cur.ok();
      if (oka) ra.load(cur.base(), cur.rs(), cur.unit(), j0, k0, m, anchor);
      cur.next();
      if (!okb) break;
      add_unit(acc, rb, k0, m, anchor);
      okb = cur.ok();
      if (okb) rb.load(cur.base(), cur.rs(), cur.unit(), j0, k0, m, anchor);
      cur.next();
    }
  }
  const int lane = threadIdx.x & 31;
  warp_fold<N>(acc, lane);
  auto put = [&](int t, float v) {
    int j, k;
    if (group_pos<B, DIAG>(t, j, k) && j0 + j < m && k0 + k < m)
      sh.tri[tri_at(j0 + j, k0 + k, m)] = v;
  };
  if constexpr (W == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) put(lane * R + r, acc[r]);
  } else {
    static_assert(N == Shape::kWidth, "red holds one group's sums");
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int r = 0; r < R; ++r) sh.red[warp][lane * R + r] = acc[r];
    __syncthreads();
    for (int t = threadIdx.x; t < N; t += kGramThreads) {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < W; ++k) sum += sh.red[k][t];
      put(t, sum);
    }
  }
}

// The CTA's Gram over its units into sh.tri (every thread of the CTA calls
// it; sh.tri is complete when it returns).
template <typename T, bool VEC, int MMAX, class Units>
__device__ __forceinline__ void gram_cta(const Units& units, int m,
                                         int anchor, GramSmem<MMAX>& sh) {
  using Shape = GramShape<MMAX>;
  if constexpr (Shape::kOne) {
    gram_group<T, VEC, MMAX, true, kGramWarps>(units, threadIdx.x, 0, 0, m,
                                               anchor, sh);
  } else {
    constexpr int B = Shape::kRows;
    const int nr = (m + B - 1) / B;          // row blocks
    const int ng = nr * (nr + 1) / 2;        // pair groups (I, J), I <= J
    const int lane = threadIdx.x & 31;
    for (int g = threadIdx.x >> 5; g < ng; g += kGramWarps) {
      int I = 0, rem = g;
      while (rem >= nr - I) {
        rem -= nr - I;
        ++I;
      }
      const int J = I + rem;
      if (I == J) {
        gram_group<T, VEC, MMAX, true, 1>(units, lane, I * B, J * B, m,
                                          anchor, sh);
      } else {
        gram_group<T, VEC, MMAX, false, 1>(units, lane, I * B, J * B, m,
                                           anchor, sh);
      }
    }
  }
  __syncthreads();
}

// out (m x m) from a triangle in shared memory, mirrored: exactly symmetric.
__device__ __forceinline__ void write_gram(float* out, const float* tri,
                                           int m) {
  for (int e = threadIdx.x; e < m * m; e += kGramThreads) {
    const int j = e / m;
    const int k = e - j * m;
    out[e] = tri[j <= k ? tri_at(j, k, m) : tri_at(k, j, m)];
  }
}

// sh.tri = the sum of `cnt` partial triangles (rows of nt floats, `stride`
// apart) in row order: thread t = r * nt + i sums entry i of rows r, r +
// stripes, ..., kBatch loads in flight at a time; the stripes are then
// summed in order. Partials come from other CTAs of this launch: read
// through L2.
template <int MMAX>
__device__ __forceinline__ void sum_partials(const float* rows,
                                             long long stride, int cnt,
                                             int nt, GramSmem<MMAX>& sh) {
  constexpr int kBatch = 16;
  const int stripes = nt < kGramThreads ? kGramThreads / nt : 1;
  for (int e = threadIdx.x; e < stripes * nt; e += kGramThreads) {
    const int r = e / nt;
    const float* p = rows + (e - r * nt);
    float sum = 0.f;
    for (int c0 = r; c0 < cnt; c0 += kBatch * stripes) {
      float v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int c = c0 + q * stripes;
        v[q] = c < cnt ? __ldcg(p + c * stride) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) sum += v[q];
    }
    sh.stripe[e] = sum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nt; i += kGramThreads) {
    float total = 0.f;
    for (int r = 0; r < stripes; ++r) total += sh.stripe[r * nt + i];
    sh.tri[i] = total;
  }
  __syncthreads();
}
