// Loads and stores shared by the streaming passes of arena.cu and flat.cu,
// for Hopper (sm_90a).
//
// A thread reads a row in units: one element, or 16 bytes (4 fp32 or 8
// bf16 lanes) where every row it reads starts 16-byte aligned and the lane
// count is whole 16-byte units. The wrapper decides which, per call
// (kernels/device.py vector_lanes). The 16-byte loads skip L1 (every byte
// is read once) and ask L2 to fetch the 256 bytes around them, the next
// lanes of the same row.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes at unit u of a row, read once: not kept in L1, and the L2 asked
// to fetch the surrounding 256 bytes (the next lanes of the same row).
template <typename Raw>
__device__ __forceinline__ Raw load16(const void* row, long long u) {
  const uint4* ptr = static_cast<const uint4*>(row) + u;
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(ptr));
  return *reinterpret_cast<Raw*>(&r);
}

// 8 bytes at unit u of a row, read as load16 reads.
template <typename Raw>
__device__ __forceinline__ Raw load8(const void* row, long long u) {
  const uint2* ptr = static_cast<const uint2*>(row) + u;
  uint2 r;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];"
      : "=r"(r.x), "=r"(r.y) : "l"(ptr));
  return *reinterpret_cast<Raw*>(&r);
}

// bf16 lane e of a 32-bit word of two lanes (even e: the low half), in
// fp32: exact, as unpack converts
__device__ __forceinline__ float bf16_lane(uint32_t w, int e) {
  return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
}

// The lanes one load covers: one element, or 16 bytes (4 fp32 or 8 bf16)
// when VEC. `Raw` holds the loaded bits until use, so the m rows of a step
// are in flight at once in few registers; `unpack` converts all its lanes,
// `lane` one (e, known at compile time after unrolling). `store` writes
// kPer fp32 results at unit u of an fp32 row with streaming (evict-first)
// stores: outputs that nothing on the card reads again soon.
template <typename T, bool VEC>
struct Lanes {
  static constexpr int kPer = 1;
  using Raw = T;
  __device__ static Raw load(const T* row, long long u) {
    return __ldg(row + u);
  }
  __device__ static void unpack(Raw r, float (&v)[kPer]) { v[0] = to_f32(r); }
  __device__ static float lane(Raw r, int) { return to_f32(r); }
  __device__ static void store(float* row, long long u, const float (&v)[kPer]) {
    __stcs(row + u, v[0]);
  }
};

template <>
struct Lanes<float, true> {
  static constexpr int kPer = 4;
  using Raw = float4;
  __device__ static Raw load(const float* row, long long u) {
    return load16<Raw>(row, u);
  }
  __device__ static void unpack(Raw r, float (&v)[kPer]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ static float lane(Raw r, int e) {
    return e == 0 ? r.x : e == 1 ? r.y : e == 2 ? r.z : r.w;
  }
  __device__ static void store(float* row, long long u, const float (&v)[kPer]) {
    __stcs(reinterpret_cast<float4*>(row) + u, make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Lanes<__nv_bfloat16, true> {
  static constexpr int kPer = 8;
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* row, long long u) {
    return load16<Raw>(row, u);
  }
  __device__ static void unpack(Raw r, float (&v)[kPer]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {            // bf16 -> fp32 is exact
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float lane(Raw r, int e) {   // lane e alone, as unpack
    const int i = e >> 1;
    return bf16_lane(i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w, e);
  }
  __device__ static void store(float* row, long long u, const float (&v)[kPer]) {
    float4* out = reinterpret_cast<float4*>(row) + 2 * u;
    __stcs(out, make_float4(v[0], v[1], v[2], v[3]));
    __stcs(out + 1, make_float4(v[4], v[5], v[6], v[7]));
  }
};

// Half-width units: 8 bytes (2 fp32 or 4 bf16 lanes), for a pass that keeps
// two units of every row in flight in the registers one 16-byte unit takes.
// Valid wherever Lanes<T, true> is.
template <typename T>
struct Lanes8;

template <>
struct Lanes8<float> {
  static constexpr int kPer = 2;
  using Raw = float2;
  __device__ static Raw load(const float* row, long long u) {
    return load8<Raw>(row, u);
  }
  __device__ static float lane(Raw r, int e) { return e == 0 ? r.x : r.y; }
};

template <>
struct Lanes8<__nv_bfloat16> {
  static constexpr int kPer = 4;
  using Raw = uint2;
  __device__ static Raw load(const __nv_bfloat16* row, long long u) {
    return load8<Raw>(row, u);
  }
  __device__ static float lane(Raw r, int e) {
    return bf16_lane(e < 2 ? r.x : r.y, e);
  }
};
