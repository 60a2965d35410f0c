// Helpers shared by the flash-attention forward (flash.cu, K7) and
// backward (flash_bwd.cu, K7b): the mask value, stride triples, bf16
// packing, 16-byte cp.async staging, transposed ldmatrix and mma.sync
// m16n8k16 (bf16 in, fp32 accumulate).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

namespace flash {

constexpr float kNegInf = -1e30f;

struct Strides {                     // in elements; the d stride is 1
  long long b, s, h;
};

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
// so the C fragments of two adjacent 8-wide n tiles, packed to bf16, are
// the A fragment of one 16-deep k step.

}  // namespace flash
