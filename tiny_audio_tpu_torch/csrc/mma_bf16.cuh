// Helpers shared by the attention kernels (attention.cu, attention_bwd.cu,
// attention_f32.cu): the bf16 tensor-core product mma.sync.m16n8k16 and its
// fragment packing, and the masking and P / dS formulas of the backward.
//
// Fragment layout of m16n8k16 (g = lane / 4, t4 = lane % 4), which every
// kernel relies on:
//   A (16 x 16, row-major): a0 = A[g][2t4..2t4+1],   a1 = A[g+8][2t4..2t4+1],
//                           a2 = A[g][2t4+8..2t4+9], a3 = A[g+8][2t4+8..2t4+9]
//   B (16 x 8, "col"):      b0 = B[2t4..2t4+1][g],   b1 = B[2t4+8..2t4+9][g]
//   C (16 x 8, fp32):       c0 = C[g][2t4], c1 = C[g][2t4+1],
//                           c2 = C[g+8][2t4], c3 = C[g+8][2t4+1]
// so a row-major [rows][k] tile in shared memory gives A fragments, and a
// row-major [n][k] tile gives B fragments, each as two 32-bit loads.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ta {

// Padding keys score this instead of -inf (models/layers.MASK_VALUE), so a
// row whose visible keys are all padding averages them uniformly.
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 values (lo at the lower address) as one 32-bit register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A key's state: 1 real, 0 padding (scores MASK_VALUE), -1 past T (excluded).
__device__ __forceinline__ int key_state_of(const int* mask_row, int key, int T) {
  return key >= T ? -1 : (mask_row == nullptr || mask_row[key] != 0) ? 1 : 0;
}

// The backward's P and dS of one score s (raw q.k) from the forward's row
// statistics m (max, log2 units) and l (sum), dP and delta = rowsum(dO * O):
// P = exp2(s * scale_log2 - m) / l, dS = P * (dP - delta).  A padding key
// has P > 0 only in a row whose visible keys are all padding, and no dS.
__device__ __forceinline__ void p_and_ds(float s, float dp, int state, bool visible,
                                         float scale_log2, float m, float l, float delta,
                                         float& p, float& ds) {
  p = 0.f;
  ds = 0.f;
  if (visible && state >= 0) {
    const float x = state == 0 ? MASK_VALUE : s * scale_log2;
    p = exp2f(x - m) / l;
    if (state == 1) ds = p * (dp - delta);
  }
}

}  // namespace ta
