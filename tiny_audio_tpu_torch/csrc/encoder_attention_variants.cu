// Kernel #9a for Hopper (sm_90a): the encoder attention's function (#1,
// attention.cu) under the 13 softmax modes of the TPU bench kernel it
// replaces, scripts/bench_encoder_attention.py (build(hg, sm), pallas_call
// :223; bodies _kernel_loop :103-163 and _kernel_packed2 :166-206).
// Bidirectional MHA over packed heads q/k/v [B, T, H*64] bf16 with a key
// mask [B, T], bf16 out; one entry point, ta_encoder_attention_variant.
//
// Per head: s = (q . k) * D^-0.5 in fp32, MASK_VALUE where the key is
// padding; then a shift m, p = exp(s - m), a denominator and a normalisation
// that the mode picks along four axes (one kernel, templated on them):
//
//   shift   ROWMAX   the exact row max (a pass over the keys before the
//                    exponentials: an online max that rescales would round
//                    otherwise, and be another function)
//           CONST8   8, no max (nomax)
//           CLAMP48  min(s, 80) - 48 (shift, shift_post, packed2)
//           TILEMAX  one max over the [256, T] scores of a head's 256 query
//                    rows: the TPU kernel's BQ grouping, which a block here
//                    keeps (a block is 256 rows)
//           QNORM    |q_row| * (max_t |k_t| * D^-0.5), the max over all T
//                    keys, padded ones too (a pass over K per head)
//   exp     fp32 expf, or bf16(expf(bf16(s - m))) summed in fp32 (bf16)
//   norm    DIV   bf16(p / denom) before P.V
//           RCP   bf16(p * rcp.approx.ftz(denom)) before P.V
//           POST  (bf16(p) . V) / denom on the [256, 64] output
//   guard   denom + 1e-30, or not
//
// A normalise-before-P.V mode needs each row's denominator before its P.V,
// so it takes a second pass over the keys that recomputes S.  packed2 is
// shift_post with two heads per block sharing each K/V tile load (NH = 2);
// the TPU's block-diagonal 128-wide dot adds exact zeros, so its function is
// shift_post's per head, and here its arithmetic is too, bit for bit.
//
// Design: one block of 16 warps per (256-row query group, hg heads, batch
// row); the mask row is loaded once per block and shared by its hg heads;
// each warp owns 16 query rows; K and V stream through shared memory in
// tiles of 64 keys (V transposed); S = Q K^T and O += P V run on the tensor
// cores (mma.sync.m16n8k16, bf16 x bf16 -> fp32) as in attention.cu; the
// scores never leave registers.  [256, 1536] fp32 scores (1.5 MB) could not
// stay on the SM (228 KB of shared memory), hence the streaming and the
// recomputation.  T must be a multiple of 256, as in the TPU grid.
//
// What bounds it on the H100: 4 B H T^2 D FLOPs (386.5 GFLOP at the bench's
// B, T, H = 32, 1536, 20: 0.391 ms at 989 TFLOP/s) over ~0.5 GB of q, k, v
// and out (0.150 ms): compute.  The modes that take two or three passes do
// 1.5-2.5x the products of #1, and mma.sync reaches only part of wgmma's
// rate: these are yardsticks of #1's redesign, not the shipped kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using ta::ld32;
using ta::mma_16816;
using ta::pack_bf16;
using ta::MASK_VALUE;

constexpr int D = 64;
constexpr int BQ = 256;              // query rows per block: the TPU kernel's
constexpr int WARPS = BQ / 16;       // each warp owns 16 rows
constexpr int THREADS = WARPS * 32;  // 512
constexpr int BK = 64;               // keys per shared-memory tile
constexpr int QP = D + 8;            // padded Q / K row: conflict-free fragments
constexpr int VP = BK + 8;           // padded V^T row
constexpr int NT = BK / 8;           // 8-key column tiles of S
constexpr int OT = D / 8;            // 8-wide column tiles of O

enum Shift { ROWMAX, CONST8, CLAMP48, TILEMAX, QNORM };
enum Norm { DIV, RCP, POST };

template <int NH>
size_t smem_bytes(int T) {
  return (size_t)NH * (BQ * QP + BK * QP + D * VP) * sizeof(__nv_bfloat16) +
         WARPS * sizeof(float) + (size_t)T * sizeof(int);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The max of x over the block; every thread gets it.  `red` holds WARPS floats.
__device__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  __syncthreads();  // the previous reduction's readers are done with red
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, red[w]);
  return r;
}

// Keys [k0, k0 + BK) of NH heads (K row-major, V transposed if WITH_V).
template <int NH, bool WITH_V>
__device__ __forceinline__ void load_kv(const __nv_bfloat16* k, const __nv_bfloat16* v,
                                        int64_t base, int64_t stride, int k0,
                                        __nv_bfloat16* k_s, __nv_bfloat16* vt_s) {
  for (int i = threadIdx.x; i < NH * BK * (D / 8); i += THREADS) {
    const int hs = i / (BK * (D / 8));
    const int row = (i / (D / 8)) % BK;
    const int col = (i % (D / 8)) * 8;
    const int64_t off = base + (int64_t)(k0 + row) * stride + hs * D + col;
    *reinterpret_cast<uint4*>(&k_s[(hs * BK + row) * QP + col]) =
        *reinterpret_cast<const uint4*>(k + off);
    if (WITH_V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(v + off);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt_s[(hs * D + col + j) * VP + row] = e[j];
    }
  }
}

// S for this thread's rows (qrow, qrow + 8) and the tile's 64 keys, scaled
// and masked as the TPU kernel does: dot * D^-0.5, MASK_VALUE at padding.
__device__ __forceinline__ void scores(const __nv_bfloat16* q_s, const __nv_bfloat16* k_s,
                                       const int* mask_s, int k0, int qrow, int g, int t4,
                                       float scale, float (&s)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p0 = &q_s[qrow * QP + kk * 16 + 2 * t4];
    const uint32_t a[4] = {ld32(p0), ld32(p0 + 8 * QP), ld32(p0 + 8), ld32(p0 + 8 * QP + 8)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* kp = &k_s[(n * 8 + g) * QP + kk * 16 + 2 * t4];
      mma_16816(s[n], a, ld32(kp), ld32(kp + 8));
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + 2 * t4 + (e & 1);
      s[n][e] = mask_s[k0 + col] ? s[n][e] * scale : MASK_VALUE;
    }
  }
}

template <int SHIFT, bool EXP_BF16>
__device__ __forceinline__ float prob(float s, float m) {
  float x;
  if (SHIFT == CONST8) {
    x = s - 8.f;
  } else if (SHIFT == CLAMP48) {
    x = fminf(s, 80.f) - 48.f;
  } else {
    x = s - m;
  }
  return EXP_BF16 ? bf16_round(expf(bf16_round(x))) : expf(x);
}

// O += P V over the tile's 64 keys, P rounded to bf16 (the A operand).
__device__ __forceinline__ void accumulate_pv(const float (&p)[NT][4], const __nv_bfloat16* vt_s,
                                              int g, int t4, float (&o)[OT][4]) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                            pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                            pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                            pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const __nv_bfloat16* vp = &vt_s[(j * 8 + g) * VP + kc * 16 + 2 * t4];
      mma_16816(o[j], pa, ld32(vp), ld32(vp + 8));
    }
  }
}

template <int SHIFT, bool EXP_BF16, int NORM, bool GUARD, int NH>
__global__ void __launch_bounds__(THREADS, 1)
variant_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
               __nv_bfloat16* __restrict__ out, int T, int H, int hg, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [NH][BQ][QP]
  __nv_bfloat16* k_s = q_s + NH * BQ * QP;                       // [NH][BK][QP]
  __nv_bfloat16* vt_s = k_s + NH * BK * QP;                      // [NH][D][VP]
  float* red = reinterpret_cast<float*>(vt_s + NH * D * VP);     // [WARPS]
  int* mask_s = reinterpret_cast<int*>(red + WARPS);             // [T]

  const int q0 = blockIdx.x * BQ;
  const int head0 = blockIdx.y * hg;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int qrow = warp * 16 + g;  // this thread's rows in the block: qrow, qrow + 8
  const int64_t stride = (int64_t)H * D;
  const int64_t batch = (int64_t)b * T * stride;

  for (int t = threadIdx.x; t < T; t += THREADS) mask_s[t] = mask[(int64_t)b * T + t] != 0;

  for (int hh = 0; hh < hg; hh += NH) {
    const int64_t base = batch + (int64_t)(head0 + hh) * D;
    __syncthreads();  // the previous heads are done with q_s (and mask_s is in)
    for (int i = threadIdx.x; i < NH * BQ * (D / 8); i += THREADS) {
      const int hs = i / (BQ * (D / 8));
      const int row = (i / (D / 8)) % BQ;
      const int col = (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(&q_s[(hs * BQ + row) * QP + col]) =
          *reinterpret_cast<const uint4*>(q + base + (int64_t)(q0 + row) * stride + hs * D + col);
    }
    __syncthreads();

    // ---- the shift m of this thread's two rows ----
    float m[NH][2];
#pragma unroll
    for (int hs = 0; hs < NH; ++hs) m[hs][0] = m[hs][1] = 0.f;
    if constexpr (SHIFT == ROWMAX || SHIFT == TILEMAX) {
      float mx[NH][2];
#pragma unroll
      for (int hs = 0; hs < NH; ++hs) mx[hs][0] = mx[hs][1] = -INFINITY;
      for (int k0 = 0; k0 < T; k0 += BK) {
        __syncthreads();
        load_kv<NH, false>(k, v, base, stride, k0, k_s, vt_s);
        __syncthreads();
#pragma unroll
        for (int hs = 0; hs < NH; ++hs) {
          float s[NT][4];
          scores(q_s + hs * BQ * QP, k_s + hs * BK * QP, mask_s, k0, qrow, g, t4, scale, s);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            mx[hs][0] = fmaxf(mx[hs][0], fmaxf(s[n][0], s[n][1]));
            mx[hs][1] = fmaxf(mx[hs][1], fmaxf(s[n][2], s[n][3]));
          }
        }
      }
#pragma unroll
      for (int hs = 0; hs < NH; ++hs) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[hs][r] = fmaxf(mx[hs][r], __shfl_xor_sync(0xffffffffu, mx[hs][r], 1));
          mx[hs][r] = fmaxf(mx[hs][r], __shfl_xor_sync(0xffffffffu, mx[hs][r], 2));
        }
        if constexpr (SHIFT == TILEMAX) {
          m[hs][0] = m[hs][1] = block_max(fmaxf(mx[hs][0], mx[hs][1]), red);
        } else {
          m[hs][0] = mx[hs][0];
          m[hs][1] = mx[hs][1];
        }
      }
    } else if constexpr (SHIFT == QNORM) {
#pragma unroll
      for (int hs = 0; hs < NH; ++hs) {
        float ksq = 0.f;  // max over the head's T keys of |k_t|^2
        for (int t = threadIdx.x; t < T; t += THREADS) {
          const __nv_bfloat16* kr = k + base + (int64_t)t * stride + hs * D;
          float sum = 0.f;
#pragma unroll
          for (int c = 0; c < D; c += 8) {
            const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
            const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float f = __bfloat162float(e[j]);
              sum += f * f;
            }
          }
          ksq = fmaxf(ksq, sum);
        }
        const float kmax = sqrtf(block_max(ksq, red));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const __nv_bfloat16* qr = &q_s[(hs * BQ + qrow + 8 * r) * QP];
          float sum = 0.f;
          for (int c = 0; c < D; ++c) {
            const float f = __bfloat162float(qr[c]);
            sum += f * f;
          }
          m[hs][r] = sqrtf(sum) * (kmax * scale);
        }
      }
    }

    // ---- the denominators, and P.V for the POST modes ----
    float l[NH][2], o[NH][OT][4];
#pragma unroll
    for (int hs = 0; hs < NH; ++hs) {
      l[hs][0] = l[hs][1] = 0.f;
#pragma unroll
      for (int j = 0; j < OT; ++j) o[hs][j][0] = o[hs][j][1] = o[hs][j][2] = o[hs][j][3] = 0.f;
    }
    for (int k0 = 0; k0 < T; k0 += BK) {
      __syncthreads();
      load_kv<NH, NORM == POST>(k, v, base, stride, k0, k_s, vt_s);
      __syncthreads();
#pragma unroll
      for (int hs = 0; hs < NH; ++hs) {
        float s[NT][4];
        scores(q_s + hs * BQ * QP, k_s + hs * BK * QP, mask_s, k0, qrow, g, t4, scale, s);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = prob<SHIFT, EXP_BF16>(s[n][e], m[hs][e >> 1]);
          l[hs][0] += s[n][0] + s[n][1];
          l[hs][1] += s[n][2] + s[n][3];
        }
        if constexpr (NORM == POST) accumulate_pv(s, vt_s + hs * D * VP, g, t4, o[hs]);
      }
    }
#pragma unroll
    for (int hs = 0; hs < NH; ++hs) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[hs][r] += __shfl_xor_sync(0xffffffffu, l[hs][r], 1);
        l[hs][r] += __shfl_xor_sync(0xffffffffu, l[hs][r], 2);
        if (GUARD) l[hs][r] += 1e-30f;
      }
    }

    // ---- normalise before P.V: a second pass recomputes S ----
    if constexpr (NORM != POST) {
      float inv[NH][2];
#pragma unroll
      for (int hs = 0; hs < NH; ++hs) {
        inv[hs][0] = rcp_approx(l[hs][0]);
        inv[hs][1] = rcp_approx(l[hs][1]);
      }
      for (int k0 = 0; k0 < T; k0 += BK) {
        __syncthreads();
        load_kv<NH, true>(k, v, base, stride, k0, k_s, vt_s);
        __syncthreads();
#pragma unroll
        for (int hs = 0; hs < NH; ++hs) {
          float s[NT][4];
          scores(q_s + hs * BQ * QP, k_s + hs * BK * QP, mask_s, k0, qrow, g, t4, scale, s);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = prob<SHIFT, EXP_BF16>(s[n][e], m[hs][e >> 1]);
              s[n][e] = NORM == DIV ? p / l[hs][e >> 1] : p * inv[hs][e >> 1];
            }
          }
          accumulate_pv(s, vt_s + hs * D * VP, g, t4, o[hs]);
        }
      }
    }

    // ---- the output, bf16 ----
#pragma unroll
    for (int hs = 0; hs < NH; ++hs) {
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        float x[4] = {o[hs][j][0], o[hs][j][1], o[hs][j][2], o[hs][j][3]};
        if constexpr (NORM == POST) {
#pragma unroll
          for (int e = 0; e < 4; ++e) x[e] = x[e] / l[hs][e >> 1];
        }
        __nv_bfloat16* o0 = out + base + (int64_t)(q0 + qrow) * stride + hs * D + j * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(o0) = pack_bf16(x[0], x[1]);
        *reinterpret_cast<uint32_t*>(o0 + 8 * stride) = pack_bf16(x[2], x[3]);
      }
    }
  }
}

template <int SHIFT, bool EXP_BF16, int NORM, bool GUARD, int NH>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
           int T, int H, int hg, float scale, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;  // per instantiation: above 48 KB needs the opt-in
  const size_t smem = smem_bytes<NH>(T);
  auto kernel = variant_kernel<SHIFT, EXP_BF16, NORM, GUARD, NH>;
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const dim3 grid(T / BQ, H / hg, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(mask),
      static_cast<__nv_bfloat16*>(out), T, H, hg, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v/out: [B, T, H*64] bf16, contiguous, 16-byte aligned; mask: [B, T]
// int32 (1 = real key).  T a multiple of 256, H a multiple of hg, and hg
// even for packed2.  mode (ops/encoder_attention_variants.MODES): 0 fp32,
// 1 bf16, 2 rcp, 3 nomax, 4 shift, 5 tilemax, 6 tilemax_rcp, 7 qnorm,
// 8 qnorm_post, 9 fp32_post, 10 shift_post, 11 tilemax_post, 12 packed2.
// Returns the launch's CUDA error code.
int ta_encoder_attention_variant(const void* q, const void* k, const void* v, const void* mask,
                                 void* out, int B, int T, int H, int D_, int hg, int mode,
                                 float scale, void* stream) {
  if (B <= 0 || T <= 0 || T % BQ != 0 || D_ != D || hg <= 0 || H % hg != 0 ||
      mask == nullptr || (mode == 12 && hg % 2 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: return launch<ROWMAX, false, DIV, false, 1>(q, k, v, mask, out, B, T, H, hg, scale, s);
    case 1: return launch<ROWMAX, true, DIV, false, 1>(q, k, v, mask, out, B, T, H, hg, scale, s);
    case 2: return launch<ROWMAX, false, RCP, false, 1>(q, k, v, mask, out, B, T, H, hg, scale, s);
    case 3: return launch<CONST8, false, DIV, false, 1>(q, k, v, mask, out, B, T, H, hg, scale, s);
    case 4: return launch<CLAMP48, false, DIV, true, 1>(q, k, v, mask, out, B, T, H, hg, scale, s);
    case 5: return launch<TILEMAX, false, DIV, true, 1>(q, k, v, mask, out, B, T, H, hg, scale, s);
    case 6: return launch<TILEMAX, false, RCP, true, 1>(q, k, v, mask, out, B, T, H, hg, scale, s);
    case 7: return launch<QNORM, false, DIV, true, 1>(q, k, v, mask, out, B, T, H, hg, scale, s);
    case 8: return launch<QNORM, false, POST, true, 1>(q, k, v, mask, out, B, T, H, hg, scale, s);
    case 9: return launch<ROWMAX, false, POST, true, 1>(q, k, v, mask, out, B, T, H, hg, scale, s);
    case 10: return launch<CLAMP48, false, POST, true, 1>(q, k, v, mask, out, B, T, H, hg, scale, s);
    case 11: return launch<TILEMAX, false, POST, true, 1>(q, k, v, mask, out, B, T, H, hg, scale, s);
    case 12: return launch<CLAMP48, false, POST, true, 2>(q, k, v, mask, out, B, T, H, hg, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
