// The encoder block's MLP fused for Hopper (sm_90a): bf16 in and out, fp32
// accumulation, the [M, F] intermediate never in device memory.
//
//   ta_encoder_ffn  replaces tiny_audio_tpu/ops/encoder_ffn.py (_ffn_impl,
//                   pallas_call :124, body _kernel :62).  Per output element
//                     out = bf16(b2 + sum_f bf16(gelu_tanh(h_f)) * W2[n, f]),
//                     h_f = sum_k x_k * W1[f, k] + b1[f],
//                   both sums in fp32, h kept in fp32 through the GELU
//                   (accurate tanhf) and rounded to bf16 once before the
//                   second product: the TPU kernel's function, not
//                   naive_ffn's, which rounds h to bf16 first.
//
// Operands are in nn.Linear's layout (models/encoder.py's fc1 and fc2):
// x [M, D], W1 [F, D], b1 [F], W2 [D, F], b2 [D].  Both products then read
// K-contiguous rows, which is what mma.sync's B fragment wants.
//
// What bounds it on the H100: 4 * M * D * F FLOPs over (2 M D + 2 D F) * 2
// bytes of inputs and output -- at M = 6,000, D = 1,280, F = 5,120, 157
// GFLOP over 57 MB, ~2,700 FLOP/byte -- so the bf16 tensor cores bound it
// (0.159 ms at 989 TFLOP/s).  The TPU kernel keeps a [512, 1280] fp32
// accumulator (2.6 MB) in VMEM; an SM has 256 KB of registers and 228 KB of
// shared memory.  The design:
//   - one block of 16 warps (one block an SM) owns 32 rows; their [32, D] fp32 partial output
//     lives in registers, each warp 32 rows x D / 16 columns (80 fp32 a
//     thread at D = 1,280: 62% of the register file), for the whole walk
//     over F, and is rounded and stored once;
//   - the block's x rows stay in shared memory ([32, D] bf16, 80 KB);
//   - F is walked in blocks of 64.  Per block: h = x W1[blk]^T, the 16
//     warps as 8 column tiles x 2 halves of D, the halves met in shared
//     memory with b1, GELU in fp32, g rounded to bf16 into shared memory;
//     then acc += g W2[:, blk]^T, every warp on its own columns;
//   - the f order inside a 16-wide mma step is permuted (a thread's step s
//     covers f = 16 t4 + 4 s + {0..3}), so each B fragment of the second
//     product is 8 contiguous bytes of a W2 row and the warp reads whole
//     128-byte runs of 8 rows;
//   - W1 and W2 stream from L2 straight into mma fragments (no shared-memory
//     staging), so each block of 32 rows re-reads both weights: 26 MB per
//     row tile, 4.9 GB of L2 reads in all at M = 6,000 (188 row tiles),
//     against 57 MB the function must move: that, and mma.sync's share of
//     the tensor-core rate, are the likely gap to the bound (not profiled
//     yet: no L2 or tensor-pipe reading has been taken).  A cluster sharing
//     weight tiles through distributed shared memory, TMA and wgmma are
//     later work;
//   - rows past M are zero in shared memory and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using ta::ld32;
using ta::mma_16816;
using ta::pack_bf16;

constexpr int BM = 32;            // rows per block: two 16-row mma tiles
constexpr int BF = 64;            // ffn columns per step of the walk over F
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int XPAD = 8;           // x row padding (bf16): conflict-free A loads
constexpr int GS = BF + 2;        // g row stride (bf16): 33 words, conflict-free
constexpr int K_BATCH = 4;        // 16-deep k steps of the first product per load batch
constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2 / pi)

__device__ __forceinline__ float gelu_tanh(float h) {
  return 0.5f * h * (1.f + tanhf(GELU_C * (h + 0.044715f * h * h * h)));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * BM * (D + XPAD) + sizeof(float) * 2 * BM * BF +
         sizeof(__nv_bfloat16) * BM * GS;
}

// NT: 8-column mma tiles of the output per warp; D = 16 warps x 8 NT.
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
encoder_ffn_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                   const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                   const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                   int M, int F) {
  constexpr int D = WARPS * 8 * NT;
  constexpr int XS = D + XPAD;
  constexpr int K_STEPS = D / 2 / 16;  // 16-deep steps in a half of D
  static_assert(K_STEPS % K_BATCH == 0, "D / 32 must be a multiple of K_BATCH");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);               // [BM][XS]
  float* ps = reinterpret_cast<float*>(smem + sizeof(__nv_bfloat16) * BM * XS);  // [2][BM][BF]
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(ps + 2 * BM * BF);   // [BM][GS]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int64_t row0 = (int64_t)blockIdx.x * BM;

  // x rows of the block, 16 bytes a thread per step; rows past M are zero.
  for (int i = threadIdx.x; i < BM * D / 8; i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < M) v = *reinterpret_cast<const uint4*>(x + (row0 + r) * D + c);
    *reinterpret_cast<uint4*>(&xs[r * XS + c]) = v;
  }
  __syncthreads();  // every warp reads every row of the tile

  // This warp's output columns: n = warp * 8 NT + nt * 8 + {2 t4, 2 t4 + 1}.
  const int n_warp = warp * 8 * NT;
  float acc[2][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n_warp + nt * 8 + 2 * t4;
    const float lo = __bfloat162float(b2[n]), hi = __bfloat162float(b2[n + 1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      acc[mt][nt][0] = lo; acc[mt][nt][1] = hi;
      acc[mt][nt][2] = lo; acc[mt][nt][3] = hi;
    }
  }

  // First product's split: 8 column tiles of h x 2 halves of D.
  const int h_tile = warp % 8;
  const int k_half = warp / 8;
  const int k_begin = k_half * (D / 2);

  for (int f0 = 0; f0 < F; f0 += BF) {
    // ---- h = x W1[f0 : f0 + 64]^T over this warp's half of D ----
    const __nv_bfloat16* w1_row = w1 + (int64_t)(f0 + h_tile * 8 + g) * D;
    float h[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kb = 0; kb < K_STEPS; kb += K_BATCH) {
      uint32_t bw[K_BATCH][2];
#pragma unroll
      for (int j = 0; j < K_BATCH; ++j) {
        const int k = k_begin + (kb + j) * 16 + 2 * t4;
        bw[j][0] = __ldg(reinterpret_cast<const unsigned int*>(w1_row + k));
        bw[j][1] = __ldg(reinterpret_cast<const unsigned int*>(w1_row + k + 8));
      }
#pragma unroll
      for (int j = 0; j < K_BATCH; ++j) {
        const int k = k_begin + (kb + j) * 16 + 2 * t4;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const __nv_bfloat16* xa = &xs[(mt * 16 + g) * XS + k];
          const uint32_t a[4] = {ld32(xa), ld32(xa + 8 * XS), ld32(xa + 8), ld32(xa + 8 * XS + 8)};
          mma_16816(h[mt], a, bw[j][0], bw[j][1]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float* p = &ps[(k_half * BM + mt * 16 + g) * BF + h_tile * 8 + 2 * t4];
      p[0] = h[mt][0];
      p[1] = h[mt][1];
      p[8 * BF] = h[mt][2];
      p[8 * BF + 1] = h[mt][3];
    }
    __syncthreads();

    // ---- g = bf16(gelu(h + b1)), h in fp32 ----
    for (int i = threadIdx.x; i < BM * BF; i += THREADS) {
      const int r = i / BF, c = i % BF;
      const float hv = ps[r * BF + c] + ps[(BM + r) * BF + c] + __bfloat162float(b1[f0 + c]);
      gs[r * GS + c] = __float2bfloat16_rn(gelu_tanh(hv));
    }
    __syncthreads();

    // ---- acc += g W2[:, f0 : f0 + 64]^T, f permuted inside each 16-deep step ----
    const __nv_bfloat16* w2_blk = w2 + f0 + t4 * 16;
#pragma unroll
    for (int s = 0; s < BF / 16; ++s) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* ga = &gs[(mt * 16 + g) * GS + t4 * 16 + 4 * s];
        a[mt][0] = ld32(ga);
        a[mt][1] = ld32(ga + 8 * GS);
        a[mt][2] = ld32(ga + 2);
        a[mt][3] = ld32(ga + 8 * GS + 2);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n_warp + nt * 8 + g;
        const uint2 bw = __ldg(reinterpret_cast<const uint2*>(w2_blk + (int64_t)n * F + 4 * s));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_16816(acc[mt][nt], a[mt], bw.x, bw.y);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int64_t r0 = row0 + mt * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n_warp + nt * 8 + 2 * t4;
      if (r0 < M) {
        *reinterpret_cast<uint32_t*>(out + r0 * D + n) = pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
      }
      if (r1 < M) {
        *reinterpret_cast<uint32_t*>(out + r1 * D + n) = pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
  }
}

template <int NT>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int M, int F, void* stream) {
  constexpr int D = WARPS * 8 * NT;
  constexpr size_t smem = smem_bytes<D>();
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        encoder_ffn_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const unsigned grid = (unsigned)((M + BM - 1) / BM);
  encoder_ffn_kernel<NT><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(out), M, F);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, D], w1 [F, D], b1 [F], w2 [D, F], b2 [D] -> out [M, D], all bf16,
// contiguous, x and out 16-byte aligned, w2 8-byte aligned.  D a multiple
// of 128 up to 1280 (Whisper tiny to large: 384 ... 1280); F a multiple of
// 64.  Returns the launch's CUDA error code.
int ta_encoder_ffn(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int M, int D, int F, void* stream) {
  if (M <= 0 || F <= 0 || F % BF != 0 || D % 128 != 0) return (int)cudaErrorInvalidValue;
  switch (D / 128) {
    case 1: return launch<1>(x, w1, b1, w2, b2, out, M, F, stream);
    case 2: return launch<2>(x, w1, b1, w2, b2, out, M, F, stream);
    case 3: return launch<3>(x, w1, b1, w2, b2, out, M, F, stream);
    case 4: return launch<4>(x, w1, b1, w2, b2, out, M, F, stream);
    case 5: return launch<5>(x, w1, b1, w2, b2, out, M, F, stream);
    case 6: return launch<6>(x, w1, b1, w2, b2, out, M, F, stream);
    case 7: return launch<7>(x, w1, b1, w2, b2, out, M, F, stream);
    case 8: return launch<8>(x, w1, b1, w2, b2, out, M, F, stream);
    case 9: return launch<9>(x, w1, b1, w2, b2, out, M, F, stream);
    case 10: return launch<10>(x, w1, b1, w2, b2, out, M, F, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
