// Kernels #9b and #9c for Hopper (sm_90a): the LM head's int8 products as
// the TPU bench scripts/bench_wq_head.py builds them (B, K, N = 48, 1024,
// 151936: x [48, 1024], the int8 head [1024, 151936], bf16 logits out).
//
//   ta_wq_matmul_pipe  replaces build_pipe(nc, nt) (pallas_call :104, body
//                      _pipe_kernel :48): #6's function (int8_matmul.cu,
//                      ta_wq_matmul), out = bf16((x . bf16(w_i8[:, n])) *
//                      scale[n]) with w [K, N], fp32 sums, by one block per
//                      nc-wide chunk of the output that streams its weight
//                      through shared memory by hand, double-buffered.
//   ta_a8_matmul       replaces build_a8(nt) (pallas_call :152, body
//                      _a8_kernel :133): x quantized per row beforehand
//                      (quantize_act, x_i8 [B, K] and sx [B] fp32), times
//                      w_i8 [K, N] with int32 sums, then bf16((acc * sx[b]) *
//                      scale[n]); one block per nt output channels.
//
// (build_a8t, #9d, is ta_a8t_matmul in int8_matmul.cu: it shares #5's tiles.)
//
// #9b's pipeline: the TPU kernel fetched [K, nt] int8 tiles (2 MB at
// nt = 2,048) into VMEM two at a time.  Shared memory holds 228 KB, and the
// fp32 accumulators of a [48, nt] output tile (384 KB at nt = 2,048) fit
// neither it nor the register file (256 KB an SM), so the stream is cut into
// stages of [KS = 512 rows of K, SW = 32 columns]: each warp owns 8 of the
// 32 columns and keeps their [48, 8] accumulators in 12 registers across the
// stages of its column slab.  Stage i + 1 is in flight (cp.async, 16 bytes a
// copy) while stage i is converted to bf16 in registers (exact) and
// multiplied on the tensor cores (mma.sync.m16n8k16, x as the A operand from
// shared memory).  The script's tile width nt has no counterpart: the slabs
// of a chunk are walked in column order, and only the chunk width nc is a
// parameter.  Unlike the TPU grid (N // nc programs), the last chunk is
// ragged and computed, so every one of the N columns is written.
//
// #9c: the weight is [K, N] (N contiguous), but __dp4a wants four K values
// of one column in one word, so each [64, 256] slab of the weight is staged
// in shared memory (coalesced 16-byte reads) and a thread, which owns one
// column, gathers its column's bytes (a byte transpose); the int8
// activations sit in shared memory and are read as broadcasts.  The sums
// are int32, exact, so the result is bitwise the plain version's.
//
// What bounds them on the H100: the int8 weight (155.6 MB at the bench
// shape) read once, with the output (14.6 MB), x and the scales: ~170.9 MB
// at 3.35 TB/s, 0.051 ms; 14.9 G operations do not bind.  One block per
// chunk (19 blocks at nc = 8,192) puts a fraction of the SMs on the stream,
// which is the design the TPU script measured and what a redesign of #6
// (a split over K, all SMs, wgmma) is timed against.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using ta::ld32;
using ta::mma_16816;
using ta::pack_bf16;

constexpr int SMEM_LIMIT = 227 * 1024;

// ------------------------------------------------------------- pipe (#9b)

constexpr int PIPE_WARPS = 4;
constexpr int PIPE_THREADS = PIPE_WARPS * 32;
constexpr int SW = PIPE_WARPS * 8;  // columns per stage: 8 a warp
constexpr int SWP = SW + 16;        // stage row pitch in bytes (16-byte copies; the
                                    // pad puts a fragment's four rows on four banks)
constexpr int KS = 512;             // rows of K per stage
constexpr int MAX_MT = 3;           // m16 tiles of x: B <= 48

using ta::sm90::cp_async_16_zfill;
using ta::sm90::cp_async_commit;
using ta::sm90::cp_async_wait;

struct PipeArgs {
  const __nv_bfloat16* x;  // [B, K]
  const int8_t* w;         // [K, N]
  const float* scale;      // [N]
  __nv_bfloat16* out;      // [B, N]
  int B, K, N, nc;
};

// Stage i of the block's chunk: column slab i / k_stages, K rows
// (i % k_stages) * KS ...; rows past K and columns past N are zero-filled.
__device__ __forceinline__ void fetch_stage(const PipeArgs& a, int c_begin, int k_stages, int i,
                                            int8_t* buf) {
  const int c0 = c_begin + (i / k_stages) * SW;
  const int k0 = (i % k_stages) * KS;
  for (int j = threadIdx.x; j < KS * (SW / 16); j += PIPE_THREADS) {
    const int row = j / (SW / 16);
    const int col = (j % (SW / 16)) * 16;
    const bool valid = k0 + row < a.K && c0 + col < a.N;
    const int8_t* src = valid ? a.w + (int64_t)(k0 + row) * a.N + c0 + col : a.w;
    cp_async_16_zfill(buf + row * SWP + col, src, valid);
  }
}

__device__ __forceinline__ uint32_t pack_i8_pair(int8_t lo, int8_t hi) {
  return pack_bf16(static_cast<float>(lo), static_cast<float>(hi));  // exact
}

__global__ void __launch_bounds__(PIPE_THREADS) wq_matmul_pipe_kernel(PipeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int XP = a.K + 8;  // padded x row (bf16): conflict-free A fragments
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [MAX_MT * 16][XP]
  int8_t* stage = reinterpret_cast<int8_t*>(x_s + MAX_MT * 16 * XP);  // [2][KS][SWP]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = (a.B + 15) / 16;
  const int c_begin = blockIdx.x * a.nc;
  const int c_end = min(a.N, c_begin + a.nc);
  const int k_stages = (a.K + KS - 1) / KS;
  const int stages = (c_end - c_begin + SW - 1) / SW * k_stages;

  fetch_stage(a, c_begin, k_stages, 0, stage);
  cp_async_commit();
  for (int i = threadIdx.x; i < mt * 16 * (a.K / 8); i += PIPE_THREADS) {
    const int row = i / (a.K / 8);
    const int col = (i % (a.K / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < a.B) val = *reinterpret_cast<const uint4*>(a.x + (int64_t)row * a.K + col);
    *reinterpret_cast<uint4*>(&x_s[row * XP + col]) = val;
  }

  float acc[MAX_MT][4];
  for (int i = 0; i < stages; ++i) {
    if (i + 1 < stages) fetch_stage(a, c_begin, k_stages, i + 1, stage + ((i + 1) & 1) * KS * SWP);
    cp_async_commit();  // (an empty group at the end keeps the count uniform)
    cp_async_wait<1>();  // stage i has landed
    __syncthreads();
    const int kst = i % k_stages;
    if (kst == 0) {
#pragma unroll
      for (int m = 0; m < MAX_MT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
    }
    const int8_t* ws = stage + (i & 1) * KS * SWP + warp * 8 + g;  // this lane's column
    const int k0 = kst * KS;
    const int steps = min(KS, a.K - k0) / 16;
    for (int kk = 0; kk < steps; ++kk) {
      const int8_t* w0 = ws + (kk * 16 + 2 * t4) * SWP;
      const uint32_t b0 = pack_i8_pair(w0[0], w0[SWP]);
      const uint32_t b1 = pack_i8_pair(w0[8 * SWP], w0[9 * SWP]);
#pragma unroll
      for (int m = 0; m < MAX_MT; ++m) {
        if (m < mt) {
          const __nv_bfloat16* xp = &x_s[(m * 16 + g) * XP + k0 + kk * 16 + 2 * t4];
          const uint32_t af[4] = {ld32(xp), ld32(xp + 8 * XP), ld32(xp + 8), ld32(xp + 8 * XP + 8)};
          mma_16816(acc[m], af, b0, b1);
        }
      }
    }
    if (kst == k_stages - 1) {  // the slab is summed over K: scale and store
      const int n = c_begin + (i / k_stages) * SW + warp * 8 + 2 * t4;
#pragma unroll
      for (int m = 0; m < MAX_MT; ++m) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m * 16 + g + (e >> 1) * 8;
          const int col = n + (e & 1);
          if (m < mt && row < a.B && col < a.N) {
            a.out[(int64_t)row * a.N + col] = __float2bfloat16_rn(__fmul_rn(acc[m][e], a.scale[col]));
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
}

// --------------------------------------------------------------- a8 (#9c)

constexpr int A8K_THREADS = 256;  // one output column a thread
constexpr int A8K_SLAB = 64;      // rows of K per staged weight slab
constexpr int A8K_ROWS = 48;      // activation rows per pass

struct A8kArgs {
  const int8_t* x;      // [B, K] int8
  const float* sx;      // [B] fp32
  const int8_t* w;      // [K, N]
  const float* scale;   // [N]
  __nv_bfloat16* out;   // [B, N]
  int B, K, N, nt;
};

__global__ void __launch_bounds__(A8K_THREADS) a8_matmul_kernel(A8kArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* w_s = reinterpret_cast<int8_t*>(smem);                   // [A8K_SLAB][A8K_THREADS]
  float* s_sx = reinterpret_cast<float*>(w_s + A8K_SLAB * A8K_THREADS);  // [A8K_ROWS]
  int8_t* x_s = reinterpret_cast<int8_t*>(s_sx + A8K_ROWS);        // [A8K_ROWS][K]
  const int K = a.K, N = a.N;
  const int n_begin = blockIdx.x * a.nt;
  const int n_end = min(N, n_begin + a.nt);

  for (int b0 = 0; b0 < a.B; b0 += A8K_ROWS) {
    const int bc = min(A8K_ROWS, a.B - b0);
    __syncthreads();  // the previous pass is done with x_s
    for (int i = threadIdx.x * 16; i < bc * K; i += A8K_THREADS * 16) {
      *reinterpret_cast<int4*>(x_s + i) = *reinterpret_cast<const int4*>(a.x + (int64_t)b0 * K + i);
    }
    if (threadIdx.x < bc) s_sx[threadIdx.x] = a.sx[b0 + threadIdx.x];

    for (int c0 = n_begin; c0 < n_end; c0 += A8K_THREADS) {
      const int n = c0 + threadIdx.x;
      int acc[A8K_ROWS];
#pragma unroll
      for (int b = 0; b < A8K_ROWS; ++b) acc[b] = 0;
      for (int k0 = 0; k0 < K; k0 += A8K_SLAB) {
        __syncthreads();  // every thread is done with the previous slab
        // rows k0 .. k0 + 63, columns c0 .. c0 + 255, 16 bytes a copy
        for (int j = threadIdx.x; j < A8K_SLAB * (A8K_THREADS / 16); j += A8K_THREADS) {
          const int row = j / (A8K_THREADS / 16);
          const int col = (j % (A8K_THREADS / 16)) * 16;
          int4 val = make_int4(0, 0, 0, 0);
          if (k0 + row < K && c0 + col < N) {
            val = *reinterpret_cast<const int4*>(a.w + (int64_t)(k0 + row) * N + c0 + col);
          }
          *reinterpret_cast<int4*>(w_s + row * A8K_THREADS + col) = val;
        }
        __syncthreads();
        const int rows = min(A8K_SLAB, K - k0);
        for (int kk = 0; kk < rows; kk += 4) {
          // this column's four K values as one word (the byte transpose)
          const uint8_t* wc = reinterpret_cast<const uint8_t*>(w_s) + kk * A8K_THREADS + threadIdx.x;
          const int w4 = (int)((uint32_t)wc[0] | ((uint32_t)wc[A8K_THREADS] << 8) |
                               ((uint32_t)wc[2 * A8K_THREADS] << 16) |
                               ((uint32_t)wc[3 * A8K_THREADS] << 24));
#pragma unroll
          for (int b = 0; b < A8K_ROWS; ++b) {
            if (b < bc) acc[b] = __dp4a(w4, *reinterpret_cast<const int*>(x_s + b * K + k0 + kk), acc[b]);
          }
        }
      }
      if (n < n_end) {
        const float sc = a.scale[n];
#pragma unroll
        for (int b = 0; b < A8K_ROWS; ++b) {
          if (b < bc) {
            const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[b]), s_sx[b]), sc);
            a.out[(int64_t)(b0 + b) * N + n] = __float2bfloat16_rn(v);
          }
        }
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

}  // namespace

extern "C" {

// x [B, K] bf16 (B <= 48), w [K, N] int8, scale [N] fp32 -> out [B, N] bf16;
// one block per nc output columns.  K and N multiples of 16, nc a multiple
// of 32, x and w 16-byte aligned, every tensor contiguous.  Returns the
// launch's CUDA error code.
int ta_wq_matmul_pipe(const void* x, const void* w, const void* scale, void* out, int B, int K,
                      int N, int nc, void* stream) {
  if (B <= 0 || B > MAX_MT * 16 || K <= 0 || N <= 0 || K % 16 || N % 16 || nc <= 0 || nc % SW) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)MAX_MT * 16 * (K + 8) * 2 + 2 * KS * SWP;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static size_t allowed = 0;
  const cudaError_t err = allow_smem(wq_matmul_pipe_kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const PipeArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
                   static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), B, K, N,
                   nc};
  wq_matmul_pipe_kernel<<<(N + nc - 1) / nc, PIPE_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// x_i8 [B, K] int8 and sx [B] fp32 (quantize_act's), w [K, N] int8, scale
// [N] fp32 -> out [B, N] bf16; one block per nt output channels.  K, N and
// nt multiples of 16 (the weight's 16-byte loads start at a block's first
// channel); x_i8 and w 16-byte aligned, every tensor contiguous.  Returns
// the launch's CUDA error code.
int ta_a8_matmul(const void* x_i8, const void* sx, const void* w, const void* scale, void* out,
                 int B, int K, int N, int nt, void* stream) {
  if (B <= 0 || K <= 0 || N <= 0 || K % 16 || N % 16 || nt <= 0 || nt % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = A8K_SLAB * A8K_THREADS + A8K_ROWS * 4 + (size_t)A8K_ROWS * K;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static size_t allowed = 0;
  const cudaError_t err = allow_smem(a8_matmul_kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const A8kArgs a{static_cast<const int8_t*>(x_i8), static_cast<const float*>(sx),
                  static_cast<const int8_t*>(w), static_cast<const float*>(scale),
                  static_cast<__nv_bfloat16*>(out), B, K, N, nt};
  a8_matmul_kernel<<<(N + nt - 1) / nt, A8K_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
