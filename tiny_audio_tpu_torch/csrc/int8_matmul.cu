// The decode step's int8 matrix products for Hopper (sm_90a): a few
// activation rows (the decode batch, B <= 16 at serving) times an int8
// weight with per-output-channel fp32 scales, bf16 out.
//
//   ta_w8a8_matmul  replaces tiny_audio_tpu/ops/wq_head.py (w8a8_matmul):
//                   out = bf16(((float)(x_i8 . wt_i8[n]) * sx[b]) * scale[n])
//                   with the activation quantized per row inside the kernel
//                   (quantize_act: sx = max(max|x|, 1e-12) / 127, x_i8 =
//                   clamp(rint(x / sx), -127, 127), IEEE divisions), int32
//                   sums and the fp32 epilogue in that order, so the result
//                   is bitwise that of w8a8_matmul_xla.  wt is [N, K] (the
//                   transposed layout: each output row is contiguous).
//   ta_wq_matmul    replaces tiny_audio_tpu/ops/wq_matmul.py (wq_matmul):
//                   out = bf16((x . bf16(w_i8[:, n])) * scale[n]), int8
//                   converted in registers (exact), fp32 sums; w is [K, N].
//   ta_a8t_matmul   kernel #9d, replaces scripts/bench_wq_head.py
//                   (build_a8t(nt), pallas_call :197, body _a8t_kernel
//                   :174): #5's product on an activation quantized
//                   beforehand (x_i8, sx), one block per nt output channels;
//                   #5's tiles with the quantization prologue replaced by a
//                   copy (the PREQUANT instance of w8a8_matmul_kernel).
//
// What bounds them on the H100: at B <= 16 a product reads each weight byte
// once and does 2 B operations with it, far below the card's ridge, so the
// int8 weight bytes over 3.35 TB/s are the bound (the LM head, 151,936 x
// 1024, is 0.047 ms; a layer projection 1-3 MB, ~0.3-0.9 us, where the
// launch itself is larger).  What the designs do about it:
//
//   - one launch per product: the activation quantization of W8A8 runs in
//     each block's prologue (a few KB of bf16 per row, from L2), not as the
//     ~6 separate torch ops around an int8 product;
//   - blocks walk their tiles of output channels in a grid-stride loop, so
//     the prologue (and the staging of the activations in shared memory) is
//     paid once per block, not once per tile;
//   - ta_w8a8_matmul: a group of 8 lanes reads 128 contiguous bytes of a
//     weight row per step (16 bytes a lane) and __dp4a's them against the
//     int8 activations in shared memory; a lane owns RPL rows, so each
//     activation load feeds RPL rows; the 8 lanes' int32 sums meet by
//     shuffles;
//   - ta_wq_matmul: 8 lanes read a run of a weight row (COLS output channels,
//     COLS bytes, a lane), the warp 4 rows, the block 32 rows per step; fp32
//     FMAs on the CUDA cores against the bf16 activations in shared memory;
//     the 32 row slots meet by shuffles and through shared memory in a fixed
//     order (deterministic);
//   - each picks its tiling from N: the wide one (RPL = 4, COLS = 16) keeps
//     more weight bytes in flight per lane and is the faster at the LM head;
//     where it would give an SM fewer than two tiles (the layer products),
//     the narrow one (RPL = 1, COLS = 4) gives more blocks instead.
//
// Both take any N (a masked ragged edge) and any B (passes of up to 16
// rows, each reading the weights again).  Simple and exact first: tensor-
// core versions (mma.sync s8 / bf16) and a split over K, so that a narrow
// layer product fills the card and a block of #6 reads long runs of a row
// of the [K, N] weight, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int MAX_ROWS = 16;               // activation rows per pass
constexpr int SMEM_BUDGET = 200 * 1024;    // dynamic shared memory a block may take
constexpr int BLOCKS_PER_SM = 4;

// ---------------------------------------------------------------- W8A8 (#5)

constexpr int A8_WARPS = 4;
constexpr int A8_THREADS = A8_WARPS * 32;
constexpr int A8_HEADER = 64;                                    // sx[16] fp32, 16-byte aligned

struct A8Args {
  const __nv_bfloat16* x;  // [B, K]
  const int8_t* wt;        // [N, K]
  const float* scale;      // [N]
  __nv_bfloat16* out;      // [B, N]
  int B, K, N;
  int rows_per_pass;       // <= MAX_ROWS, limited by shared memory
  const int8_t* x_i8;      // PREQUANT: [B, K] int8 and sx [B] fp32, quantized
  const float* sx;         //   beforehand (x unused)
  int block_tiles;         // > 0: block i takes tiles [i, i + 1) * block_tiles;
                           // 0: the blocks stride over the tiles
};

// A lane owns RPL weight rows: a tile is 4 warps x 4 row groups x RPL rows.
template <int RPL, bool PREQUANT>
__global__ void __launch_bounds__(A8_THREADS) w8a8_matmul_kernel(A8Args a) {
  constexpr int A8_TILE = A8_WARPS * 4 * RPL;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_sx = reinterpret_cast<float*>(smem);
  int8_t* s_x = reinterpret_cast<int8_t*>(smem + A8_HEADER);
  const int K = a.K, N = a.N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l8 = lane & 7;  // lane within its row group
  const int tiles = (N + A8_TILE - 1) / A8_TILE;

  for (int b0 = 0; b0 < a.B; b0 += a.rows_per_pass) {
    const int bc = min(a.rows_per_pass, a.B - b0);
    if constexpr (PREQUANT) {  // x_i8 and sx as given
      if (threadIdx.x < bc) s_sx[threadIdx.x] = a.sx[b0 + threadIdx.x];
      for (int i = threadIdx.x * 16; i < bc * K; i += A8_THREADS * 16) {
        *reinterpret_cast<int4*>(s_x + i) =
            *reinterpret_cast<const int4*>(a.x_i8 + (int64_t)b0 * K + i);
      }
      __syncthreads();
    } else {
      // quantize_act, rows b0 .. b0 + bc - 1: amax by one warp per row ...
      for (int r = warp; r < bc; r += A8_WARPS) {
        const __nv_bfloat16* xr = a.x + (int64_t)(b0 + r) * K;
        float m = 0.f;
        for (int k = lane * 8; k < K; k += 32 * 8) {
          const uint4 raw = *reinterpret_cast<const uint4*>(xr + k);
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(__bfloat162float(e[i])));
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (lane == 0) s_sx[r] = __fdiv_rn(fmaxf(m, 1e-12f), 127.f);
      }
      __syncthreads();
      // ... then x_i8 = clamp(rint(x / sx)), 8 elements a thread per step
      for (int i = threadIdx.x * 8; i < bc * K; i += A8_THREADS * 8) {
        const int r = i / K;
        const uint4 raw = *reinterpret_cast<const uint4*>(a.x + (int64_t)b0 * K + i);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
        const float sx = s_sx[r];
        uint2 packed;
        int8_t* q = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int v = __float2int_rn(__fdiv_rn(__bfloat162float(e[j]), sx));
          q[j] = static_cast<int8_t>(min(max(v, -127), 127));
        }
        *reinterpret_cast<uint2*>(s_x + i) = packed;
      }
      __syncthreads();
    }

    const int first = a.block_tiles ? blockIdx.x * a.block_tiles : blockIdx.x;
    const int last = a.block_tiles ? min(tiles, first + a.block_tiles) : tiles;
    const int step = a.block_tiles ? 1 : gridDim.x;
    for (int tile = first; tile < last; tile += step) {
      const int n0 = tile * A8_TILE + warp * 4 * RPL + (lane >> 3) * RPL;
      const int8_t* wrow[RPL];
      bool ok[RPL];
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        ok[r] = n0 + r < N;
        wrow[r] = a.wt + (int64_t)(ok[r] ? n0 + r : 0) * K;
      }
      int acc[RPL][MAX_ROWS];
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
#pragma unroll
        for (int b = 0; b < MAX_ROWS; ++b) acc[r][b] = 0;
      }
#pragma unroll 2
      for (int k = l8 * 16; k < K; k += 128) {
        int4 w[RPL];
#pragma unroll
        for (int r = 0; r < RPL; ++r) {
          w[r] = ok[r] ? __ldg(reinterpret_cast<const int4*>(wrow[r] + k)) : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int b = 0; b < MAX_ROWS; ++b) {
          if (b < bc) {
            const int4 xv = *reinterpret_cast<const int4*>(s_x + b * K + k);
#pragma unroll
            for (int r = 0; r < RPL; ++r) {
              int s = acc[r][b];
              s = __dp4a(w[r].x, xv.x, s);
              s = __dp4a(w[r].y, xv.y, s);
              s = __dp4a(w[r].z, xv.z, s);
              acc[r][b] = __dp4a(w[r].w, xv.w, s);
            }
          }
        }
      }
      // the 8 lanes of a row group hold partial sums of the same outputs
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
#pragma unroll
        for (int b = 0; b < MAX_ROWS; ++b) {
          if (b < bc) {
#pragma unroll
            for (int off = 4; off > 0; off >>= 1) {
              acc[r][b] += __shfl_xor_sync(0xffffffffu, acc[r][b], off);
            }
          }
        }
      }
      // lane l8 of the group stores the outputs (r, b) with (r * 16 + b) % 8 == l8
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
#pragma unroll
        for (int b = 0; b < MAX_ROWS; ++b) {
          if (b < bc && ((r * MAX_ROWS + b) & 7) == l8 && ok[r]) {
            const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[r][b]), s_sx[b]),
                                      a.scale[n0 + r]);
            a.out[(int64_t)(b0 + b) * N + n0 + r] = __float2bfloat16_rn(v);
          }
        }
      }
    }
    __syncthreads();  // the next pass overwrites s_x
  }
}

// ------------------------------------------------------------------ launch

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

// Raise the kernel's dynamic shared memory limit once to what a launch needs.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// Whether tiles of `tile` output channels still give every SM two of them:
// the wide tiling (more bytes in flight per lane) then reads the weight
// faster; a narrower one gives a narrow product more blocks.
bool wide(int N, int tile) { return N / tile >= 2 * sm_count(); }

int grid_for(int tiles) {
  const int cap = sm_count() * BLOCKS_PER_SM;
  return std::min(tiles, cap);
}

// ---------------------------------------------------------- weight-only (#6)

constexpr int WQ_WARPS = 8;
constexpr int WQ_THREADS = WQ_WARPS * 32;
constexpr int WQ_KSLOTS = WQ_THREADS / 8;      // 32 weight rows per step

struct WqArgs {
  const __nv_bfloat16* x;  // [B, K]
  const int8_t* w;         // [K, N]
  const float* scale;      // [N]
  __nv_bfloat16* out;      // [B, N]
  int B, K, N;
  int rows_per_pass;
};

// COLS int8 weights as COLS / 4 words, by one aligned vector load
template <int COLS> __device__ __forceinline__ void load_words(const int8_t* p, int (&w)[COLS / 4]);
template <> __device__ __forceinline__ void load_words<4>(const int8_t* p, int (&w)[1]) {
  w[0] = __ldg(reinterpret_cast<const int*>(p));
}
template <> __device__ __forceinline__ void load_words<8>(const int8_t* p, int (&w)[2]) {
  const int2 v = __ldg(reinterpret_cast<const int2*>(p));
  w[0] = v.x; w[1] = v.y;
}
template <> __device__ __forceinline__ void load_words<16>(const int8_t* p, int (&w)[4]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

// COLS output channels a lane (a COLS-byte load of a weight row), 8 lanes a
// row slot, so a block tile is 8 * COLS channels and 32 row slots.
template <int COLS>
__global__ void __launch_bounds__(WQ_THREADS) wq_matmul_kernel(WqArgs a) {
  constexpr int TILE = 8 * COLS;
  constexpr int ROWS = 128 / COLS < MAX_ROWS ? 128 / COLS : MAX_ROWS;  // accumulators <= 128
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.K, N = a.N;
  float* s_red = reinterpret_cast<float*>(smem);  // [WQ_WARPS][rows_per_pass][TILE]
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(
      smem + (size_t)WQ_WARPS * a.rows_per_pass * TILE * sizeof(float));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = (lane & 7) * COLS;              // this lane's channels in the tile
  const int kslot = warp * 4 + (lane >> 3);       // this lane's first weight row
  // vector loads are aligned: every row starts on a COLS-byte boundary
  const bool vec = N % COLS == 0 && reinterpret_cast<uintptr_t>(a.w) % COLS == 0;
  const int tiles = (N + TILE - 1) / TILE;

  for (int b0 = 0; b0 < a.B; b0 += a.rows_per_pass) {
    const int bc = min(a.rows_per_pass, a.B - b0);
    for (int i = threadIdx.x; i < bc * K; i += WQ_THREADS) s_x[i] = a.x[(int64_t)b0 * K + i];
    __syncthreads();

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int c0 = tile * TILE + col;
      float acc[ROWS][COLS];
#pragma unroll
      for (int b = 0; b < ROWS; ++b) {
#pragma unroll
        for (int j = 0; j < COLS; ++j) acc[b][j] = 0.f;
      }
#pragma unroll 4
      for (int k = kslot; k < K; k += WQ_KSLOTS) {
        const int8_t* wk = a.w + (int64_t)k * N + c0;
        int words[COLS / 4];
        if (vec && c0 + COLS <= N) {
          load_words<COLS>(wk, words);
        } else {
#pragma unroll
          for (int i = 0; i < COLS / 4; ++i) words[i] = 0;
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            const int byte = c0 + j < N ? __ldg(wk + j) : 0;
            words[j / 4] |= (byte & 0xff) << (8 * (j % 4));
          }
        }
        float wv[COLS];
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          wv[j] = static_cast<float>(static_cast<int8_t>(words[j / 4] >> (8 * (j % 4))));
        }
#pragma unroll
        for (int b = 0; b < ROWS; ++b) {
          if (b < bc) {
            const float xb = __bfloat162float(s_x[b * K + k]);
#pragma unroll
            for (int j = 0; j < COLS; ++j) acc[b][j] = fmaf(xb, wv[j], acc[b][j]);
          }
        }
      }
      // the 4 row slots of the warp (lanes 8 apart) hold the same channels
#pragma unroll
      for (int b = 0; b < ROWS; ++b) {
        if (b < bc) {
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            acc[b][j] += __shfl_xor_sync(0xffffffffu, acc[b][j], 8);
            acc[b][j] += __shfl_xor_sync(0xffffffffu, acc[b][j], 16);
          }
        }
      }
      if (lane < 8) {
#pragma unroll
        for (int b = 0; b < ROWS; ++b) {
          if (b < bc) {
#pragma unroll
            for (int j = 0; j < COLS; ++j) s_red[(warp * bc + b) * TILE + col + j] = acc[b][j];
          }
        }
      }
      __syncthreads();
      for (int o = threadIdx.x; o < bc * TILE; o += WQ_THREADS) {
        const int b = o / TILE, cc = o % TILE;
        const int n = tile * TILE + cc;
        if (n < N) {
          float s = 0.f;
#pragma unroll
          for (int w = 0; w < WQ_WARPS; ++w) s += s_red[(w * bc + b) * TILE + cc];
          a.out[(int64_t)(b0 + b) * N + n] = __float2bfloat16_rn(__fmul_rn(s, a.scale[n]));
        }
      }
      __syncthreads();  // s_red is reused by the next tile
    }
  }
}

template <int COLS>
int launch_wq(const WqArgs& args, void* stream) {
  constexpr int TILE = 8 * COLS;
  constexpr int ROWS = 128 / COLS < MAX_ROWS ? 128 / COLS : MAX_ROWS;
  const int per_row = WQ_WARPS * TILE * 4 + 2 * args.K;  // shared bytes per activation row
  const int rows = std::min(ROWS, SMEM_BUDGET / per_row);
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const int smem = rows * per_row;
  static int allowed = 0;
  cudaError_t err = allow_smem(wq_matmul_kernel<COLS>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  WqArgs a = args;
  a.rows_per_pass = rows;
  wq_matmul_kernel<COLS><<<grid_for((a.N + TILE - 1) / TILE), WQ_THREADS, smem,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int RPL, bool PREQUANT>
int launch_a8(const A8Args& a, int smem, int blocks, void* stream) {
  static int allowed = 0;
  cudaError_t err = allow_smem(w8a8_matmul_kernel<RPL, PREQUANT>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  w8a8_matmul_kernel<RPL, PREQUANT><<<blocks, A8_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int a8_rows(int K) { return std::min(MAX_ROWS, (SMEM_BUDGET - A8_HEADER) / K); }

}  // namespace

extern "C" {

// x [B, K] bf16, wt [N, K] int8, scale [N] fp32 -> out [B, N] bf16.  K a
// multiple of 16; x and wt 16-byte aligned, every tensor contiguous.
// Returns the launch's CUDA error code.
int ta_w8a8_matmul(const void* x, const void* wt, const void* scale, void* out, int B, int K,
                   int N, void* stream) {
  if (B <= 0 || K <= 0 || N <= 0 || K % 16 != 0) return (int)cudaErrorInvalidValue;
  const int rows = a8_rows(K);
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const int smem = A8_HEADER + rows * K;
  A8Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wt),
           static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), B, K, N, rows,
           nullptr, nullptr, 0};
  constexpr int wide_tile = A8_WARPS * 4 * 4;
  if (wide(N, wide_tile)) {
    return launch_a8<4, false>(a, smem, grid_for((N + wide_tile - 1) / wide_tile), stream);
  }
  return launch_a8<1, false>(a, smem, grid_for((N + A8_WARPS * 4 - 1) / (A8_WARPS * 4)), stream);
}

// x_i8 [B, K] int8 and sx [B] fp32 (quantize_act's), wt [N, K] int8, scale
// [N] fp32 -> out [B, N] bf16; block i computes channels [i nt, (i + 1) nt).
// K a multiple of 16, nt of 64; x_i8 and wt 16-byte aligned, every tensor
// contiguous.  Returns the launch's CUDA error code.
int ta_a8t_matmul(const void* x_i8, const void* sx, const void* wt, const void* scale, void* out,
                  int B, int K, int N, int nt, void* stream) {
  constexpr int tile = A8_WARPS * 4 * 4;
  if (B <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || nt <= 0 || nt % tile != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = a8_rows(K);
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const int smem = A8_HEADER + rows * K;
  A8Args a{nullptr, static_cast<const int8_t*>(wt), static_cast<const float*>(scale),
           static_cast<__nv_bfloat16*>(out), B, K, N, rows, static_cast<const int8_t*>(x_i8),
           static_cast<const float*>(sx), nt / tile};
  return launch_a8<4, true>(a, smem, (N + nt - 1) / nt, stream);
}

// x [B, K] bf16, w [K, N] int8, scale [N] fp32 -> out [B, N] bf16; every
// tensor contiguous.  Returns the launch's CUDA error code.
int ta_wq_matmul(const void* x, const void* w, const void* scale, void* out, int B, int K,
                 int N, void* stream) {
  if (B <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  WqArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
           static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), B, K, N, 0};
  if (wide(N, 8 * 16)) return launch_wq<16>(a, stream);
  return launch_wq<4>(a, stream);
}

}  // extern "C"
