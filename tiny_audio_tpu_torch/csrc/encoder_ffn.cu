// The encoder block's MLP for Hopper (sm_90a): bf16 in and out, fp32
// accumulation, one persistent launch.
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
// A and B K-major (x and W1, then g and W2): wgmma's plainest case.
//
// What bounds it on the H100: 4 * M * D * F FLOPs over (2 M D + 2 D F) * 2
// bytes of inputs and output -- at M = 6,000, D = 1,280, F = 5,120, 157
// GFLOP over 57 MB, ~2,700 FLOP/byte -- so the bf16 tensor cores bound it
// (0.159 ms at 989 TFLOP/s).  The TPU kernel keeps a [512, 1280] fp32
// accumulator in VMEM; here a wgmma row tile is at least 64 rows and
// [64, 1280] fp32 (320 KB) outgrows an SM's register file, so the output
// cannot stay on the SM over the walk over F.  The design instead runs two
// kinds of GEMM tile in one launch and lets the [M, F] intermediate g pass
// through L2:
//   - phase-1 tiles: g[rows, f-block] = bf16(gelu(x W1^T + b1)), bias and
//     GELU in fp32 in the epilogue; phase-2 tiles: out[rows, d-block] =
//     bf16(g W2^T + b2).  A tile is 128 x 256 outputs: two consumer
//     warpgroups of 64 rows, each two m64n128k16 products a 16-deep step
//     with every accumulator in registers (128 a thread);
//   - a producer warp streams A and B boxes of [rows][64] by TMA into a ring
//     of STAGES 128-byte-swizzled stages (48 KB each); 2-D operands are
//     read as the 4-D maps of sm90::make_map (B = 1, H = columns / 64), so
//     rows past M or F read as zeros;
//   - one block per SM walks a queue of tiles claimed from one atomic
//     counter.  The queue (ops/encoder_ffn.ffn_tile_plan mirrors it) runs
//     row block by row block: row block i's phase-1 tiles, with row block
//     i - lag's phase-2 tiles after them, so a phase-2 tile finds its g
//     written several microseconds before and still in L2 (g of lag + 1 row
//     blocks is ~6.5 MB at F = 5,120).  A phase-2 tile waits until its row
//     block's readiness counter counts every phase-1 tile of the block;
//     those were claimed earlier by running blocks and wait on nothing, so
//     the wait cannot deadlock, however many blocks are resident;
//   - ordering: the epilogue stores g with plain stores, each storing thread
//     fences its generic stores against the async proxy, the warpgroups
//     meet at a named barrier and one thread releases the row block's
//     counter at gpu scope; the producer of a phase-2 tile acquires the
//     counter, then fences the async proxy before its TMA loads of g;
//   - the counters (queue, blocks done, readiness per row block) come from
//     the wrapper, zero; the last block to finish zeroes them again, so a
//     CUDA graph replays the launch bit for bit with no host memset.
// g is a scratch [M, F] bf16 tensor the wrapper allocates (61 MB at
// M = 6,000); each element is written once and read D / 256 times, from
// L2 while it lasts there.  On the H100, lag 8 beat 1, 2 and 4 at
// M = 6,000, and tiles of 128 x 128 (two blocks an SM, or six stages) and a
// cluster of two blocks sharing the weight box by TMA multicast were slower
// (development runs, PERF.md).  Each stage moves 48 KB from L2 for 4.2
// MFLOP, and the GELU epilogue of a phase-1 tile leaves the tensor cores
// idle: ping-pong consumers and TMA stores of g are the next steps.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

namespace sm90 = ta::sm90;
using sm90::ROW_BYTES;
using ta::pack_bf16;

constexpr int BM = 128;                        // rows of a tile: two consumer warpgroups
constexpr int BN = 256;                        // columns of a tile: two m64n128 products
constexpr int BK = sm90::BOX_COLS;             // depth of a stage: one 64-wide box
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                   // warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;  // and the producer warp
constexpr int A_BYTES = BM * ROW_BYTES;        // 16 KB
constexpr int B_BYTES = BN * ROW_BYTES;        // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// shared memory from a 1,024-byte aligned base: the stages, then full[STAGES],
// empty[STAGES], tile_full[2], tile_empty[2], then two tile slots
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr int SLOT_OFF = BAR_OFF + 8 * (2 * STAGES + 4);
constexpr int SMEM_ALLOC = SLOT_OFF + 8 + 1024;
constexpr int CONSUMER_BARRIER = 1;            // named barrier of the 256 consumer threads
constexpr int LAG = 8;                         // queue lag in row blocks (min(LAG, rows))
constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2 / pi)

__device__ __forceinline__ float gelu_tanh(float h) {
  return 0.5f * h * (1.f + tanhf(GELU_C * (h + 0.044715f * h * h * h)));
}

// The queue of tiles (ops/encoder_ffn.ffn_tile_plan is its Python mirror).
struct Plan {
  int rows;   // row blocks of BM
  int n1;     // phase-1 tiles a row block: ceil(F / BN)
  int n2;     // phase-2 tiles a row block: ceil(D / BN)
  int lag;    // row blocks between a block's phase-1 and its phase-2 tiles: min(LAG, rows)
  int total;  // rows * (n1 + n2)
};

struct Tile {
  int phase;  // 1: g = gelu(x W1^T + b1); 2: out = g W2^T + b2
  int rb;     // row block
  int cb;     // column block of BN
};

// Queue position t: first the phase-1 tiles of row blocks 0 .. lag - 1;
// then, for i = lag .. rows - 1, row block i's phase-1 tiles followed by
// row block i - lag's phase-2 tiles; last the phase-2 tiles of the final
// lag row blocks.
__device__ __forceinline__ Tile tile_of(const Plan& p, int t) {
  const int head = p.lag * p.n1;
  if (t < head) return {1, t / p.n1, t % p.n1};
  t -= head;
  const int per = p.n1 + p.n2;
  const int body = (p.rows - p.lag) * per;
  if (t < body) {
    const int s = t / per, r = t % per;
    return r < p.n1 ? Tile{1, p.lag + s, r} : Tile{2, s, r - p.n1};
  }
  t -= body;
  return {2, p.rows - p.lag + t / p.n2, t % p.n2};
}

__global__ void __launch_bounds__(THREADS, 1)
encoder_ffn_sm90(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap w1_map,
                 const __grid_constant__ CUtensorMap g_map,
                 const __grid_constant__ CUtensorMap w2_map,
                 const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ b2,
                 __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ out,
                 int* __restrict__ counters,  // [0] queue, [1] blocks done, [2 + i] row block i
                 int M, int D, int F, Plan plan) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* tile_full = empty + STAGES;
  uint64_t* tile_empty = tile_full + 2;
  volatile int* slots = reinterpret_cast<volatile int*>(smem + SLOT_OFF);
  int* queue = counters;
  int* done = counters + 1;
  int* ready = counters + 2;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS * 4);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&tile_full[s], 1);
      sm90::mbar_init(&tile_empty[s], CONSUMERS * 4);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // ---- producer: claim a tile, hand it to the consumers, stream its boxes
    if (lane == 0) {
      sm90::prefetch_tensor_map(&x_map);
      sm90::prefetch_tensor_map(&w1_map);
      sm90::prefetch_tensor_map(&g_map);
      sm90::prefetch_tensor_map(&w2_map);
      int it = 0;  // stages filled so far
      for (int j = 0;; ++j) {
        const int slot = j & 1;
        sm90::mbar_wait(&tile_empty[slot], ((j >> 1) & 1) ^ 1);
        const int t = atomicAdd(queue, 1);
        slots[slot] = t;
        sm90::mbar_arrive(&tile_full[slot]);
        if (t >= plan.total) break;
        const Tile tile = tile_of(plan, t);
        const bool first = tile.phase == 1;
        if (!first) {
          // every phase-1 tile of the row block has stored its g
          while (sm90::ld_acquire_gpu(ready + tile.rb) < plan.n1) __nanosleep(64);
          sm90::fence_proxy_async_global();
        }
        const CUtensorMap* a_map = first ? &x_map : &g_map;
        const CUtensorMap* b_map = first ? &w1_map : &w2_map;
        const int depth = (first ? D : F) / BK;
        for (int kb = 0; kb < depth; ++kb, ++it) {
          const int s = it % STAGES;
          sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
          uint8_t* st = smem + s * STAGE_BYTES;
          sm90::tma_load_4d(st, a_map, &full[s], 0, kb, tile.rb * BM, 0);
          sm90::tma_load_4d(st + A_BYTES, b_map, &full[s], 0, kb, tile.cb * BN, 0);
        }
      }
    }
    __syncwarp();
  } else {
    // ---- the consumer warpgroups: 64 rows of the tile each
    const int wg = warp / 4;
    const int gr = lane >> 2;
    const int t4 = lane & 3;
    int it = 0;  // stages consumed so far
    for (int j = 0;; ++j) {
      const int slot = j & 1;
      sm90::mbar_wait(&tile_full[slot], (j >> 1) & 1);
      const int t = slots[slot];
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&tile_empty[slot]);
      if (t >= plan.total) break;
      const Tile tile = tile_of(plan, t);
      const bool first = tile.phase == 1;
      const int depth = (first ? D : F) / BK;

      float acc[2][64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
      for (int kb = 0; kb < depth; ++kb, ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&full[s], (it / STAGES) & 1);
        const uint8_t* a_st = smem + s * STAGE_BYTES + wg * 64 * ROW_BYTES;
        const uint8_t* b_st = smem + s * STAGE_BYTES + A_BYTES;
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sm90::wgmma_ss<128, 0>(acc[h], sm90::desc_sw128(a_st + kk * 32, 16, 1024),
                                   sm90::desc_sw128(b_st + h * 128 * ROW_BYTES + kk * 32, 16, 1024),
                                   1);
          }
        }
        sm90::wgmma_commit();
        // the previous stage's products are done: hand its stage back
        sm90::wgmma_wait<1>();
        sm90::fence_operands(acc[0]);
        sm90::fence_operands(acc[1]);
        if (kb > 0) {
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(&empty[(it - 1) % STAGES]);
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc[0]);
      sm90::fence_operands(acc[1]);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[(it - 1) % STAGES]);

      // ---- epilogue: accumulator d[4 q + e] is row 16 w + gr + 8 (e / 2),
      // column 8 q + 2 t4 + (e % 2) of the warpgroup's 64 x 128 half h
      const int r0 = tile.rb * BM + wg * 64 + (warp % 4) * 16 + gr;
      const int r1 = r0 + 8;
      const int n_cols = first ? F : D;
      const __nv_bfloat16* bias = first ? b1 : b2;
      __nv_bfloat16* dst = first ? g : out;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int c = tile.cb * BN + h * 128 + 8 * q + 2 * t4;
          if (c >= n_cols) continue;  // n_cols is a multiple of 64
          const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + c);
          const float lo = __low2float(bb), hi = __high2float(bb);
          float v[4] = {acc[h][4 * q] + lo, acc[h][4 * q + 1] + hi, acc[h][4 * q + 2] + lo,
                        acc[h][4 * q + 3] + hi};
          if (first) {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = gelu_tanh(v[e]);
          }
          if (r0 < M) {
            *reinterpret_cast<uint32_t*>(dst + (int64_t)r0 * n_cols + c) = pack_bf16(v[0], v[1]);
          }
          if (r1 < M) {
            *reinterpret_cast<uint32_t*>(dst + (int64_t)r1 * n_cols + c) = pack_bf16(v[2], v[3]);
          }
        }
      }
      if (first) {
        // g of this tile is stored: publish it to the phase-2 tiles' TMA loads
        sm90::fence_proxy_async_global();
        sm90::named_barrier(CONSUMER_BARRIER, CONSUMERS * 128);
        if (threadIdx.x == 0) sm90::red_release_gpu_add(ready + tile.rb, 1);
      }
    }
  }

  // The last block to finish leaves the counters zero for the next launch:
  // every other block has claimed its last tile and stopped reading them.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(done, 1) == (int)gridDim.x - 1) {
      __threadfence();
      for (int i = 0; i < plan.rows; ++i) ready[i] = 0;
      *queue = 0;
      *done = 0;
      __threadfence();
    }
  }
}

}  // namespace

extern "C" {

// x [M, D], w1 [F, D], b1 [F], w2 [D, F], b2 [D] -> out [M, D], all bf16,
// contiguous, 16-byte aligned; g: scratch [M, F] bf16, 16-byte aligned;
// counters: 2 + ceil(M / 128) int32, zero (left zero).  D a multiple of
// 128, F a multiple of 64.  One block an SM, at most one a tile.  Returns
// the launch's CUDA error code.
int ta_encoder_ffn(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, void* g, void* counters, int M, int D, int F,
                   void* stream) {
  const int rows = (M + BM - 1) / BM;
  if (M <= 0 || F <= 0 || F % BK != 0 || D <= 0 || D % 128 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  for (const void* p : {x, w1, b1, w2, b2, static_cast<const void*>(out),
                        static_cast<const void*>(g)}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
  }
  CUtensorMap x_map, w1_map, g_map, w2_map;
  if (!sm90::make_map(&x_map, x, 1, M, D / BK, BK, BM) ||
      !sm90::make_map(&w1_map, w1, 1, F, D / BK, BK, BN) ||
      !sm90::make_map(&g_map, g, 1, M, F / BK, BK, BM) ||
      !sm90::make_map(&w2_map, w2, 1, D, F / BK, BK, BN)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(encoder_ffn_sm90,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_ALLOC);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int n1 = (F + BN - 1) / BN, n2 = (D + BN - 1) / BN;
  const Plan plan{rows, n1, n2, rows < LAG ? rows : LAG, rows * (n1 + n2)};
  const int grid = plan.total < sms ? plan.total : sms;
  encoder_ffn_sm90<<<grid, THREADS, SMEM_ALLOC, (cudaStream_t)stream>>>(
      x_map, w1_map, g_map, w2_map, static_cast<const __nv_bfloat16*>(b1),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(g),
      static_cast<__nv_bfloat16*>(out), static_cast<int*>(counters), M, D, F, plan);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block takes (ptxas reports only static shared memory).
int ta_encoder_ffn_smem_bytes() { return SMEM_ALLOC; }

}  // extern "C"
