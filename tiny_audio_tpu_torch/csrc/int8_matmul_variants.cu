// Kernel #9b for Hopper (sm_90a): the LM head's weight-only int8 product as
// the TPU bench scripts/bench_wq_head.py builds it (B, K, N = 48, 1024,
// 151936: x [48, 1024], the int8 head [1024, 151936], bf16 logits out).
//
//   ta_wq_matmul_pipe  replaces build_pipe(nc, nt) (pallas_call :104, body
//                      _pipe_kernel :48): #6's function (int8_matmul.cu,
//                      ta_wq_matmul), out = bf16((x . bf16(w_i8[:, n])) *
//                      scale[n]) with w [K, N], fp32 sums.  The TPU kernel
//                      streamed its weight by hand (make_async_copy and DMA
//                      semaphores, two [K, nt] tiles in flight); here the
//                      stream is the Tensor Memory Accelerator's.
//
// (build_a8, #9c, is ta_a8_matmul and build_a8t, #9d, ta_a8t_matmul, both in
// int8_matmul.cu: kinds of #5's and #6's split design.)
//
// What bounds it on the H100: the int8 weight (155.6 MB at the bench
// shape) read once, with the output (14.6 MB), x and the scales: ~170.9 MB
// at 3.35 TB/s, 0.051 ms; 14.9 G bf16 operations take 0.015 ms at 989
// TFLOP/s.  The first design (one block per nc-wide chunk: 19 blocks at nc =
// 8,192, 19 of 132 SMs on the stream) took 2.2 ms; this one takes ~0.077 ms
// from a CUDA graph on an H100 80GB HBM3 at 700 W, ~0.67 of the bound, and
// ~0.068 at B = 1 (chip_smoke.py; PERF.md has the runs).
//
// The design: TMA + mbarrier ring, wgmma with the weight in registers.
//   - Persistent blocks, one an SM (x and the ring fill its shared memory),
//     walk output tiles over the whole K (tile blockIdx.x, + gridDim.x, ...;
//     no split over K, so no merge and a fixed order of sums).  A tile is two
//     128-channel units (a "pair", 256 channels) or one (a "single"): pairs
//     as long as every block still takes ceil(units / blocks) units, then
//     singles.  At the head, 1,187 units on 132 SMs: 528 pairs and 131
//     singles, 9 units a block but one.  On the H100 256-byte runs of each k
//     row streamed markedly faster than 128-byte ones (128-channel tiles
//     alone ran at about #9c's share of the bound, at B = 1 as at 48), and
//     pairs alone (4.5 a block) left the card unevenly loaded.
//   - A producer warp keeps TMA box loads of the [K, N] int8 weight in flight
//     (boxes of BOX_K = 64 k rows x 128 channel bytes, 8 KB, the 128-byte
//     swizzle; a pair's stage is two boxes side by side, 16 KB) through a
//     ring of up to MAX_STAGES stages with full / empty mbarriers; the ring
//     runs on across a block's tiles, so one tile's epilogue overlaps the
//     next tile's loads.  It first loads x [B, K] bf16 whole, as boxes of
//     [NB][64] (rows past B read as zeros): the B operand of every product,
//     K-major, 96 KB at B = 48, kept for the block's life.
//   - Two consumer warpgroups, a unit each (warpgroup 1 idles on a single):
//     two m64nNk16 products (N = NB = B padded to 16, 32 or 48) a k16 step.
//     A thread reads a 32-bit word of its 4 channels at k rows 2t, 2t + 1,
//     2t + 8, 2t + 9 of each k16 step (pipe_offset: the swizzle undone, 32
//     banks) and converts them to the RS A fragments with #6's exact trick
//     (i8x2_to_bf16x2: one byte_perm gathers the same channel's byte from two
//     k rows into a bf16 pair, a mask, an OR and a subtraction make it
//     exact), so no transposes are needed: an RS register holds two k of one
//     channel.  M row r of product m, warp w holds channel 32 w + 4 (r % 8) +
//     2 m + r / 8 of the unit.  The slot is released as soon as the fragments
//     are in registers; a stage's products are one wgmma group, retired
//     before the next stage's fragments are written (converting the next
//     stage while a group was in flight made ptxas serialize every wgmma).
//   - Epilogue: fp32 sums x scale[n], rounded to bf16; a thread stores its 4
//     neighbouring channels of each of its batch rows as one 8-byte word, so
//     the 8 threads of a row group write a whole 64-byte run of a row of out
//     [B, N] (no pass through shared memory is needed).
// The fp32 sums run in k order inside each wgmma chain, with no atomics, so
// the output is bitwise repeatable; it agrees with #6 and its plain version
// within WQ_ATOL / WQ_RTOL.  The script's nc and nt set nothing here.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

namespace sm90 = ta::sm90;
using ta::i8x2_to_bf16x2;

constexpr int UNIT_N = 128;                     // channels of a TMA box's rows
constexpr int CONSUMERS = 2;                    // consumer warpgroups, a unit each
constexpr int MT = UNIT_N / 64;                 // m64 products of a warpgroup: 2
constexpr int TILE_N = CONSUMERS * UNIT_N;      // channels of a pair tile
constexpr int BOX_K = 64;                       // k rows of a weight stage
constexpr int BOX_BYTES = BOX_K * UNIT_N;       // a TMA box of [BOX_K][128] int8
constexpr int STAGE_BYTES = BOX_K * TILE_N;     // two boxes side by side
constexpr int THREADS = CONSUMERS * 128 + 32;
constexpr int MAX_ROWS = 48;                    // x rows: wgmma N up to 48
constexpr int MAX_STAGES = 128 * 1024 / STAGE_BYTES;
constexpr int MIN_STAGES = 4;
constexpr int SMEM_LIMIT = 227 * 1024;

struct PipeArgs {
  const float* scale;      // [N]
  __nv_bfloat16* out;      // [B, N]
  int B, K, N;
  int pairs, tiles;        // tiles 0 .. pairs - 1 are 256 channels, the rest 128
  int boxes, stages;
};

// Tile i's first channel and its units (1 or 2): pairs first, then singles.
__device__ __forceinline__ int tile_units(const PipeArgs& a, int i, int& n0) {
  n0 = i < a.pairs ? TILE_N * i : TILE_N * a.pairs + UNIT_N * (i - a.pairs);
  return i < a.pairs ? 2 : 1;
}

// Dynamic shared memory from a 1,024-byte aligned base: x (boxes of
// [NB][64] bf16, 128 bytes a row), the ring, then the x barrier and the
// stages' full and empty barriers.
struct PipeSmem {
  int x_bytes, ring_off, bar_off, bytes;
  __host__ __device__ PipeSmem(int nb, int k, int stages)
      : x_bytes(((k + BOX_K - 1) / BOX_K * BOX_K + 63) / 64 * nb * 128),  // zeros past K
        ring_off(x_bytes),
        bar_off(x_bytes + stages * STAGE_BYTES),
        bytes(bar_off + 8 * (1 + 2 * stages) + 1024) {}
};

// Byte offset in a stage of weight byte (k row `row`, channel byte `col` of
// the tile): box col / 128, whose 128-byte swizzle XORs the 16-byte chunk
// index with row % 8.
__device__ __forceinline__ int pipe_offset(int row, int col) {
  return (col >> 7) * BOX_BYTES + row * 128 + ((((col >> 4) & 7) ^ (row & 7)) << 4) + (col & 15);
}

// The A fragments of one box for this thread: k16 step s, k rows 16 s + 2t,
// + 1, + 8, + 9, a 32-bit word of the thread's 4 channels each; m64 product
// m takes bytes 2m (M row g) and 2m + 1 (M row g + 8).
__device__ __forceinline__ void box_fragments(const uint8_t* st, int col, int t,
                                              uint32_t (&fr)[BOX_K / 16][MT][4]) {
#pragma unroll
  for (int s = 0; s < BOX_K / 16; ++s) {
    uint32_t v[4];  // rows 2t, 2t + 1, 2t + 8, 2t + 9 of the step
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = 16 * s + 2 * t + (q & 1) + 8 * (q >> 1);
      v[q] = *reinterpret_cast<const uint32_t*>(st + pipe_offset(row, col));
    }
    fr[s][0][0] = i8x2_to_bf16x2<0>(v[0], v[1]);  // channel col, k 2t, 2t + 1
    fr[s][0][1] = i8x2_to_bf16x2<1>(v[0], v[1]);  // channel col + 1
    fr[s][0][2] = i8x2_to_bf16x2<0>(v[2], v[3]);  // channel col, k 2t + 8, 2t + 9
    fr[s][0][3] = i8x2_to_bf16x2<1>(v[2], v[3]);
    fr[s][1][0] = i8x2_to_bf16x2<2>(v[0], v[1]);  // channels col + 2, col + 3
    fr[s][1][1] = i8x2_to_bf16x2<3>(v[0], v[1]);
    fr[s][1][2] = i8x2_to_bf16x2<2>(v[2], v[3]);
    fr[s][1][3] = i8x2_to_bf16x2<3>(v[2], v[3]);
  }
}

template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
wq_pipe_sm90(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap x_map,
             const PipeArgs a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const PipeSmem lay(NB, a.K, a.stages);
  uint8_t* ring = smem + lay.ring_off;
  uint64_t* x_bar = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* full = x_bar + 1;
  uint64_t* empty = full + a.stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(x_bar, 1);
    for (int s = 0; s < a.stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS * 4);  // lane 0 of each consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // ---- producer: x whole, then the weight stages of the block's tiles
    if (lane == 0) {
      sm90::prefetch_tensor_map(&w_map);
      sm90::prefetch_tensor_map(&x_map);
      sm90::mbar_arrive_expect_tx(x_bar, lay.x_bytes);
      for (int xb = 0; xb < lay.x_bytes / (NB * 128); ++xb) {
        sm90::tma_load_2d(smem + xb * NB * 128, &x_map, x_bar, xb * 64, 0);
      }
      int it = 0;
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
        int n0;
        const int units = tile_units(a, tile, n0);
        for (int kb = 0; kb < a.boxes; ++kb, ++it) {
          const int slot = it % a.stages;
          sm90::mbar_wait(&empty[slot], ((it / a.stages) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&full[slot], units * BOX_BYTES);
          for (int u = 0; u < units; ++u) {
            sm90::tma_load_2d(ring + slot * STAGE_BYTES + u * BOX_BYTES, &w_map, &full[slot],
                              n0 + u * UNIT_N, kb * BOX_K);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup c takes unit c of a tile (idle on a single)
  const int c = warp / 4, w = warp % 4, g = lane >> 2, t = lane & 3;
  const int col = UNIT_N * c + 32 * w + 4 * g;  // this thread's 4 channels in the tile
  uint32_t fr[BOX_K / 16][MT][4];
  float acc[MT][NB / 2];
  sm90::mbar_wait(x_bar, 0);
  int it = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    int n0;
    const bool mine = c < tile_units(a, tile, n0);
    for (int kb = 0; kb < a.boxes; ++kb, ++it) {
      // the stage's fragments to registers and the slot released, then its
      // products as one group, retired before the fragments are rewritten
      // (an idle warpgroup waits for the stage too, so it never releases a
      // slot before its fill)
      const int slot = it % a.stages;
      sm90::mbar_wait(&full[slot], (it / a.stages) & 1);
      if (mine) box_fragments(ring + slot * STAGE_BYTES, col, t, fr);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[slot]);
      if (!mine) continue;
#pragma unroll
      for (int m = 0; m < MT; ++m) sm90::fence_operands(acc[m]);
      sm90::wgmma_fence();
#pragma unroll
      for (int s = 0; s < BOX_K / 16; ++s) {
        const int ks = kb * (BOX_K / 16) + s;  // the k16 step: x box ks / 4, 32 bytes a step
        const uint64_t desc =
            sm90::desc_sw128(smem + (ks >> 2) * NB * 128 + 32 * (ks & 3), 16, 1024);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          sm90::wgmma_rs<NB, 0>(acc[m], fr[s][m], desc, kb == 0 && s == 0 ? 0 : 1);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < BOX_K / 16; ++s) sm90::fence_operands(fr[s]);
#pragma unroll
      for (int m = 0; m < MT; ++m) sm90::fence_operands(acc[m]);
    }
    // acc[m][4 j + 2 h + e] is channel col + 2 m + h at batch row 8 j + 2 t + e
    const int n = n0 + col;
    if (mine && n < a.N) {  // N is a multiple of 16: all 4 channels are in
      const float4 sc4 = __ldg(reinterpret_cast<const float4*>(a.scale + n));
      const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int b = 8 * j + 2 * t + e;
          if (b < a.B) {
            uint32_t y[MT];
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              y[m] = ta::pack_bf16(__fmul_rn(acc[m][4 * j + e], sc[2 * m]),
                                   __fmul_rn(acc[m][4 * j + 2 + e], sc[2 * m + 1]));
            }
            *reinterpret_cast<uint2*>(a.out + (int64_t)b * a.N + n) = make_uint2(y[0], y[1]);
          }
        }
      }
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

// x rows padded to the product's N: 16, 32 or 48
int pipe_nb(int B) { return B <= 16 ? 16 : B <= 32 ? 32 : 48; }

// The ring's stages: as many as shared memory holds beside x, at most
// MAX_STAGES; 0 where fewer than MIN_STAGES fit (K too large for x to stay).
int pipe_stages(int B, int K) {
  const int room = SMEM_LIMIT - PipeSmem(pipe_nb(B), K, 0).bytes - 16 * MAX_STAGES;
  const int stages = std::min(MAX_STAGES, room / STAGE_BYTES);
  return stages < MIN_STAGES ? 0 : stages;
}

template <int NB>
int launch_pipe(const void* x, const void* w, PipeArgs a, cudaStream_t stream) {
  CUtensorMap w_map, x_map;
  if (!sm90::make_map_2d(&w_map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.N, a.K, a.N, UNIT_N,
                         BOX_K) ||
      !sm90::make_map_2d(&x_map, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.K, a.B, 2 * (int64_t)a.K,
                         64, NB)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = wq_pipe_sm90<NB>;
  const int smem = PipeSmem(NB, a.K, a.stages).bytes;
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  kernel<<<std::min(a.tiles, sm_count()), THREADS, smem, stream>>>(w_map, x_map, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, K] bf16 (B <= 48), w [K, N] int8, scale [N] fp32 -> out [B, N] bf16
// by persistent blocks over 256- and 128-channel tiles.  K and N multiples of
// 16, x, w and scale 16-byte aligned, every tensor contiguous; x must fit
// shared memory beside a ring of MIN_STAGES (K <= 1,664 at 48 rows).  nc (the TPU
// script's chunk width, a positive multiple of 32) sets nothing.  Returns
// the launch's CUDA error code.
int ta_wq_matmul_pipe(const void* x, const void* w, const void* scale, void* out, int B, int K,
                      int N, int nc, void* stream) {
  if (B <= 0 || B > MAX_ROWS || K <= 0 || N <= 0 || K % 16 || N % 16 || nc <= 0 || nc % 32) {
    return (int)cudaErrorInvalidValue;
  }
  const int stages = pipe_stages(B, K);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  // the grid's blocks take ceil(units / blocks) units each: as many pair
  // tiles as keep that even, then single tiles for the rest
  const int units = (N + UNIT_N - 1) / UNIT_N, blocks = std::min(units, sm_count());
  const int per_block = (units + blocks - 1) / blocks;
  const int pairs = std::min(per_block / 2 * blocks, units / 2);
  const PipeArgs a{static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), B, K, N,
                   pairs, units - pairs, (K + BOX_K - 1) / BOX_K, stages};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pipe_nb(B)) {
    case 16: return launch_pipe<16>(x, w, a, s);
    case 32: return launch_pipe<32>(x, w, a, s);
    default: return launch_pipe<48>(x, w, a, s);
  }
}

}  // extern "C"
