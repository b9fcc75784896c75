// The decode step's int8 matrix products for Hopper (sm_90a): a few
// activation rows (the decode batch: 4 at serving, 48 in the JAX bench)
// times an int8 weight with per-output-channel fp32 scales, bf16 out.
//
//   ta_w8a8_matmul  kernel #5, replaces tiny_audio_tpu/ops/wq_head.py:128
//                   (w8a8_matmul, pallas_call :146, body _kernel :102):
//                   out = bf16(((float)(x_i8 . wt_i8[n]) * sx[b]) * scale[n])
//                   with the activation quantized per row inside the launch
//                   (quantize_act: sx = max(max|x|, 1e-12) / 127, x_i8 =
//                   clamp(rint(x / sx), -127, 127), IEEE divisions), int32
//                   sums and the fp32 epilogue in that order, so the result
//                   is bitwise that of w8a8_matmul_xla.  wt is [N, K].
//   ta_wq_matmul    kernel #6, replaces tiny_audio_tpu/ops/wq_matmul.py:73
//                   (wq_matmul, pallas_call :92, body _kernel :63):
//                   out = bf16((x . bf16(w_i8[:, n])) * scale[n]), int8
//                   converted to bf16 exactly, fp32 sums; w is [K, N].
//   ta_a8_matmul    kernel #9c, replaces scripts/bench_wq_head.py:142
//                   (build_a8(nt), pallas_call :152, body _a8_kernel :133):
//                   #5's function on an activation quantized beforehand
//                   (x_i8 [B, K] int8, sx [B] fp32: quantize_act) and #6's
//                   weight layout, w_i8 [K, N] with N contiguous; int32 sums
//                   and #5's epilogue, so bitwise w8a8_matmul_xla on w_i8^T.
//                   The third kind of the split design below (A8).
//   ta_a8t_matmul   kernel #9d, replaces scripts/bench_wq_head.py:184
//                   (build_a8t(nt), pallas_call :197, body _a8t_kernel
//                   :174): #5's product on an activation quantized
//                   beforehand (x_i8, sx) and #5's weight layout, wt [N, K];
//                   bitwise w8a8_matmul_xla.  The fourth kind of the split
//                   design below (A8T): #5's stage and products, #9c's
//                   given x_i8 and sx.  Its first design (CUDA-core __dp4a
//                   tiles, one block per nt channels, x re-read every 16
//                   rows) took 1.6 ms at the bench shape, this kind ~0.09
//                   ms from a CUDA graph (~0.57 of its bound; #9c ~0.086,
//                   ~0.59; H100 80GB HBM3, 700 W, chip_smoke.py).
//
// The bound on the H100: a product reads each weight byte once and, at the
// decode batch, does 2 B operations with it, far below the card's ridge, so
// the int8 weight bytes over 3.35 TB/s bound it: 0.047 ms for the LM head
// (151,936 x 1,024), 0.3-0.9 us for a layer projection (1-3 MB), where one
// launch and one DRAM round trip take longer.  A decode step streams 28
// layers x 15 MiB and the 156 MB head, so every read is cold in L2.
//
// What the first design (CUDA-core tiles, one output tile a block) lost:
// the layer products gave the card 32-192 blocks of a few KB in flight each
// (an SM needs ~26 KB in flight to stream at 3.35 TB/s); #5 quantized the
// whole activation before asking for its first weight byte; a batch above
// 8 (#6) or 16 (#5) rows read the weights again per pass (#6 at B = 48: six
// reads of the head); #6 converted every weight with I2F (a quarter-rate
// pipe) and both ran their products on the CUDA cores.
//
// The design here (one launch a product, any B up to 64 in one pass), for
// four kinds of product: W8A8 (#5), WQ (#6), A8 (#9c: #6's [K, N] stage
// layout with #5's s8 products and no quantizing prologue) and A8T (#9d:
// #5's [N, K] stage and products, no quantizing prologue):
//
//   - a split over K sized by the launch (ops/wq_matmul.py int8_split_plan,
//     from shapes only): a product whose 32-channel tiles number 64 or more
//     (q, gate/up, the head) takes one split; a narrower one (k/v, o, down:
//     32 tiles) enough splits for ~128 work units, about one a SM: each
//     split more lengthens the launch by its merge, and on the H100 256
//     units were no faster than 128.
//     A block is 4 warps; a warp owns a sub-tile of 32 output channels x 32
//     k a stage, and the block's warps stand WN across the channels and
//     4 / WN along k (#5, #9d: WN = 1, 32 channels x 128 k a stage; #6: WN =
//     4 for the head, 128 channels x 32 k, WN = 1 for the layers): 128-byte
//     runs of each weight row but #6's layers' 32-byte ones.  Blocks are
//     persistent: the grid is at most what the SMs hold at once, and a
//     block walks its units;
//   - the weights stream through a ring of ~48 KB of stages in shared memory
//     by 16-byte cp.async.cg copies (zero-filled past K and N), issued
//     before #5 quantizes the activation (#9c and #9d load their x_i8 and
//     sx), so that runs under the copies; the
//     ring runs on across a block's units, so a unit's epilogue overlaps the
//     next unit's copies.  Each 128-byte run of a row lands in one 128-byte
//     span of the stage (stage_offset: on the H100 a run spread over four
//     sub-tiles slowed the head markedly), its chunks XOR-permuted so the
//     products' reads hit 32 banks.  #6's activation rows ride in the same
//     stages.  The s8 kinds at 32 rows or more, whose int8 activation and
//     sums take ~75 KB, use a ring half as deep where their blocks walk many
//     units (the head), so that two blocks share an SM;
//   - #5's prologue: every block takes each row's amax over the whole K (sx
//     must be bitwise quantize_act's) and quantizes only its split's chunk.
//     Above 8 rows, where a product has splits, a cluster of 4 blocks shares
//     the amax (each block reduces a quarter of the rows, and reads the
//     others' maxima from their shared memory);
//   - tensor-core products, weights as the MMA's 16 rows (output channels)
//     and the batch as its 8 columns (B padded to 8): #5 mma.sync m16n8k32
//     s8 -> s32 on the [N, K] rows (#9d the same); #9c the same MMA on the
//     [K, N] stage, an
//     A register (four k of one channel) made from four words of four k
//     rows (four channels each) by a 4 x 4 byte transpose (__byte_perm,
//     8 a group of 16 bytes); #6 mma.sync m16n8k16 bf16 -> fp32, the
//     int8 converted in registers without I2F (bf16 of 128 + (v & 127) by
//     a mask and an OR, minus 128 or 256 by v's sign: exact).  The order of
//     k inside an MMA is free, so each thread reads whole words of the tile
//     (#5 8 bytes of a row; #6 one word from each of 4 rows of the [K, N]
//     tile, #9c from each of 8), no ldmatrix: a thread's A register j of the
//     s8 MMA holds k 8t + 4 (j / 2) .. + 3 of the warp's 32, and its B
//     registers the same k of x_i8 read as one 8-byte word of the natural
//     row (#5, #9c and #9d alike).  wgmma (64 output channels as its A
//     operand, x as B in shared memory) is #9b's design
//     (int8_matmul_variants.cu, TMA-fed), not this one's;
//   - one deterministic merge inside the launch: a block with more than one
//     split writes its part (int32 for the s8 kinds, fp32 for #6) to a scratch the
//     wrapper allocates, fences, and counts itself on its tile's counter;
//     the last one sums the parts in split order (read with __ldcg: other
//     SMs' writes never reach this SM's L1) and writes the output.  #5, #9c
//     and #9d stay bitwise; #6 is repeatable run to run.  The counters are the wrapper's
//     (per device, never freed: a captured graph keeps their address), and
//     every launch leaves them zero.
//
// #6 keeps its first design (wq_matmul_kernel) for shapes the copies cannot
// take: N not a multiple of 16, K not a multiple of 8, or a tensor off a
// 16-byte boundary; the wrapper picks it by shape and alignment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using ta::i8x2_to_bf16x2;
using ta::mma_16816;
using ta::sm90::cp_async_16_zfill;
using ta::sm90::cp_async_commit;
using ta::sm90::cp_async_wait;

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

// --------------------------------------- the split design (#5, #6, #9c, #9d)

// the kinds of product (the template's first argument)
constexpr int WQ = 0;    // #6: bf16 x, [K, N] weight, fp32 sums
constexpr int W8A8 = 1;  // #5: bf16 x quantized in the launch, [N, K] weight, int32 sums
constexpr int A8 = 2;    // #9c: x_i8 and sx given, [K, N] weight, int32 sums
constexpr int A8T = 3;   // #9d: x_i8 and sx given, [N, K] weight, int32 sums

constexpr int THREADS = 128;             // 4 warps
constexpr int SUB = 32;                  // output channels and k of a warp's sub-tile
constexpr int SUB_BYTES = SUB * SUB;     // its int8 weights
constexpr int STAGE_W = 4 * SUB_BYTES;   // a stage's weights: a sub-tile a warp
constexpr int MAX_ROWS = 64;             // x rows of a launch: 8 MMA columns x 8
constexpr int X_PAD = 32;                // #5's x_i8 row: the split's k + 32 bytes
constexpr int RING_BYTES = 48 * 1024;    // the ring's shared memory, about
constexpr int AMAX_BATCH = 8;            // #5: 16-byte loads of x a thread has in flight
// #5: above AMAX_SHARE_ROWS rows of x, clusters of AMAX_CLUSTER blocks share
// the amax (each block reads B / AMAX_CLUSTER rows of x instead of B)
constexpr int AMAX_SHARE_ROWS = 8;
constexpr unsigned AMAX_CLUSTER = 4;
constexpr int SHALLOW_UNITS = 256;       // s8 kinds at 32+ rows: more units take the shallow ring

struct SplitArgs {
  const __nv_bfloat16* x;  // [B, K] (#5, #6)
  const int8_t* x_i8;      // [B, K] and sx [B] (#9c, #9d)
  const float* sx;
  const int8_t* w;         // #5, #9d: [N, K]; #6, #9c: [K, N]
  const float* scale;      // [N]
  __nv_bfloat16* out;      // [B, N]
  void* partial;           // [splits, B, n_part] int32 (s8 kinds) or fp32 (#6); null with one split
  int* counters;           // [tiles], zero between launches
  int B, K, N;
  int split_k;             // k of a split, a multiple of a stage's k
  int splits, tiles;
  int n_part;              // a partial row's length: N rounded up to 4
};

template <int KIND, int NT, int WN, bool SHALLOW>
struct Layout {
  static constexpr bool S8 = KIND != WQ;  // s8 products, int32 sums, x_i8 in shared memory
  static constexpr int WK = 4 / WN;     // warps along k
  static constexpr int TN = SUB * WN;   // output channels of a tile
  static constexpr int KT = SUB * WK;   // k of a stage
  static constexpr int BP = 8 * NT;     // x rows, padded to the MMA's 8 columns
  // #6: the stage's x slices, [wk][BP][32] bf16, 64 bytes a row
  static constexpr int STAGE_X = S8 ? 0 : WK * BP * 64;
  static constexpr int STAGE = STAGE_W + STAGE_X;
  // the ring's depth: about RING_BYTES of stages, 3 to 12; SHALLOW: half as
  // deep (#5, #9c, #9d at 32 rows or more when the blocks walk many units: launch_nt)
  static constexpr int STAGES =
      std::min(12, std::max(3, (SHALLOW ? RING_BYTES / 2 : RING_BYTES) / STAGE));
  static constexpr int RING = STAGES * STAGE;
  static constexpr int RED = WK * BP * TN * 4;  // the warps' sums, [wk][BP][TN]
  // #5, #9c, #9d after these: x_i8 [BP][split_k + X_PAD], sx [64] fp32; #5
  // the warps' amax [4][64]
  static int smem(int split_k) {
    return RING + RED + (S8 ? BP * (split_k + X_PAD) + 64 * 4 : 0) +
           (KIND == W8A8 ? 4 * 64 * 4 : 0);
  }
};

__device__ __forceinline__ void add4(int4& a, int4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}
__device__ __forceinline__ void add4(float4& a, float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where 16-byte chunk c of tile row `row` sits in a stage.  Each row's run
// from global memory lands in one span (the copy unit writes a returning
// line into as few shared-memory lines as it can), and the chunks are
// XOR-permuted so the products' reads hit 32 banks:
//   #5, #9d: 32 channel rows x 128 k bytes, chunk c at c ^ 2 (row % 4): warp
//       wk reads chunks 2 wk, 2 wk + 1 of 4 neighbouring rows at once;
//   #6, WN = 4: 32 k rows x 128 channel bytes, chunk c at c ^ 2 ((row / 4) %
//       4): warp wn reads its 32 channels of rows 4 t + q, t = 0..3;
//   #9c (WN = 4): 32 k rows x 128 channel bytes, chunk c at c ^ 2 ((row / 8)
//       % 4): warp wn reads its 32 channels of rows 8 t + q, t = 0..3;
//   #6, WN = 1: 128 k rows x 32 channel bytes, sub-tile row / 32 of [32][32],
//       k row 16 h + 4 t + q at row 16 h + 4 q + (t ^ q): a thread's 4 rows
//       (q) for its t and the 4 rows of a copy's quarter-warp hit 32 banks.
template <int KIND, int WN>
__device__ __forceinline__ int stage_offset(int row, int c) {
  if (KIND == W8A8 || KIND == A8T) return row * 128 + ((c ^ ((row & 3) << 1)) * 16);
  if (KIND == A8) return row * 128 + ((c ^ (((row >> 3) & 3) << 1)) * 16);
  if (WN == 4) return row * 128 + ((c ^ (((row >> 2) & 3) << 1)) * 16);
  const int r = row % SUB, h = r >> 4, t = (r >> 2) & 3, q = r & 3;
  return (row / SUB) * SUB_BYTES + (16 * h + 4 * q + (t ^ q)) * SUB + c * 16;
}

// quantize_act's clamp(rint(x / sx), -127, 127) of 8 bf16, IEEE divisions
__device__ __forceinline__ uint2 quantize8(uint4 raw, float sx) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
  unsigned q[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float x = __uint_as_float(j % 2 ? w[j / 2] & 0xFFFF0000u : w[j / 2] << 16);
    const int v = min(max(__float2int_rn(__fdiv_rn(x, sx)), -127), 127);
    q[j / 4] |= (unsigned)(v & 0xFF) << (8 * (j % 4));
  }
  return make_uint2(q[0], q[1]);
}

// ---- thread block clusters (#5's shared amax): this block's rank and the
// cluster's size (1 and 1 outside a cluster launch), a barrier over the
// cluster in two halves, and a 32-bit read of another block's shared memory
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
__device__ __forceinline__ unsigned ld_cluster(const unsigned* p, unsigned rank) {
  unsigned remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(ta::sm90::smem_addr(p)), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// max |x| over 8 bf16 as the bits of a non-negative bf16 (their order is
// the values' order)
__device__ __forceinline__ unsigned absmax_bits(uint4 v) {
  const unsigned m = __vmaxu2(__vmaxu2(v.x & 0x7FFF7FFFu, v.y & 0x7FFF7FFFu),
                              __vmaxu2(v.z & 0x7FFF7FFFu, v.w & 0x7FFF7FFFu));
  return max(m & 0xFFFFu, m >> 16);
}

// 4 x 4 bytes transposed: word j of the result holds byte j of w0, w1, w2,
// w3 (in that order), i.e. four k of channel j from four k rows' words
__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                             uint32_t (&c)[4]) {
  const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
  const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);
  c[1] = __byte_perm(lo01, lo23, 0x7632);
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
}

template <int KIND, int NT, int WN, bool SHALLOW>
__global__ void __launch_bounds__(THREADS) split_matmul_kernel(const SplitArgs a) {
  using L = Layout<KIND, NT, WN, SHALLOW>;
  constexpr bool S8 = L::S8;           // #5, #9c, #9d: s8 products, int32 sums
  constexpr bool KN = KIND == WQ || KIND == A8;  // #6, #9c: the weight is [K, N]
  constexpr bool GIVEN = KIND == A8 || KIND == A8T;  // #9c, #9d: x_i8 and sx given
  using Acc = typename std::conditional<S8, int, float>::type;
  using Vec = typename std::conditional<S8, int4, float4>::type;
  constexpr int WK = L::WK, TN = L::TN, KT = L::KT, BP = L::BP, STAGES = L::STAGES;
  constexpr int OUTS = (BP * TN / 4 + THREADS - 1) / THREADS;  // 4-channel outputs a thread
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  Acc* red = reinterpret_cast<Acc*>(smem + L::RING);
  const int xs = a.split_k + X_PAD;  // #5, #9c, #9d: bytes of an x_i8 row
  int8_t* s_x = reinterpret_cast<int8_t*>(smem + L::RING + L::RED);
  float* s_sx = reinterpret_cast<float*>(smem + L::RING + L::RED + BP * xs);
  unsigned* s_wmax = reinterpret_cast<unsigned*>(s_sx + 64);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // the MMA fragments' group and thread
  const int wn = warp % WN, wk = warp / WN;
  const int B = a.B, K = a.K, N = a.N;
  const int units = a.tiles * a.splits;
  const auto unit_stages = [&](int split) {
    return (min(a.split_k, K - split * a.split_k) + KT - 1) / KT;
  };

  // The ring: the block's stages, unit after unit, stage j in slot j % STAGES.
  int p_unit = blockIdx.x, p_stage = 0, p_slot = 0;
  const auto issue = [&]() {
    if (p_unit < units) {
      const int tile = p_unit % a.tiles, split = p_unit / a.tiles;
      const int kb = split * a.split_k + p_stage * KT, n0 = tile * TN;
      unsigned char* st = smem + p_slot * L::STAGE;
#pragma unroll
      // The weights: 256 copies of 16 bytes, 8 lanes on each 128-byte run
      // (#6 at WN = 1: 2 lanes on each 32-byte run) of a row, which lands in
      // one 128-byte (32-byte) span of the stage (see stage_offset).
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = tid + j * THREADS;
        const int row = i / (KN ? TN / 16 : 8);
        const int c = i % (KN ? TN / 16 : 8);
        int64_t off;
        bool ok;
        if constexpr (!KN) {  // channel row `row` of [N, K], k chunk c
          const int n = n0 + row, k = kb + c * 16;
          ok = n < N && k < K;
          off = (int64_t)n * K + k;
        } else {  // k row `row` of [K, N], channel chunk c
          const int k = kb + row, n = n0 + c * 16;
          ok = k < K && n < N;
          off = (int64_t)k * N + n;
        }
        cp_async_16_zfill(st + stage_offset<KIND, WN>(row, c), ok ? a.w + off : a.w, ok);
      }
      if constexpr (KIND == WQ) {  // x [wk][BP][32] bf16, 16-byte chunks swizzled by row
        for (int gi = tid; gi < WK * BP * 4; gi += THREADS) {
          const int sw = gi / (BP * 4), b = (gi / 4) % BP, c = gi % 4;
          const int k = kb + sw * SUB + c * 8;
          const bool ok = b < B && k < K;
          cp_async_16_zfill(st + STAGE_W + (sw * BP + b) * 64 + (c ^ (((b >> 1) & 1) << 1)) * 16,
                            ok ? a.x + (int64_t)b * K + k : a.x, ok);
        }
      }
      if (++p_stage == unit_stages(split)) {
        p_stage = 0;
        p_unit += gridDim.x;
      }
    }
    cp_async_commit();  // an empty group past the last unit keeps the count
    p_slot = p_slot + 1 == STAGES ? 0 : p_slot + 1;
  };
#pragma unroll 1
  for (int i = 0; i < STAGES - 1; ++i) issue();

  if constexpr (GIVEN) {  // sx as quantize_act gave it
    if (tid < B) s_sx[tid] = __ldg(a.sx + tid);
  }
  if constexpr (KIND == W8A8) {
    // quantize_act's amax over each whole row, while the copies fly, shared
    // by the blocks of a cluster: block `rank` of `size` takes rows rank,
    // rank + size, ...  Slot s is its row rank + size (s / cpt), 16-byte
    // chunk tid + THREADS * (s % cpt); AMAX_BATCH loads at once.
    const unsigned rank = cluster_rank(), size = cluster_size();
    const int mine = (B - (int)rank + (int)size - 1) / (int)size;  // rows of this block
    const int chunks = K / 8, cpt = (chunks + THREADS - 1) / THREADS, slots = mine * cpt;
    unsigned m = 0;
    for (int s0 = 0; s0 < slots; s0 += AMAX_BATCH) {
      uint4 v[AMAX_BATCH];
#pragma unroll
      for (int u = 0; u < AMAX_BATCH; ++u) {
        const int sl = s0 + u, c = tid + THREADS * (sl % cpt);
        const int row = rank + size * (sl / cpt);
        v[u] = sl < slots && c < chunks
                   ? __ldg(reinterpret_cast<const uint4*>(a.x + (int64_t)row * K) + c)
                   : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < AMAX_BATCH; ++u) {
        const int sl = s0 + u;
        m = max(m, absmax_bits(v[u]));
        if (sl < slots && sl % cpt == cpt - 1) {  // the row's last slot (warp-uniform)
          m = __reduce_max_sync(0xffffffffu, m);
          if (lane == 0) s_wmax[warp * 64 + rank + size * (sl / cpt)] = m;
          m = 0;
        }
      }
    }
    __syncthreads();
    if (tid < B && tid % size == rank) {
      unsigned mb = s_wmax[tid];
#pragma unroll
      for (int w = 1; w < 4; ++w) mb = max(mb, s_wmax[w * 64 + tid]);
      s_wmax[tid] = mb;  // the row's amax, for the cluster to read
    }
    if (size > 1) cluster_sync();
    else __syncthreads();
    if (tid < B) {  // row tid's amax from the block that took it
      const unsigned mb = size > 1 ? ld_cluster(&s_wmax[tid], tid % size) : s_wmax[tid];
      s_sx[tid] = __fdiv_rn(fmaxf(__uint_as_float(mb << 16), 1e-12f), 127.f);
    }
    if (size > 1) cluster_arrive();  // done with the other blocks' shared memory (wait at exit)
  }

  int q_split = -1;  // #5, #9c, #9d: the split whose x_i8 is in shared memory
  int c_slot = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = u % a.tiles, split = u / a.tiles;
    const int k0 = split * a.split_k, nst = unit_stages(split);
    // this thread's 4 output channels in the epilogue, and their scales, asked for now
    const int c4 = (tid % (TN / 4)) * 4, n4 = tile * TN + c4;
    float scale4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) scale4[j] = n4 + j < N ? __ldg(a.scale + n4 + j) : 0.f;
    if constexpr (S8) {
      if (split != q_split) {  // x_i8 of [k0, k0 + split_k), zero past K and B
        __syncthreads();       // sx is ready; nobody reads the last split's x_i8
        const int cpr = a.split_k / 8;
#pragma unroll 4
        for (int i = tid; i < BP * cpr; i += THREADS) {
          const int b = i / cpr, c = i % cpr, k = k0 + c * 8;
          uint2 packed = make_uint2(0, 0);
          if (b < B && k < K) {
            if constexpr (KIND == W8A8) {
              packed = quantize8(__ldg(reinterpret_cast<const uint4*>(a.x + (int64_t)b * K + k)),
                                 s_sx[b]);
            } else {  // #9c, #9d: K is a multiple of 16, so 8 bytes are all in or all out
              packed = __ldg(reinterpret_cast<const uint2*>(a.x_i8 + (int64_t)b * K + k));
            }
          }
          *reinterpret_cast<uint2*>(s_x + b * xs + c * 8) = packed;
        }
        q_split = split;
      }
    }

    Acc acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
      }
    }
    for (int s = 0; s < nst; ++s) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // the stage landed for every thread; the slot refilled below is free
      issue();
      const unsigned char* st = smem + c_slot * L::STAGE;
      if constexpr (KIND == W8A8 || KIND == A8T) {
        const int kc = s * KT + wk * SUB;  // this warp's 32 k: a column of x_i8
        const int cw = 2 * wk + (t >> 1), bw = 8 * (t & 1);  // its chunk and byte in it
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint2 lo = *reinterpret_cast<const uint2*>(
              st + stage_offset<KIND, 1>(mt * 16 + g, cw) + bw);
          const uint2 hi = *reinterpret_cast<const uint2*>(
              st + stage_offset<KIND, 1>(mt * 16 + g + 8, cw) + bw);
          af[mt][0] = lo.x;
          af[mt][1] = hi.x;
          af[mt][2] = lo.y;
          af[mt][3] = hi.y;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 xv = *reinterpret_cast<const uint2*>(s_x + (nt * 8 + g) * xs + kc + 8 * t);
          mma_s8(acc[0][nt], af[0], xv.x, xv.y);
          mma_s8(acc[1][nt], af[1], xv.x, xv.y);
        }
      } else if constexpr (KIND == A8) {
        // k rows 8t + q (q < 8) of the stage, channels 32 wn + 4g .. + 3
        // (chunk 2 wn + g / 4, word g % 4), transposed: lo[j] is channel 4g +
        // j at k 8t .. 8t + 3, hi[j] at 8t + 4 .. 8t + 7
        uint32_t wv[8], lo[4], hi[4];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          wv[q] = *reinterpret_cast<const uint32_t*>(
              st + stage_offset<A8, 4>(8 * t + q, 2 * wn + (g >> 2)) + 4 * (g & 3));
        }
        transpose4x4(wv[0], wv[1], wv[2], wv[3], lo);
        transpose4x4(wv[4], wv[5], wv[6], wv[7], hi);
        // rows g and g + 8 of MMA tile mt are channels 4g + mt and 4g + 2 + mt
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          af[mt][0] = lo[mt];
          af[mt][1] = lo[2 + mt];
          af[mt][2] = hi[mt];
          af[mt][3] = hi[2 + mt];
        }
        const int kc = s * KT;  // the stage's 32 k: a column of x_i8
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 xv = *reinterpret_cast<const uint2*>(s_x + (nt * 8 + g) * xs + kc + 8 * t);
          mma_s8(acc[0][nt], af[0], xv.x, xv.y);
          mma_s8(acc[1][nt], af[1], xv.x, xv.y);
        }
      } else {
        const unsigned char* xsl = st + STAGE_W + wk * BP * 64;
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // two k16 steps; thread t takes k 16h + 4t .. + 3
          uint32_t wv[4];  // k row 16h + 4t + q, channels 4g .. 4g + 3
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // channels 32 wn + 4g .. + 3: chunk 2 wn + g / 4 (WN = 4), g / 4 (WN = 1)
            wv[q] = *reinterpret_cast<const uint32_t*>(
                st + stage_offset<false, WN>(wk * SUB + 16 * h + 4 * t + q, 2 * wn + (g >> 2)) +
                4 * (g & 3));
          }
          // rows g and g + 8 of MMA tile mt are channels 4g + mt and 4g + 2 + mt
          uint32_t af[2][4];
          af[0][0] = i8x2_to_bf16x2<0>(wv[0], wv[1]);
          af[0][1] = i8x2_to_bf16x2<2>(wv[0], wv[1]);
          af[0][2] = i8x2_to_bf16x2<0>(wv[2], wv[3]);
          af[0][3] = i8x2_to_bf16x2<2>(wv[2], wv[3]);
          af[1][0] = i8x2_to_bf16x2<1>(wv[0], wv[1]);
          af[1][1] = i8x2_to_bf16x2<3>(wv[0], wv[1]);
          af[1][2] = i8x2_to_bf16x2<1>(wv[2], wv[3]);
          af[1][3] = i8x2_to_bf16x2<3>(wv[2], wv[3]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int b = nt * 8 + g, c = 2 * h + (t >> 1);
            const uint2 xv = *reinterpret_cast<const uint2*>(
                xsl + b * 64 + (c ^ (((b >> 1) & 1) << 1)) * 16 + (t & 1) * 8);
            mma_16816(acc[0][nt], af[0], xv.x, xv.y);
            mma_16816(acc[1][nt], af[1], xv.x, xv.y);
          }
        }
      }
      c_slot = c_slot + 1 == STAGES ? 0 : c_slot + 1;
    }

    // The warps' sums to shared memory: C element e of tile (mt, nt) is
    // column (batch row) 8 nt + 2t + e % 2 and MMA row g + 8 (e / 2).
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = nt * 8 + 2 * t + (e & 1);
          const int ch = KN ? 4 * g + 2 * (e >> 1) + mt : mt * 16 + g + 8 * (e >> 1);
          red[(wk * BP + b) * TN + wn * SUB + ch] = acc[mt][nt][e];
        }
      }
    }
    __syncthreads();
    // A thread takes 4 channels c4 .. c4 + 3 of rows b = o / (TN / 4), for o
    // = tid + THREADS i (TN divides THREADS, so c4 is the same for every i).
    const auto block_sum = [&](int b) {
      Vec v = *reinterpret_cast<const Vec*>(red + b * TN + c4);
#pragma unroll
      for (int w = 1; w < WK; ++w) {
        add4(v, *reinterpret_cast<const Vec*>(red + (w * BP + b) * TN + c4));
      }
      return v;
    };
    const auto store = [&](Vec v, int b) {  // the 4 outputs, in one 8-byte store where aligned
      const Acc e[4] = {v.x, v.y, v.z, v.w};
      unsigned short y[4];  // bf16 bits
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float r;
        if constexpr (S8) {
          r = __fmul_rn(__fmul_rn(__int2float_rn(e[j]), s_sx[b]), scale4[j]);
        } else {
          r = __fmul_rn(e[j], scale4[j]);
        }
        y[j] = __bfloat16_as_ushort(__float2bfloat16_rn(r));
      }
      __nv_bfloat16* o = a.out + (int64_t)b * N + n4;
      if (N % 4 == 0 && n4 + 4 <= N) {
        *reinterpret_cast<uint2*>(o) = make_uint2(y[0] | (unsigned)y[1] << 16,
                                                  y[2] | (unsigned)y[3] << 16);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n4 + j < N) o[j] = __ushort_as_bfloat16(y[j]);
        }
      }
    };
    if (a.splits == 1) {
#pragma unroll 1
      for (int i = 0; i < OUTS; ++i) {
        const int b = (tid + i * THREADS) / (TN / 4);
        if (b < B) store(block_sum(b), b);
      }
      continue;
    }
    // This split's part to the scratch; the tile's last split merges them.
    Acc* part = static_cast<Acc*>(a.partial);
    const auto part_at = [&](int sp, int b) {
      return part + ((int64_t)sp * B + b) * a.n_part + n4;
    };
#pragma unroll
    for (int i = 0; i < OUTS; ++i) {
      const int b = (tid + i * THREADS) / (TN / 4);
      if (b < B && n4 < N) *reinterpret_cast<Vec*>(part_at(split, b)) = block_sum(b);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(a.counters + tile, 1) == a.splits - 1;
    __syncthreads();
    if (!s_last) continue;
    __threadfence();
#pragma unroll 1
    for (int i = 0; i < OUTS; ++i) {  // the parts in split order, read from L2
      const int b = (tid + i * THREADS) / (TN / 4);
      if (b < B && n4 < N) {
        Vec v = __ldcg(reinterpret_cast<const Vec*>(part_at(0, b)));
#pragma unroll 8
        for (int sp = 1; sp < a.splits; ++sp) {
          add4(v, __ldcg(reinterpret_cast<const Vec*>(part_at(sp, b))));
        }
        store(v, b);
      }
    }
    if (tid == 0) a.counters[tile] = 0;  // ready for the next launch
  }
  cp_async_wait<0>();
  if constexpr (KIND == W8A8) {
    if (cluster_size() > 1) cluster_wait();  // no block leaves while another reads its amax
  }
}

template <int KIND, int NT, int WN, bool SHALLOW>
int launch_split(const SplitArgs& a, cudaStream_t stream) {
  using L = Layout<KIND, NT, WN, SHALLOW>;
  const auto kernel = split_matmul_kernel<KIND, NT, WN, SHALLOW>;
  static int allowed = 0, occupancy_smem = -1, occupancy = 0;
  const int smem = L::smem(a.split_k);
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  if (smem != occupancy_smem) {  // blocks an SM holds at this shared memory
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, kernel, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    occupancy_smem = smem;
  }
  if (occupancy < 1) return (int)cudaErrorInvalidConfiguration;
  int grid = std::min(a.tiles * a.splits, occupancy * sm_count());
  if (KIND != W8A8 || a.B <= AMAX_SHARE_ROWS || a.splits == 1) {
    kernel<<<grid, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  // #5 with many rows and a split: clusters of blocks share the activation's
  // amax (a whole multiple of them; a block past the units only helps)
  const unsigned cluster = AMAX_CLUSTER;
  grid = (grid + cluster - 1) / cluster * cluster;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeClusterDimension;
  attribute.val.clusterDim.x = cluster;
  attribute.val.clusterDim.y = 1;
  attribute.val.clusterDim.z = 1;
  config.attrs = &attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The instance for the batch: 8, 16, 32, 48 or 64 rows of x in the MMA.
// #5, #9c and #9d at 32 rows or more take ~75 KB of shared memory besides the
// ring: where the blocks walk many units (more than SHALLOW_UNITS: the
// head), the shallow ring lets two blocks share an SM (faster for #5 on the
// H100 at B = 48); a block with one unit keeps the deep ring, every stage of
// its unit in flight at once (the shallow one was slower there).
template <int KIND, int NT, int WN>
int launch_nt(const SplitArgs& a, cudaStream_t s) {
  if constexpr (KIND != WQ && NT >= 4) {
    if (a.tiles * a.splits > SHALLOW_UNITS) return launch_split<KIND, NT, WN, true>(a, s);
  }
  return launch_split<KIND, NT, WN, false>(a, s);
}

template <int KIND, int WN>
int launch_rows(const SplitArgs& a, cudaStream_t s) {
  if (a.B <= 8) return launch_nt<KIND, 1, WN>(a, s);
  if (a.B <= 16) return launch_nt<KIND, 2, WN>(a, s);
  if (a.B <= 32) return launch_nt<KIND, 4, WN>(a, s);
  if (a.B <= 48) return launch_nt<KIND, 6, WN>(a, s);
  return launch_nt<KIND, 8, WN>(a, s);
}

// The block arrangements: #5 and #9d wn = 1 ([N, K] rows), #9c wn = 4
// (128-byte runs of its [K, N] rows), #6 either.
int launch_split_design(int kind, SplitArgs a, int wn, void* stream) {
  const bool wn_ok = kind == W8A8 || kind == A8T ? wn == 1 : kind == A8 ? wn == 4
                                                                        : wn == 1 || wn == 4;
  if (a.B < 1 || a.B > MAX_ROWS || a.K <= 0 || a.N <= 0 || a.K % 8 || a.split_k <= 0 ||
      !wn_ok || a.split_k % (SUB * (4 / wn)) || (kind != W8A8 && a.N % 16) ||
      (kind != WQ && a.K % 16)) {
    return (int)cudaErrorInvalidValue;
  }
  a.splits = (a.K + a.split_k - 1) / a.split_k;
  a.tiles = (a.N + SUB * wn - 1) / (SUB * wn);
  a.n_part = (a.N + 3) / 4 * 4;
  if (a.splits > 1 && (a.partial == nullptr || a.counters == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == W8A8) return launch_rows<W8A8, 1>(a, s);
  if (kind == A8) return launch_rows<A8, 4>(a, s);
  if (kind == A8T) return launch_rows<A8T, 1>(a, s);
  return wn == 4 ? launch_rows<WQ, 4>(a, s) : launch_rows<WQ, 1>(a, s);
}

SplitArgs split_args(const void* x, const void* x_i8, const void* sx, const void* w,
                     const void* scale, void* out, void* partial, void* counters, int B, int K,
                     int N, int split_k) {
  SplitArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.x_i8 = static_cast<const int8_t*>(x_i8);
  a.sx = static_cast<const float*>(sx);
  a.w = static_cast<const int8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.partial = partial;
  a.counters = static_cast<int*>(counters);
  a.B = B;
  a.K = K;
  a.N = N;
  a.split_k = split_k;
  return a;
}

// ------------------------------------------- #6's first design's tiles

constexpr int MAX_PASS_ROWS = 16;          // activation rows per pass
constexpr int SMEM_BUDGET = 200 * 1024;    // dynamic shared memory a block may take
constexpr int BLOCKS_PER_SM = 4;

// Whether tiles of `tile` output channels still give every SM two of them:
// the wide tiling (more bytes in flight per lane) then reads the weight
// faster; a narrower one gives a narrow product more blocks.
bool wide(int N, int tile) { return N / tile >= 2 * sm_count(); }

int grid_for(int tiles) {
  const int cap = sm_count() * BLOCKS_PER_SM;
  return std::min(tiles, cap);
}

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
template <> __device__ __forceinline__ void load_words<16>(const int8_t* p, int (&w)[4]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

// COLS output channels a lane (a COLS-byte load of a weight row), 8 lanes a
// row slot, so a block tile is 8 * COLS channels and 32 row slots; fp32 FMAs
// on the CUDA cores against the bf16 activations in shared memory; the 32
// row slots meet by shuffles and through shared memory in a fixed order.
template <int COLS>
__global__ void __launch_bounds__(WQ_THREADS) wq_matmul_kernel(WqArgs a) {
  constexpr int TILE = 8 * COLS;
  constexpr int ROWS = 128 / COLS < MAX_PASS_ROWS ? 128 / COLS : MAX_PASS_ROWS;
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
  constexpr int ROWS = 128 / COLS < MAX_PASS_ROWS ? 128 / COLS : MAX_PASS_ROWS;
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

}  // namespace

extern "C" {

// x [B, K] bf16, wt [N, K] int8, scale [N] fp32 -> out [B, N] bf16, by the
// split design with `split_k` k a split (a multiple of 128; wn = 1).  B <=
// 64, K a multiple of 16; x and wt 16-byte aligned, every tensor contiguous.
// With more than one split, `partial` holds splits x B x N int32 and
// `counters` ceil(N / 32) zeros.  Returns the launch's CUDA error code.
int ta_w8a8_matmul(const void* x, const void* wt, const void* scale, void* out, void* partial,
                   void* counters, int B, int K, int N, int wn, int split_k, void* stream) {
  return launch_split_design(
      W8A8, split_args(x, nullptr, nullptr, wt, scale, out, partial, counters, B, K, N, split_k),
      wn, stream);
}

// x_i8 [B, K] int8 and sx [B] fp32 (quantize_act's), w [K, N] int8, scale
// [N] fp32 -> out [B, N] bf16, by the split design with `split_k` k a split
// (a multiple of 32; wn = 4).  B <= 64, K and N multiples of 16; x_i8 and w
// 16-byte aligned, every tensor contiguous.  With more than one split,
// `partial` holds splits x B x N int32 and `counters` ceil(N / 128) zeros.
// Returns the launch's CUDA error code.
int ta_a8_matmul(const void* x_i8, const void* sx, const void* w, const void* scale, void* out,
                 void* partial, void* counters, int B, int K, int N, int wn, int split_k,
                 void* stream) {
  return launch_split_design(
      A8, split_args(nullptr, x_i8, sx, w, scale, out, partial, counters, B, K, N, split_k), wn,
      stream);
}

// x_i8 [B, K] int8 and sx [B] fp32 (quantize_act's), wt [N, K] int8, scale
// [N] fp32 -> out [B, N] bf16, by the split design with `split_k` k a split
// (a multiple of 128; wn = 1).  B <= 64, K and N multiples of 16; x_i8 and
// wt 16-byte aligned, every tensor contiguous.  With more than one split,
// `partial` holds splits x B x N int32 and `counters` ceil(N / 32) zeros.
// Returns the launch's CUDA error code.
int ta_a8t_matmul(const void* x_i8, const void* sx, const void* wt, const void* scale,
                  void* out, void* partial, void* counters, int B, int K, int N, int wn,
                  int split_k, void* stream) {
  return launch_split_design(
      A8T, split_args(nullptr, x_i8, sx, wt, scale, out, partial, counters, B, K, N, split_k),
      wn, stream);
}

// x [B, K] bf16, w [K, N] int8, scale [N] fp32 -> out [B, N] bf16; every
// tensor contiguous.  wn = 1 or 4: the split design with `split_k` k a split
// (a multiple of 128 / wn), B <= 64, K a multiple of 8, N of 16, x and w
// 16-byte aligned; with more than one split `partial` holds splits x B x N
// fp32 and `counters` ceil(N / (32 wn)) zeros.  wn = 0: the first design's
// tiles (any B, K and N; partial, counters and split_k unused).  Returns the
// launch's CUDA error code.
int ta_wq_matmul(const void* x, const void* w, const void* scale, void* out, void* partial,
                 void* counters, int B, int K, int N, int wn, int split_k, void* stream) {
  if (wn != 0) {
    return launch_split_design(
        WQ, split_args(x, nullptr, nullptr, w, scale, out, partial, counters, B, K, N, split_k),
        wn, stream);
  }
  if (B <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  WqArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
           static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), B, K, N, 0};
  if (wide(N, 8 * 16)) return launch_wq<16>(a, stream);
  return launch_wq<4>(a, stream);
}

}  // extern "C"
