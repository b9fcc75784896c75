// Backward of the causal GQA prefill attention designed for Hopper (sm_90a):
// TMA loads into 128-byte-swizzled shared memory, wgmma products with the
// accumulators in registers, a producer warp and consumer warpgroups.  bf16
// in and out, fp32 accumulation.  It serves attention_bwd.cu's two entry
// points in bf16 at head_dim 64 and 128 (bf16 at 16, 32 and 256 stays on
// attention_bwd.cu's mma.sync template, every fp32 instance on
// attention_f32.cu):
//
//   attention_bwd_dkv_sm90 (ta_prefill_attention_bwd_dkv)  replaces
//       _flash_attention_bwd_dkv of jax.experimental.pallas.ops.tpu.
//       flash_attention (jax 0.9.0, :941, pallas_call :1121): dK, dV;
//   attention_bwd_dq_sm90 (ta_prefill_attention_bwd_dq)  replaces
//       _flash_attention_bwd_dq (:1287, pallas_call :1456): dQ.
//
// The contract is attention_bwd.cu's: q and dout [B, T, Hq, D], k and v
// [B, T, Hkv, D] read in place, a [B, T] int32 key mask, the forward's row
// statistics m (max, log2 units) and l (sum) kept apart, and delta =
// rowsum(dO * O), each [B, Hq, T] fp32.  P = exp2(s * scale * log2e - m) / l
// is recomputed, dP = dO V^T, dS = P (dP - delta); dV = P^T dO,
// dK = scale dS^T Q (the GQA group summed in the block: no atomics, so dK
// and dV are deterministic), dQ = scale dS K.  A key past T, or past the
// query, has P = 0; a padding key scores MASK_VALUE, so it has P > 0 only in
// a row whose visible keys are all padding (there P = 1 / count, which
// needs m and l apart: MASK_VALUE - (m + log2 l) rounds to 0) and no dS.
//
// What bounds it.  dkv does 4 products of 2 D FLOPs per visible score (S^T
// and dP^T again, dV, dK) and dq 3 (S, dP, dQ), over about twice the
// forward's bytes: on the training path (B = 6, T = 512, 16/8 heads of 128)
// dkv's 12.9 GFLOP need 0.013 ms at 989 TFLOP/s and its bytes 0.01521 ms at
// 3.35 TB/s, so the two bounds nearly meet.  There (chip_smoke.py, NVIDIA
// H100 80GB HBM3 at 700 W, CUDA graph; PERF.md section 6) dkv takes
// 0.05623 ms, 27% of its bound (229.6 TFLOP/s), and dq 0.04637 ms, 33%
// (208.8 TFLOP/s).  Without a profile, what the design leaves serial is
// each warpgroup's chain of products, exp2 and the next products (a wgmma
// wait between each), which only the SM's other warpgroup overlaps, and a
// grid of 1.45 waves (192 dkv blocks, one an SM).  The design:
//   - wgmma with every accumulator in registers.  dkv: S^T = K Q^T and
//     dP^T = V dO^T (SS, K and V the A operands), P^T and dS^T formed in the
//     accumulators' registers, which are the RS product's A fragments, then
//     dV += P^T dO and dK += dS^T Q with the [query][d] dO and Q tiles read
//     as MN-major ("transposed") B operands through their descriptors: no
//     tile is copied or transposed.  dq: S = Q K^T and dP = dO V^T, then
//     dQ += dS K with the K tile read MN-major.
//   - dkv's dK and dV live in registers for the block's whole life (D / 2
//     floats each a thread).  A block is two consumer warpgroups of 64 keys
//     each (128 keys, FA3's shape: the Q and dO tiles each stage holds feed
//     both) and a producer warpgroup, one block an SM; setmaxnreg moves
//     registers from the producer (40) to the consumers (232).  dq is the
//     forward's shape: one consumer warpgroup of 64 query rows and a
//     producer warp, two blocks an SM.
//   - A producer warp loads what a block keeps (dkv: its K and V tiles; dq:
//     its Q and dO tiles) once by TMA through 4-D (D, H, T, B) maps and
//     streams the rest (dkv: Q, dO and 64 rows of -m, 1/l and delta for each
//     query head of the group from the diagonal to T; dq: K, V and the key
//     states up to the diagonal) through a ring of two stages with full and
//     empty mbarriers.
//   - The per-element mask runs only where needed.  dkv: a key is a row of
//     the thread, so its padding state is known once per block, and only
//     the diagonal tile and warps holding a padding key take the masked
//     formula; a query past T has -m = -inf and 1/l = 0 from the producer,
//     so P = 0 without a test; a key past T is a row of dK and dV that is
//     never stored.  dq: the forward's key bits, the diagonal, and tiles
//     holding a padding key or a key past T; a query past T is a row never
//     stored.  Interior tiles take one FFMA, one exp2 and one FMUL a score.
//   - The heaviest tiles launch first: dkv's first key tiles (they see the
//     most query tiles), dq's last query tiles, a GQA group's heads side by
//     side so that their blocks share K and V in L2.
// Not done yet: FA3's single pass with dQ reduced across key tiles by
// atomics (2.5x the forward's FLOPs, not 3.5x, but not deterministic),
// ping-pong of consumer warpgroups, and overlap of one tile's softmax with
// the next tile's products.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using ta::MASK_VALUE;
using ta::pack_bf16;
namespace sm90 = ta::sm90;
using sm90::BOX_COLS;
using sm90::make_map;
using sm90::ROW_BYTES;

constexpr int TILE = 64;    // query or key rows of a tile: one consumer warpgroup's
constexpr int STAGES = 2;   // the streamed ring
constexpr int TILE_BOX = TILE * ROW_BYTES;  // a [64][64] bf16 box

// dkv: two consumer warpgroups of 64 keys and a producer warpgroup, one
// block an SM.  At entry a thread holds 65,536 / 384 = 168 registers
// (rounded down to 8); setmaxnreg takes the producer warpgroup down to 40
// and the consumers up to 232, exactly the registers the block holds.  A
// setmaxnreg.inc waits until the pool can give what it asks, so a build
// that enters with fewer than 168 would hang: launch_dkv refuses it.  (One
// consumer warpgroup a block, two an SM, spills at D = 128: PERF.md.)
constexpr int DKV_CONSUMERS = 2;
constexpr int DKV_KEYS = TILE * DKV_CONSUMERS;
constexpr int DKV_THREADS = 384;
constexpr int DKV_ENTRY_REGS = 168;
constexpr int DKV_PRODUCER_REGS = 40;
constexpr int DKV_CONSUMER_REGS = 232;
static_assert(DKV_THREADS == 128 * (DKV_CONSUMERS + 1) &&
                  DKV_ENTRY_REGS == 65536 / DKV_THREADS / 8 * 8 &&
                  3 * DKV_ENTRY_REGS == DKV_PRODUCER_REGS + 2 * DKV_CONSUMER_REGS,
              "setmaxnreg must balance the registers the block holds at entry");
// dq: one consumer warpgroup and a producer warp, two blocks an SM
constexpr int DQ_THREADS = 128 + 32;
constexpr int DQ_MIN_BLOCKS = 2;

// dkv's dynamic shared memory, from a 1,024-byte aligned base: the block's K
// and V (boxes of [128 keys][64]), then each stage's Q and dO (boxes of
// [64 queries][64]) and its 64 rows of -m, 1/l and delta, then the barriers.
template <int D>
struct DkvSmem {
  static constexpr int BOXES = D / BOX_COLS;
  static constexpr int KV_BOX = DKV_KEYS * ROW_BYTES;
  static constexpr int KV_BYTES = BOXES * KV_BOX;  // the K or the V tile
  static constexpr int Q_BYTES = BOXES * TILE_BOX;  // a Q or a dO tile
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int RING_OFF = 2 * KV_BYTES;  // stage s: Q, then dO
  static constexpr int STAT_OFF = RING_OFF + STAGES * 2 * Q_BYTES;
  static constexpr int STAT_FLOATS = 3 * TILE;  // a stage's -m, 1/l, delta
  static constexpr int BAR_OFF = STAT_OFF + STAGES * STAT_FLOATS * 4;  // kv, full[], empty[]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
};

// dq's: the block's Q and dO, each stage's K and V (boxes of [64][64]), the
// barriers and each stage's key states (the forward's bits).
template <int D>
struct DqSmem {
  static constexpr int WORDS = TILE / 32;
  static constexpr int KEY_WORDS = 2 * WORDS + 1;  // real bits, valid bits, "masked" flag
  static constexpr int BOXES = D / BOX_COLS;
  static constexpr int TILE_BYTES = BOXES * TILE_BOX;
  static constexpr int DO_OFF = TILE_BYTES;
  static constexpr int K_OFF = 2 * TILE_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE_BYTES;  // q, full[], empty[]
  static constexpr int KEYS_OFF = BAR_OFF + 8 * (1 + 2 * STAGES);
  static constexpr int BYTES = KEYS_OFF + 4 * STAGES * KEY_WORDS;
  static constexpr int ALLOC = BYTES + 1024;
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (sm90::smem_addr(raw) & 1023)) & 1023);
}

// c (+)= A B^T over D for a 64 x 64 tile: A and B both [rows][d] tiles in
// boxes of [rows][64] (`a_box`, `b_box` bytes apart), B read K-major.
template <int D>
__device__ __forceinline__ void product_over_d(float (&c)[TILE / 2], const uint8_t* a, int a_box,
                                               const uint8_t* b, int b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk % 4) * 32;  // the k16 step inside a 64-wide box
    sm90::wgmma_ss<TILE, 0>(c, sm90::desc_sw128(a + (kk / 4) * a_box + off, 16, 1024),
                            sm90::desc_sw128(b + (kk / 4) * b_box + off, 16, 1024), kk > 0);
  }
}

// acc += A X over 64 rows of X: A the packed [64][64] fragments, X a [row][d]
// tile in boxes of [64][64] read MN-major (its 64-wide boxes along d lie
// TILE_BOX bytes apart).
template <int D>
__device__ __forceinline__ void product_over_rows(float (&acc)[D / 2],
                                                  const uint32_t (&a)[TILE / 16][4],
                                                  const uint8_t* x) {
#pragma unroll
  for (int kc = 0; kc < TILE / 16; ++kc) {
    sm90::wgmma_rs<D, 1>(acc, a[kc], sm90::desc_sw128(x + kc * 16 * ROW_BYTES, TILE_BOX, 1024),
                         1);
  }
}

// Two neighbouring 8-column blocks of an accumulator as one k16 step of the
// RS product's A operand (bf16 pairs).
__device__ __forceinline__ void pack_fragments(const float (&c)[TILE / 2],
                                               uint32_t (&a)[TILE / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < TILE / 16; ++kc) {
    a[kc][0] = pack_bf16(c[8 * kc], c[8 * kc + 1]);
    a[kc][1] = pack_bf16(c[8 * kc + 2], c[8 * kc + 3]);
    a[kc][2] = pack_bf16(c[8 * kc + 4], c[8 * kc + 5]);
    a[kc][3] = pack_bf16(c[8 * kc + 6], c[8 * kc + 7]);
  }
}

// Rows (r0, r0 + 8) of a [64][D] accumulator, times `scale`, as bf16 into
// rows of `base` (time stride `stride`) below T.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], int r0, int t4, int T,
                                           __nv_bfloat16* base, int64_t stride, float scale) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    if (r0 < T) {
      *reinterpret_cast<uint32_t*>(base + r0 * stride + c) =
          pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    }
    if (r0 + 8 < T) {
      *reinterpret_cast<uint32_t*>(base + (r0 + 8) * stride + c) =
          pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 1)
attention_bwd_dkv_sm90(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const int* __restrict__ mask,  // [B, T], 1 = real; or null
                       const float* __restrict__ m_stat,
                       const float* __restrict__ l_stat,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv,
                       int T, int Hq, int Hkv, float scale_log2, float scale) {
  static_assert(D == 64 || D == 128, "the Hopper design serves head_dim 64 and 128");
  using S = DkvSmem<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + STAGES;
  float* stats = reinterpret_cast<float*>(smem + S::STAT_OFF);

  // the heaviest (first) key tiles first, a batch row's KV heads side by side
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * DKV_KEYS;
  const int group = Hq / Hkv;
  const int first_tile = blockIdx.z * DKV_CONSUMERS;  // the query tile at k0: the diagonal
  const int q_tiles = (T + TILE - 1) / TILE;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 32);                  // every producer lane: its stats
      sm90::mbar_init(&empty[s], 4 * DKV_CONSUMERS);  // lane 0 of each consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * DKV_CONSUMERS) {
    // ---- the producer warpgroup; its first warp loads K and V once, then
    // for each query head of the group and each query tile from the
    // diagonal to T: the Q and dO tiles, and the rows' -m, 1/l and delta
    sm90::setmaxnreg_dec<DKV_PRODUCER_REGS>();
    if (warp == 4 * DKV_CONSUMERS) {
      if (lane == 0) {
        sm90::prefetch_tensor_map(&q_map);
        sm90::prefetch_tensor_map(&k_map);
        sm90::prefetch_tensor_map(&v_map);
        sm90::prefetch_tensor_map(&do_map);
        sm90::mbar_arrive_expect_tx(kv_bar, 2 * S::KV_BYTES);
#pragma unroll
        for (int box = 0; box < S::BOXES; ++box) {
          sm90::tma_load_4d(smem + box * S::KV_BOX, &k_map, kv_bar, box * BOX_COLS, kvh, k0, b);
          sm90::tma_load_4d(smem + S::V_OFF + box * S::KV_BOX, &v_map, kv_bar, box * BOX_COLS,
                            kvh, k0, b);
        }
      }
      int it = 0;
      for (int hg = 0; hg < group; ++hg) {
        const int h = kvh * group + hg;
        const int64_t stat_off = ((int64_t)b * Hq + h) * T;
        for (int qt = first_tile; qt < q_tiles; ++qt, ++it) {
          const int s = it % STAGES;
          const int q0 = qt * TILE;
          sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          // a query past T gets -m = -inf and 1/l = 0: P = exp2(-inf) * 0 = 0
          float* st = stats + s * S::STAT_FLOATS;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = q0 + 32 * i + lane;
            const bool in = r < T;
            st[32 * i + lane] = in ? -m_stat[stat_off + r] : -INFINITY;
            st[TILE + 32 * i + lane] = in ? 1.f / l_stat[stat_off + r] : 0.f;
            st[2 * TILE + 32 * i + lane] = in ? delta[stat_off + r] : 0.f;
          }
          if (lane == 0) {
            sm90::mbar_arrive_expect_tx(&full[s], 2 * S::Q_BYTES);
            uint8_t* q_st = smem + S::RING_OFF + s * 2 * S::Q_BYTES;
#pragma unroll
            for (int box = 0; box < S::BOXES; ++box) {
              sm90::tma_load_4d(q_st + box * TILE_BOX, &q_map, &full[s], box * BOX_COLS, h, q0,
                                b);
              sm90::tma_load_4d(q_st + S::Q_BYTES + box * TILE_BOX, &do_map, &full[s],
                                box * BOX_COLS, h, q0, b);
            }
          } else {
            sm90::mbar_arrive(&full[s]);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: keys wk0 .. wk0 + 63, 16 a warp; a
    // thread's two keys are rows of its S^T and dP^T accumulators
    sm90::setmaxnreg_inc<DKV_CONSUMER_REGS>();
    const int wg = warp / 4;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int wk0 = k0 + TILE * wg;
    const int key0 = wk0 + 16 * (warp % 4) + g;
    const int key1 = key0 + 8;
    // a padding key scores MASK_VALUE (its score's factor 0, MASK_VALUE
    // added) and has no dS; a key past T is a row never stored
    const int* mask_row = mask ? mask + (int64_t)b * T : nullptr;
    const bool pad0 = mask_row != nullptr && key0 < T && mask_row[key0] == 0;
    const bool pad1 = mask_row != nullptr && key1 < T && mask_row[key1] == 0;
    const bool warp_pad = __any_sync(0xffffffffu, pad0 || pad1);
    const float mul0 = pad0 ? 0.f : scale_log2, mul1 = pad1 ? 0.f : scale_log2;
    const float add0 = pad0 ? MASK_VALUE : 0.f, add1 = pad1 ? MASK_VALUE : 0.f;
    const uint8_t* k_wg = smem + wg * TILE * ROW_BYTES;  // this warpgroup's 64 rows of each box
    const uint8_t* v_wg = k_wg + S::V_OFF;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    sm90::mbar_wait(kv_bar, 0);
    int it = 0;
    for (int hg = 0; hg < group; ++hg) {
      for (int qt = first_tile; qt < q_tiles; ++qt, ++it) {
        const int s = it % STAGES;
        const int q0 = qt * TILE;
        sm90::mbar_wait(&full[s], (it / STAGES) & 1);
        if (q0 + TILE > wk0) {  // else every query of the tile precedes every key here
          const uint8_t* q_st = smem + S::RING_OFF + s * 2 * S::Q_BYTES;
          const uint8_t* do_st = q_st + S::Q_BYTES;
          const float* st = stats + s * S::STAT_FLOATS;

          // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries
          float sc[TILE / 2], dp[TILE / 2];
          sm90::wgmma_fence();
          product_over_d<D>(sc, k_wg, S::KV_BOX, q_st, TILE_BOX);
          sm90::wgmma_commit();
          product_over_d<D>(dp, v_wg, S::KV_BOX, do_st, TILE_BOX);
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();  // S^T is in; dP^T may still run
          sm90::fence_operands(sc);

          // P^T in place of S^T
          const bool diagonal = q0 == wk0;
          if (diagonal || warp_pad) {
#pragma unroll
            for (int j = 0; j < TILE / 8; ++j) {
              const float2 nm = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t4);
              const float2 il = *reinterpret_cast<const float2*>(st + TILE + 8 * j + 2 * t4);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float x = fmaf(sc[4 * j + e], e < 2 ? mul0 : mul1,
                                     (e < 2 ? add0 : add1) + ((e & 1) ? nm.y : nm.x));
                float p = exp2f(x) * ((e & 1) ? il.y : il.x);
                if (diagonal && q0 + 8 * j + 2 * t4 + (e & 1) < (e < 2 ? key0 : key1)) p = 0.f;
                sc[4 * j + e] = p;
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < TILE / 8; ++j) {
              const float2 nm = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t4);
              const float2 il = *reinterpret_cast<const float2*>(st + TILE + 8 * j + 2 * t4);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                sc[4 * j + e] = exp2f(fmaf(sc[4 * j + e], scale_log2, (e & 1) ? nm.y : nm.x)) *
                                ((e & 1) ? il.y : il.x);
              }
            }
          }

          // dS^T = P^T (dP^T - delta) in place of dP^T; 0 for a padding key
          sm90::wgmma_wait<0>();
          sm90::fence_operands(dp);
#pragma unroll
          for (int j = 0; j < TILE / 8; ++j) {
            const float2 dl = *reinterpret_cast<const float2*>(st + 2 * TILE + 8 * j + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float ds = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
              dp[4 * j + e] = (e < 2 ? pad0 : pad1) ? 0.f : ds;
            }
          }
          uint32_t pa[TILE / 16][4], dsa[TILE / 16][4];
          pack_fragments(sc, pa);
          pack_fragments(dp, dsa);

          // dV += P^T dO and dK += dS^T Q: dO and Q read MN-major
          sm90::fence_operands(dv_acc);
          sm90::fence_operands(dk_acc);
          sm90::wgmma_fence();
          product_over_rows<D>(dv_acc, pa, do_st);
          product_over_rows<D>(dk_acc, dsa, q_st);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_operands(dv_acc);
          sm90::fence_operands(dk_acc);
          sm90::fence_operands(pa);
          sm90::fence_operands(dsa);
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
      }
    }

    const int64_t stride = (int64_t)Hkv * D;  // between time steps
    const int64_t off = (int64_t)b * T * stride + (int64_t)kvh * D;
    store_rows<D>(dk_acc, key0, t4, T, dk + off, stride, scale);
    store_rows<D>(dv_acc, key0, t4, T, dv + off, stride, 1.f);
  }
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, DQ_MIN_BLOCKS)
attention_bwd_dq_sm90(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const int* __restrict__ mask,  // [B, T], 1 = real; or null
                      const float* __restrict__ m_stat,
                      const float* __restrict__ l_stat,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq,
                      int T, int Hq, int Hkv, float scale_log2, float scale) {
  static_assert(D == 64 || D == 128, "the Hopper design serves head_dim 64 and 128");
  using S = DqSmem<D>;
  constexpr int WORDS = S::WORDS;
  constexpr int KEY_WORDS = S::KEY_WORDS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + STAGES;
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem + S::KEYS_OFF);

  // the heaviest (last) query tiles first, a GQA group's heads side by side
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q_tile = gridDim.z - 1 - blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = q_tile * TILE;
  const int n_tiles = q_tile + 1;  // causal: keys up to the tile's last query
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: Q and dO once, then K, V and the key states of each tile
    if (lane == 0) {
      sm90::prefetch_tensor_map(&q_map);
      sm90::prefetch_tensor_map(&k_map);
      sm90::prefetch_tensor_map(&v_map);
      sm90::prefetch_tensor_map(&do_map);
      sm90::mbar_arrive_expect_tx(q_bar, 2 * S::TILE_BYTES);
#pragma unroll
      for (int box = 0; box < S::BOXES; ++box) {
        sm90::tma_load_4d(smem + box * TILE_BOX, &q_map, q_bar, box * BOX_COLS, h, q0, b);
        sm90::tma_load_4d(smem + S::DO_OFF + box * TILE_BOX, &do_map, q_bar, box * BOX_COLS, h,
                          q0, b);
      }
    }
    const int* mask_row = mask ? mask + (int64_t)b * T : nullptr;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const int k0 = t * TILE;
      uint32_t words[KEY_WORDS];
      sm90::key_words<WORDS>(mask_row, k0, T, lane, words);
      if (lane == 0) {
        sm90::mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        uint32_t* kw = keys + s * KEY_WORDS;
#pragma unroll
        for (int w = 0; w < KEY_WORDS; ++w) kw[w] = words[w];
        sm90::mbar_arrive_expect_tx(&full[s], 2 * S::TILE_BYTES);
        uint8_t* k_st = smem + S::K_OFF + s * S::TILE_BYTES;
        uint8_t* v_st = smem + S::V_OFF + s * S::TILE_BYTES;
#pragma unroll
        for (int box = 0; box < S::BOXES; ++box) {
          sm90::tma_load_4d(k_st + box * TILE_BOX, &k_map, &full[s], box * BOX_COLS, kvh, k0, b);
          sm90::tma_load_4d(v_st + box * TILE_BOX, &v_map, &full[s], box * BOX_COLS, kvh, k0, b);
        }
      }
    }
  } else {
    // ---- the consumer warpgroup: query rows q0 .. q0 + 63, 16 a warp
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int r0 = q0 + 16 * warp + g;  // this thread's two rows
    const int r1 = r0 + 8;
    // a row past T is never stored: -m = 0, 1/l = 0 keep it finite
    const int64_t stat_off = ((int64_t)b * Hq + h) * T;
    const float nm0 = r0 < T ? -m_stat[stat_off + r0] : 0.f;
    const float nm1 = r1 < T ? -m_stat[stat_off + r1] : 0.f;
    const float il0 = r0 < T ? 1.f / l_stat[stat_off + r0] : 0.f;
    const float il1 = r1 < T ? 1.f / l_stat[stat_off + r1] : 0.f;
    const float dl0 = r0 < T ? delta[stat_off + r0] : 0.f;
    const float dl1 = r1 < T ? delta[stat_off + r1] : 0.f;

    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

    sm90::mbar_wait(q_bar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const int k0 = t * TILE;
      sm90::mbar_wait(&full[s], (t / STAGES) & 1);
      const uint8_t* k_st = smem + S::K_OFF + s * S::TILE_BYTES;
      const uint8_t* v_st = smem + S::V_OFF + s * S::TILE_BYTES;

      // S = Q K^T and dP = dO V^T: K and V's [key][d] tiles are K-major B
      float sc[TILE / 2], dp[TILE / 2];
      sm90::wgmma_fence();
      product_over_d<D>(sc, smem, TILE_BOX, k_st, TILE_BOX);
      sm90::wgmma_commit();
      product_over_d<D>(dp, smem + S::DO_OFF, TILE_BOX, v_st, TILE_BOX);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_operands(sc);
#pragma unroll
      for (int i = 0; i < TILE / 2; ++i) {
        const bool top = (i & 2) == 0;
        sc[i] = exp2f(fmaf(sc[i], scale_log2, top ? nm0 : nm1)) * (top ? il0 : il1);
      }

      // dS = P (dP - delta); where the tile needs the mask, 0 for a key
      // past T, past the row or padding (its score a constant)
      sm90::wgmma_wait<0>();
      sm90::fence_operands(dp);
      const uint32_t* kw = keys + s * KEY_WORDS;
      const bool masked = kw[2 * WORDS] != 0 || k0 == q0;
      uint32_t keep[WORDS];
#pragma unroll
      for (int w = 0; w < WORDS; ++w) keep[w] = masked ? kw[w] & kw[WORDS + w] : 0xffffffffu;
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);
          const float ds = sc[4 * j + e] * (dp[4 * j + e] - (e < 2 ? dl0 : dl1));
          const bool kept = !masked || (((keep[j / 4] >> (col & 31)) & 1u) &&
                                        k0 + col <= (e < 2 ? r0 : r1));
          dp[4 * j + e] = kept ? ds : 0.f;
        }
      }
      uint32_t dsa[TILE / 16][4];
      pack_fragments(dp, dsa);

      // dQ += dS K: K's [key][d] tile read MN-major
      sm90::fence_operands(dq_acc);
      sm90::wgmma_fence();
      product_over_rows<D>(dq_acc, dsa, k_st);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(dq_acc);
      sm90::fence_operands(dsa);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }

    const int64_t stride = (int64_t)Hq * D;
    store_rows<D>(dq_acc, r0, t4, T, dq + (int64_t)b * T * stride + (int64_t)h * D, stride,
                  scale);
  }
}

struct Args {
  const void *q, *k, *v, *mask, *dout, *m, *l, *delta;
  int B, T, Hq, Hkv;
  float scale;
  cudaStream_t stream;
};

// The tensor maps of q, k, v and dout, k and v in boxes of `kv_rows` rows.
bool make_maps(const Args& a, int D, int kv_rows, CUtensorMap (&maps)[4]) {
  return make_map(&maps[0], a.q, a.B, a.T, a.Hq, D, TILE) &&
         make_map(&maps[1], a.k, a.B, a.T, a.Hkv, D, kv_rows) &&
         make_map(&maps[2], a.v, a.B, a.T, a.Hkv, D, kv_rows) &&
         make_map(&maps[3], a.dout, a.B, a.T, a.Hq, D, TILE);
}

template <int D>
int launch_dkv(const Args& a, void* dk, void* dv) {
  CUtensorMap maps[4];
  if (!make_maps(a, D, DKV_KEYS, maps)) return (int)cudaErrorInvalidValue;
  auto kernel = attention_bwd_dkv_sm90<D>;
  // the registers ptxas gave the kernel, read once: setmaxnreg balances 168
  static const cudaError_t regs = [kernel] {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    return attr.numRegs == DKV_ENTRY_REGS ? cudaSuccess : cudaErrorLaunchOutOfResources;
  }();
  if (regs != cudaSuccess) return (int)regs;
  constexpr int smem = DkvSmem<D>::ALLOC;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Hkv, a.B, (a.T + DKV_KEYS - 1) / DKV_KEYS);
  kernel<<<grid, DKV_THREADS, smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const int*>(a.mask),
      static_cast<const float*>(a.m), static_cast<const float*>(a.l),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a.T, a.Hq, a.Hkv, a.scale * ta::LOG2E, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const Args& a, void* dq) {
  CUtensorMap maps[4];
  if (!make_maps(a, D, TILE, maps)) return (int)cudaErrorInvalidValue;
  auto kernel = attention_bwd_dq_sm90<D>;
  constexpr int smem = DqSmem<D>::ALLOC;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Hq, a.B, (a.T + TILE - 1) / TILE);
  kernel<<<grid, DQ_THREADS, smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const int*>(a.mask),
      static_cast<const float*>(a.m), static_cast<const float*>(a.l),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(dq), a.T, a.Hq, a.Hkv,
      a.scale * ta::LOG2E, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

namespace ta {

// The bf16 backward at head_dim 64 and 128; any other head_dim is refused.
// Arguments as attention_bwd.cu's entry points (which check the shapes).
int attention_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* mask,
                           const void* dout, const void* m, const void* l, const void* delta,
                           void* dk, void* dv, int B, int T, int Hq, int Hkv, int D, float scale,
                           void* stream) {
  const Args a{q, k, v, mask, dout, m, l, delta, B, T, Hq, Hkv, scale, (cudaStream_t)stream};
  if (D == 64) return launch_dkv<64>(a, dk, dv);
  if (D == 128) return launch_dkv<128>(a, dk, dv);
  return (int)cudaErrorInvalidValue;
}

int attention_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* mask,
                          const void* dout, const void* m, const void* l, const void* delta,
                          void* dq, int B, int T, int Hq, int Hkv, int D, float scale,
                          void* stream) {
  const Args a{q, k, v, mask, dout, m, l, delta, B, T, Hq, Hkv, scale, (cudaStream_t)stream};
  if (D == 64) return launch_dq<64>(a, dq);
  if (D == 128) return launch_dq<128>(a, dq);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ta

extern "C" {

// Dynamic shared memory a block of the dkv (dkv = 1) or dq (dkv = 0)
// instance at head_dim D takes (0 for one the design does not serve): ptxas
// reports only static shared memory.
int ta_attention_bwd_sm90_smem_bytes(int D, int dkv) {
  if (D == 64) return dkv ? DkvSmem<64>::ALLOC : DqSmem<64>::ALLOC;
  if (D == 128) return dkv ? DkvSmem<128>::ALLOC : DqSmem<128>::ALLOC;
  return 0;
}

// The registers a thread of every dkv instance must enter with, which its
// setmaxnreg split balances; launch_dkv refuses a build with another count.
int ta_attention_bwd_sm90_dkv_entry_registers() { return DKV_ENTRY_REGS; }

}  // extern "C"
