// Kernel #9a for Hopper (sm_90a): the encoder attention's function (#1,
// attention_sm90.cu) under the 13 softmax modes of the TPU bench kernel it
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
//                    keeps (a block is 256 rows of one head)
//           QNORM    |q_row| * (max_t |k_t| * D^-0.5), the max over all T
//                    keys, padded ones too (a pass that reads only K)
//   exp     fp32 expf, or bf16(expf(bf16(s - m))) summed in fp32 (bf16)
//   norm    DIV   bf16(p / denom) before P.V (the IEEE quotient, from a
//                 correctly rounded reciprocal and one Markstein step)
//           RCP   bf16(p * rcp.approx.ftz(denom)) before P.V
//           POST  (bf16(p) . V) / denom on the [256, 64] output
//   guard   denom + 1e-30, or not
//
// Passes over the keys, in units of one S product over all keys (P.V is
// one unit too; ops/encoder_attention_variants.variant_passes mirrors it):
//   2  shift_post, packed2, qnorm_post (QNORM adds a pre-pass over K alone)
//   3  fp32_post, tilemax_post (a max pass); nomax, shift, qnorm (a
//      denominator pass: a normalise-before-P.V mode needs each row's
//      denominator before its P.V)
//   4  fp32, bf16, rcp, tilemax, tilemax_rcp (a max pass, then a
//      denominator pass)
// Merging the max pass into the denominator pass with an online rescale
// would round the denominator otherwise: another function.  packed2 is
// shift_post with two heads sharing each K/V stage; the TPU's block-diagonal
// 128-wide dot adds exact zeros, so its function is shift_post's per head,
// and here its arithmetic is too, bit for bit (the same per-head code; the
// scale is an explicit __fmul_rn, so no product fuses into a later add).
//
// Design, on #1's Hopper forward (attention_sm90.cu): a block is four
// consumer warpgroups of 64 query rows and a producer warpgroup, one thread
// of which streams the head's K tiles (and V tiles in the P.V pass) of 64
// keys by TMA through 4-D (D, H, T, B) maps into a ring of 8 (NH = 2: 4)
// 128-byte-swizzled stages, once per pass, shared by the four warpgroups;
// S = Q K^T runs as wgmma with Q and K in shared memory (SS), O += P V with
// P from registers (RS) and V's [key][d] tile read MN-major through its
// descriptor, so V is never copied or transposed.  Twenty warps leave a
// thread 96 registers (a producer warp alone, 17 warps, leaves it 96 too,
// where two modes spilled; the first thread of the consumers issuing the
// loads itself held every warpgroup to the first one's pace, and was
// slower), so setmaxnreg moves the producer warpgroup's to the consumers:
// 112 each.  With NH = 1 the four warpgroups are 256 rows of one head (BQ:
// tilemax meets its max in shared memory); with NH = 2 (packed2) they are
// 128 rows of two heads, two warpgroups a head, and each stage holds both
// heads' K/V.  Q comes by TMA into one of two buffers, so the next head's
// Q lands while this one's passes run.  hg is the heads a block walks (NH
// at a time) under one load of its batch row's mask, kept in shared memory
// as a bit a key and a flag a tile (tiles with no padding key skip the
// select).  The grid is (T / (256 / NH), H / hg, B) with one block an SM,
// whose four warpgroups overlap one another's exponentials and products.
// T must be a multiple of 256, as in the TPU grid.
//
// What bounds it on the H100: 4 B H T^2 D FLOPs per two units (386.5 GFLOP
// at the bench's B, T, H = 32, 1536, 20: 0.391 ms at 989 TFLOP/s) over ~0.5
// GB of q, k, v and out (0.150 ms): compute.  A mode of u units does u / 2
// of that on the tensor cores, and each exponential pass an accurate expf
// (a MUFU.EX2 and a handful of FMAs) per score on the CUDA cores, which at
// this shape is about as long as a unit of products.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using ta::MASK_VALUE;
using ta::pack_bf16;
namespace sm90 = ta::sm90;
using sm90::ROW_BYTES;

constexpr int D = 64;
constexpr int BQ = 256;                        // query rows of a tilemax group: the TPU kernel's
constexpr int BLOCK_K = 64;                    // keys a stage
constexpr int CONSUMERS = 4;                   // warpgroups of 64 rows
constexpr int CONSUMER_WARPS = CONSUMERS * 4;
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and a producer warpgroup
constexpr int WORDS = BLOCK_K / 32;            // mask words a tile, then a flag
constexpr int KV_BOX = BLOCK_K * ROW_BYTES;    // one head's K or V tile, 8 KB
constexpr int CONSUMER_BARRIER = 1;
// At entry a thread holds 96 registers: an SM sub-partition's 16,384 over
// the five warps it holds (warps w, w + 4, ... of the 20).  setmaxnreg takes
// the producer warpgroup down to 24 and the consumers up to 112, within
// what the block holds.  A setmaxnreg.inc waits until the pool can give
// what it asks, so a build that enters with fewer than 96 could hang:
// launch refuses it.
constexpr int ENTRY_REGS = 96;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 112;
static_assert(ENTRY_REGS == 16384 / (THREADS / 128) / 32 / 8 * 8 &&
                  PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= (CONSUMERS + 1) * ENTRY_REGS,
              "setmaxnreg must stay within the registers the block holds at entry");

enum Shift { ROWMAX, CONST8, CLAMP48, TILEMAX, QNORM };
enum Norm { DIV, RCP, POST };

// Dynamic shared memory, from a 1,024-byte aligned base: two Q buffers, the
// K/V stages, the barriers, two reduction slots of a float a consumer warp,
// and the mask's words and flag a tile.
template <int NH>
struct Smem {
  // the ring: a max or K-norm pass consumes a stage faster than its load
  // comes back from L2, so as many stages as shared memory holds
  static constexpr int STAGES = NH == 1 ? 8 : 4;
  static constexpr int ROWS = BQ / NH;            // query rows a block
  static constexpr int Q_BOX = ROWS * ROW_BYTES;  // one head's Q
  static constexpr int Q_BYTES = NH * Q_BOX;      // a buffer
  static constexpr int K_BYTES = NH * KV_BOX;     // a stage's K (its V follows)
  static constexpr int STAGE_BYTES = 2 * K_BYTES;
  static constexpr int ST_OFF = 2 * Q_BYTES;
  // full[STAGES], empty[STAGES], q_full[2], q_empty[2]
  static constexpr int BAR_OFF = ST_OFF + STAGES * STAGE_BYTES;
  static constexpr int RED_OFF = BAR_OFF + 8 * (2 * STAGES + 4);
  static constexpr int KEYS_OFF = RED_OFF + 4 * 2 * CONSUMER_WARPS;
  static constexpr int alloc(int T) { return KEYS_OFF + 4 * (T / BLOCK_K) * (WORDS + 1) + 1024; }
};

// Units of passes over the keys a mode takes: a K-norm pre-pass (reads K
// only, no product), a max pass, a denominator pass, and the P.V pass.
template <int SHIFT, int NORM>
struct Passes {
  static constexpr int KNORM = SHIFT == QNORM;
  static constexpr int MAX = SHIFT == ROWMAX || SHIFT == TILEMAX;
  static constexpr int DEN = NORM != POST;
  static constexpr int COUNT = KNORM + MAX + DEN + 1;
};

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two values rounded to bf16 (round to nearest even) by one conversion
// instruction, and widened back.
__device__ __forceinline__ void bf16_round_pair(float& a, float& b) {
  const uint32_t u = pack_bf16(a, b);
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xffff0000u);
}

template <int SHIFT>
__device__ __forceinline__ float shifted(float s, float m) {
  if (SHIFT == CONST8) return s - 8.f;
  if (SHIFT == CLAMP48) return fminf(s, 80.f) - 48.f;
  return s - m;
}

// p = exp(s - m) of two scores of one row: expf, or bf16(expf(bf16(s - m))).
template <int SHIFT, bool EXP_BF16>
__device__ __forceinline__ void prob2(float s0, float s1, float m, float& p0, float& p1) {
  float x0 = shifted<SHIFT>(s0, m), x1 = shifted<SHIFT>(s1, m);
  if (EXP_BF16) bf16_round_pair(x0, x1);
  p0 = expf(x0);
  p1 = expf(x1);
  if (EXP_BF16) bf16_round_pair(p0, p1);
}

// p / l, rounded as the IEEE division rounds it, from r = 1 / l correctly
// rounded: q = p r and one Markstein step q + (p - l q) r, exact for every
// normal quotient (a subnormal one may differ in its last bit).  Only for a
// finite, normal l; the caller divides otherwise.
__device__ __forceinline__ float div_by(float p, float l, float r) {
  const float q = __fmul_rn(p, r);
  return __fmaf_rn(__fmaf_rn(-l, q, p), r, q);
}

// The max of x over the 16 consumer warps; every consumer thread gets it.
// `red` is this head step's slot (two slots alternate, so a slow warp still
// reading one never sees the next step's writes).
__device__ __forceinline__ float consumers_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  sm90::named_barrier(CONSUMER_BARRIER, CONSUMERS * 128);
  float r = red[0];
#pragma unroll
  for (int w = 1; w < CONSUMER_WARPS; ++w) r = fmaxf(r, red[w]);
  return r;
}

// S of this warpgroup's 64 rows and the stage's 64 keys: the dot products
// times D^-0.5 (rounded once, as the plain version's), MASK_VALUE at padding.
__device__ __forceinline__ void scores(float (&sc)[BLOCK_K / 2], const uint8_t* q_tile,
                                       const uint8_t* k_tile, const uint32_t* kw, int t4,
                                       float scale) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    sm90::wgmma_ss<BLOCK_K, 0>(sc, sm90::desc_sw128(q_tile + kk * 32, 16, 1024),
                               sm90::desc_sw128(k_tile + kk * 32, 16, 1024), kk > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_operands(sc);
  if (kw[WORDS] != 0) {
    uint32_t real[WORDS];
#pragma unroll
    for (int w = 0; w < WORDS; ++w) real[w] = kw[w];
#pragma unroll
    for (int j = 0; j < BLOCK_K / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t4 + (e & 1);
        sc[4 * j + e] = (real[j / 4] >> (col & 31)) & 1u ? __fmul_rn(sc[4 * j + e], scale)
                                                         : MASK_VALUE;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < BLOCK_K / 2; ++i) sc[i] = __fmul_rn(sc[i], scale);
  }
}

template <int SHIFT, bool EXP_BF16, int NORM, bool GUARD, int NH>
__global__ void __launch_bounds__(THREADS, 1)
variant_sm90(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, const int* __restrict__ mask,
             __nv_bfloat16* __restrict__ out, int T, int H, int hg, float scale) {
  using S = Smem<NH>;
  using P = Passes<SHIFT, NORM>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;
  uint64_t* q_empty = q_full + 2;
  float* red = reinterpret_cast<float*>(smem + S::RED_OFF);
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem + S::KEYS_OFF);

  const int q0 = blockIdx.x * S::ROWS;
  const int head0 = blockIdx.y * hg;
  const int b = blockIdx.z;
  const int n_tiles = T / BLOCK_K;
  const int steps = hg / NH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&q_full[s], 1);
      sm90::mbar_init(&q_empty[s], CONSUMER_WARPS);
    }
    sm90::fence_barrier_init();
  }
  // the batch row's mask, once for the block's hg heads: a bit a key (1 =
  // real), then a flag a tile that holds a padding key
  const int* mask_row = mask + (int64_t)b * T;
  for (int i = warp; i < n_tiles * WORDS; i += THREADS / 32) {
    const uint32_t w = __ballot_sync(0xffffffffu, mask_row[i * 32 + lane] != 0);
    if (lane == 0) keys[(i / WORDS) * (WORDS + 1) + i % WORDS] = w;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += THREADS) {
    bool all_real = true;
#pragma unroll
    for (int w = 0; w < WORDS; ++w) all_real = all_real && keys[t * (WORDS + 1) + w] == 0xffffffffu;
    keys[t * (WORDS + 1) + WORDS] = all_real ? 0u : 1u;
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ---- producer: per head step its Q, then K (and V in the last pass)
    // tile by tile, once per pass; one thread of the warpgroup issues
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      sm90::prefetch_tensor_map(&q_map);
      sm90::prefetch_tensor_map(&k_map);
      sm90::prefetch_tensor_map(&v_map);
      int it = 0;
      for (int step = 0; step < steps; ++step) {
        const int qb = step & 1;
        const int h = head0 + step * NH;
        sm90::mbar_wait(&q_empty[qb], ((step >> 1) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&q_full[qb], S::Q_BYTES);
#pragma unroll
        for (int hs = 0; hs < NH; ++hs) {
          sm90::tma_load_4d(smem + qb * S::Q_BYTES + hs * S::Q_BOX, &q_map, &q_full[qb], 0,
                            h + hs, q0, b);
        }
        for (int pass = 0; pass < P::COUNT; ++pass) {
          const bool with_v = pass == P::COUNT - 1;
          for (int t = 0; t < n_tiles; ++t, ++it) {
            const int s = it % STAGES;
            uint8_t* st = smem + S::ST_OFF + s * S::STAGE_BYTES;
            sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
            sm90::mbar_arrive_expect_tx(&full[s], (with_v ? 2 : 1) * S::K_BYTES);
#pragma unroll
            for (int hs = 0; hs < NH; ++hs) {
              sm90::tma_load_4d(st + hs * KV_BOX, &k_map, &full[s], 0, h + hs, t * BLOCK_K, b);
              if (with_v) {
                sm90::tma_load_4d(st + S::K_BYTES + hs * KV_BOX, &v_map, &full[s], 0, h + hs,
                                  t * BLOCK_K, b);
              }
            }
          }
        }
      }
    }
    return;
  }
  sm90::setmaxnreg_inc<CONSUMER_REGS>();

  // ---- the warpgroups: 64 query rows of one head each
  const int wg = warp / 4;
  constexpr int PER_HEAD = CONSUMERS / NH;  // warpgroups a head
  const int hs = wg / PER_HEAD;
  const int row_in = (wg % PER_HEAD) * 64 + (warp % 4) * 16 + (lane >> 2);  // this thread's first row
  const int t4 = lane & 3;
  constexpr int NS = BLOCK_K / 2;  // score accumulators a thread
  constexpr int NO = D / 2;        // output accumulators a thread

  int it = 0;
  for (int step = 0; step < steps; ++step) {
    const int qb = step & 1;
    const int h = head0 + step * NH + hs;
    const uint8_t* q_head = smem + qb * S::Q_BYTES + hs * S::Q_BOX;
    const uint8_t* q_tile = q_head + (wg % PER_HEAD) * 64 * ROW_BYTES;
    sm90::mbar_wait(&q_full[qb], (step >> 1) & 1);

    // ---- the shift of this thread's two rows
    float m0 = 0.f, m1 = 0.f;
    if constexpr (P::KNORM) {
      // max_t |k_t|^2 over the head's T keys: 8 threads a key, 8 values each
      float ksq = 0.f;
      const int ti = threadIdx.x;  // 0 .. 511
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&full[s], (it / STAGES) & 1);
        const uint8_t* k_tile = smem + S::ST_OFF + s * S::STAGE_BYTES;
        const uint4 raw = *reinterpret_cast<const uint4*>(k_tile + (ti / 8) * ROW_BYTES + (ti % 8) * 16);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float f = __bfloat162float(e[j]);
          sum = fmaf(f, f, sum);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        ksq = fmaxf(ksq, sum);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
      }
      const float kmax = sqrtf(consumers_max(ksq, red + qb * CONSUMER_WARPS));
      // |q_row|: the four threads of a row read two of its 16-byte chunks each
      float qsq[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint8_t* row = q_tile + ((warp % 4) * 16 + (lane >> 2) + 8 * r) * ROW_BYTES;
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(row + (t4 + 4 * c) * 16);
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float f = __bfloat162float(e[j]);
            sum = fmaf(f, f, sum);
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        qsq[r] = sum;
      }
      m0 = sqrtf(qsq[0]) * (kmax * scale);
      m1 = sqrtf(qsq[1]) * (kmax * scale);
    }
    if constexpr (P::MAX) {
      float mx0 = -INFINITY, mx1 = -INFINITY;
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&full[s], (it / STAGES) & 1);
        const uint8_t* k_tile = smem + S::ST_OFF + s * S::STAGE_BYTES + hs * KV_BOX;
        float sc[NS];
        scores(sc, q_tile, k_tile, keys + t * (WORDS + 1), t4, scale);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
#pragma unroll
        for (int j = 0; j < BLOCK_K / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      if constexpr (SHIFT == TILEMAX) {
        m0 = m1 = consumers_max(fmaxf(mx0, mx1), red + qb * CONSUMER_WARPS);
      } else {
        m0 = mx0;
        m1 = mx1;
      }
    }

    // ---- the denominators (for the modes that normalise before P.V)
    float l0 = 0.f, l1 = 0.f;
    if constexpr (P::DEN) {
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&full[s], (it / STAGES) & 1);
        const uint8_t* k_tile = smem + S::ST_OFF + s * S::STAGE_BYTES + hs * KV_BOX;
        float sc[NS];
        scores(sc, q_tile, k_tile, keys + t * (WORDS + 1), t4, scale);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
#pragma unroll
        for (int j = 0; j < BLOCK_K / 8; ++j) {
          float p[4];
          prob2<SHIFT, EXP_BF16>(sc[4 * j], sc[4 * j + 1], m0, p[0], p[1]);
          prob2<SHIFT, EXP_BF16>(sc[4 * j + 2], sc[4 * j + 3], m1, p[2], p[3]);
          l0 += p[0] + p[1];
          l1 += p[2] + p[3];
        }
      }
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      if (GUARD) {
        l0 += 1e-30f;
        l1 += 1e-30f;
      }
    }
    // RCP's approximate reciprocals; DIV's correctly rounded ones, and
    // whether every row of the warp may divide through them
    const float inv0 = NORM == RCP ? rcp_approx(l0) : __frcp_rn(l0);
    const float inv1 = NORM == RCP ? rcp_approx(l1) : __frcp_rn(l1);
    const bool normal = __all_sync(0xffffffffu, isfinite(l0) && isfinite(l1) &&
                                                    l0 >= FLT_MIN && l1 >= FLT_MIN);

    // ---- O += P V, P normalised (DIV, RCP) or not (POST), rounded to bf16
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    for (int t = 0; t < n_tiles; ++t, ++it) {
      const int s = it % STAGES;
      sm90::mbar_wait(&full[s], (it / STAGES) & 1);
      const uint8_t* st = smem + S::ST_OFF + s * S::STAGE_BYTES;
      float sc[NS];
      scores(sc, q_tile, st + hs * KV_BOX, keys + t * (WORDS + 1), t4, scale);
      uint32_t p[BLOCK_K / 16][4];
#pragma unroll
      for (int kc = 0; kc < BLOCK_K / 16; ++kc) {
        float e[8];  // rows r0, r0, r1, r1, r0, r0, r1, r1
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          prob2<SHIFT, EXP_BF16>(sc[8 * kc + i], sc[8 * kc + i + 1], (i & 2) ? m1 : m0, e[i],
                                 e[i + 1]);
        }
        if constexpr (NORM == POST) {
          l0 += e[0] + e[1];
          l1 += e[2] + e[3];
          l0 += e[4] + e[5];
          l1 += e[6] + e[7];
        } else {
          if (NORM == RCP) {
#pragma unroll
            for (int i = 0; i < 8; ++i) e[i] *= (i & 2) ? inv1 : inv0;
          } else if (normal) {
#pragma unroll
            for (int i = 0; i < 8; ++i) e[i] = div_by(e[i], (i & 2) ? l1 : l0, (i & 2) ? inv1 : inv0);
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) e[i] = e[i] / ((i & 2) ? l1 : l0);
          }
        }
        p[kc][0] = pack_bf16(e[0], e[1]);
        p[kc][1] = pack_bf16(e[2], e[3]);
        p[kc][2] = pack_bf16(e[4], e[5]);
        p[kc][3] = pack_bf16(e[6], e[7]);
      }
      sm90::fence_operands(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BLOCK_K / 16; ++kc) {
        sm90::wgmma_rs<D, 1>(o, p[kc],
                             sm90::desc_sw128(st + S::K_BYTES + hs * KV_BOX + kc * 16 * ROW_BYTES,
                                              KV_BOX, 1024),
                             1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(o);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }
    // every S product of this head step is done: its Q buffer is free
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&q_empty[qb]);

    if constexpr (NORM == POST) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      if (GUARD) {
        l0 += 1e-30f;
        l1 += 1e-30f;
      }
    }

    // ---- the output, bf16: accumulator o[4 j + e] is row row_in + 8 (e / 2),
    // column 8 j + 2 t4 + (e % 2)
    const int64_t stride = (int64_t)H * D;  // between time steps
    __nv_bfloat16* o_base =
        out + ((int64_t)b * T + q0 + row_in) * stride + (int64_t)h * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      float x[4] = {o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]};
      if constexpr (NORM == POST) {
        x[0] = x[0] / l0;
        x[1] = x[1] / l0;
        x[2] = x[2] / l1;
        x[3] = x[3] / l1;
      }
      *reinterpret_cast<uint32_t*>(o_base + 8 * j) = pack_bf16(x[0], x[1]);
      *reinterpret_cast<uint32_t*>(o_base + 8 * stride + 8 * j) = pack_bf16(x[2], x[3]);
    }
  }
}

template <int SHIFT, bool EXP_BF16, int NORM, bool GUARD, int NH>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
           int T, int H, int hg, float scale, cudaStream_t stream) {
  using S = Smem<NH>;
  CUtensorMap q_map, k_map, v_map;
  if (!sm90::make_map(&q_map, q, B, T, H, D, S::ROWS) ||
      !sm90::make_map(&k_map, k, B, T, H, D, BLOCK_K) ||
      !sm90::make_map(&v_map, v, B, T, H, D, BLOCK_K)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = variant_sm90<SHIFT, EXP_BF16, NORM, GUARD, NH>;
  // the registers ptxas gave the kernel, read once: setmaxnreg assumes 96
  static const cudaError_t regs = [kernel] {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    return attr.numRegs == ENTRY_REGS ? cudaSuccess : cudaErrorLaunchOutOfResources;
  }();
  if (regs != cudaSuccess) return (int)regs;
  const int smem = S::alloc(T);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(T / S::ROWS, H / hg, B);
  kernel<<<grid, THREADS, smem, stream>>>(q_map, k_map, v_map, static_cast<const int*>(mask),
                                          static_cast<__nv_bfloat16*>(out), T, H, hg, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v/out: [B, T, H*64] bf16, contiguous, 16-byte aligned; mask: [B, T]
// int32 (1 = real key).  T a multiple of 256 up to 65,536, H a multiple of
// hg, and hg even for packed2.  mode (ops/encoder_attention_variants.MODES):
// 0 fp32, 1 bf16, 2 rcp, 3 nomax, 4 shift, 5 tilemax, 6 tilemax_rcp,
// 7 qnorm, 8 qnorm_post, 9 fp32_post, 10 shift_post, 11 tilemax_post,
// 12 packed2.  Returns the launch's CUDA error code.
int ta_encoder_attention_variant(const void* q, const void* k, const void* v, const void* mask,
                                 void* out, int B, int T, int H, int D_, int hg, int mode,
                                 float scale, void* stream) {
  if (B <= 0 || T <= 0 || T % BQ != 0 || T > 65536 || D_ != D || hg <= 0 || H % hg != 0 ||
      mask == nullptr || (mode == 12 && hg % 2 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  for (const void* p : {q, k, v, static_cast<const void*>(out)}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
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

// The registers a thread of every instance enters with, which its
// setmaxnreg split assumes; the launch refuses a build with another count.
int ta_encoder_attention_variant_entry_registers() { return ENTRY_REGS; }

// Dynamic shared memory a block of the mode's instance takes at T keys (0
// for an unknown mode): ptxas reports only static shared memory.
int ta_encoder_attention_variant_smem_bytes(int mode, int T) {
  if (mode < 0 || mode > 12) return 0;
  return mode == 12 ? Smem<2>::alloc(T) : Smem<1>::alloc(T);
}

}  // extern "C"
