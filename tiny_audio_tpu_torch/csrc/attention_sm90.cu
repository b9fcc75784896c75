// Flash-attention forward designed for Hopper (sm_90a): TMA loads into a
// ring of 128-byte-swizzled shared-memory stages, wgmma products, a producer
// warp and a consumer warpgroup per block.  bf16 in and out, fp32
// accumulation, exact online softmax.  It serves attention.cu's three entry
// points at head_dim 64 and 128 (the other head sizes and every fp32
// instance stay on attention.cu's mma.sync template and attention_f32.cu):
//
//   ta_encoder_attention (D = 64)  replaces tiny_audio_tpu/ops/
//       encoder_attention.py:159 _encoder_attention_impl: bidirectional MHA
//       over packed heads [B, T, H*D] with a key-padding mask;
//   ta_prefill_attention, ta_prefill_attention_fwd_stats (D = 64, 128)
//       replace tiny_audio_tpu/ops/attention.py:65 _flash_call (the library
//       Pallas flash_attention): causal attention with native GQA
//       (kv_head = q_head / group), key-padding mask, and for training each
//       query row's max m (log2 units) and sum l, [B, Hq, T] fp32, apart.
//
// The contract is attention.cu's: q [B, T, Hq, D] and k/v [B, T, Hkv, D]
// read in place; a key whose mask entry is 0 scores MASK_VALUE (so a row of
// padding keys averages them uniformly), a key past T, or past the query in
// the causal kernel, is excluded.
//
// What bounds it.  Per (batch row, head) attention does 4 T^2 D FLOPs over
// 8 T D bytes of q, k, v and out: T/2 FLOP per byte, 750 for the encoder's
// 1,500 frames and ~234 for a 468-token prefill, at or above the card's ~295
// FLOP/byte bf16 ridge.  So it is bound by operations: the tensor cores'
// issue rate and, at D = 64, the exp2 per score (a 64 x 128 score tile needs
// about as long on the SM's 16 exp2 units a clock as its two products on the
// tensor cores).  The design does this about it:
//   - wgmma (the card's full tensor-core rate) in place of mma.sync: S = Q K^T
//     with Q and K from shared memory (SS), O += P V with P from registers
//     (RS) and V's [key][d] tile read as a transposed ("MN-major") B through
//     its descriptor, so V is never copied or transposed;
//   - the producer warp issues TMA loads of K and V tiles into a ring of two
//     stages (full / empty mbarriers), so loads overlap the products and
//     the softmax; the tensor maps are 4-D (D, H, T, B), so rows past T are
//     zero-filled by the hardware and never read from the next batch row;
//   - a block is 64 query rows (one consumer warpgroup) and two blocks share
//     an SM, so one block's softmax overlaps the other's products; the
//     encoder stages 128 keys, the prefill 64 (two blocks of D = 128 fit
//     the SM's shared memory only so);
//   - the per-element mask runs only on tiles that need it: the causal
//     diagonal, the ragged last tile and tiles holding a padding key (the
//     producer votes over the tile's mask entries and hands the consumers a
//     bit per key and a flag); interior tiles take one FFMA and one exp2 a
//     score;
//   - causal blocks stop at the diagonal, and the grid runs the heaviest
//     (last) query tiles first; the bidirectional grid runs a head's query
//     tiles side by side, so the blocks on the card share K/V in L2.
// Not done yet (FA3's schedule): ping-pong of two consumer warpgroups and
// overlap of one tile's softmax with the next tile's product, clusters with
// TMA multicast of K/V, packing a GQA group's query heads into one block.

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
constexpr int STAGES = 2;              // the K/V ring
constexpr int BLOCK_Q = 64;            // query rows a block: one consumer warpgroup
constexpr int NUM_THREADS = 128 + 32;  // the consumer warpgroup and the producer warp
// Two blocks an SM, so that one block's softmax overlaps the other's
// products.  On the H100 this was faster for both kernels than a block of
// two consumer warpgroups (128 rows) with 128-key stages, one an SM
// (PERF.md).  The prefill stages 64 keys, so that two blocks of D = 128 fit
// the SM's shared memory; the encoder 128.
constexpr int MIN_BLOCKS = 2;
constexpr int ENCODER_BLOCK_K = 128;
constexpr int PREFILL_BLOCK_K = 64;

// Dynamic shared memory, from a 1,024-byte aligned base (the swizzle atom):
// Q (a box of [BLOCK_Q][64] per 64 columns of D), the K and V stages of
// BLOCK_K keys (boxes of [BLOCK_K][64]), the barriers and the key states.
template <int D, int BLOCK_K>
struct Smem {
  static constexpr int WORDS = BLOCK_K / 32;       // key-state words per stage
  static constexpr int KEY_WORDS = 2 * WORDS + 1;  // real bits, valid bits, "masked" flag
  static constexpr int BOXES = D / BOX_COLS;
  static constexpr int Q_BOX = BLOCK_Q * ROW_BYTES;
  static constexpr int KV_BOX = BLOCK_K * ROW_BYTES;
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int KV_BYTES = BOXES * KV_BOX;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;  // q, full[STAGES], empty[STAGES]
  static constexpr int KEYS_OFF = BAR_OFF + 8 * (1 + 2 * STAGES);
  static constexpr int BYTES = KEYS_OFF + 4 * STAGES * KEY_WORDS;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
};

template <int D, int BLOCK_K, bool CAUSAL, bool STATS>
__global__ void __launch_bounds__(NUM_THREADS, MIN_BLOCKS)
attention_fwd_sm90(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const int* __restrict__ mask,  // [B, T], 1 = real; or null
                   __nv_bfloat16* __restrict__ out,
                   float* __restrict__ m_out,     // [B, Hq, T] when STATS
                   float* __restrict__ l_out,
                   int T, int Hq, int Hkv, float scale_log2) {
  static_assert(D == 64 || D == 128, "the Hopper design serves head_dim 64 and 128");
  using S = Smem<D, BLOCK_K>;
  constexpr int WORDS = S::WORDS;
  constexpr int KEY_WORDS = S::KEY_WORDS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + STAGES;
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem + S::KEYS_OFF);

  // causal: the heaviest (last) query tiles first, a GQA group's heads side
  // by side; bidirectional: a head's query tiles side by side, so the blocks
  // on the card at once share their K/V in L2
  const int h = CAUSAL ? blockIdx.x : blockIdx.y;
  const int b = CAUSAL ? blockIdx.y : blockIdx.z;
  const int q_tile = CAUSAL ? gridDim.z - 1 - blockIdx.z : blockIdx.x;
  const int kvh = h / (Hq / Hkv);
  const int q0 = q_tile * BLOCK_Q;
  const int k_end = CAUSAL ? min(T, q0 + BLOCK_Q) : T;
  const int n_tiles = (k_end + BLOCK_K - 1) / BLOCK_K;
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
    // ---- producer: Q once, then K, V and the key states of each tile
    if (lane == 0) {
      sm90::prefetch_tensor_map(&q_map);
      sm90::prefetch_tensor_map(&k_map);
      sm90::prefetch_tensor_map(&v_map);
      sm90::mbar_arrive_expect_tx(q_bar, S::Q_BYTES);
#pragma unroll
      for (int box = 0; box < S::BOXES; ++box) {
        sm90::tma_load_4d(smem + box * S::Q_BOX, &q_map, q_bar, box * BOX_COLS, h, q0, b);
      }
    }
    const int* mask_row = mask ? mask + (int64_t)b * T : nullptr;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const int k0 = t * BLOCK_K;
      uint32_t words[KEY_WORDS];
      sm90::key_words<WORDS>(mask_row, k0, T, lane, words);
      if (lane == 0) {
        sm90::mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        uint32_t* kw = keys + s * KEY_WORDS;
#pragma unroll
        for (int w = 0; w < KEY_WORDS; ++w) kw[w] = words[w];
        sm90::mbar_arrive_expect_tx(&full[s], 2 * S::KV_BYTES);
        uint8_t* k_st = smem + S::K_OFF + s * S::KV_BYTES;
        uint8_t* v_st = smem + S::V_OFF + s * S::KV_BYTES;
#pragma unroll
        for (int box = 0; box < S::BOXES; ++box) {
          sm90::tma_load_4d(k_st + box * S::KV_BOX, &k_map, &full[s], box * BOX_COLS, kvh, k0, b);
          sm90::tma_load_4d(v_st + box * S::KV_BOX, &v_map, &full[s], box * BOX_COLS, kvh, k0, b);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: query rows q0 .. q0 + 63, 16 a warp
  constexpr int NS = BLOCK_K / 2;  // score accumulators a thread
  constexpr int NO = D / 2;        // output accumulators a thread
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = q0 + 16 * warp + g;  // this thread's two rows
  const int r1 = r0 + 8;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max (log2 units)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sum

  sm90::mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const int k0 = t * BLOCK_K;
    sm90::mbar_wait(&full[s], (t / STAGES) & 1);
    const uint8_t* k_st = smem + S::K_OFF + s * S::KV_BYTES;
    const uint8_t* v_st = smem + S::V_OFF + s * S::KV_BYTES;

    // S = Q K^T: K's [key][d] tile is the K-major B operand
    float sc[NS];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk % 4) * 32;  // the k16 step inside a 64-wide box
      sm90::wgmma_ss<BLOCK_K, 0>(
          sc, sm90::desc_sw128(smem + (kk / 4) * S::Q_BOX + off, 16, 1024),
          sm90::desc_sw128(k_st + (kk / 4) * S::KV_BOX + off, 16, 1024), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(sc);

    // Mask where needed; there the scores move to log2 units (mul = 1),
    // elsewhere the scale folds into the exp2's FFMA.
    const uint32_t* kw = keys + s * KEY_WORDS;
    const bool masked = kw[2 * WORDS] != 0 || (CAUSAL && k0 + BLOCK_K - 1 > q0);
    const float mul = masked ? 1.f : scale_log2;
    if (masked) {
      uint32_t real[WORDS], valid[WORDS];
#pragma unroll
      for (int w = 0; w < WORDS; ++w) {
        real[w] = kw[w];
        valid[w] = kw[WORDS + w];
      }
#pragma unroll
      for (int j = 0; j < BLOCK_K / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);
          const int bit = col & 31;
          float x = sc[4 * j + e] * scale_log2;
          if (!((valid[j / 4] >> bit) & 1u) || (CAUSAL && k0 + col > (e < 2 ? r0 : r1))) {
            x = -INFINITY;
          } else if (!((real[j / 4] >> bit) & 1u)) {
            x = MASK_VALUE;
          }
          sc[4 * j + e] = x;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BLOCK_K / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    // the four threads of a row group hold one row between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    mx0 = fmaxf(m0, mx0 * mul);
    mx1 = fmaxf(m1, mx1 * mul);
    // a row with nothing attendable yet keeps a finite base (no inf - inf)
    const float base0 = mx0 == -INFINITY ? 0.f : mx0;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1;
    const float alpha0 = exp2f(m0 - base0);
    const float alpha1 = exp2f(m1 - base1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }

    // P in registers: two neighbouring 8-key column blocks of S are the
    // RS product's A fragment of one 16-key step
    uint32_t p[BLOCK_K / 16][4];
#pragma unroll
    for (int kc = 0; kc < BLOCK_K / 16; ++kc) {
      float e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        e[i] = exp2f(fmaf(sc[8 * kc + i], mul, (i & 2) ? -base1 : -base0));
      }
      l0 += (e[0] + e[1]) + (e[4] + e[5]);
      l1 += (e[2] + e[3]) + (e[6] + e[7]);
      p[kc][0] = pack_bf16(e[0], e[1]);
      p[kc][1] = pack_bf16(e[2], e[3]);
      p[kc][2] = pack_bf16(e[4], e[5]);
      p[kc][3] = pack_bf16(e[6], e[7]);
    }

    // O += P V: V's [key][d] tile is the MN-major B operand; its 64-wide
    // boxes along d lie KV_BOX bytes apart
    sm90::fence_operands(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BLOCK_K / 16; ++kc) {
      sm90::wgmma_rs<D, 1>(o, p[kc],
                           sm90::desc_sw128(v_st + kc * 16 * ROW_BYTES, S::KV_BOX, 1024), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(o);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  const int64_t stride = (int64_t)Hq * D;  // between time steps
  __nv_bfloat16* o_base = out + (int64_t)b * T * stride + (int64_t)h * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    if (r0 < T) {
      *reinterpret_cast<uint32_t*>(o_base + r0 * stride + c) =
          pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    }
    if (r1 < T) {
      *reinterpret_cast<uint32_t*>(o_base + r1 * stride + c) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
  if constexpr (STATS) {
    if (t4 == 0) {  // one thread of the four that share a row writes it
      const int64_t base = ((int64_t)b * Hq + h) * T;
      if (r0 < T) {
        m_out[base + r0] = m0;
        l_out[base + r0] = l0;
      }
      if (r1 < T) {
        m_out[base + r1] = m1;
        l_out[base + r1] = l1;
      }
    }
  }
}

template <int D, int BLOCK_K, bool CAUSAL, bool STATS>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
           void* m_out, void* l_out, int B, int T, int Hq, int Hkv, float scale,
           void* stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, B, T, Hq, D, BLOCK_Q) || !make_map(&k_map, k, B, T, Hkv, D, BLOCK_K) ||
      !make_map(&v_map, v, B, T, Hkv, D, BLOCK_K)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = attention_fwd_sm90<D, BLOCK_K, CAUSAL, STATS>;
  constexpr int smem = Smem<D, BLOCK_K>::ALLOC;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (T + BLOCK_Q - 1) / BLOCK_Q;
  const dim3 grid = CAUSAL ? dim3(Hq, B, q_tiles) : dim3(q_tiles, Hq, B);
  kernel<<<grid, NUM_THREADS, smem, (cudaStream_t)stream>>>(
      q_map, k_map, v_map, static_cast<const int*>(mask), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(m_out), static_cast<float*>(l_out), T, Hq, Hkv, scale * ta::LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

namespace ta {

// The bf16 forward at head_dim 64 (bidirectional or causal) and 128
// (causal), with or without the statistics; any other case is refused.
// Arguments as attention.cu's entry points (Hq % Hkv == 0 checked there).
int attention_fwd_sm90(const void* q, const void* k, const void* v, const void* mask, void* out,
                       void* m_out, void* l_out, int B, int T, int Hq, int Hkv, int D,
                       bool causal, bool stats, float scale, void* stream) {
  using Launch = int (*)(const void*, const void*, const void*, const void*, void*, void*,
                         void*, int, int, int, int, float, void*);
  Launch run = nullptr;
  if (!causal && !stats && D == 64) run = launch<64, ENCODER_BLOCK_K, false, false>;
  if (causal && !stats && D == 64) run = launch<64, PREFILL_BLOCK_K, true, false>;
  if (causal && stats && D == 64) run = launch<64, PREFILL_BLOCK_K, true, true>;
  if (causal && !stats && D == 128) run = launch<128, PREFILL_BLOCK_K, true, false>;
  if (causal && stats && D == 128) run = launch<128, PREFILL_BLOCK_K, true, true>;
  if (run == nullptr) return (int)cudaErrorInvalidValue;
  return run(q, k, v, mask, out, m_out, l_out, B, T, Hq, Hkv, scale, stream);
}

}  // namespace ta

extern "C" {

// Dynamic shared memory a block of the (head_dim, causal) instance takes (0
// for one the design does not serve): ptxas reports only static shared
// memory.
int ta_attention_sm90_smem_bytes(int D, int causal) {
  if (causal && D == 64) return Smem<64, PREFILL_BLOCK_K>::ALLOC;
  if (causal && D == 128) return Smem<128, PREFILL_BLOCK_K>::ALLOC;
  return !causal && D == 64 ? Smem<64, ENCODER_BLOCK_K>::ALLOC : 0;
}

}  // extern "C"
