// Flash-attention forward, bf16 in and out, fp32 accumulation, exact online
// softmax: the entry points, and the mma.sync template that serves the head
// sizes the Hopper design does not.  (The fp32 instances of the same entry
// points are in attention_f32.cu.)
//
// Three entry points:
//
//   ta_encoder_attention       replaces tiny_audio_tpu/ops/encoder_attention.py
//                              (_encoder_attention_impl): bidirectional MHA
//                              over packed heads [B, T, H*D], key-padding
//                              mask, D = 16, 32 or 64.
//   ta_prefill_attention       replaces tiny_audio_tpu/ops/attention.py
//                              (_flash_call / flash_mha): causal attention
//                              with native GQA (kv_head = q_head / group),
//                              key-padding mask, D = 16, 32, 64, 128 or 256.
//   ta_prefill_attention_fwd_stats
//                              the same, and also each query row's softmax
//                              statistics for the backward (attention_bwd.cu):
//                              the row max m (log2 units) and the row sum l,
//                              [B, Hq, T] fp32 each.  They stay apart, as the
//                              library kernel's save_residuals keeps them: a
//                              row whose visible keys are all padding has
//                              m = MASK_VALUE, where m + log2(l) would round
//                              back to m and lose l.
//
// The entry points pick the design by head_dim:
//   - D = 64 and 128 (the flagship's encoder and decoder): attention_sm90.cu,
//     TMA stages, wgmma products, a producer warp and a consumer warpgroup
//     a block; its header has the design and what bounds it;
//   - D = 16, 32 and 256 (the tiny towers, 256-wide decoders): the template
//     below.
//
// The packed encoder layout [B, T, H*D] is the same memory as [B, T, H, D],
// so both read q as [B, T, Hq, D] and k/v as [B, T, Hkv, D] straight from
// the projections: no transpose, no padding copy, no repeated KV heads.
//
// The template below (simple and exact; the Hopper design replaced it at
// D = 64 and 128):
//   - one block of 4 warps per (64-row q tile, q head, batch row); each warp
//     owns 16 query rows; up to D = 128 it keeps its Q fragments in
//     registers, at D = 256 (64 more registers) it reloads them from L1/L2
//     at each key tile instead;
//   - K and V tiles of 64 keys (32 at D = 256, to stay inside 48 KB of
//     static shared memory) are staged in shared memory (V transposed so
//     the P.V operand fragments are contiguous 32-bit loads);
//   - S = Q K^T and O += P V run on the tensor cores with
//     mma.sync.m16n8k16 (bf16 x bf16 -> fp32); the S accumulator fragment is
//     reused as the A fragment of P, so P never leaves registers;
//   - online softmax in fp32 in the log2 domain; the ragged edge is masked
//     in the kernel; causal blocks stop at the diagonal.
//
// Masking follows the plain version (models/layers.attention): a key whose
// padding-mask entry is 0 scores MASK_VALUE (-0.7 * FLT_MAX), not -inf, so a
// fully masked row averages V uniformly instead of producing NaN.  Keys past
// T (and, for the causal kernel, past the query) are excluded entirely.
//
// What bounds it on the H100: per (batch, head) attention does 4*T*T*D
// FLOPs over 8*T*D bytes of q, k, v and out, T/2 FLOP/byte, at or above the
// card's ~295 FLOP/byte bf16 ridge for the path's lengths.  So it is bound
// by compute: the tensor-core issue rate (mma.sync reaches only part of the
// wgmma peak) and the softmax's exp/max work per score.  Device-memory
// traffic stays at the inputs and output because the [T, T] score matrix
// never leaves the SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace ta {
// attention_sm90.cu: the bf16 forward at D = 64 (bidirectional or causal) and
// D = 128 (causal), with or without the statistics.
int attention_fwd_sm90(const void* q, const void* k, const void* v, const void* mask, void* out,
                       void* m_out, void* l_out, int B, int T, int Hq, int Hkv, int D,
                       bool causal, bool stats, float scale, void* stream);
}  // namespace ta

namespace {

using ta::ld32;
using ta::mma_16816;
using ta::pack_bf16;
using ta::MASK_VALUE;

constexpr int BLOCK_Q = 64;    // query rows per block, 16 per warp
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;

template <int D, bool CAUSAL, bool STATS>
__global__ void __launch_bounds__(NUM_THREADS)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ mask,  // [B, T], 1 = real; or null
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ m_out,     // [B, Hq, T] when STATS
                     float* __restrict__ l_out,
                     int T, int Hq, int Hkv, float scale_log2) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int BLOCK_K = D > 128 ? 32 : 64;  // keys per shared-memory tile
  constexpr bool Q_IN_REGS = D <= 128;
  constexpr int KPAD = D + 8;        // padded K row: conflict-free fragment loads
  constexpr int VPAD = BLOCK_K + 8;  // padded V^T row
  constexpr int VEC = 8;             // bf16 values per 16-byte load
  constexpr int VECS_PER_ROW = D / VEC;
  constexpr int N_TILES = BLOCK_K / 8;  // 8-key column tiles of S
  constexpr int O_TILES = D / 8;        // 8-wide column tiles of O

  __shared__ __align__(16) __nv_bfloat16 k_s[BLOCK_K * KPAD];
  __shared__ __align__(16) __nv_bfloat16 vt_s[D * VPAD];
  __shared__ int key_state[BLOCK_K];  // 1 real, 0 padding (MASK_VALUE), -1 past T

  const int q_tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row within the 8-row group
  const int t4 = lane & 3;  // fragment column pair

  const int64_t q_stride = (int64_t)Hq * D;    // between time steps
  const int64_t kv_stride = (int64_t)Hkv * D;
  const __nv_bfloat16* q_base = q + (int64_t)b * T * q_stride + (int64_t)h * D;
  const __nv_bfloat16* k_base = k + (int64_t)b * T * kv_stride + (int64_t)kvh * D;
  const __nv_bfloat16* v_base = v + (int64_t)b * T * kv_stride + (int64_t)kvh * D;
  __nv_bfloat16* o_base = out + (int64_t)b * T * q_stride + (int64_t)h * D;
  const int* mask_row = mask ? mask + (int64_t)b * T : nullptr;

  // This thread's two query rows (fragment rows g and g + 8 of its warp).
  const int r0 = q_tile * BLOCK_Q + warp * 16 + g;
  const int r1 = r0 + 8;

  // Q as mma A fragments for the 16-wide k step kk (rows past T are zero).
  auto load_q = [&](int kk, uint32_t (&a)[4]) {
    const int c = kk * 16 + 2 * t4;
    a[0] = r0 < T ? ld32(q_base + r0 * q_stride + c) : 0u;
    a[1] = r1 < T ? ld32(q_base + r1 * q_stride + c) : 0u;
    a[2] = r0 < T ? ld32(q_base + r0 * q_stride + c + 8) : 0u;
    a[3] = r1 < T ? ld32(q_base + r1 * q_stride + c + 8) : 0u;
  };
  uint32_t qf[Q_IN_REGS ? D / 16 : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) load_q(kk, qf[kk]);
  }

  float o[O_TILES][4];
#pragma unroll
  for (int j = 0; j < O_TILES; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max (log2 units)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sum

  const int k_end = CAUSAL ? min(T, (q_tile + 1) * BLOCK_Q) : T;
  const int k_tiles = (k_end + BLOCK_K - 1) / BLOCK_K;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * BLOCK_K;
    __syncthreads();  // every warp is done with the previous tile

    for (int i = threadIdx.x; i < BLOCK_K * VECS_PER_ROW; i += NUM_THREADS) {
      const int row = i / VECS_PER_ROW;
      const int col = (i % VECS_PER_ROW) * VEC;
      const int key = k0 + row;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv4 = make_uint4(0u, 0u, 0u, 0u);  // zero rows past T: 0 * garbage could be NaN
      if (key < T) {
        kv4 = *reinterpret_cast<const uint4*>(k_base + key * kv_stride + col);
        vv4 = *reinterpret_cast<const uint4*>(v_base + key * kv_stride + col);
      }
      *reinterpret_cast<uint4*>(&k_s[row * KPAD + col]) = kv4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int e = 0; e < VEC; ++e) vt_s[(col + e) * VPAD + row] = ve[e];
    }
    if (threadIdx.x < BLOCK_K) {
      const int key = k0 + threadIdx.x;
      key_state[threadIdx.x] =
          key >= T ? -1 : (mask_row == nullptr || mask_row[key] != 0) ? 1 : 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BLOCK_K keys.
    float s[N_TILES][4];
#pragma unroll
    for (int n = 0; n < N_TILES; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qf[kk][r];
      } else {
        load_q(kk, a);
      }
#pragma unroll
      for (int n = 0; n < N_TILES; ++n) {
        const __nv_bfloat16* kp = &k_s[(n * 8 + g) * KPAD + kk * 16 + 2 * t4];
        mma_16816(s[n], a, ld32(kp), ld32(kp + 8));
      }
    }

    // Scale into log2 units, mask, and take the tile's row max.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < N_TILES; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const int state = key_state[col];
        float x = s[n][e] * scale_log2;
        if (state < 0 || (CAUSAL && k0 + col > row)) {
          x = -INFINITY;
        } else if (state == 0) {
          x = MASK_VALUE;
        }
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // The four threads of a fragment row group hold one row between them.
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // A row with nothing attendable yet keeps a finite base (no inf - inf).
    const float base0 = mx0 == -INFINITY ? 0.f : mx0;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1;
    const float alpha0 = exp2f(m0 - base0);
    const float alpha1 = exp2f(m1 - base1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int j = 0; j < O_TILES; ++j) {
      o[j][0] *= alpha0;
      o[j][1] *= alpha0;
      o[j][2] *= alpha1;
      o[j][3] *= alpha1;
    }
#pragma unroll
    for (int n = 0; n < N_TILES; ++n) {
      s[n][0] = exp2f(s[n][0] - base0);
      s[n][1] = exp2f(s[n][1] - base0);
      s[n][2] = exp2f(s[n][2] - base1);
      s[n][3] = exp2f(s[n][3] - base1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }

    // O += P V: the S fragments of two neighbouring 8-key tiles form the A
    // fragment of one 16-key step.
#pragma unroll
    for (int kc = 0; kc < BLOCK_K / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int j = 0; j < O_TILES; ++j) {
        const __nv_bfloat16* vp = &vt_s[(j * 8 + g) * VPAD + kc * 16 + 2 * t4];
        mma_16816(o[j], pa, ld32(vp), ld32(vp + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < O_TILES; ++j) {
    const int c = j * 8 + 2 * t4;
    if (r0 < T) {
      *reinterpret_cast<uint32_t*>(o_base + r0 * q_stride + c) =
          pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    }
    if (r1 < T) {
      *reinterpret_cast<uint32_t*>(o_base + r1 * q_stride + c) =
          pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
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

template <int D, bool CAUSAL, bool STATS>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
           void* m_out, void* l_out, int B, int T, int Hq, int Hkv, float scale,
           void* stream) {
  const dim3 grid((T + BLOCK_Q - 1) / BLOCK_Q, Hq, B);
  attention_fwd_kernel<D, CAUSAL, STATS><<<grid, NUM_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(mask),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(m_out),
      static_cast<float*>(l_out), T, Hq, Hkv, scale * ta::LOG2E);
  return (int)cudaGetLastError();
}

template <bool STATS>
int launch_prefill(const void* q, const void* k, const void* v, const void* mask, void* out,
                   void* m_out, void* l_out, int B, int T, int Hq, int Hkv, int D,
                   float scale, void* stream) {
  if (T <= 0 || B <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return launch<16, true, STATS>(q, k, v, mask, out, m_out, l_out, B, T, Hq, Hkv, scale, stream);
    case 32:
      return launch<32, true, STATS>(q, k, v, mask, out, m_out, l_out, B, T, Hq, Hkv, scale, stream);
    case 64:
    case 128:
      return ta::attention_fwd_sm90(q, k, v, mask, out, m_out, l_out, B, T, Hq, Hkv, D, true,
                                    STATS, scale, stream);
    case 256:
      return launch<256, true, STATS>(q, k, v, mask, out, m_out, l_out, B, T, Hq, Hkv, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q/k/v/out: [B, T, H*D] bf16 with D = 16, 32 or 64, contiguous, 16-byte
// aligned; mask: [B, T] int32 or null.  Returns the CUDA error code of the
// launch (0 = success).
int ta_encoder_attention(const void* q, const void* k, const void* v, const void* mask,
                         void* out, int B, int T, int H, int D, float scale,
                         void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return launch<16, false, false>(q, k, v, mask, out, nullptr, nullptr, B, T, H, H, scale, stream);
    case 32:
      return launch<32, false, false>(q, k, v, mask, out, nullptr, nullptr, B, T, H, H, scale, stream);
    case 64:
      return ta::attention_fwd_sm90(q, k, v, mask, out, nullptr, nullptr, B, T, H, H, 64, false,
                                    false, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// q/out: [B, T, Hq, D]; k/v: [B, T, Hkv, D] (Hq % Hkv == 0, D = 16, 32, 64,
// 128 or 256); bf16, contiguous, 16-byte aligned; mask: [B, T] int32 or null.  Causal.
int ta_prefill_attention(const void* q, const void* k, const void* v, const void* mask,
                         void* out, int B, int T, int Hq, int Hkv, int D, float scale,
                         void* stream) {
  return launch_prefill<false>(q, k, v, mask, out, nullptr, nullptr, B, T, Hq, Hkv, D, scale,
                               stream);
}

// As ta_prefill_attention, and m/l: [B, Hq, T] fp32, each row's max score
// (log2 units, scale applied) and sum of exp2(score - max).
int ta_prefill_attention_fwd_stats(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* m, void* l, int B,
                                   int T, int Hq, int Hkv, int D, float scale, void* stream) {
  return launch_prefill<true>(q, k, v, mask, out, m, l, B, T, Hq, Hkv, D, scale, stream);
}

}  // extern "C"
