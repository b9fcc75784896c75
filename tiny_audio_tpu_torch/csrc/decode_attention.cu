// Decode-step attention over the KV cache for Hopper (sm_90a): one query row
// per head attends over the valid cache prefix [0, kv_len) plus the fresh
// (not yet cached) row.  bf16 queries and fresh K/V, a cache of int8 with
// fp32 per-entry scales or of bf16, fp32 arithmetic, bf16 output.
//
//   ta_decode_attention         replaces tiny_audio_tpu/ops/decode_attention.py
//                               (decode_attention_tpu): the module decode
//                               step, which reads the stale cache and leaves
//                               the write of the fresh row to its caller.
//   ta_decode_attention_update  replaces decode_attention_update_tpu in the
//                               same file, driven by ops/fused_decode.py: the
//                               same attention, plus the in-place append of
//                               the fresh row at kv_len (int8-quantized with
//                               quantize_kv's arithmetic, or stored as bf16).
//
// Both run one device function for the attention (attend below).
//
// Design (simple and exact first):
//   - head_dim D in {64, 128, 256} (a template parameter) and GQA group
//     Hq / Hkv in {1, 2, 3, 4, 8} (a runtime bound): one block of 8 warps
//     per (batch row, KV head) holds up to MAX_HEADS = 4 query heads of the
//     group, which share every K/V row it reads once; a group of 8 takes
//     two blocks per KV head, each reading the rows once;
//   - kv_len is read from a device int32, so the launch does not depend on a
//     host value (fit for a CUDA graph of the decode step later);
//   - rows at kv_len and beyond are never read, so NaN or garbage there
//     cannot reach the output (the Pallas kernel zero-fills those slabs);
//   - each lane loads 16 bytes of a row (an int8 row of D = 128 is 8 lanes,
//     4 rows per warp step; a bf16 row 16 lanes, 2 rows), dequantizes in
//     registers and prefetches its next row before the math;
//   - scores are q.k * D^-0.5 * k_scale in fp32 (log2 units); an exact
//     online softmax in fp32 per lane, merged across the rows of a warp with
//     shuffles and across warps in shared memory; v_scale folds into the
//     probabilities; the fresh row's score comes from the unquantized bf16
//     fresh K, and p_self * fresh_v is added last, as both JAX versions do.
//     The final merge loops over the block's heads x D outputs.
//
// The append (ta_decode_attention_update): the last warp of the first block
// of each KV head quantizes the head's fresh K and V rows, scale =
// max(amax / 127, 1e-8), q = clamp(rint(x / scale), -127, 127), with IEEE
// divisions (no fast math, no reciprocal multiply), so the stored bytes and
// scales equal ops/decode_attention.py::quantize_kv's bit for bit.  The attention reads only
// rows < kv_len, so the write at row kv_len cannot race with it.
//
// What bounds it on the H100: a decode step's attention is a matrix-vector
// product, ~2 operations per cache byte, far below the card's ridge, so it
// is bound by the bytes it must move.  At B=4, Hkv=8, kv_len 468 -> 595 with
// an int8 cache it reads ~4.5 MB a launch (K, V and their scales), ~1.3 us
// at 3.35 TB/s; a bf16 cache reads twice that.  B x 8 = 32 blocks fill a
// quarter of the 132 SMs, and each warp walks its rows one dependent load at
// a time, so at this batch the launch and the load latency, not the bytes,
// will set the time.  A split over the sequence (more blocks, a second
// merge pass) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NUM_WARPS = 8;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int MAX_HEADS = 4;  // query heads one block holds

struct Args {
  const __nv_bfloat16* q;        // [B, Hq, D]
  void* cache_k;                 // [B, S, Hkv, D] int8 or bf16
  void* cache_v;
  float* k_scale;                // [B, S, Hkv] fp32, null for a bf16 cache
  float* v_scale;
  const __nv_bfloat16* fresh_k;  // [B, Hkv, D]
  const __nv_bfloat16* fresh_v;
  const int* kv_len;             // device scalar: valid prefix, row of the append
  __nv_bfloat16* out;            // [B, Hq, D]
  int S;
  int Hkv;
  int group;                     // Hq / Hkv
  int heads;                     // query heads per block: group, or 4 of a group of 8
  float scale_log2;              // D^-0.5 * log2(e)
};

__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int N>
__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[N]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = to_float(e[i]);
}

// exp2(m_part - m_total) as a merge weight; a part that saw no row has weight 0.
__device__ __forceinline__ float merge_weight(float m_part, float m_total) {
  return m_part == -INFINITY ? 0.f : exp2f(m_part - m_total);
}

// Query heads h0 .. h0 + a.heads - 1 of KV head kvh (heads counted within
// the group) attend over rows [0, kv_len) of batch row b plus the fresh row.
template <typename T, int D>
__device__ void attend(const Args& a, const int b, const int kvh, const int h0, const int kv_len) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int EPL = 16 / sizeof(T);  // cache elements a lane loads per row
  constexpr int LPR = D / EPL;         // lanes per row
  constexpr int RPW = 32 / LPR;        // rows per warp step
  constexpr int ROWS_PER_STEP = NUM_WARPS * RPW;
  constexpr int CPL = D / 32;          // fresh-row columns per lane

  __shared__ float sm_m[NUM_WARPS][MAX_HEADS];
  __shared__ float sm_l[NUM_WARPS][MAX_HEADS];
  __shared__ float sm_acc[NUM_WARPS][MAX_HEADS][D];
  __shared__ float sm_self[MAX_HEADS];

  const int heads = a.heads;  // uniform across the block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPR;            // which row of the warp step
  const int col0 = (lane % LPR) * EPL;   // this lane's columns
  const int hq = a.Hkv * a.group;
  const int64_t head0 = (int64_t)b * hq + (int64_t)kvh * a.group + h0;
  const __nv_bfloat16* q_rows = a.q + head0 * D;
  const int64_t fresh_off = ((int64_t)b * a.Hkv + kvh) * D;

  // The fresh row's score per query head: warp g, CPL columns a lane.
  if (warp < heads) {
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < CPL; ++e) {
      const int c = lane * CPL + e;
      dot += __bfloat162float(q_rows[warp * D + c]) * __bfloat162float(a.fresh_k[fresh_off + c]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) sm_self[warp] = dot * a.scale_log2;
  }

  float q[MAX_HEADS][EPL];
#pragma unroll
  for (int g = 0; g < MAX_HEADS; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      q[g][e] = g < heads ? __bfloat162float(q_rows[g * D + col0 + e]) : 0.f;
    }
  }

  const int64_t row_stride = (int64_t)a.Hkv * D;
  const int64_t head_off = (int64_t)b * a.S * row_stride + (int64_t)kvh * D + col0;
  const T* k_head = static_cast<const T*>(a.cache_k) + head_off;
  const T* v_head = static_cast<const T*>(a.cache_v) + head_off;
  const int64_t scale_off = (int64_t)b * a.S * a.Hkv + kvh;

  float m[MAX_HEADS], l[MAX_HEADS], acc[MAX_HEADS][EPL];
#pragma unroll
  for (int g = 0; g < MAX_HEADS; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  // The loop bound is uniform across the warp (the shuffles need every
  // lane); a row group past kv_len loads nothing and updates nothing.
  uint4 k_raw = make_uint4(0u, 0u, 0u, 0u), v_raw = k_raw;
  float ks = 1.f, vs = 1.f;
  int row = warp * RPW + sub;
  if (row < kv_len) {
    k_raw = *reinterpret_cast<const uint4*>(k_head + row * row_stride);
    v_raw = *reinterpret_cast<const uint4*>(v_head + row * row_stride);
    if (QUANT) {
      ks = a.k_scale[scale_off + (int64_t)row * a.Hkv];
      vs = a.v_scale[scale_off + (int64_t)row * a.Hkv];
    }
  }
  for (int base = warp * RPW; base < kv_len; base += ROWS_PER_STEP, row += ROWS_PER_STEP) {
    const bool valid = row < kv_len;
    float k[EPL], v[EPL];
    unpack<T, EPL>(k_raw, k);
    unpack<T, EPL>(v_raw, v);
    const float k_mul = a.scale_log2 * ks;
    const float v_mul = vs;
    // prefetch this lane's next row before the math
    const int next = row + ROWS_PER_STEP;
    if (next < kv_len) {
      k_raw = *reinterpret_cast<const uint4*>(k_head + next * row_stride);
      v_raw = *reinterpret_cast<const uint4*>(v_head + next * row_stride);
      if (QUANT) {
        ks = a.k_scale[scale_off + (int64_t)next * a.Hkv];
        vs = a.v_scale[scale_off + (int64_t)next * a.Hkv];
      }
    }
#pragma unroll
    for (int g = 0; g < MAX_HEADS; ++g) {
      if (g < heads) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot += q[g][e] * k[e];
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (valid) {
          const float s = dot * k_mul;
          const float m_new = fmaxf(m[g], s);
          const float corr = exp2f(m[g] - m_new);  // 0 while m is -inf
          const float p = exp2f(s - m_new);
          l[g] = l[g] * corr + p;
          const float pv = p * v_mul;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * corr + pv * v[e];
          m[g] = m_new;
        }
      }
    }
  }

  // Merge the row groups of the warp (lanes lane ^ off hold the same columns).
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < MAX_HEADS; ++g) {
      if (g < heads) {
        const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float m_new = fmaxf(m[g], m_o);
        const float w_self = merge_weight(m[g], m_new);
        const float w_o = merge_weight(m_o, m_new);
        l[g] = l[g] * w_self + l_o * w_o;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          acc[g][e] = acc[g][e] * w_self + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * w_o;
        }
        m[g] = m_new;
      }
    }
  }
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < MAX_HEADS; ++g) {
      if (g < heads) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) sm_acc[warp][g][col0 + e] = acc[g][e];
        if (lane == 0) {
          sm_m[warp][g] = m[g];
          sm_l[warp][g] = l[g];
        }
      }
    }
  }
  __syncthreads();

  // Merge the warps and fold in the fresh row, looping over the outputs.
  for (int o = threadIdx.x; o < heads * D; o += NUM_THREADS) {
    const int g = o / D;
    const int c = o % D;
    const float s_self = sm_self[g];
    float m_all = s_self;
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) m_all = fmaxf(m_all, sm_m[w][g]);
    const float p_self = exp2f(s_self - m_all);
    float denom = p_self;
    float out = p_self * __bfloat162float(a.fresh_v[fresh_off + c]);
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) {
      const float wt = merge_weight(sm_m[w][g], m_all);
      denom += sm_l[w][g] * wt;
      out += sm_acc[w][g][c] * wt;
    }
    a.out[(head0 + g) * D + c] = __float2bfloat16(out / denom);
  }
}

// Row kv_len of one head's K and V: quantized (int8) or copied (bf16); one warp.
template <typename T, int D>
__device__ void append_row(const Args& a, const int b, const int kvh, const int kv_len) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int CPL = D / 32;  // columns per lane
  const int lane = threadIdx.x % 32;
  const int c = lane * CPL;
  const int64_t fresh_off = ((int64_t)b * a.Hkv + kvh) * D + c;
  const int64_t row_off = ((int64_t)b * a.S + kv_len) * a.Hkv * D + (int64_t)kvh * D + c;
  const int64_t scale_at = ((int64_t)b * a.S + kv_len) * a.Hkv + kvh;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const __nv_bfloat16* src = (which == 0 ? a.fresh_k : a.fresh_v) + fresh_off;
    T* dst = static_cast<T*>(which == 0 ? a.cache_k : a.cache_v) + row_off;
    if constexpr (QUANT) {
      float x[CPL];
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        x[e] = __bfloat162float(src[e]);
        amax = fmaxf(amax, fabsf(x[e]));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      }
      const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        reinterpret_cast<int8_t*>(dst)[e] = static_cast<int8_t>(
            fminf(fmaxf(rintf(__fdiv_rn(x[e], scale)), -127.f), 127.f));
      }
      if (lane == 0) (which == 0 ? a.k_scale : a.v_scale)[scale_at] = scale;
    } else {
#pragma unroll
      for (int e = 0; e < CPL; ++e) dst[e] = src[e];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS) decode_attention_kernel(Args a) {
  const int kv_len = min(max(*a.kv_len, 0), a.S);
  const int chunks = a.group / a.heads;
  attend<T, D>(a, blockIdx.y, blockIdx.x / chunks, (blockIdx.x % chunks) * a.heads, kv_len);
}

template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS) decode_attention_update_kernel(Args a) {
  const int kv_len = *a.kv_len;
  const int chunks = a.group / a.heads;
  const int kvh = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  // one block per KV head appends; a row outside the cache is not written
  // (the wrapper checks a host kv_len)
  if (chunk == 0 && threadIdx.x / 32 == NUM_WARPS - 1 && kv_len >= 0 && kv_len < a.S) {
    append_row<T, D>(a, blockIdx.y, kvh, kv_len);
  }
  attend<T, D>(a, blockIdx.y, kvh, chunk * a.heads, min(max(kv_len, 0), a.S));
}

template <typename T, int D>
void launch_typed(bool update, const Args& a, dim3 grid, cudaStream_t s) {
  if (update) decode_attention_update_kernel<T, D><<<grid, NUM_THREADS, 0, s>>>(a);
  else decode_attention_kernel<T, D><<<grid, NUM_THREADS, 0, s>>>(a);
}

template <int D>
void launch_dim(bool update, bool quantized, const Args& a, dim3 grid, cudaStream_t s) {
  if (quantized) launch_typed<int8_t, D>(update, a, grid, s);
  else launch_typed<__nv_bfloat16, D>(update, a, grid, s);
}

bool supported_group(int group) {
  return group == 1 || group == 2 || group == 3 || group == 4 || group == 8;
}

int launch(bool update, const void* q, void* cache_k, void* cache_v, void* k_scale,
           void* v_scale, const void* fresh_k, const void* fresh_v, const void* kv_len,
           void* out, int B, int S, int Hq, int Hkv, int head_dim, int quantized,
           float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || !supported_group(Hq / Hkv) ||
      (head_dim != 64 && head_dim != 128 && head_dim != 256) ||
      (quantized && (k_scale == nullptr || v_scale == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.cache_k = cache_k;
  a.cache_v = cache_v;
  a.k_scale = static_cast<float*>(k_scale);
  a.v_scale = static_cast<float*>(v_scale);
  a.fresh_k = static_cast<const __nv_bfloat16*>(fresh_k);
  a.fresh_v = static_cast<const __nv_bfloat16*>(fresh_v);
  a.kv_len = static_cast<const int*>(kv_len);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.S = S;
  a.Hkv = Hkv;
  a.group = Hq / Hkv;
  a.heads = a.group <= MAX_HEADS ? a.group : MAX_HEADS;
  a.scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid(Hkv * (a.group / a.heads), B);
  cudaStream_t s = (cudaStream_t)stream;
  if (head_dim == 64) launch_dim<64>(update, quantized, a, grid, s);
  else if (head_dim == 128) launch_dim<128>(update, quantized, a, grid, s);
  else launch_dim<256>(update, quantized, a, grid, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/out: [B, Hq, D] bf16; cache_k/v: [B, S, Hkv, D] int8 (quantized = 1, with
// k/v_scale [B, S, Hkv] fp32) or bf16 (quantized = 0, scales null); fresh_k/v:
// [B, Hkv, D] bf16; kv_len: device int32 scalar.  D in {64, 128, 256},
// Hq / Hkv in {1, 2, 3, 4, 8}; every tensor contiguous and 16-byte aligned.
// Returns the launch's CUDA error code.
int ta_decode_attention(const void* q, const void* cache_k, const void* cache_v,
                        const void* k_scale, const void* v_scale, const void* fresh_k,
                        const void* fresh_v, const void* kv_len, void* out, int B, int S,
                        int Hq, int Hkv, int D_, int quantized, float scale, void* stream) {
  return launch(false, q, const_cast<void*>(cache_k), const_cast<void*>(cache_v),
                const_cast<void*>(k_scale), const_cast<void*>(v_scale), fresh_k, fresh_v,
                kv_len, out, B, S, Hq, Hkv, D_, quantized, scale, stream);
}

// As ta_decode_attention, and writes row kv_len of cache_k/v (and, quantized,
// of k/v_scale) in place before attending over rows [0, kv_len).
int ta_decode_attention_update(const void* q, void* cache_k, void* cache_v, void* k_scale,
                               void* v_scale, const void* fresh_k, const void* fresh_v,
                               const void* kv_len, void* out, int B, int S, int Hq, int Hkv,
                               int D_, int quantized, float scale, void* stream) {
  return launch(true, q, cache_k, cache_v, k_scale, v_scale, fresh_k, fresh_v, kv_len, out,
                B, S, Hq, Hkv, D_, quantized, scale, stream);
}

}  // extern "C"
