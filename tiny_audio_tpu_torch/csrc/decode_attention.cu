// Decode-step attention over the KV cache for Hopper (sm_90a): one query row
// per head attends over the valid cache prefix [0, kv_len) plus the fresh
// (not yet cached) row.  Queries, fresh K/V and the output in bf16 or fp32
// (the model's dtype), a cache of int8 with fp32 per-entry scales or of the
// model's dtype, fp32 arithmetic.
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
//   - head_dim D in {16, 32, 64, 128, 256} (a template parameter), the
//     model's dtype Q (bf16 or fp32) and the cache's (int8 or Q) template
//     parameters too, and GQA group
//     Hq / Hkv in {1, 2, 3, 4, 8} (a runtime bound): one block of 8 warps
//     per (batch row, KV head) holds up to MAX_HEADS = 4 query heads of the
//     group, which share every K/V row it reads once; a group of 8 takes
//     two blocks per KV head, each reading the rows once;
//   - kv_len is read from a device int32, so the launch does not depend on a
//     host value (fit for a CUDA graph of the decode step later);
//   - rows at kv_len and beyond are never read, so NaN or garbage there
//     cannot reach the output (the Pallas kernel zero-fills those slabs);
//   - each lane loads 16 bytes of a row (an int8 row of D = 128 is 8 lanes,
//     4 rows per warp step; a bf16 row 16 lanes, 2 rows), or 32 where a row
//     is wider than a warp's 16-byte loads (fp32 at D = 256), dequantizes in
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
  const void* q;                 // [B, Hq, D] bf16 or fp32 (Q)
  void* cache_k;                 // [B, S, Hkv, D] int8 or Q
  void* cache_v;
  float* k_scale;                // [B, S, Hkv] fp32, null for a cache of Q
  float* v_scale;
  const void* fresh_k;           // [B, Hkv, D] Q
  const void* fresh_v;
  const int* kv_len;             // device scalar: valid prefix, row of the append
  void* out;                     // [B, Hq, D] Q
  int S;
  int Hkv;
  int group;                     // Hq / Hkv
  int heads;                     // query heads per block: group, or 4 of a group of 8
  float scale_log2;              // D^-0.5 * log2(e)
};

__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

template <typename Q> __device__ __forceinline__ Q from_float(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }

template <typename T, int N, int NV>
__device__ __forceinline__ void unpack(const uint4 (&raw)[NV], float (&x)[N]) {
  const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = to_float(e[i]);
}

template <int NV>
__device__ __forceinline__ void load_row(const void* p, uint4 (&raw)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) raw[i] = reinterpret_cast<const uint4*>(p)[i];
}

// exp2(m_part - m_total) as a merge weight; a part that saw no row has weight 0.
__device__ __forceinline__ float merge_weight(float m_part, float m_total) {
  return m_part == -INFINITY ? 0.f : exp2f(m_part - m_total);
}

// Query heads h0 .. h0 + a.heads - 1 of KV head kvh (heads counted within
// the group) attend over rows [0, kv_len) of batch row b plus the fresh row.
template <typename Q, typename T, int D>
__device__ void attend(const Args& a, const int b, const int kvh, const int h0, const int kv_len) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  // cache elements a lane loads per row: 16 bytes, or a warp's share of a
  // row that 32 lanes of 16 bytes do not cover
  constexpr int EPL = 16 / sizeof(T) > D / 32 ? 16 / sizeof(T) : D / 32;
  constexpr int NV = EPL * sizeof(T) / 16;  // 16-byte loads per lane and row
  constexpr int LPR = D / EPL;         // lanes per row
  constexpr int RPW = 32 / LPR;        // rows per warp step
  constexpr int ROWS_PER_STEP = NUM_WARPS * RPW;
  constexpr int CPL = D >= 32 ? D / 32 : 1;  // fresh-row columns per lane (D < 32: lanes < D)
  const Q* q_all = static_cast<const Q*>(a.q);
  const Q* fresh_k = static_cast<const Q*>(a.fresh_k);
  const Q* fresh_v = static_cast<const Q*>(a.fresh_v);

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
  const Q* q_rows = q_all + head0 * D;
  const int64_t fresh_off = ((int64_t)b * a.Hkv + kvh) * D;

  // The fresh row's score per query head: warp g, CPL columns a lane.
  if (warp < heads) {
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < CPL; ++e) {
      const int c = lane * CPL + e;
      if (c < D) dot += to_float(q_rows[warp * D + c]) * to_float(fresh_k[fresh_off + c]);
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
      q[g][e] = g < heads ? to_float(q_rows[g * D + col0 + e]) : 0.f;
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
  uint4 k_raw[NV], v_raw[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) k_raw[i] = v_raw[i] = make_uint4(0u, 0u, 0u, 0u);
  float ks = 1.f, vs = 1.f;
  int row = warp * RPW + sub;
  if (row < kv_len) {
    load_row(k_head + row * row_stride, k_raw);
    load_row(v_head + row * row_stride, v_raw);
    if (QUANT) {
      ks = a.k_scale[scale_off + (int64_t)row * a.Hkv];
      vs = a.v_scale[scale_off + (int64_t)row * a.Hkv];
    }
  }
  for (int base = warp * RPW; base < kv_len; base += ROWS_PER_STEP, row += ROWS_PER_STEP) {
    const bool valid = row < kv_len;
    float k[EPL], v[EPL];
    unpack<T, EPL, NV>(k_raw, k);
    unpack<T, EPL, NV>(v_raw, v);
    const float k_mul = a.scale_log2 * ks;
    const float v_mul = vs;
    // prefetch this lane's next row before the math
    const int next = row + ROWS_PER_STEP;
    if (next < kv_len) {
      load_row(k_head + next * row_stride, k_raw);
      load_row(v_head + next * row_stride, v_raw);
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
    float out = p_self * to_float(fresh_v[fresh_off + c]);
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) {
      const float wt = merge_weight(sm_m[w][g], m_all);
      denom += sm_l[w][g] * wt;
      out += sm_acc[w][g][c] * wt;
    }
    static_cast<Q*>(a.out)[(head0 + g) * D + c] = from_float<Q>(out / denom);
  }
}

// Row kv_len of one head's K and V: quantized (int8) or copied (a cache of
// Q); one warp.
template <typename Q, typename T, int D>
__device__ void append_row(const Args& a, const int b, const int kvh, const int kv_len) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int CPL = D >= 32 ? D / 32 : 1;  // columns per lane (D < 32: lanes < D)
  const int lane = threadIdx.x % 32;
  const int c = lane * CPL;
  const bool active = c < D;
  const int64_t fresh_off = ((int64_t)b * a.Hkv + kvh) * D + c;
  const int64_t row_off = ((int64_t)b * a.S + kv_len) * a.Hkv * D + (int64_t)kvh * D + c;
  const int64_t scale_at = ((int64_t)b * a.S + kv_len) * a.Hkv + kvh;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const Q* src = static_cast<const Q*>(which == 0 ? a.fresh_k : a.fresh_v) + fresh_off;
    T* dst = static_cast<T*>(which == 0 ? a.cache_k : a.cache_v) + row_off;
    if constexpr (QUANT) {
      float x[CPL];
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        x[e] = active ? to_float(src[e]) : 0.f;
        amax = fmaxf(amax, fabsf(x[e]));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      }
      const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        if (active) {
          reinterpret_cast<int8_t*>(dst)[e] = static_cast<int8_t>(
              fminf(fmaxf(rintf(__fdiv_rn(x[e], scale)), -127.f), 127.f));
        }
      }
      if (lane == 0) (which == 0 ? a.k_scale : a.v_scale)[scale_at] = scale;
    } else if (active) {
#pragma unroll
      for (int e = 0; e < CPL; ++e) dst[e] = src[e];
    }
  }
}

template <typename Q, typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS) decode_attention_kernel(Args a) {
  const int kv_len = min(max(*a.kv_len, 0), a.S);
  const int chunks = a.group / a.heads;
  attend<Q, T, D>(a, blockIdx.y, blockIdx.x / chunks, (blockIdx.x % chunks) * a.heads, kv_len);
}

template <typename Q, typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS) decode_attention_update_kernel(Args a) {
  const int kv_len = *a.kv_len;
  const int chunks = a.group / a.heads;
  const int kvh = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  // one block per KV head appends; a row outside the cache is not written
  // (the wrapper checks a host kv_len)
  if (chunk == 0 && threadIdx.x / 32 == NUM_WARPS - 1 && kv_len >= 0 && kv_len < a.S) {
    append_row<Q, T, D>(a, blockIdx.y, kvh, kv_len);
  }
  attend<Q, T, D>(a, blockIdx.y, kvh, chunk * a.heads, min(max(kv_len, 0), a.S));
}

template <typename Q, typename T, int D>
void launch_typed(bool update, const Args& a, dim3 grid, cudaStream_t s) {
  if (update) decode_attention_update_kernel<Q, T, D><<<grid, NUM_THREADS, 0, s>>>(a);
  else decode_attention_kernel<Q, T, D><<<grid, NUM_THREADS, 0, s>>>(a);
}

template <int D>
void launch_dim(bool update, bool quantized, bool fp32, const Args& a, dim3 grid,
                cudaStream_t s) {
  if (fp32) {
    if (quantized) launch_typed<float, int8_t, D>(update, a, grid, s);
    else launch_typed<float, float, D>(update, a, grid, s);
  } else {
    if (quantized) launch_typed<__nv_bfloat16, int8_t, D>(update, a, grid, s);
    else launch_typed<__nv_bfloat16, __nv_bfloat16, D>(update, a, grid, s);
  }
}

bool supported_group(int group) {
  return group == 1 || group == 2 || group == 3 || group == 4 || group == 8;
}

int launch(bool update, const void* q, void* cache_k, void* cache_v, void* k_scale,
           void* v_scale, const void* fresh_k, const void* fresh_v, const void* kv_len,
           void* out, int B, int S, int Hq, int Hkv, int head_dim, int quantized, int fp32,
           float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || !supported_group(Hq / Hkv) ||
      (head_dim != 16 && head_dim != 32 && head_dim != 64 && head_dim != 128 &&
       head_dim != 256) ||
      (quantized && (k_scale == nullptr || v_scale == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.q = q;
  a.cache_k = cache_k;
  a.cache_v = cache_v;
  a.k_scale = static_cast<float*>(k_scale);
  a.v_scale = static_cast<float*>(v_scale);
  a.fresh_k = fresh_k;
  a.fresh_v = fresh_v;
  a.kv_len = static_cast<const int*>(kv_len);
  a.out = out;
  a.S = S;
  a.Hkv = Hkv;
  a.group = Hq / Hkv;
  a.heads = a.group <= MAX_HEADS ? a.group : MAX_HEADS;
  a.scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid(Hkv * (a.group / a.heads), B);
  cudaStream_t s = (cudaStream_t)stream;
  switch (head_dim) {
    case 16: launch_dim<16>(update, quantized, fp32, a, grid, s); break;
    case 32: launch_dim<32>(update, quantized, fp32, a, grid, s); break;
    case 64: launch_dim<64>(update, quantized, fp32, a, grid, s); break;
    case 128: launch_dim<128>(update, quantized, fp32, a, grid, s); break;
    default: launch_dim<256>(update, quantized, fp32, a, grid, s); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/out: [B, Hq, D] bf16 (fp32 = 0) or fp32 (fp32 = 1); cache_k/v:
// [B, S, Hkv, D] int8 (quantized = 1, with k/v_scale [B, S, Hkv] fp32) or
// q's dtype (quantized = 0, scales null); fresh_k/v: [B, Hkv, D] q's dtype;
// kv_len: device int32 scalar.  D in {16, 32, 64, 128, 256}, Hq / Hkv in
// {1, 2, 3, 4, 8}; every tensor contiguous and 16-byte aligned.
// Returns the launch's CUDA error code.
int ta_decode_attention(const void* q, const void* cache_k, const void* cache_v,
                        const void* k_scale, const void* v_scale, const void* fresh_k,
                        const void* fresh_v, const void* kv_len, void* out, int B, int S,
                        int Hq, int Hkv, int D_, int quantized, int fp32, float scale,
                        void* stream) {
  return launch(false, q, const_cast<void*>(cache_k), const_cast<void*>(cache_v),
                const_cast<void*>(k_scale), const_cast<void*>(v_scale), fresh_k, fresh_v,
                kv_len, out, B, S, Hq, Hkv, D_, quantized, fp32, scale, stream);
}

// As ta_decode_attention, and writes row kv_len of cache_k/v (and, quantized,
// of k/v_scale) in place before attending over rows [0, kv_len).
int ta_decode_attention_update(const void* q, void* cache_k, void* cache_v, void* k_scale,
                               void* v_scale, const void* fresh_k, const void* fresh_v,
                               const void* kv_len, void* out, int B, int S, int Hq, int Hkv,
                               int D_, int quantized, int fp32, float scale, void* stream) {
  return launch(true, q, cache_k, cache_v, k_scale, v_scale, fresh_k, fresh_v, kv_len, out,
                B, S, Hq, Hkv, D_, quantized, fp32, scale, stream);
}

}  // extern "C"
