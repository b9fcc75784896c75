// The fp32 instances of the attention kernels for Hopper (sm_90a): fp32 in
// and out, fp32 FMAs on the CUDA cores (no tensor cores, so no TF32
// rounding), the same functions and entry-point shapes as the bf16 kernels:
//
//   ta_encoder_attention_f32            kernel #1 (attention.cu) in fp32:
//                                       tiny_audio_tpu/ops/encoder_attention.py
//                                       (_encoder_attention_impl), whose output
//                                       dtype is q's
//   ta_prefill_attention_f32            kernel #2 (attention.cu) in fp32:
//   ta_prefill_attention_fwd_stats_f32  tiny_audio_tpu/ops/attention.py
//                                       (flash_mha), with the row statistics
//   ta_prefill_attention_bwd_dkv_f32    kernels #2b and #2c (attention_bwd.cu)
//   ta_prefill_attention_bwd_dq_f32     in fp32
//
// The JAX package sends every dtype and head_dim to its kernels; an fp32
// model (the repo's tiny towers in fp32: configs/experiments/smoke.yaml) runs
// these.  D is 16, 32, 64, 128 or 256.
//
// Design (simple and right; speed is later work): a block is one warp and
// each lane owns one row of its side (a query row in the forward and in dq,
// a key in dkv), 32 rows a block.  The own rows (and their fp32 accumulator)
// sit in shared memory with a padded stride of D + 1 floats, so the 32 lanes
// reading column d of their rows hit 32 different banks; the other side
// streams through shared memory in tiles of 32 rows, each element read by
// all lanes at once (a broadcast).  A lane keeps the 32 scores of a tile in
// registers, so every score is one dot product of D FMAs, and the softmax,
// masking and statistics are the bf16 kernels' (log2 units, a padding key
// scores MASK_VALUE, keys past T or past the query are excluded; the
// backward recomputes P from m and l with the same p_and_ds).
//
// What bounds it on the H100: fp32 on the CUDA cores peaks at 67 TFLOP/s,
// and an attention of 4 T^2 D FLOPs per head over 16 T D bytes is far above
// that ridge (~20 FLOP/byte), so it is bound by the FP32 FMA rate and, here,
// by one warp per block keeping few FMAs in flight: the fp32 models this
// serves are the small ones.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using ta::key_state_of;
using ta::p_and_ds;
using ta::MASK_VALUE;

constexpr int ROWS = 32;  // own rows per block: one per lane of the one warp
constexpr int TILE = 32;  // rows of the other side per shared-memory tile

// Rows [r0, r0 + n) of one head of x (time stride `stride`) into `dst` with
// row pitch `pitch`; rows past T are zero.  Lanes walk the columns, so the
// global reads are coalesced.
template <int D>
__device__ __forceinline__ void load_rows(const float* base, int64_t stride, int r0, int n,
                                          int T, float* dst, int pitch) {
  for (int r = 0; r < n; ++r) {
    for (int d = threadIdx.x; d < D; d += 32) {
      dst[r * pitch + d] = r0 + r < T ? base[(r0 + r) * stride + d] : 0.f;
    }
  }
}

// Rows of `acc` (pitch D + 1) times scale[r] to the rows r0 + r < T of out.
template <int D>
__device__ __forceinline__ void store_rows(const float* acc, const float* scale, int r0, int T,
                                           float* base, int64_t stride) {
  for (int r = 0; r < ROWS && r0 + r < T; ++r) {
    for (int d = threadIdx.x; d < D; d += 32) {
      base[(r0 + r) * stride + d] = acc[r * (D + 1) + d] * scale[r];
    }
  }
}

template <int D>
struct F32Smem {
  static constexpr int P = D + 1;  // padded pitch of the lane-owned rows
  // forward: q, o (own rows); k, v (tiles)
  static constexpr size_t FWD = (2 * ROWS * P + 2 * TILE * D) * sizeof(float);
  // dq: q, dO, dQ (own rows); k, v (tiles)
  static constexpr size_t DQ = (3 * ROWS * P + 2 * TILE * D) * sizeof(float);
  // dkv: k, v, dK, dV (own rows); q, dO (tiles); m, l, delta
  static constexpr size_t DKV = (4 * ROWS * P + 2 * TILE * D + 3 * TILE) * sizeof(float);
};

template <int D, bool CAUSAL, bool STATS>
__global__ void __launch_bounds__(32)
attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ mask,
                         float* __restrict__ out, float* __restrict__ m_out,
                         float* __restrict__ l_out, int T, int Hq, int Hkv, float scale_log2) {
  constexpr int P = F32Smem<D>::P;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* o_s = q_s + ROWS * P;
  float* k_s = o_s + ROWS * P;
  float* v_s = k_s + TILE * D;
  __shared__ int key_state[TILE];
  __shared__ float inv_l[ROWS];

  const int lane = threadIdx.x;
  const int q0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int64_t q_stride = (int64_t)Hq * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const float* q_base = q + (int64_t)b * T * q_stride + (int64_t)h * D;
  const float* k_base = k + (int64_t)b * T * kv_stride + (int64_t)kvh * D;
  const float* v_base = v + (int64_t)b * T * kv_stride + (int64_t)kvh * D;
  const int* mask_row = mask ? mask + (int64_t)b * T : nullptr;

  load_rows<D>(q_base, q_stride, q0, ROWS, T, q_s, P);
  for (int i = lane; i < ROWS * P; i += 32) o_s[i] = 0.f;
  const int row = q0 + lane;
  float m = -INFINITY, l = 0.f;

  const int k_end = CAUSAL ? min(T, q0 + ROWS) : T;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncwarp();  // every lane is done with the previous tile
    load_rows<D>(k_base, kv_stride, k0, TILE, T, k_s, D);
    load_rows<D>(v_base, kv_stride, k0, TILE, T, v_s, D);
    key_state[lane] = key_state_of(mask_row, k0 + lane, T);
    __syncwarp();

    float s[TILE];
#pragma unroll
    for (int j = 0; j < TILE; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = q_s[lane * P + d];
#pragma unroll
      for (int j = 0; j < TILE; ++j) s[j] = fmaf(qd, k_s[j * D + d], s[j]);
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const int state = key_state[j];
      float x = s[j] * scale_log2;
      if (state < 0 || (CAUSAL && k0 + j > row)) {
        x = -INFINITY;
      } else if (state == 0) {
        x = MASK_VALUE;
      }
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    // a row with nothing attendable yet keeps a finite base (no inf - inf)
    const float base = mx == -INFINITY ? 0.f : mx;
    const float alpha = exp2f(m - base);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      s[j] = exp2f(s[j] - base);
      l += s[j];
    }
    for (int d = 0; d < D; ++d) {
      float acc = o_s[lane * P + d] * alpha;
#pragma unroll
      for (int j = 0; j < TILE; ++j) acc = fmaf(s[j], v_s[j * D + d], acc);
      o_s[lane * P + d] = acc;
    }
  }
  inv_l[lane] = 1.f / l;
  if (STATS && row < T) {
    const int64_t at = ((int64_t)b * Hq + h) * T + row;
    m_out[at] = m;
    l_out[at] = l;
  }
  __syncwarp();
  store_rows<D>(o_s, inv_l, q0, T, out + (int64_t)b * T * q_stride + (int64_t)h * D, q_stride);
}

template <int D>
__global__ void __launch_bounds__(32)
attention_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const int* __restrict__ mask,
                            const float* __restrict__ dout, const float* __restrict__ m_stat,
                            const float* __restrict__ l_stat, const float* __restrict__ delta,
                            float* __restrict__ dq, int T, int Hq, int Hkv, float scale_log2,
                            float scale) {
  constexpr int P = F32Smem<D>::P;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + ROWS * P;
  float* dq_s = do_s + ROWS * P;
  float* k_s = dq_s + ROWS * P;
  float* v_s = k_s + TILE * D;
  __shared__ int key_state[TILE];
  __shared__ float scales[ROWS];

  const int lane = threadIdx.x;
  const int q0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int64_t q_stride = (int64_t)Hq * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t q_off = (int64_t)b * T * q_stride + (int64_t)h * D;
  const int64_t kv_off = (int64_t)b * T * kv_stride + (int64_t)kvh * D;
  const int* mask_row = mask ? mask + (int64_t)b * T : nullptr;

  load_rows<D>(q + q_off, q_stride, q0, ROWS, T, q_s, P);
  load_rows<D>(dout + q_off, q_stride, q0, ROWS, T, do_s, P);
  for (int i = lane; i < ROWS * P; i += 32) dq_s[i] = 0.f;
  const int row = q0 + lane;
  const int64_t stat = ((int64_t)b * Hq + h) * T + row;
  const float m = row < T ? m_stat[stat] : 0.f;
  const float l = row < T ? l_stat[stat] : 1.f;
  const float dl = row < T ? delta[stat] : 0.f;

  const int k_end = min(T, q0 + ROWS);  // causal: keys up to the block's last query
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncwarp();
    load_rows<D>(k + kv_off, kv_stride, k0, TILE, T, k_s, D);
    load_rows<D>(v + kv_off, kv_stride, k0, TILE, T, v_s, D);
    key_state[lane] = key_state_of(mask_row, k0 + lane, T);
    __syncwarp();

    float s[TILE], dp[TILE];
#pragma unroll
    for (int j = 0; j < TILE; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = q_s[lane * P + d];
      const float dod = do_s[lane * P + d];
#pragma unroll
      for (int j = 0; j < TILE; ++j) {
        s[j] = fmaf(qd, k_s[j * D + d], s[j]);
        dp[j] = fmaf(dod, v_s[j * D + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      float p;
      p_and_ds(s[j], dp[j], key_state[j], row < T && k0 + j <= row, scale_log2, m, l, dl, p,
               dp[j]);
    }
    for (int d = 0; d < D; ++d) {
      float acc = dq_s[lane * P + d];
#pragma unroll
      for (int j = 0; j < TILE; ++j) acc = fmaf(dp[j], k_s[j * D + d], acc);
      dq_s[lane * P + d] = acc;
    }
  }
  scales[lane] = scale;
  __syncwarp();
  store_rows<D>(dq_s, scales, q0, T, dq + q_off, q_stride);
}

template <int D>
__global__ void __launch_bounds__(32)
attention_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const int* __restrict__ mask,
                             const float* __restrict__ dout, const float* __restrict__ m_stat,
                             const float* __restrict__ l_stat, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv, int T, int Hq,
                             int Hkv, float scale_log2, float scale) {
  constexpr int P = F32Smem<D>::P;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + ROWS * P;
  float* dk_s = v_s + ROWS * P;
  float* dv_s = dk_s + ROWS * P;
  float* q_s = dv_s + ROWS * P;
  float* do_s = q_s + TILE * D;
  float* m_s = do_s + TILE * D;
  float* l_s = m_s + TILE;
  float* d_s = l_s + TILE;
  __shared__ float scales[2][ROWS];

  const int lane = threadIdx.x;
  const int k0 = blockIdx.x * ROWS;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int64_t q_stride = (int64_t)Hq * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t kv_off = (int64_t)b * T * kv_stride + (int64_t)kvh * D;
  const int* mask_row = mask ? mask + (int64_t)b * T : nullptr;

  load_rows<D>(k + kv_off, kv_stride, k0, ROWS, T, k_s, P);
  load_rows<D>(v + kv_off, kv_stride, k0, ROWS, T, v_s, P);
  for (int i = lane; i < ROWS * P; i += 32) dk_s[i] = dv_s[i] = 0.f;
  const int key = k0 + lane;
  const int state = key_state_of(mask_row, key, T);

  // the GQA group's query heads, each over its queries from the diagonal on
  for (int hg = 0; hg < group; ++hg) {
    const int h = kvh * group + hg;
    const int64_t q_off = (int64_t)b * T * q_stride + (int64_t)h * D;
    const int64_t stat_off = ((int64_t)b * Hq + h) * T;
    for (int q0 = k0; q0 < T; q0 += TILE) {
      __syncwarp();
      load_rows<D>(q + q_off, q_stride, q0, TILE, T, q_s, D);
      load_rows<D>(dout + q_off, q_stride, q0, TILE, T, do_s, D);
      const int r = q0 + lane;
      m_s[lane] = r < T ? m_stat[stat_off + r] : 0.f;
      l_s[lane] = r < T ? l_stat[stat_off + r] : 1.f;
      d_s[lane] = r < T ? delta[stat_off + r] : 0.f;
      __syncwarp();

      float s[TILE], dp[TILE];
#pragma unroll
      for (int i = 0; i < TILE; ++i) s[i] = dp[i] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kd = k_s[lane * P + d];
        const float vd = v_s[lane * P + d];
#pragma unroll
        for (int i = 0; i < TILE; ++i) {
          s[i] = fmaf(kd, q_s[i * D + d], s[i]);
          dp[i] = fmaf(vd, do_s[i * D + d], dp[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < TILE; ++i) {
        const bool visible = q0 + i < T && key <= q0 + i;
        p_and_ds(s[i], dp[i], state, visible, scale_log2, m_s[i], l_s[i], d_s[i], s[i], dp[i]);
      }
      for (int d = 0; d < D; ++d) {
        float av = dv_s[lane * P + d];
        float ak = dk_s[lane * P + d];
#pragma unroll
        for (int i = 0; i < TILE; ++i) {
          av = fmaf(s[i], do_s[i * D + d], av);
          ak = fmaf(dp[i], q_s[i * D + d], ak);
        }
        dv_s[lane * P + d] = av;
        dk_s[lane * P + d] = ak;
      }
    }
  }
  scales[0][lane] = scale;
  scales[1][lane] = 1.f;
  __syncwarp();
  store_rows<D>(dk_s, scales[0], k0, T, dk + kv_off, kv_stride);
  store_rows<D>(dv_s, scales[1], k0, T, dv + kv_off, kv_stride);
}

// Above 48 KB of dynamic shared memory a kernel needs the opt-in, once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) configured = true;
  return err;
}

struct Args {
  const float *q, *k, *v;
  const int* mask;
  const float *dout, *m, *l, *delta;
  int B, T, Hq, Hkv;
  float scale;
  cudaStream_t stream;
};

bool valid(const Args& a) { return a.T > 0 && a.B > 0 && a.Hkv > 0 && a.Hq % a.Hkv == 0; }

template <int D, bool CAUSAL, bool STATS>
int launch_fwd(const Args& a, float* out, float* m, float* l) {
  static bool configured = false;
  const size_t smem = F32Smem<D>::FWD;
  const cudaError_t err = allow_smem(attention_fwd_f32_kernel<D, CAUSAL, STATS>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.T + ROWS - 1) / ROWS, a.Hq, a.B);
  attention_fwd_f32_kernel<D, CAUSAL, STATS><<<grid, 32, smem, a.stream>>>(
      a.q, a.k, a.v, a.mask, out, m, l, a.T, a.Hq, a.Hkv, a.scale * ta::LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const Args& a, float* dq) {
  static bool configured = false;
  const size_t smem = F32Smem<D>::DQ;
  const cudaError_t err = allow_smem(attention_bwd_dq_f32_kernel<D>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.T + ROWS - 1) / ROWS, a.Hq, a.B);
  attention_bwd_dq_f32_kernel<D><<<grid, 32, smem, a.stream>>>(
      a.q, a.k, a.v, a.mask, a.dout, a.m, a.l, a.delta, dq, a.T, a.Hq, a.Hkv,
      a.scale * ta::LOG2E, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a, float* dk, float* dv) {
  static bool configured = false;
  const size_t smem = F32Smem<D>::DKV;
  const cudaError_t err = allow_smem(attention_bwd_dkv_f32_kernel<D>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.T + ROWS - 1) / ROWS, a.Hkv, a.B);
  attention_bwd_dkv_f32_kernel<D><<<grid, 32, smem, a.stream>>>(
      a.q, a.k, a.v, a.mask, a.dout, a.m, a.l, a.delta, dk, dv, a.T, a.Hq, a.Hkv,
      a.scale * ta::LOG2E, a.scale);
  return (int)cudaGetLastError();
}

// One of the five entry points at head_dim D: `which` 0 encoder, 1 prefill,
// 2 prefill with statistics, 3 dkv, 4 dq.
template <int D>
int dispatch(int which, const Args& a, float* o0, float* o1, float* o2) {
  switch (which) {
    case 0: return launch_fwd<D, false, false>(a, o0, nullptr, nullptr);
    case 1: return launch_fwd<D, true, false>(a, o0, nullptr, nullptr);
    case 2: return launch_fwd<D, true, true>(a, o0, o1, o2);
    case 3: return launch_dkv<D>(a, o0, o1);
    default: return launch_dq<D>(a, o0);
  }
}

int run(int which, const Args& a, int D, void* o0, void* o1, void* o2) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  float* p0 = static_cast<float*>(o0);
  float* p1 = static_cast<float*>(o1);
  float* p2 = static_cast<float*>(o2);
  switch (D) {
    case 16: return dispatch<16>(which, a, p0, p1, p2);
    case 32: return dispatch<32>(which, a, p0, p1, p2);
    case 64: return dispatch<64>(which, a, p0, p1, p2);
    case 128: return dispatch<128>(which, a, p0, p1, p2);
    case 256: return dispatch<256>(which, a, p0, p1, p2);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args args(const void* q, const void* k, const void* v, const void* mask, const void* dout,
          const void* m, const void* l, const void* delta, int B, int T, int Hq, int Hkv,
          float scale, void* stream) {
  return Args{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<const int*>(mask),
              static_cast<const float*>(dout), static_cast<const float*>(m),
              static_cast<const float*>(l), static_cast<const float*>(delta),
              B, T, Hq, Hkv, scale, (cudaStream_t)stream};
}

}  // namespace

extern "C" {

// The signatures of the bf16 entry points (attention.cu, attention_bwd.cu)
// with fp32 q, k, v, dout and outputs; D in {16, 32, 64, 128, 256} (the
// encoder's D as well).  Every tensor contiguous.  Each returns the CUDA
// error code of its launch.
int ta_encoder_attention_f32(const void* q, const void* k, const void* v, const void* mask,
                             void* out, int B, int T, int H, int D, float scale, void* stream) {
  return run(0, args(q, k, v, mask, nullptr, nullptr, nullptr, nullptr, B, T, H, H, scale,
                     stream), D, out, nullptr, nullptr);
}

int ta_prefill_attention_f32(const void* q, const void* k, const void* v, const void* mask,
                             void* out, int B, int T, int Hq, int Hkv, int D, float scale,
                             void* stream) {
  return run(1, args(q, k, v, mask, nullptr, nullptr, nullptr, nullptr, B, T, Hq, Hkv, scale,
                     stream), D, out, nullptr, nullptr);
}

int ta_prefill_attention_fwd_stats_f32(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, void* m, void* l, int B,
                                       int T, int Hq, int Hkv, int D, float scale,
                                       void* stream) {
  return run(2, args(q, k, v, mask, nullptr, nullptr, nullptr, nullptr, B, T, Hq, Hkv, scale,
                     stream), D, out, m, l);
}

int ta_prefill_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                     const void* mask, const void* dout, const void* m,
                                     const void* l, const void* delta, void* dk, void* dv, int B,
                                     int T, int Hq, int Hkv, int D, float scale, void* stream) {
  return run(3, args(q, k, v, mask, dout, m, l, delta, B, T, Hq, Hkv, scale, stream), D, dk, dv,
             nullptr);
}

int ta_prefill_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                                    const void* mask, const void* dout, const void* m,
                                    const void* l, const void* delta, void* dq, int B, int T,
                                    int Hq, int Hkv, int D, float scale, void* stream) {
  return run(4, args(q, k, v, mask, dout, m, l, delta, B, T, Hq, Hkv, scale, stream), D, dq,
             nullptr, nullptr);
}

}  // extern "C"
