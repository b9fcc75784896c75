// Backward of the causal GQA prefill attention (attention.cu,
// ta_prefill_attention_fwd_stats) for Hopper (sm_90a): bf16 in and out,
// fp32 accumulation.
//
//   ta_prefill_attention_bwd_dkv  replaces _flash_attention_bwd_dkv of
//                                 jax.experimental.pallas.ops.tpu.flash_attention
//                                 (jax 0.9.0, :941, pallas_call :1121): dK, dV.
//   ta_prefill_attention_bwd_dq   replaces _flash_attention_bwd_dq (:1287,
//                                 pallas_call :1456): dQ.
//
// The JAX package reaches both through jax.value_and_grad of its train step
// (tiny_audio_tpu/train/optim.py:154) around ops/attention.py::_flash_call.
// As there, delta = rowsum(dO * O) is computed outside (one torch
// expression), and P is recomputed from Q, K and the forward's saved row
// statistics m (max, log2 units) and l (sum): P = exp2(s * scale * log2e - m) / l.
// Then, with dP = dO V^T and dS = P * (dP - delta):
//   dV = P^T dO,   dK = scale * dS^T Q,   dQ = scale * dS K.
//
// Masking is the forward's exactly: keys past T and past the query (causal)
// have P = 0; a padding key (mask 0) scores MASK_VALUE, so it has P > 0 only
// in a row whose visible keys are all padding, where it takes a share of dV
// but, its score being a constant, no dS (no dQ or dK).
//
// Which design serves which head_dim:
//   - bf16 at D = 64 and 128 (the flagship's decoder): the Hopper design of
//     attention_bwd_sm90.cu (TMA, wgmma, accumulators in registers);
//   - bf16 at D = 16, 32 and 256: the mma.sync template below;
//   - fp32 at every head_dim: attention_f32.cu.
//
// The mma.sync template (simple and exact first, like the forward's):
//   - dkv: one block per (key tile, KV head, batch row); each warp owns 16
//     keys.  It loops over the query heads of its GQA group and over the
//     query tiles from the diagonal on, recomputing S^T = K Q^T and
//     dP^T = V dO^T on the tensor cores (mma.sync.m16n8k16) and
//     accumulating dV += P^T dO and dK += dS^T Q.  The group's sum (which
//     the JAX package leaves to jnp.repeat's transpose) happens in the
//     block, so dK and dV are written once, with no atomics.
//   - dq: one block per (query tile, query head, batch row); each warp owns
//     16 query rows and loops over the key tiles up to the diagonal,
//     accumulating dQ += dS K.
//   - Tiles are 64 rows (32 at head_dim 256).  Q, dO, K and V tiles sit in
//     dynamic shared memory in both layouts the fragments need (row-major,
//     and transposed where the tile is the B operand over its rows); the fp32
//     accumulators [tile, D] live in shared memory too, each element owned by
//     the one thread whose mma fragment holds it, so registers stay below
//     ~100 at every head_dim.  P and dS never leave registers: the S^T (S)
//     accumulator fragments are repacked as the A operand of the next
//     product.
//
// What bounds it on the H100.  On the training path's inputs (B = 6, T = 512,
// 16/8 heads of 128; chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W) this
// template took 0.504 ms (dkv) and 0.338 ms (dq) at D = 128, 3.0% and 4.5%
// of their 0.0152 ms byte bound (26 and 29 TFLOP/s), not the tensor cores'
// rate: every tile reads and writes its fp32 accumulators in shared memory,
// one 128-thread block fits an SM, and the loads are synchronous, with the
// transposed copies stored one bf16 at a time (16-way bank conflicts at
// D = 128).  The Hopper design, which removes each of those, runs 9x and 7x
// faster there (attention_bwd_sm90.cu's header).  At D = 16, 32 and 256 this
// template stays; it is not timed at a training shape there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using ta::key_state_of;
using ta::ld32;
using ta::mma_16816;
using ta::p_and_ds;
using ta::pack_bf16;

template <int D>
struct Tile {
  static constexpr int N = D > 128 ? 32 : 64;  // rows per tile (keys or queries)
  static constexpr int WARPS = N / 16;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int RP = D + 8;    // padded row of a [N][D] bf16 tile
  static constexpr int TP = N + 8;    // padded row of a [D][N] bf16 tile
  static constexpr int AP = D + 8;    // padded row of a [N][D] fp32 accumulator
  static constexpr int VEC = 8;       // bf16 values per 16-byte load
  static constexpr int VPR = D / VEC;
  // dkv: K, V, Q, dO row-major; Q^T, dO^T; dK, dV fp32; m, l, delta; key state
  static constexpr size_t DKV_SMEM =
      4 * N * RP * 2 + 2 * D * TP * 2 + 2 * N * AP * 4 + 3 * N * 4 + N * 4;
  // dq: Q, dO, K, V row-major; K^T; dQ fp32; m, l, delta; key state
  static constexpr size_t DQ_SMEM =
      4 * N * RP * 2 + D * TP * 2 + N * AP * 4 + 3 * N * 4 + N * 4;
};

// Rows [r0, r0 + N) of one head of x ([B, T, H, D], time stride `stride`)
// into a row-major [N][RP] tile and, if `xt` is not null, a transposed
// [D][TP] tile; rows past T are zero.
template <int D>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* base, int64_t stride, int r0,
                                          int T, __nv_bfloat16* x, __nv_bfloat16* xt) {
  using L = Tile<D>;
  for (int i = threadIdx.x; i < L::N * L::VPR; i += L::THREADS) {
    const int row = i / L::VPR;
    const int col = (i % L::VPR) * L::VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < T) val = *reinterpret_cast<const uint4*>(base + (r0 + row) * stride + col);
    *reinterpret_cast<uint4*>(&x[row * L::RP + col]) = val;
    if (xt != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < L::VEC; ++j) xt[(col + j) * L::TP + row] = e[j];
    }
  }
}

// A fragment of rows (row, row + 8) of a row-major tile, k step kk.
template <int RP>
__device__ __forceinline__ void a_frag(const __nv_bfloat16* x, int row, int kk, int t4,
                                       uint32_t (&a)[4]) {
  const __nv_bfloat16* p0 = &x[row * RP + kk * 16 + 2 * t4];
  const __nv_bfloat16* p1 = p0 + 8 * RP;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// c[n] += A B over D, with A rows (row, row + 8) of the row-major tile `a_s`
// and B^T the row-major tile `b_s` (its rows are the n columns).
template <int D, int NT>
__device__ __forceinline__ void product_over_d(const __nv_bfloat16* a_s,
                                               const __nv_bfloat16* b_s, int row, int g,
                                               int t4, float (&c)[NT][4]) {
  constexpr int RP = Tile<D>::RP;
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    a_frag<RP>(a_s, row, kk, t4, a);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* bp = &b_s[(n * 8 + g) * RP + kk * 16 + 2 * t4];
      mma_16816(c[n], a, ld32(bp), ld32(bp + 8));
    }
  }
}

// The C fragments of neighbouring 8-column tiles as the A fragments of the
// 16-deep steps of the next product (bf16).
template <int NT>
__device__ __forceinline__ void pack_a(const float (&c)[NT][4], uint32_t (&a)[NT / 2][4]) {
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    a[kc][0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
    a[kc][1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
    a[kc][2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
    a[kc][3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
  }
}

// acc[row, row + 8][D] += A (16 x N, as packed fragments) times the
// [N x D] operand whose transpose is the [D][TP] tile `bt_s`.
template <int D>
__device__ __forceinline__ void accumulate(float* acc, int row, int g, int t4,
                                           const uint32_t (&a)[Tile<D>::N / 16][4],
                                           const __nv_bfloat16* bt_s) {
  using L = Tile<D>;
  for (int j = 0; j < D / 8; ++j) {
    float* c0 = &acc[row * L::AP + j * 8 + 2 * t4];
    float* c1 = c0 + 8 * L::AP;
    float2 lo = *reinterpret_cast<float2*>(c0);
    float2 hi = *reinterpret_cast<float2*>(c1);
    float c[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
    for (int kc = 0; kc < L::N / 16; ++kc) {
      const __nv_bfloat16* bp = &bt_s[(j * 8 + g) * L::TP + kc * 16 + 2 * t4];
      mma_16816(c, a[kc], ld32(bp), ld32(bp + 8));
    }
    *reinterpret_cast<float2*>(c0) = make_float2(c[0], c[1]);
    *reinterpret_cast<float2*>(c1) = make_float2(c[2], c[3]);
  }
}

// Rows (row, row + 8) of acc, times `scale`, to out rows r0 + row (< T).
template <int D>
__device__ __forceinline__ void store_rows(const float* acc, int row, int t4, int r0, int T,
                                           __nv_bfloat16* base, int64_t stride, float scale) {
  using L = Tile<D>;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r0 + r >= T) continue;
    for (int j = 0; j < D / 8; ++j) {
      const float2 x = *reinterpret_cast<const float2*>(&acc[r * L::AP + j * 8 + 2 * t4]);
      *reinterpret_cast<uint32_t*>(base + (r0 + r) * stride + j * 8 + 2 * t4) =
          pack_bf16(x.x * scale, x.y * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS)
attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ m_stat,
                         const float* __restrict__ l_stat,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv,
                         int T, int Hq, int Hkv, float scale_log2, float scale) {
  using L = Tile<D>;
  constexpr int N = L::N;
  constexpr int NT = N / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + N * L::RP;
  __nv_bfloat16* q_s = v_s + N * L::RP;
  __nv_bfloat16* do_s = q_s + N * L::RP;
  __nv_bfloat16* qt_s = do_s + N * L::RP;
  __nv_bfloat16* dot_s = qt_s + D * L::TP;
  float* dk_acc = reinterpret_cast<float*>(dot_s + D * L::TP);
  float* dv_acc = dk_acc + N * L::AP;
  float* m_s = dv_acc + N * L::AP;
  float* l_s = m_s + N;
  float* d_s = l_s + N;
  int* key_state = reinterpret_cast<int*>(d_s + N);

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * N;
  const int group = Hq / Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row = warp * 16 + g;  // this thread's key rows: row, row + 8

  const int64_t q_stride = (int64_t)Hq * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t kv_off = (int64_t)b * T * kv_stride + (int64_t)kvh * D;
  const int* mask_row = mask ? mask + (int64_t)b * T : nullptr;

  load_tile<D>(k + kv_off, kv_stride, k0, T, k_s, nullptr);
  load_tile<D>(v + kv_off, kv_stride, k0, T, v_s, nullptr);
  if (threadIdx.x < N) key_state[threadIdx.x] = key_state_of(mask_row, k0 + threadIdx.x, T);
  for (int i = threadIdx.x; i < N * L::AP; i += L::THREADS) dk_acc[i] = dv_acc[i] = 0.f;

  const int q_tiles = (T + N - 1) / N;
  for (int hg = 0; hg < group; ++hg) {
    const int h = kvh * group + hg;
    const int64_t q_off = (int64_t)b * T * q_stride + (int64_t)h * D;
    const int64_t stat_off = ((int64_t)b * Hq + h) * T;
    for (int qt = blockIdx.x; qt < q_tiles; ++qt) {  // the diagonal on: queries >= k0
      const int q0 = qt * N;
      __syncthreads();  // every warp is done with the previous tiles
      load_tile<D>(q + q_off, q_stride, q0, T, q_s, qt_s);
      load_tile<D>(dout + q_off, q_stride, q0, T, do_s, dot_s);
      if (threadIdx.x < N) {
        const int r = q0 + threadIdx.x;
        m_s[threadIdx.x] = r < T ? m_stat[stat_off + r] : 0.f;
        l_s[threadIdx.x] = r < T ? l_stat[stat_off + r] : 1.f;
        d_s[threadIdx.x] = r < T ? delta[stat_off + r] : 0.f;
      }
      __syncthreads();

      float s[NT][4], dp[NT][4];
      product_over_d<D, NT>(k_s, q_s, row, g, t4, s);    // S^T = K Q^T
      product_over_d<D, NT>(v_s, do_s, row, g, t4, dp);  // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = e < 2 ? row : row + 8;
          const int ql = n * 8 + 2 * t4 + (e & 1);
          const bool visible = q0 + ql < T && k0 + kl <= q0 + ql;
          p_and_ds(s[n][e], dp[n][e], key_state[kl], visible, scale_log2, m_s[ql], l_s[ql],
                   d_s[ql], s[n][e], dp[n][e]);
        }
      }
      uint32_t pa[NT / 2][4], dsa[NT / 2][4];
      pack_a<NT>(s, pa);
      pack_a<NT>(dp, dsa);
      accumulate<D>(dv_acc, row, g, t4, pa, dot_s);   // dV += P^T dO
      accumulate<D>(dk_acc, row, g, t4, dsa, qt_s);   // dK += dS^T Q
    }
  }
  // each thread reads back only the accumulator elements it wrote
  store_rows<D>(dk_acc, row, t4, k0, T, dk + kv_off, kv_stride, scale);
  store_rows<D>(dv_acc, row, t4, k0, T, dv + kv_off, kv_stride, 1.f);
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS)
attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ mask,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ m_stat,
                        const float* __restrict__ l_stat,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq,
                        int T, int Hq, int Hkv, float scale_log2, float scale) {
  using L = Tile<D>;
  constexpr int N = L::N;
  constexpr int NT = N / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* do_s = q_s + N * L::RP;
  __nv_bfloat16* k_s = do_s + N * L::RP;
  __nv_bfloat16* v_s = k_s + N * L::RP;
  __nv_bfloat16* kt_s = v_s + N * L::RP;
  float* dq_acc = reinterpret_cast<float*>(kt_s + D * L::TP);
  float* m_s = dq_acc + N * L::AP;
  float* l_s = m_s + N;
  float* d_s = l_s + N;
  int* key_state = reinterpret_cast<int*>(d_s + N);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kvh = h / (Hq / Hkv);
  const int q0 = blockIdx.x * N;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row = warp * 16 + g;  // this thread's query rows: row, row + 8

  const int64_t q_stride = (int64_t)Hq * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t q_off = (int64_t)b * T * q_stride + (int64_t)h * D;
  const int64_t kv_off = (int64_t)b * T * kv_stride + (int64_t)kvh * D;
  const int64_t stat_off = ((int64_t)b * Hq + h) * T;
  const int* mask_row = mask ? mask + (int64_t)b * T : nullptr;

  load_tile<D>(q + q_off, q_stride, q0, T, q_s, nullptr);
  load_tile<D>(dout + q_off, q_stride, q0, T, do_s, nullptr);
  if (threadIdx.x < N) {
    const int r = q0 + threadIdx.x;
    m_s[threadIdx.x] = r < T ? m_stat[stat_off + r] : 0.f;
    l_s[threadIdx.x] = r < T ? l_stat[stat_off + r] : 1.f;
    d_s[threadIdx.x] = r < T ? delta[stat_off + r] : 0.f;
  }
  for (int i = threadIdx.x; i < N * L::AP; i += L::THREADS) dq_acc[i] = 0.f;

  const int k_tiles = blockIdx.x + 1;  // causal: keys up to the tile's last query
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * N;
    __syncthreads();
    load_tile<D>(k + kv_off, kv_stride, k0, T, k_s, kt_s);
    load_tile<D>(v + kv_off, kv_stride, k0, T, v_s, nullptr);
    if (threadIdx.x < N) key_state[threadIdx.x] = key_state_of(mask_row, k0 + threadIdx.x, T);
    __syncthreads();

    float s[NT][4], dp[NT][4];
    product_over_d<D, NT>(q_s, k_s, row, g, t4, s);    // S = Q K^T
    product_over_d<D, NT>(do_s, v_s, row, g, t4, dp);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = e < 2 ? row : row + 8;
        const int kl = n * 8 + 2 * t4 + (e & 1);
        const bool visible = q0 + ql < T && k0 + kl <= q0 + ql;
        float p;
        p_and_ds(s[n][e], dp[n][e], key_state[kl], visible, scale_log2, m_s[ql], l_s[ql],
                 d_s[ql], p, dp[n][e]);
      }
    }
    uint32_t dsa[NT / 2][4];
    pack_a<NT>(dp, dsa);
    accumulate<D>(dq_acc, row, g, t4, dsa, kt_s);  // dQ += dS K
  }
  store_rows<D>(dq_acc, row, t4, q0, T, dq + q_off, q_stride, scale);
}

struct BwdArgs {
  const void *q, *k, *v, *mask, *dout, *m, *l, *delta;
  int B, T, Hq, Hkv;
  float scale;
  cudaStream_t stream;
};

template <int D>
int launch_dkv(const BwdArgs& a, void* dk, void* dv) {
  using L = Tile<D>;
  static bool configured = false;  // once per instantiation: above 48 KB needs the opt-in
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::DKV_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((a.T + L::N - 1) / L::N, a.Hkv, a.B);
  attention_bwd_dkv_kernel<D><<<grid, L::THREADS, L::DKV_SMEM, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const int*>(a.mask),
      static_cast<const __nv_bfloat16*>(a.dout), static_cast<const float*>(a.m),
      static_cast<const float*>(a.l), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.T, a.Hq, a.Hkv,
      a.scale * ta::LOG2E, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const BwdArgs& a, void* dq) {
  using L = Tile<D>;
  static bool configured = false;  // once per instantiation: above 48 KB needs the opt-in
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::DQ_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((a.T + L::N - 1) / L::N, a.Hq, a.B);
  attention_bwd_dq_kernel<D><<<grid, L::THREADS, L::DQ_SMEM, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const int*>(a.mask),
      static_cast<const __nv_bfloat16*>(a.dout), static_cast<const float*>(a.m),
      static_cast<const float*>(a.l), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(dq), a.T, a.Hq, a.Hkv, a.scale * ta::LOG2E, a.scale);
  return (int)cudaGetLastError();
}

bool valid(const BwdArgs& a) { return a.T > 0 && a.B > 0 && a.Hkv > 0 && a.Hq % a.Hkv == 0; }

}  // namespace

namespace ta {

// attention_bwd_sm90.cu: the bf16 backward at D = 64 and 128.
int attention_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* mask,
                           const void* dout, const void* m, const void* l, const void* delta,
                           void* dk, void* dv, int B, int T, int Hq, int Hkv, int D, float scale,
                           void* stream);
int attention_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* mask,
                          const void* dout, const void* m, const void* l, const void* delta,
                          void* dq, int B, int T, int Hq, int Hkv, int D, float scale,
                          void* stream);

}  // namespace ta

extern "C" {

// q/dout: [B, T, Hq, D]; k/v: [B, T, Hkv, D] (Hq % Hkv == 0, D = 16, 32, 64,
// 128 or 256), bf16, contiguous, 16-byte aligned; mask: [B, T] int32 or null;
// m/l/delta: [B, Hq, T] fp32 (ta_prefill_attention_fwd_stats' m and l, and
// rowsum(dout * out)); dk/dv: [B, T, Hkv, D] bf16, written whole.
// Returns the CUDA error code of the launch (0 = success).
int ta_prefill_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* mask,
                                 const void* dout, const void* m, const void* l,
                                 const void* delta, void* dk, void* dv, int B, int T, int Hq,
                                 int Hkv, int D, float scale, void* stream) {
  const BwdArgs a{q, k, v, mask, dout, m, l, delta, B, T, Hq, Hkv, scale,
                  (cudaStream_t)stream};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_dkv<16>(a, dk, dv);
    case 32: return launch_dkv<32>(a, dk, dv);
    case 64:
    case 128:
      return ta::attention_bwd_dkv_sm90(q, k, v, mask, dout, m, l, delta, dk, dv, B, T, Hq, Hkv,
                                        D, scale, stream);
    case 256: return launch_dkv<256>(a, dk, dv);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As above; dq: [B, T, Hq, D] bf16, written whole.
int ta_prefill_attention_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                                const void* dout, const void* m, const void* l,
                                const void* delta, void* dq, int B, int T, int Hq, int Hkv,
                                int D, float scale, void* stream) {
  const BwdArgs a{q, k, v, mask, dout, m, l, delta, B, T, Hq, Hkv, scale,
                  (cudaStream_t)stream};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_dq<16>(a, dq);
    case 32: return launch_dq<32>(a, dq);
    case 64:
    case 128:
      return ta::attention_bwd_dq_sm90(q, k, v, mask, dout, m, l, delta, dq, B, T, Hq, Hkv, D,
                                       scale, stream);
    case 256: return launch_dq<256>(a, dq);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
