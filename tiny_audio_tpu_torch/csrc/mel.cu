// The fused Whisper log-mel front end for Hopper (sm_90a), fp32 throughout.
//
//   ta_log_mel  replaces tiny_audio_tpu/ops/mel_pallas.py
//               (log_mel_spectrogram_pallas, pallas_call :136, body
//               _mel_kernel :60): per tile of frames, frame assembly, the
//               windowed-DFT product, power = re^2 + im^2, the mel filterbank
//               product and log10(max(mel, 1e-10)); only [B, mels, T] is
//               written.  The reflect padding before it and the per-row
//               max - 8 clamp and affine step after it stay in torch
//               (ops/mel_fused.py), where the JAX function keeps them in XLA.
//
// What bounds the function on the H100: its bytes.  Per frame it reads 640
// bytes of new audio (a hop) and writes 4 * mels; an FFT of 400 samples
// (~8,600 FLOPs) and the filterbank's ~400 nonzero weights keep it under 20
// FLOP/byte.  This kernel does not reach that bound by design: it computes
// the DFT as a dense product, 2 * 400 * 402 FLOPs a frame (~500 FLOP/byte),
// so its own operations bound it; an FFT is later work.  They
// run in fp32 on the CUDA cores (67 TFLOP/s), not in TF32 on the tensor
// cores: TF32 keeps ~3 decimal digits, and the squaring in the power
// spectrum amplifies what the DFT loses (the JAX kernel asks for
// Precision.HIGHEST for the same reason).  Splitting each operand in three
// for the tensor cores (3xTF32) is a later design.
//
// Design (simple and exact first):
//   - one block of 8 warps per (32-frame tile, batch row).  The tile's
//     audio is one contiguous run of 31 * 160 + 400 samples in shared
//     memory: frame f is the window at f * 160, so overlapping frames are
//     never copied (the TPU kernel concatenates three hop chunks instead);
//   - the window is zero on samples 400-479, so the DFT's depth is 400, not
//     the TPU tile's zero-padded 512;
//   - the basis [400, 512] (772 KB: bins padded from 201 to 256, each bin's
//     cos and sin in neighbouring columns) does not fit on an SM: it streams
//     from L2 in [16 samples x 128 columns] tiles through shared memory, the
//     next tile held in registers while the current one is used;
//   - a thread accumulates 4 frames x 4 columns (2 bins, cos and sin) with
//     fp32 FMAs in sample order; a warp shares its 4 frames, so their audio
//     reads are broadcasts and the basis reads are 16 contiguous bytes a lane;
//   - the power of the block's 32 x 256 bins stays in shared memory; the
//     filterbank [201, mels] is read from L1/L2 (each warp a uniform run of
//     mels / 8 columns), one frame a lane, so the output row of each mel is
//     stored coalesced along T; the ragged end of T is masked.
// The padded bins 201-255 cost 27% of the DFT's FMAs (4 column tiles where
// 3.14 are needed); a narrower last tile is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HOP = 160;
constexpr int NFFT = 400;
constexpr int NFREQ = 201;
constexpr int BINS_PAD = 256;
constexpr int COLS = 2 * BINS_PAD;         // basis columns: (cos, sin) per bin
constexpr int TF = 32;                     // frames per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int FRAMES_PER_WARP = TF / WARPS;  // 4
constexpr int CT = 128;                    // basis columns per tile (64 bins)
constexpr int NC = 16;                     // samples per basis tile
constexpr int SEG = (TF - 1) * HOP + NFFT; // 5360 samples of audio per block
constexpr int P_STRIDE = BINS_PAD + 1;     // power row: conflict-free column reads
constexpr int MAX_MELS = 128;
constexpr int TILE_VEC = NC * CT / 4 / THREADS;  // float4s of a basis tile a thread moves
constexpr size_t SMEM_BYTES = sizeof(float) * (SEG + TF * P_STRIDE + NC * CT);

static_assert(NFFT % NC == 0 && HOP % 4 == 0 && SEG % 4 == 0, "tile shapes");
static_assert(TILE_VEC * THREADS * 4 == NC * CT, "basis tile split");

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ audio,  // [B, P], padded
               const float* __restrict__ basis,  // [NFFT, COLS]
               const float* __restrict__ fb,     // [NFREQ, mels]
               float* __restrict__ out,          // [B, mels, T]
               int P, int T, int mels) {
  extern __shared__ __align__(16) float smem[];
  float* seg = smem;                    // [SEG]
  float* power = seg + SEG;             // [TF][P_STRIDE]
  float* btile = power + TF * P_STRIDE; // [NC][CT]

  const int t0 = blockIdx.x * TF;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* row = audio + (int64_t)b * P;
  const int64_t start = (int64_t)t0 * HOP;

  // The tile's audio; past the end of the row (frames past T) zeros.
  for (int i = threadIdx.x; i < SEG / 4; i += THREADS) {
    const int64_t s = start + 4 * i;  // P is a multiple of 4: a vector is all in or all out
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < P) v = *reinterpret_cast<const float4*>(row + s);
    reinterpret_cast<float4*>(seg)[i] = v;
  }

  const int f0 = warp * FRAMES_PER_WARP;
  float4 next[TILE_VEC];
  auto fetch = [&](int n0, int ct) {
#pragma unroll
    for (int v = 0; v < TILE_VEC; ++v) {
      const int idx = threadIdx.x + v * THREADS;  // float4 index in the tile
      const int r = idx / (CT / 4), c = (idx % (CT / 4)) * 4;
      next[v] = __ldg(reinterpret_cast<const float4*>(basis + (n0 + r) * COLS + ct * CT + c));
    }
  };

  for (int ct = 0; ct < COLS / CT; ++ct) {
    float acc[FRAMES_PER_WARP][4];
#pragma unroll
    for (int i = 0; i < FRAMES_PER_WARP; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    fetch(0, ct);
    for (int n0 = 0; n0 < NFFT; n0 += NC) {
      __syncthreads();  // the previous tile is used up (and the audio stored)
#pragma unroll
      for (int v = 0; v < TILE_VEC; ++v) {
        reinterpret_cast<float4*>(btile)[threadIdx.x + v * THREADS] = next[v];
      }
      __syncthreads();
      if (n0 + NC < NFFT) fetch(n0 + NC, ct);
#pragma unroll
      for (int nn = 0; nn < NC; nn += 4) {
        float a[FRAMES_PER_WARP][4];
#pragma unroll
        for (int i = 0; i < FRAMES_PER_WARP; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(&seg[(f0 + i) * HOP + n0 + nn]);
          a[i][0] = x.x; a[i][1] = x.y; a[i][2] = x.z; a[i][3] = x.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 w = *reinterpret_cast<const float4*>(&btile[(nn + j) * CT + lane * 4]);
#pragma unroll
          for (int i = 0; i < FRAMES_PER_WARP; ++i) {
            acc[i][0] = fmaf(a[i][j], w.x, acc[i][0]);
            acc[i][1] = fmaf(a[i][j], w.y, acc[i][1]);
            acc[i][2] = fmaf(a[i][j], w.z, acc[i][2]);
            acc[i][3] = fmaf(a[i][j], w.w, acc[i][3]);
          }
        }
      }
    }
    // columns ct * CT + lane * 4 + {0, 1, 2, 3} are bins 2 * lane, 2 * lane + 1 of the tile
    const int bin = ct * (CT / 2) + lane * 2;
#pragma unroll
    for (int i = 0; i < FRAMES_PER_WARP; ++i) {
      float* p = &power[(f0 + i) * P_STRIDE + bin];
      p[0] = __fadd_rn(__fmul_rn(acc[i][0], acc[i][0]), __fmul_rn(acc[i][1], acc[i][1]));
      p[1] = __fadd_rn(__fmul_rn(acc[i][2], acc[i][2]), __fmul_rn(acc[i][3], acc[i][3]));
    }
  }
  __syncthreads();

  // mel = power @ fb: one frame a lane, mels / 8 filters a warp.
  const int per_warp = mels / WARPS;
  const int m0 = warp * per_warp;
  float m[MAX_MELS / WARPS];
#pragma unroll
  for (int j = 0; j < MAX_MELS / WARPS; ++j) m[j] = 0.f;
  const float* prow = &power[lane * P_STRIDE];
  for (int k = 0; k < NFREQ; ++k) {
    const float p = prow[k];
    const float* fr = fb + k * mels + m0;
#pragma unroll
    for (int j = 0; j < MAX_MELS / WARPS; ++j) {
      if (j < per_warp) m[j] = fmaf(p, __ldg(fr + j), m[j]);
    }
  }
  const int t = t0 + lane;
  if (t < T) {
#pragma unroll
    for (int j = 0; j < MAX_MELS / WARPS; ++j) {
      if (j < per_warp) {
        const float v = m[j] < 1e-10f ? 1e-10f : m[j];  // torch.clamp: NaN stays NaN
        out[((int64_t)b * mels + m0 + j) * T + t] = log10f(v);
      }
    }
  }
}

}  // namespace

extern "C" {

// audio: [B, P] fp32, padded (P >= (T + 2) * 160, P a multiple of 4, 16-byte
// aligned); basis [400, 512] and fb [201, mels] fp32 (ops/mel_fused.py's
// kernel_constants); out [B, mels, T] fp32 log10 power.  mels a multiple of 8
// up to 128.  Returns the launch's CUDA error code.
int ta_log_mel(const void* audio, const void* basis, const void* fb, void* out, int B, int P,
               int T, int mels, void* stream) {
  if (B <= 0 || T <= 0 || P % 4 != 0 || (int64_t)P < (int64_t)(T + 2) * HOP || mels <= 0 ||
      mels % WARPS != 0 || mels > MAX_MELS || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const dim3 grid((T + TF - 1) / TF, B);
  log_mel_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const float*>(audio), static_cast<const float*>(basis),
      static_cast<const float*>(fb), static_cast<float*>(out), P, T, mels);
  return (int)cudaGetLastError();
}

}  // extern "C"
