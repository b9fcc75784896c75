// The fused Whisper log-mel front end for Hopper (sm_90a), fp32 throughout.
//
//   ta_log_mel  replaces tiny_audio_tpu/ops/mel_pallas.py
//               (log_mel_spectrogram_pallas, pallas_call :136, body
//               _mel_kernel :60): per tile of frames, frame assembly, the
//               windowed real DFT of 400 samples to 201 bins, power =
//               re^2 + im^2, the mel filterbank and log10(max(mel, 1e-10));
//               only [B, mels, T] is written.  The reflect padding before it
//               and the per-row max - 8 clamp and affine step after it stay
//               in torch (ops/mel_fused.py), where the JAX function keeps
//               them in XLA.
//
// What bounds the function on the H100: its bytes.  Per frame it reads 640
// bytes of new audio (a hop) and writes 4 * mels; a real FFT of 400 samples
// (~8,600 FLOPs) and the filterbank's ~400 nonzero weights keep it under 20
// FLOP/byte, so the audio read once and the features written once over
// 3.35 TB/s are its bound.  The design keeps the operations that small:
//
//   - one block of 8 warps per (FRAMES = 32-frame tile, batch row).  The
//     tile's audio is one contiguous run of 31 * 160 + 400 samples, copied
//     once into shared memory with 16-byte cp.async (zero past the row):
//     frames overlap there and are never copied twice;
//   - no basis operand: each frame's even and odd samples, windowed, are the
//     real and imaginary parts of one 200-point complex sequence z, and a
//     mixed-radix FFT runs in fp32 registers.  200 = 8 x 25: a thread takes
//     radix-8 butterflies over n1 (n = 25 n1 + n2, 800 of them a block; a
//     thread keeps one n2 and its window and twiddles in registers across
//     its frames), multiplies by W200^(n2 k1) and stores through shared
//     memory (the one exchange); then one thread a (frame, k1) does a
//     25-point DFT over n2 in registers as 5 x 5 (n2 = 5 p + q, k2 = r +
//     5 s), giving Z[k1 + 8 k2];
//   - the real-FFT split X[k] = A[k] + W400^k B[k], A = (Z[k] + conj
//     Z[-k]) / 2, B = (Z[k] - conj Z[-k]) / 2i: Z[-k] lives in the thread of
//     k1' = -k1 mod 8 (the same warp), so it arrives by shuffles; X[200] =
//     Re Z[0] - Im Z[0].  Each thread writes the power of its 25 bins;
//   - every twiddle and the window come from a table computed in float64
//     on the host and rounded to fp32 once (ops/mel_fused.kernel_constants),
//     the butterflies' W8 and W5 and the 25-point DFTs' W25 from fp32
//     literals of the same values (operands, not loads): no sincosf, no TF32
//     (the squaring in the power spectrum amplifies lost digits; the JAX
//     kernel asks for Precision.HIGHEST for that reason);
//   - the filterbank is banded: each mel's first bin, bin count and weights
//     (at most 9 bins a mel at 128 mels, 394 weights in all) are copied into
//     shared memory once the audio is used up, and gathered from the power
//     there; the dense [201, mels] matrix is never read.  A warp takes one
//     mel at a time, a lane one frame, so each mel's row is stored along T
//     by one 128-byte warp store; the ragged end of T is masked.  The log is
//     lg2.approx times log10(2), exact at the 1e-10 floor (log10_clamped).
//
// The work is small but not free: per block the radix-8 pass, the 25-point
// DFTs with the split and the filterbank each take a share of the time
// beside the copies; shared-memory and L1 traffic (loads of tables, the
// exchange, shuffles) is what the table literals and the per-thread n2 of
// the radix-8 pass cut.
//
// Shared memory: the audio run (21,440 bytes), which the filterbank's tables
// replace once the radix-8 pass has read it, and the exchange (32 frames x 200
// complex, 51,200 bytes), which the power [32][201] overwrites once every
// thread holds its 25 values: three blocks an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using ta::sm90::cp_async_16;
using ta::sm90::cp_async_16_zfill;
using ta::sm90::cp_async_commit;
using ta::sm90::cp_async_wait;

constexpr int HOP = 160;
constexpr int NFFT = 400;
constexpr int NFREQ = 201;
constexpr int LEN = NFFT / 2;   // the complex transform's length
constexpr int N1 = 8, N2 = 25;  // LEN = N1 x N2
constexpr int FRAMES = 32;      // frames per block: a warp's lanes
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SEG = (FRAMES - 1) * HOP + NFFT;  // 5360 samples of audio per block
constexpr int P_STRIDE = NFREQ;                 // power row: odd, so a warp's 32 frames hit 32 banks
constexpr int RADIX8_GROUPS = THREADS / N2;      // 10 groups of 25 threads in the radix-8 pass
constexpr int MAX_MELS = 128;
// float2 offsets in the table (ops/mel_fused.py TAB_*)
constexpr int TAB_WINDOW = 0, TAB_STAGE = 200, TAB_POST = 425;
// The butterflies' constants, the table's W8^1 = (H, -H), W5^1 = (C1, -S1)
// and W5^2 = (C2, -S2) as literals (each the fp32 rounding of the exact
// value; tests/test_torch_mel_fused.py holds them to the table), so they
// cost no register
constexpr float H = 0.707106781186547524f;   // cos(pi / 4)
constexpr float C1 = 0.309016994374947424f;  // cos(2 pi / 5)
constexpr float S1 = 0.951056516295153572f;  // sin(2 pi / 5)
constexpr float C2 = -0.809016994374947424f; // cos(4 pi / 5)
constexpr float S2 = 0.587785252292473129f;  // sin(4 pi / 5)
// The 25-point DFTs' inner twiddles W25^e = exp(-2 pi i e / 25), e = q r
// for q, r in 1..4 (at most 16), likewise as literals of the table's values:
// read with indices known after unrolling, they are operands, not loads.
__constant__ float2 W25[17] = {
    {1.0f, -0.0f},
    {0.9685831611286311f, -0.2486898871648548f},
    {0.8763066800438636f, -0.4817536741017153f},
    {0.7289686274214116f, -0.6845471059286886f},
    {0.5358267949789965f, -0.8443279255020151f},
    {0.30901699437494745f, -0.9510565162951535f},
    {0.06279051952931353f, -0.9980267284282716f},
    {-0.1873813145857246f, -0.9822872507286887f},
    {-0.4257792915650727f, -0.9048270524660195f},
    {-0.6374239897486897f, -0.7705132427757893f},
    {-0.8090169943749473f, -0.5877852522924732f},
    {-0.9297764858882513f, -0.36812455268467814f},
    {-0.9921147013144778f, -0.12533323356430454f},
    {-0.9921147013144779f, 0.12533323356430429f},
    {-0.9297764858882515f, 0.3681245526846779f},
    {-0.8090169943749478f, 0.5877852522924727f},
    {-0.6374239897486895f, 0.7705132427757894f}};
constexpr size_t SMEM_BYTES = sizeof(float) * SEG + sizeof(float2) * FRAMES * LEN;

static_assert(THREADS == FRAMES * N1, "one thread a (frame, k1) in the 25-point DFTs");
static_assert(FRAMES * P_STRIDE <= 2 * FRAMES * LEN, "the power fits the exchange");
static_assert(SEG % 4 == 0 && HOP % 4 == 0, "16-byte copies");

struct cplx {
  float r, i;
};
__device__ __forceinline__ cplx operator+(cplx a, cplx b) { return {a.r + b.r, a.i + b.i}; }
__device__ __forceinline__ cplx operator-(cplx a, cplx b) { return {a.r - b.r, a.i - b.i}; }
__device__ __forceinline__ cplx mul(cplx a, cplx b) {
  return {fmaf(a.r, b.r, -a.i * b.i), fmaf(a.r, b.i, a.i * b.r)};
}
__device__ __forceinline__ cplx mul_neg_i(cplx a) { return {a.i, -a.r}; }  // a * (-i)
// log10(max(x, 1e-10)) as torch.clamp and log10 give it: exactly -10 at the
// floor (silence), NaN for NaN, elsewhere lg2.approx (relative error ~2^-22,
// under 3e-6 on the log10 of the features' range) times log10(2): two
// instructions where log10f takes about fifteen.
__device__ __forceinline__ float log10_clamped(float x) {
  if (x <= 1e-10f) return -10.f;
  return __log2f(x) * 0.301029995663981195f;
}
__device__ __forceinline__ cplx load(const float2* p) {
  const float2 v = __ldg(p);
  return {v.x, v.y};
}

// v[k] <- sum_n v[n] W8^(n k), W8 = exp(-2 pi i / 8) = (H, -H)
__device__ __forceinline__ void dft8(cplx (&v)[8]) {
  constexpr float h = H;
  cplx a[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j] = v[j] + v[j + 4];
    b[j] = v[j] - v[j + 4];
  }
  // b[j] *= W8^j
  b[1] = {h * (b[1].r + b[1].i), h * (b[1].i - b[1].r)};
  b[2] = mul_neg_i(b[2]);
  b[3] = {h * (b[3].i - b[3].r), -h * (b[3].r + b[3].i)};
  // a 4-point DFT of each: even outputs from a, odd from b
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const cplx* u = half ? b : a;
    const cplx s0 = u[0] + u[2], s1 = u[0] - u[2], s2 = u[1] + u[3];
    const cplx s3 = mul_neg_i(u[1] - u[3]);
    v[half + 0] = s0 + s2;
    v[half + 4] = s0 - s2;
    v[half + 2] = s1 + s3;
    v[half + 6] = s1 - s3;
  }
}

// u[k] <- sum_n u[n] W5^(n k) for the five values u[o], u[o + d], ... (o, d
// static); W5^1 = (C1, -S1), W5^2 = (C2, -S2)
template <int O, int D>
__device__ __forceinline__ void dft5(cplx (&u)[25]) {
  constexpr float c1 = C1, s1 = S1, c2 = C2, s2 = S2;
  const cplx x0 = u[O], x1 = u[O + D], x2 = u[O + 2 * D], x3 = u[O + 3 * D], x4 = u[O + 4 * D];
  const cplx t1 = x1 + x4, t2 = x2 + x3, t3 = x1 - x4, t4 = x2 - x3;
  const cplx a1 = {fmaf(c1, t1.r, fmaf(c2, t2.r, x0.r)), fmaf(c1, t1.i, fmaf(c2, t2.i, x0.i))};
  const cplx a2 = {fmaf(c2, t1.r, fmaf(c1, t2.r, x0.r)), fmaf(c2, t1.i, fmaf(c1, t2.i, x0.i))};
  const cplx b1 = {fmaf(s1, t3.r, s2 * t4.r), fmaf(s1, t3.i, s2 * t4.i)};
  const cplx b2 = {fmaf(s2, t3.r, -s1 * t4.r), fmaf(s2, t3.i, -s1 * t4.i)};
  u[O] = x0 + t1 + t2;
  u[O + D] = {a1.r + b1.i, a1.i - b1.r};      // a1 - i b1
  u[O + 4 * D] = {a1.r - b1.i, a1.i + b1.r};  // a1 + i b1
  u[O + 2 * D] = {a2.r + b2.i, a2.i - b2.r};
  u[O + 3 * D] = {a2.r - b2.i, a2.i + b2.r};
}

template <int I>
__device__ __forceinline__ void dft5_columns(cplx (&u)[25]) {
  if constexpr (I < 5) {
    dft5<I, 5>(u);  // over p: u[5 p + q] for q = I
    dft5_columns<I + 1>(u);
  }
}
template <int I>
__device__ __forceinline__ void dft5_rows(cplx (&u)[25]) {
  if constexpr (I < 5) {
    dft5<5 * I, 1>(u);  // over q: u[5 r + q] for r = I
    dft5_rows<I + 1>(u);
  }
}

__global__ void __launch_bounds__(THREADS, 3)
log_mel_kernel(const float* __restrict__ audio,   // [B, P], padded
               const float2* __restrict__ table,  // [TAB_LEN]: window, twiddles
               const int2* __restrict__ band,     // [mels]: first bin, count
               const float* __restrict__ weights, // [mels, width]
               float* __restrict__ out,           // [B, mels, T]
               int P, int T, int mels, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* seg = reinterpret_cast<float*>(smem);              // [SEG]
  float2* xch = reinterpret_cast<float2*>(seg + SEG);       // [FRAMES][N1][N2]
  float* power = reinterpret_cast<float*>(xch);             // [FRAMES][P_STRIDE], after
  const int t0 = blockIdx.x * FRAMES;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* row = audio + (int64_t)b * P;
  const int start = t0 * HOP;  // in the row: P < 2^31

  // The tile's audio; past the end of the row (frames past T) zeros.
  for (int i = tid; i < SEG / 4; i += THREADS) {
    const int s = start + 4 * i;  // P is a multiple of 4: a vector is all in or all out
    const bool ok = s < P;
    cp_async_16_zfill(seg + 4 * i, ok ? row + s : row, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Radix-8 over n1 for each (frame, n2), times W200^(n2 k1) -> xch[f][k1][n2].
  // Thread t < 250 keeps n2 = t % 25, so it loads its window pairs and
  // twiddles once, and takes frames t / 25 + 10 j.
  if (tid < RADIX8_GROUPS * N2) {
    const int n2 = tid % N2;
    float2 win[8];
    cplx tw[8];
#pragma unroll
    for (int n1 = 0; n1 < 8; ++n1) win[n1] = __ldg(&table[TAB_WINDOW + N2 * n1 + n2]);
#pragma unroll
    for (int k1 = 1; k1 < 8; ++k1) tw[k1] = load(&table[TAB_STAGE + N2 * k1 + n2]);
    for (int f = tid / N2; f < FRAMES; f += RADIX8_GROUPS) {
      const float2* x = reinterpret_cast<const float2*>(seg + f * HOP) + n2;
      cplx v[8];
#pragma unroll
      for (int n1 = 0; n1 < 8; ++n1) {
        const float2 s = x[N2 * n1];  // samples 2n, 2n + 1
        v[n1] = {s.x * win[n1].x, s.y * win[n1].y};
      }
      dft8(v);
      float2* y = xch + f * LEN + n2;
      y[0] = make_float2(v[0].r, v[0].i);
#pragma unroll
      for (int k1 = 1; k1 < 8; ++k1) {
        const cplx t = mul(v[k1], tw[k1]);
        y[N2 * k1] = make_float2(t.r, t.i);
      }
    }
  }
  __syncthreads();

  // The audio is used up: the filterbank's bands and weights (a few KB, hot
  // in L2) land in its place while the transform runs.
  int2* s_band = reinterpret_cast<int2*>(seg);                  // [mels]
  float* s_weights = reinterpret_cast<float*>(s_band + mels);  // [mels][width]
  for (int i = tid; i < mels / 2; i += THREADS) cp_async_16(s_band + 2 * i, band + 2 * i);
  for (int i = tid; i < mels * width / 4; i += THREADS) {
    cp_async_16(s_weights + 4 * i, weights + 4 * i);
  }
  cp_async_commit();

  // 25-point DFT over n2 for (frame f, k1): u[5 p + q] = xch[f][k1][5 p + q].
  const int f = tid / N1, k1 = tid % N1;
  cplx u[25];
#pragma unroll
  for (int n = 0; n < 25; ++n) {
    const float2 v = xch[f * LEN + N2 * k1 + n];
    u[n] = {v.x, v.y};
  }
  __syncthreads();  // the exchange is read: the power may overwrite it
  dft5_columns<0>(u);  // u[5 r + q] = sum_p ... W5^(p r)
#pragma unroll
  for (int r = 1; r < 5; ++r) {
#pragma unroll
    for (int q = 1; q < 5; ++q) u[5 * r + q] = mul(u[5 * r + q], {W25[q * r].x, W25[q * r].y});
  }
  dft5_rows<0>(u);  // u[5 r + s] = Z[k1 + 8 (r + 5 s)]

  // The real-FFT split, bin k = k1 + 8 k2 (k2 = r + 5 s): Z[-k] is Z[k1' +
  // 8 (24 - k2)] of lane k1' = -k1 mod 8 for k1 != 0, this thread's Z[8 (25 -
  // k2) mod 200] for k1 = 0.  k2 runs 0, 24, 1, 23, ..., 12: the value a lane
  // sends for k2 is its own Z at 24 - k2, so each pair dies together and the
  // 25 values need fewer registers as the loop goes.
  const int partner = lane - k1 + ((N1 - k1) & (N1 - 1));
  float* prow = power + f * P_STRIDE + k1;
  const float2* post = table + TAB_POST + k1;
#pragma unroll
  for (int i = 0; i < 25; ++i) {
    const int k2 = i & 1 ? 24 - i / 2 : i / 2;
    const int j = (k2 % 5) * 5 + k2 / 5;               // u index of k2
    const int jm = ((24 - k2) % 5) * 5 + (24 - k2) / 5;  // of 24 - k2
    const int k2z = (25 - k2) % 25;
    const int jz = (k2z % 5) * 5 + k2z / 5;             // of 25 - k2 (mod 25)
    const float qr = __shfl_sync(0xffffffffu, u[jm].r, partner);
    const float qi = __shfl_sync(0xffffffffu, u[jm].i, partner);
    const cplx p = u[j];
    const cplx q = k1 == 0 ? u[jz] : cplx{qr, qi};
    // 2 A[k] and 2 B[k]; the power of 2 X[k] scaled by 1/4 (exact)
    const cplx a = {p.r + q.r, p.i - q.i};
    const cplx bb = {p.i + q.i, q.r - p.r};
    const cplx w = load(&post[N1 * k2]);
    const float xr = fmaf(bb.r, w.r, fmaf(-bb.i, w.i, a.r));
    const float xi = fmaf(bb.r, w.i, fmaf(bb.i, w.r, a.i));
    prow[N1 * k2] = 0.25f * fmaf(xr, xr, xi * xi);
  }
  if (k1 == 0) {
    const float x200 = u[0].r - u[0].i;
    prow[LEN] = x200 * x200;  // k1 = 0
  }
  cp_async_wait<0>();
  __syncthreads();

  // mel = the band's power x weights: one mel a warp at a time, one frame a
  // lane; the band's first bin, count and weights are warp-uniform reads.
  const bool store = t0 + lane < T;
  const float* pf = power + lane * P_STRIDE;
  float* dst = out + ((int64_t)b * mels + warp) * T + t0 + lane;
  for (int m = warp; m < mels; m += WARPS, dst += (int64_t)WARPS * T) {
    const int2 bd = s_band[m];
    const float* wm = s_weights + m * width;
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < bd.y; ++j) acc = fmaf(pf[bd.x + j], wm[j], acc);
    if (store) *dst = log10_clamped(acc);
  }
}

}  // namespace

extern "C" {

// audio: [B, P] fp32, padded (P >= (T + 2) * 160, P a multiple of 4, 16-byte
// aligned); table [628] float2, band [mels] int2 and weights [mels, width]
// fp32, zero past each band's count (ops/mel_fused.py's kernel_constants),
// band and weights 16-byte aligned; out [B, mels, T] fp32 log10 power.  mels
// a multiple of 8 up to 128, width a multiple of 4 with the band table and
// weights within the audio run's shared memory.  Returns the launch's CUDA
// error code.
int ta_log_mel(const void* audio, const void* table, const void* band, const void* weights,
               void* out, int B, int P, int T, int mels, int width, void* stream) {
  if (B <= 0 || T <= 0 || P % 4 != 0 || (int64_t)P < (int64_t)(T + 2) * HOP || mels <= 0 ||
      mels % WARPS != 0 || mels > MAX_MELS || B > 65535 || width <= 0 || width % 4 != 0 ||
      (int64_t)mels * (8 + 4 * width) > (int64_t)sizeof(float) * SEG) {
    return (int)cudaErrorInvalidValue;
  }
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const dim3 grid((T + FRAMES - 1) / FRAMES, B);
  log_mel_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const float*>(audio), static_cast<const float2*>(table),
      static_cast<const int2*>(band), static_cast<const float*>(weights),
      static_cast<float*>(out), P, T, mels, width);
  return (int)cudaGetLastError();
}

}  // extern "C"
