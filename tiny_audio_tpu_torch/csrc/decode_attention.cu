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
//                               quantize_kv's arithmetic, or stored as is).
//
// Both are one kernel template (decode_kernel below, UPDATE a parameter).
//
// The bound.  A decode step's attention is a matrix-vector product: ~2 fp32
// operations per cache byte, 15 MFLOP at B = 4 (0.2 us at 67 TFLOP/s), far
// below the card's ridge, so it is bound by the bytes it must move
// (chip_smoke.decode_bound): q, fresh K/V and the output once, the prefix's
// K and V rows once, 2 B kv_len Hkv (D elem + 4 if int8), and for the append
// its new row.  At B = 4, Hkv = 8, D = 128, kv_len 468 with an int8 cache that
// is 3.95 MB, 1.19 us at 3.35 TB/s; at B = 48 47 MB, 14.3 us.
//
// Why this design.  By Little's law the card needs ~3.3 MB of loads in
// flight (3.35 TB/s x ~1 us of DRAM latency) to run at its rate, about the
// whole of what one launch reads at B = 4.  One block per (batch row, KV
// head) walking its rows one dependent load at a time (32 blocks at B = 4)
// keeps ~0.26 MB in flight.  So the rows are split:
//   - the grid is (head chunk x KV head, split, batch row), blocks of 8
//     warps, three an SM (80 registers); a split is R cache rows, R and the
//     number of splits chosen by the host from B, S, Hkv and the group only
//     (ops/decode_attention.py::split_plan), never from kv_len, so a launch
//     fits a CUDA graph: R = 56 and 11 splits at B = 4, S = 608 (288 blocks
//     with rows at kv_len 468, one wave); one split at B = 48, where the 384
//     (batch row, KV head) blocks already fill the card and every merge
//     costs more than it gains;
//   - each block copies its rows' K, V (and scales) into shared memory with
//     cp.async, 16 bytes a thread (scales 4 bytes), in tiles of <= 16 KB in
//     a two-stage ring, issued before the math: at B = 4 a whole split is
//     in flight at once, ~4 MB on the card;
//   - a split whose first row is at or past kv_len exits at once; the others
//     count themselves in the merge.  Rows at kv_len and beyond are never
//     read, so NaN or garbage there cannot reach the output.
// At these sizes a block's time is a chain of latencies (kv_len, the copies,
// the tile's three phases, the partials' store, fence and counter, the
// merge's loads), not its bytes: each round trip to memory on that chain
// is kept to one (the query rows and fresh row load beside kv_len, the
// merge loads every part it needs at once).
// Hopper's bulk copy (cp.async.bulk with an mbarrier) would have one thread
// issue a row per copy; the scales are 4-byte values strided by Hkv, which it
// cannot copy.  Tensor maps are not used: the cache view changes every layer
// and step, and encoding a map per call costs the eager loop its time.
// Tensor cores buy nothing: a wgmma takes 64 rows and a GQA group offers 2-8
// query rows; the arithmetic runs on the CUDA cores, in fp32.
//
// The arithmetic, a tile of rows at a time, in fp32 on the CUDA cores:
//   - scores q.k * D^-0.5 * k_scale in log2 units, one (row, part of D) a
//     thread for every query head of the block, so each cache element is
//     converted once (int8 through the mantissa of 2^23: I2F converts 16
//     values a clock an SM, so the 45 M int8 values of B = 48 would take
//     ~12 us of it alone);
//     the 16-byte chunks of a row sit XOR-swizzled in shared memory, so the
//     threads of a warp, on consecutive rows, read distinct banks;
//   - the tile's softmax, one query head a warp: an exact running max and
//     sum, the sums so far rescaled once a tile, v_scale folded into the
//     probability;
//   - P.V with each warp its rows and each lane its columns, no shuffles;
//     the warps' sums added in a fixed order at the end;
//   - the fresh row's score from the unquantized fresh K, and p_self *
//     fresh_v added last, as both JAX versions do.
//
// The merge, inside the same launch.  With more than one split holding rows
// (splits_used = max(ceil(kv_len / R), 1)), each writes its (m, l, acc[D])
// per query head, fp32, to `partial` (the wrapper's torch.empty scratch,
// [B, Hq, splits, D] then [B, Hq, splits, 2]), runs __threadfence() and
// adds one to the counter of its (batch row, KV head, head chunk).  The block
// that arrives last reads the partials from L2 (cp.async.cg, __ldcg), merges
// them in split order (a run is bitwise repeatable, whichever block arrives
// last), folds in the fresh row, writes the output and sets its counter back
// to 0.  A single split merges its own warps and writes the output directly.
// Per-row lengths (kv_stride = 1, the continuous engine's slots) change
// none of this: the plan is the host's, every block of batch row b reads
// kv_len[b], so the blocks of one (b, KV head, chunk) agree on splits_used
// and its counter counts to that row's number; rows of other lengths use
// other counters.
// The counters (`counters`, B x Hkv x chunks int32) are owned by the
// wrapper: zero before a launch, zero after it, and never freed (a CUDA graph
// keeps their address); so two launches that share a counter buffer must not
// run at once (one stream per device).
//
// The append (ta_decode_attention_update): one warp of a block of its own
// per (batch row, KV head), beside the splits' blocks and off their path (in
// them, its IEEE divisions' slow-path calls cost the 80 registers a spill),
// quantizes the head's fresh K and V rows, scale = max(amax / 127, 1e-8),
// q = clamp(rint(x / scale), -127, 127), with IEEE divisions (no fast math,
// no reciprocal multiply), so the stored bytes and scales equal
// ops/decode_attention.py::quantize_kv's bit for bit.  No block reads row kv_len, so the write cannot race with a read;
// a row outside the cache is not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using ta::sm90::cp_async_16;
using ta::sm90::cp_async_4;
using ta::sm90::cp_async_commit;
using ta::sm90::cp_async_wait;

constexpr int NUM_WARPS = 8;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int MAX_HEADS = 4;     // query heads one block holds
constexpr int MAX_SPLITS = 16;   // splits of the cache rows (split_plan keeps to 12)
constexpr int STAGES = 2;        // tiles of the ring in shared memory
constexpr int TILE_BYTES = 16384;  // K + V rows of one tile, at most

// Rows of one tile: as many as fit TILE_BYTES, 8 to 64.
template <typename T, int D>
__host__ __device__ constexpr int tile_rows() {
  return TILE_BYTES / (2 * D * (int)sizeof(T)) > 64  ? 64
         : TILE_BYTES / (2 * D * (int)sizeof(T)) < 8 ? 8
                                                     : TILE_BYTES / (2 * D * (int)sizeof(T));
}

struct Args {
  const void* q;                 // [B, Hq, D] bf16 or fp32 (Q)
  void* cache_k;                 // [B, S, Hkv, D] int8 or Q
  void* cache_v;
  float* k_scale;                // [B, S, Hkv] fp32, null for a cache of Q
  float* v_scale;
  const void* fresh_k;           // [B, Hkv, D] Q
  const void* fresh_v;
  const int* kv_len;             // device int32: valid prefix, row of the append
  int kv_stride;                 // 0: one length for every batch row; 1: [B], one a row
  void* out;                     // [B, Hq, D] Q
  float* partial;                // [B, Hq, splits, D + 2] fp32 scratch (splits > 1)
  int* counters;                 // [B, Hkv, chunks] int32, zero between launches
  int S;
  int Hkv;
  int group;                     // Hq / Hkv
  int heads;                     // query heads per block: group, or 4 of a group of 8
  int rows;                      // cache rows per split (R)
  int splits;                    // ceil(S / R)
  float scale_log2;              // D^-0.5 * log2(e)
};

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

template <typename Q> __device__ __forceinline__ Q from_float(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }

// Where chunk c of row r of a tile sits: the 16-byte chunks of a row are
// XOR-permuted so that 8 consecutive rows' chunk c fall in 8 distinct
// 16-byte bank groups (a warp's 16-byte loads are served 8 lanes at a time).
template <int CPR>
__device__ __forceinline__ int swizzle(int r, int c) {
  return CPR >= 8 ? c ^ (r & 7) : c ^ ((r / (8 / CPR)) & (CPR - 1));
}

template <int BYTES> struct Raw;
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// 4 int8 in a 32-bit word as 4 floats, exactly and without I2F (16 a clock
// an SM, an eighth of the FMA rate): each byte, biased to unsigned, is
// placed in the mantissa of 2^23 and the bias is subtracted.
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* x) {
  const uint32_t u = w ^ 0x80808080u;
  x[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  x[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  x[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  x[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// N elements at p in shared memory (4, 8 or 16 bytes, aligned), as floats.
template <typename T, int N>
__device__ __forceinline__ void load_elems(const T* p, float* x) {
  using R = typename Raw<N * (int)sizeof(T)>::type;
  const R raw = *reinterpret_cast<const R*>(p);
  if constexpr (std::is_same<T, int8_t>::value) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) int8x4_to_float(w[i], x + 4 * i);
  } else {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_float(e[i]);
  }
}

// One 16-byte chunk, as floats.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, float (&x)[16 / sizeof(T)]) {
  load_elems<T, 16 / (int)sizeof(T)>(p, x);
}

// Columns col0 .. col0 + N - 1 of tile row r (its base at row), in pieces
// of at most one chunk.
template <typename T, int CPR, int N>
__device__ __forceinline__ void load_cols(const T* row, int r, int col0, float (&x)[N]) {
  constexpr int CHUNK = 16 / (int)sizeof(T);
  constexpr int PIECE = N < CHUNK ? N : CHUNK;
#pragma unroll
  for (int p = 0; p < N / PIECE; ++p) {
    const int col = col0 + p * PIECE;
    load_elems<T, PIECE>(row + swizzle<CPR>(r, col / CHUNK) * CHUNK + col % CHUNK, x + p * PIECE);
  }
}

// exp2(m_part - m_total) as a merge weight; a part that saw no row has weight 0.
__device__ __forceinline__ float merge_weight(float m_part, float m_total) {
  return m_part == -INFINITY ? 0.f : exp2f(m_part - m_total);
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

// Block (head chunk x KV head, split, batch row): query heads h0 .. h0 +
// a.heads - 1 of KV head kvh (counted within the group) over cache rows
// [split R, min((split + 1) R, kv_len)) of batch row b; the last block of its
// (b, kvh, chunk) to finish merges the splits and writes the output.
template <typename Q, typename T, int D, bool UPDATE>
__global__ void __launch_bounds__(NUM_THREADS, 3) decode_kernel(Args a) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int TR = tile_rows<T, D>();
  constexpr int CHUNK = 16 / (int)sizeof(T);  // elements of one 16-byte copy
  constexpr int CPR = D / CHUNK;              // 16-byte chunks a row
  constexpr int EPL = D >= 128 ? D / 32 : 4;  // P.V: columns a lane holds
  constexpr int LPR = D / EPL;                // P.V: lanes a row
  constexpr int RPW = 32 / LPR;               // P.V: rows a warp step
  constexpr int CPL = D >= 32 ? D / 32 : 1;   // fresh-row columns a lane (D < 32: lanes < D)
  constexpr int NH = NUM_THREADS / TR < CPR ? NUM_THREADS / TR : CPR;  // scores: parts of D
  constexpr int CPP = CPR / NH;               // scores: chunks a part
  constexpr int RING_BYTES = STAGES * 2 * TR * D * (int)sizeof(T);
  constexpr int MERGE_BYTES = NUM_WARPS * MAX_HEADS * D * (int)sizeof(float);
  static_assert(D % CHUNK == 0 && 32 % LPR == 0 && TR <= 64, "unsupported head_dim");

  // the ring of tiles (rows swizzled by 16-byte chunk), reused after the
  // loop for the warps' partial sums
  __shared__ __align__(128) unsigned char smem[RING_BYTES > MERGE_BYTES ? RING_BYTES : MERGE_BYTES];
  __shared__ float s_scale[STAGES][2][TR];
  __shared__ __align__(16) float sm_q[MAX_HEADS][D];
  __shared__ float sm_part[NH][MAX_HEADS][TR];  // the scores' parts over D
  __shared__ float sm_p[MAX_HEADS][TR];  // scores, then probabilities x v_scale
  __shared__ float sm_m[MAX_HEADS];      // running max of the block's rows
  __shared__ float sm_l[MAX_HEADS];      // running sum of exp2(s - m)
  __shared__ float sm_corr[MAX_HEADS];   // this tile's rescale of the sums
  __shared__ float sm_self[MAX_HEADS];
  __shared__ __align__(8) float sm_ml[MAX_HEADS][MAX_SPLITS][2];  // the splits' (m, l)
  __shared__ int sm_last;
  T* const ring_k = reinterpret_cast<T*>(smem);       // [STAGES][TR][D]
  T* const ring_v = ring_k + STAGES * TR * D;
  float* const sm_acc = reinterpret_cast<float*>(smem);  // [NUM_WARPS][MAX_HEADS][D]

  constexpr int OUTS = (MAX_HEADS * D + NUM_THREADS - 1) / NUM_THREADS;  // outputs a thread
  const int chunks = a.group / a.heads;
  if (UPDATE && blockIdx.y == a.splits) {  // #4's append: a block of its own, beside the splits
    const int kv = a.kv_len[blockIdx.z * a.kv_stride];
    if (blockIdx.x % chunks == 0 && threadIdx.x < 32 && kv >= 0 && kv < a.S) {
      append_row<Q, T, D>(a, blockIdx.z, blockIdx.x / chunks, kv);
    }
    return;
  }
  const int kvh = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int split = blockIdx.y;
  const int splits = a.splits;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int heads = a.heads;  // uniform across the block
  const int hq = a.Hkv * a.group;
  const int64_t head0 = (int64_t)b * hq + (int64_t)kvh * a.group + chunk * heads;
  const Q* q_rows = static_cast<const Q*>(a.q) + head0 * D;
  const Q* fresh_k = static_cast<const Q*>(a.fresh_k);
  const Q* fresh_v = static_cast<const Q*>(a.fresh_v);
  const int64_t fresh_off = ((int64_t)b * a.Hkv + kvh) * D;

  // kv_len, the block's query rows and the fresh row's score, their loads
  // in flight together
  const int kv_raw = a.kv_len[blockIdx.z * a.kv_stride];
  float q_mine[OUTS];
#pragma unroll
  for (int k = 0; k < OUTS; ++k) {
    const int i = threadIdx.x + k * NUM_THREADS;
    q_mine[k] = i < heads * D ? to_float(q_rows[i]) : 0.f;
  }
  float self_dot = 0.f;
  if (warp < heads) {
#pragma unroll
    for (int e = 0; e < CPL; ++e) {
      const int c = lane * CPL + e;
      if (c < D) self_dot += to_float(q_rows[warp * D + c]) * to_float(fresh_k[fresh_off + c]);
    }
  }
  const int kv_len = min(max(kv_raw, 0), a.S);

  const int used = max((kv_len + a.rows - 1) / a.rows, 1);  // splits that take part
  if (split >= used) return;
  const int row0 = split * a.rows;
  const int nrows = max(min(a.rows, kv_len - row0), 0);  // 0 only for split 0 at kv_len 0
  const int ntiles = (nrows + TR - 1) / TR;

  const int64_t row_stride = (int64_t)a.Hkv * D;  // elements between rows of one head
  const int64_t head_off = (int64_t)b * a.S * row_stride + (int64_t)kvh * D;
  const T* k_head = static_cast<const T*>(a.cache_k) + head_off;
  const T* v_head = static_cast<const T*>(a.cache_v) + head_off;
  const int64_t scale_off = (int64_t)b * a.S * a.Hkv + kvh;

  // Copies tile t of this split's rows into stage st of the ring: chunk c of
  // row r lands at chunk swizzle<CPR>(r, c), so that the threads of a warp
  // reading one chunk of consecutive rows hit distinct banks.
  auto issue = [&](int t, int st) {
    const int r0 = row0 + t * TR;
    const int n = min(TR, row0 + nrows - r0);
    T* dk = ring_k + st * TR * D;
    T* dv = ring_v + st * TR * D;
    for (int i = threadIdx.x; i < n * CPR; i += NUM_THREADS) {
      const int r = i / CPR;
      const int c = i % CPR;
      const int64_t g = (int64_t)(r0 + r) * row_stride + c * CHUNK;
      const int at = r * D + swizzle<CPR>(r, c) * CHUNK;
      cp_async_16(dk + at, k_head + g);
      cp_async_16(dv + at, v_head + g);
    }
    if constexpr (QUANT) {
      for (int i = threadIdx.x; i < n; i += NUM_THREADS) {
        const int64_t g = scale_off + (int64_t)(r0 + i) * a.Hkv;
        cp_async_4(&s_scale[st][0][i], a.k_scale + g);
        cp_async_4(&s_scale[st][1][i], a.v_scale + g);
      }
    }
  };
#pragma unroll
  for (int t = 0; t < STAGES; ++t) {
    if (t < ntiles) issue(t, t);
    cp_async_commit();
  }

  // While the copies fly: q as fp32 in shared memory, the fresh row's score
  // per query head (warp g), the running softmax state.
#pragma unroll
  for (int k = 0; k < OUTS; ++k) {
    const int i = threadIdx.x + k * NUM_THREADS;
    if (i < heads * D) sm_q[i / D][i % D] = q_mine[k];
  }
  if (warp < heads) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) self_dot += __shfl_xor_sync(0xffffffffu, self_dot, off);
    if (lane == 0) {
      sm_self[warp] = self_dot * a.scale_log2;
      sm_m[warp] = -INFINITY;
      sm_l[warp] = 0.f;
    }
  }

  const int sub = lane / LPR;            // P.V: which row of the warp step
  const int col0 = (lane % LPR) * EPL;   // P.V: this lane's columns
  float acc[MAX_HEADS][EPL];
#pragma unroll
  for (int g = 0; g < MAX_HEADS; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const int st = t % STAGES;
    const int n = min(TR, nrows - t * TR);
    const T* tk = ring_k + st * TR * D;
    const T* tv = ring_v + st * TR * D;

    // Scores: one (row, part of D) a thread, every query head of the block,
    // each element converted once; consecutive threads take consecutive rows.
    if (threadIdx.x < NH * TR) {
      const int r = threadIdx.x % TR;
      const int h = threadIdx.x / TR;
      if (r < n) {
        float part[MAX_HEADS] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int cc = 0; cc < CPP; ++cc) {
          const int c = h * CPP + cc;
          float x[CHUNK];
          load_chunk(tk + r * D + swizzle<CPR>(r, c) * CHUNK, x);
#pragma unroll
          for (int g = 0; g < MAX_HEADS; ++g) {
            if (g < heads) {
              const float4* qc = reinterpret_cast<const float4*>(&sm_q[g][c * CHUNK]);
#pragma unroll
              for (int e4 = 0; e4 < CHUNK / 4; ++e4) {
                const float4 qv = qc[e4];
                part[g] = fmaf(qv.x, x[4 * e4], part[g]);
                part[g] = fmaf(qv.y, x[4 * e4 + 1], part[g]);
                part[g] = fmaf(qv.z, x[4 * e4 + 2], part[g]);
                part[g] = fmaf(qv.w, x[4 * e4 + 3], part[g]);
              }
            }
          }
        }
#pragma unroll
        for (int g = 0; g < MAX_HEADS; ++g) {
          if (g < heads) sm_part[h][g][r] = part[g];
        }
      }
    }
    __syncthreads();

    // The tile's softmax, one query head a warp: the scores (parts summed in
    // order, log2 units, k_scale applied), the running max and sum, the
    // rescale of the sums so far, and exp2(s - m) x v_scale per row.
    if (warp < heads) {
      float mt = -INFINITY;
      for (int r = lane; r < n; r += 32) {
        float dot = sm_part[0][warp][r];
#pragma unroll
        for (int h = 1; h < NH; ++h) dot += sm_part[h][warp][r];
        const float s = dot * (QUANT ? a.scale_log2 * s_scale[st][0][r] : a.scale_log2);
        sm_p[warp][r] = s;
        mt = fmaxf(mt, s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = sm_m[warp];
      const float m_new = fmaxf(m_old, mt);
      float lt = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float p = exp2f(sm_p[warp][r] - m_new);
        lt += p;
        sm_p[warp][r] = QUANT ? p * s_scale[st][1][r] : p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
      if (lane == 0) {
        const float corr = exp2f(m_old - m_new);  // 0 while m_old is -inf
        sm_corr[warp] = corr;
        sm_l[warp] = sm_l[warp] * corr + lt;
        sm_m[warp] = m_new;
      }
    }
    __syncthreads();

    // P.V: each warp its rows, each lane its columns, sums rescaled once.
#pragma unroll
    for (int g = 0; g < MAX_HEADS; ++g) {
      if (g < heads) {
        const float corr = sm_corr[g];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
      }
    }
#pragma unroll
    for (int k = 0; k < (TR + NUM_WARPS * RPW - 1) / (NUM_WARPS * RPW); ++k) {
      const int r = (k * NUM_WARPS + warp) * RPW + sub;
      if (r < n) {
        float v[EPL];
        load_cols<T, CPR, EPL>(tv + r * D, r, col0, v);
#pragma unroll
        for (int g = 0; g < MAX_HEADS; ++g) {
          if (g < heads) {
            const float p = sm_p[g][r];
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, v[e], acc[g][e]);
          }
        }
      }
    }
    __syncthreads();
    if (t + STAGES < ntiles) issue(t + STAGES, st);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' sums now

  // Sum the row groups of the warp (lanes lane ^ off hold the same columns),
  // then the warps, in a fixed order.
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < MAX_HEADS; ++g) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    }
  }
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < MAX_HEADS; ++g) {
      if (g < heads) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) sm_acc[(warp * MAX_HEADS + g) * D + col0 + e] = acc[g][e];
      }
    }
  }
  __syncthreads();

  Q* out = static_cast<Q*>(a.out) + head0 * D;
  // This block's sum of exp2(s - m) x v over its rows, query head g, column c.
  auto block_acc = [&](int g, int c) {
    float sum = sm_acc[g * D + c];
#pragma unroll
    for (int w = 1; w < NUM_WARPS; ++w) sum += sm_acc[(w * MAX_HEADS + g) * D + c];
    return sum;
  };
  // The output from the splits' parts merged (their running max m_all taken
  // with the fresh row's score), the fresh row folded in last.
  auto finish = [&](int g, int c, float m_all, float denom, float num) {
    const float p_self = exp2f(sm_self[g] - m_all);
    num += p_self * to_float(fresh_v[fresh_off + c]);
    denom += p_self;
    out[g * D + c] = from_float<Q>(num / denom);
  };

  if (used == 1) {  // one split: no partials, no counter
    for (int o = threadIdx.x; o < heads * D; o += NUM_THREADS) {
      const int g = o / D;
      const int c = o % D;
      const float m_all = fmaxf(sm_self[g], sm_m[g]);
      const float wt = merge_weight(sm_m[g], m_all);
      finish(g, c, m_all, sm_l[g] * wt, block_acc(g, c) * wt);
    }
    return;
  }

  // This split's part to the scratch; the last split of the output merges.
  const int64_t part_acc = head0 * splits * D;  // [B, Hq, splits, D]
  const int64_t part_ml = (int64_t)gridDim.z * hq * splits * D + head0 * splits * 2;
  for (int o = threadIdx.x; o < heads * D; o += NUM_THREADS) {
    const int g = o / D;
    const int c = o % D;
    a.partial[part_acc + ((int64_t)g * splits + split) * D + c] = block_acc(g, c);
    if (c == 0) {
      a.partial[part_ml + ((int64_t)g * splits + split) * 2] = sm_m[g];
      a.partial[part_ml + ((int64_t)g * splits + split) * 2 + 1] = sm_l[g];
    }
  }
  __threadfence();
  __syncthreads();
  int* counter = a.counters + (int64_t)b * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) sm_last = atomicAdd(counter, 1) == used - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  // The splits' parts, copied from L2 (never L1, which other blocks' writes
  // do not reach) into shared memory: acc with cp.async.cg (every copy of a
  // batch of splits in flight at once: each round trip to L2 is on the
  // launch's path, and no register holds them), m and l with __ldcg; then
  // merged in split order: bitwise repeatable.
  float* const sm_parts = reinterpret_cast<float*>(smem);  // [heads][nb][D]
  const int batch = min(used, (int)(sizeof(smem) / sizeof(float)) / (heads * D));
  float m_all[OUTS], num[OUTS], denom[OUTS];
  for (int sp0 = 0; sp0 < used; sp0 += batch) {
    const int nb = min(batch, used - sp0);
    const int per_head = nb * D / 4;  // 16-byte copies of one head's parts
    for (int i = threadIdx.x; i < heads * per_head; i += NUM_THREADS) {
      const int g = i / per_head;
      const int k = i % per_head;
      cp_async_16(sm_parts + g * nb * D + 4 * k,
                  a.partial + part_acc + ((int64_t)g * splits + sp0) * D + 4 * k);
    }
    if (sp0 == 0) {
      for (int i = threadIdx.x; i < heads * used; i += NUM_THREADS) {
        const float2 ml = __ldcg(reinterpret_cast<const float2*>(
            a.partial + part_ml + ((int64_t)(i / used) * splits + i % used) * 2));
        sm_ml[i / used][i % used][0] = ml.x;
        sm_ml[i / used][i % used][1] = ml.y;
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < OUTS; ++k) {
      const int o = threadIdx.x + k * NUM_THREADS;
      if (o < heads * D) {
        const int g = o / D;
        const int c = o % D;
        if (sp0 == 0) {
          m_all[k] = sm_self[g];
          for (int sp = 0; sp < used; ++sp) m_all[k] = fmaxf(m_all[k], sm_ml[g][sp][0]);
          num[k] = 0.f;
          denom[k] = 0.f;
        }
        for (int j = 0; j < nb; ++j) {
          const float wt = merge_weight(sm_ml[g][sp0 + j][0], m_all[k]);
          denom[k] += sm_ml[g][sp0 + j][1] * wt;
          num[k] += sm_parts[(g * nb + j) * D + c] * wt;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < OUTS; ++k) {
    const int o = threadIdx.x + k * NUM_THREADS;
    if (o < heads * D) finish(o / D, o % D, m_all[k], denom[k], num[k]);
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
}

template <typename Q, typename T, int D>
void launch_typed(bool update, const Args& a, dim3 grid, cudaStream_t s) {
  if (update) decode_kernel<Q, T, D, true><<<grid, NUM_THREADS, 0, s>>>(a);
  else decode_kernel<Q, T, D, false><<<grid, NUM_THREADS, 0, s>>>(a);
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
           void* out, void* partial, void* counters, int B, int S, int Hq, int Hkv,
           int head_dim, int rows, int quantized, int fp32, float scale, int kv_stride,
           void* stream) {
  const int splits = rows > 0 ? (S + rows - 1) / rows : 0;
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || !supported_group(Hq / Hkv) ||
      (head_dim != 16 && head_dim != 32 && head_dim != 64 && head_dim != 128 &&
       head_dim != 256) ||
      (quantized && (k_scale == nullptr || v_scale == nullptr)) || rows <= 0 ||
      splits > MAX_SPLITS || counters == nullptr || (splits > 1 && partial == nullptr) ||
      (kv_stride != 0 && kv_stride != 1)) {
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
  a.kv_stride = kv_stride;
  a.out = out;
  a.partial = static_cast<float*>(partial);
  a.counters = static_cast<int*>(counters);
  a.S = S;
  a.Hkv = Hkv;
  a.group = Hq / Hkv;
  a.heads = a.group <= MAX_HEADS ? a.group : MAX_HEADS;
  a.rows = rows;
  a.splits = splits;
  a.scale_log2 = scale * 1.4426950408889634f;
  // #4 takes one more block per (head chunk, KV head, batch row): the append's
  const dim3 grid(Hkv * (a.group / a.heads), splits + (update ? 1 : 0), B);
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
// kv_len: device int32, one for every row (kv_stride = 0) or [B], one a row
// (kv_stride = 1; any value is safe: a block clamps it into [0, S], and the
// append writes no row outside [0, S)); partial: fp32 scratch of B Hq splits (D + 2)
// values, splits = ceil(S / rows) <= 16 (null when splits = 1); counters:
// B Hkv chunks int32, zero (chunks = 2 for a group of 8, else 1).  D in
// {16, 32, 64, 128, 256}, Hq / Hkv in {1, 2, 3, 4, 8}; every tensor
// contiguous and 16-byte aligned.  Returns the launch's CUDA error code.
int ta_decode_attention(const void* q, const void* cache_k, const void* cache_v,
                        const void* k_scale, const void* v_scale, const void* fresh_k,
                        const void* fresh_v, const void* kv_len, void* out, void* partial,
                        void* counters, int B, int S, int Hq, int Hkv, int D_, int rows,
                        int quantized, int fp32, float scale, int kv_stride, void* stream) {
  return launch(false, q, const_cast<void*>(cache_k), const_cast<void*>(cache_v),
                const_cast<void*>(k_scale), const_cast<void*>(v_scale), fresh_k, fresh_v,
                kv_len, out, partial, counters, B, S, Hq, Hkv, D_, rows, quantized, fp32,
                scale, kv_stride, stream);
}

// As ta_decode_attention, and writes row kv_len (of each batch row) of cache_k/v (and, quantized,
// of k/v_scale) in place; the attention reads rows [0, kv_len).
int ta_decode_attention_update(const void* q, void* cache_k, void* cache_v, void* k_scale,
                               void* v_scale, const void* fresh_k, const void* fresh_v,
                               const void* kv_len, void* out, void* partial, void* counters,
                               int B, int S, int Hq, int Hkv, int D_, int rows, int quantized,
                               int fp32, float scale, int kv_stride, void* stream) {
  return launch(true, q, cache_k, cache_v, k_scale, v_scale, fresh_k, fresh_v, kv_len, out,
                partial, counters, B, S, Hq, Hkv, D_, rows, quantized, fp32, scale, kv_stride,
                stream);
}

}  // extern "C"
