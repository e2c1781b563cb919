// Cosine scores for Hopper (sm_90a): scores[n, j] = emb[n, :] . query[j, :]
// in f32, with padded rows (valid[n] == 0) written as -inf.
//
// Replaces avede_tpu/ops/pallas_kernels.py: cosine_scores_pallas /
// _score_kernel (the pl.pallas_call at :139). Three entries:
// - f32 rows: the scoring product of every warm query ([Nb, 512] table
//   against one or a few text embeddings);
// - bf16 rows and int8 rows x a per-row f32 scale: the library index's
//   bfloat16 and int8 tiers (avede_tpu/services/library_index.py:83-105).
//   The query is rounded to bf16 and the sum taken in f32, as
//   jnp.dot(table_bf16, q.astype(bf16), preferred_element_type=f32) does;
//   an int8 row is cast exactly to float (|v| <= 127) and its sum is
//   multiplied by the row's scale.
//
// f32: one warp per table row: lanes read the row in coalesced 128-byte
// steps, multiply by each query (a few KB, cached in L1) and reduce
// with shuffles; lane 0 writes the score, or -inf for a padded row,
// which is what window_topk applies next.
//
// Bound on the H100: two FLOP per table element, so every entry is bound
// by bytes. At the largest FRAME_BUCKETS table (1024 x 512 f32, 2 MB)
// that is under a microsecond, and the launch costs more than the work.
// At the library's million rows (1 GB in bf16, 0.5 GB in int8) the bytes
// dominate. For one query and a width that is a whole number (1-4) of
// 16-byte loads per lane (D = 512: two in bf16, one in int8), the entry
// is templated on that number: the bf16-rounded query sits in registers,
// nothing inside a row is masked, and each warp has 4 KB of rows in
// flight per step (four bf16 or eight int8 rows at D = 512); the mask
// bytes and scales are loaded with the rows. An int8 value becomes a
// float on the ALU (a byte spliced into the mantissa of 2^23, then one
// exact subtraction) rather than through the quarter-rate
// integer-to-float conversion, which would cost about as much as the
// bytes.
// Other shapes (several queries, other widths) take a plain warp-per-row
// loop. Fusing the window gather and top-k into these launches is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
cosine_scores_kernel(const float* __restrict__ emb,
                     const float* __restrict__ queries,
                     const uint8_t* __restrict__ valid,
                     float* __restrict__ out, int n, int d, int nq) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;                 // whole warp leaves together
  const float* e = emb + (long long)row * d;
  const bool ok = valid == nullptr || valid[row] != 0;
  for (int j = 0; j < nq; ++j) {
    const float* qv = queries + (long long)j * d;
    float acc = 0.f;
    for (int c = lane; c < d; c += 32) acc = fmaf(e[c], qv[c], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[(long long)row * nq + j] = ok ? acc : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// bf16 and int8 rows

constexpr int LP_THREADS = 256;
constexpr int LP_WARPS = LP_THREADS / 32;

// rows a warp loads per step in the fast kernel: 8 / STEPS (at least 1),
// i.e. 4 KB of 16-byte loads per warp
__host__ __device__ constexpr int fast_rows(int steps) {
  return steps >= 8 ? 1 : 8 / steps;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Bf16Rows {
  using T = __nv_bfloat16;
  static constexpr int V = 8;          // elements per 16-byte load
  __device__ static void unpack(const uint4& raw, float* f) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {      // little-endian: element 2i is low
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float load(const T* p) { return __bfloat162float(*p); }
};

struct Int8Rows {
  using T = signed char;
  static constexpr int V = 16;
  __device__ static void unpack(const uint4& raw, float* f) {
    // flipping the sign bit maps v to the byte v + 128; spliced under
    // 0x4B00 that is the float 2^23 + v + 128, so one subtraction of
    // 2^23 + 128 gives v exactly
    const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                           raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[4 * i + b] = __uint_as_float(__byte_perm(w[i], 0x4B000000u,
                                                   0x7540u + b)) -
                       8388736.0f;
  }
  __device__ static float load(const T* p) { return (float)*p; }
};

__device__ __forceinline__ float finish(float acc, const float* scales,
                                        const uint8_t* valid, long long row) {
  if (valid != nullptr && valid[row] == 0) return -INFINITY;
  return scales != nullptr ? acc * scales[row] : acc;
}

// One query and d == STEPS * 32 * V: a lane's share of a row is STEPS
// 16-byte loads, with nothing to mask. A warp walks ROWS rows per step,
// 4 KB of loads in flight whatever the row's width.
template <class R, int STEPS>
__global__ void __launch_bounds__(LP_THREADS)
lowp_scores_fast(const typename R::T* __restrict__ emb,
                 const float* __restrict__ scales,
                 const float* __restrict__ query,
                 const uint8_t* __restrict__ valid,
                 float* __restrict__ out, int n) {
  constexpr int V = R::V, ROWS = fast_rows(STEPS), D = STEPS * 32 * V;
  const int lane = threadIdx.x % 32;
  float q[STEPS][V];
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
#pragma unroll
    for (int t = 0; t < V; ++t)
      q[s][t] = bf16_round(query[(s * 32 + lane) * V + t]);
  const long long step = (long long)gridDim.x * LP_WARPS * ROWS;
  for (long long row0 =
           ((long long)blockIdx.x * LP_WARPS + threadIdx.x / 32) * ROWS;
       row0 < n; row0 += step) {
    // the rows' mask bytes and scales are loaded with the rows, so their
    // latency overlaps the rows' instead of following each reduction
    uint4 raw[ROWS][STEPS];
    bool ok[ROWS];
    float sc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const long long row = row0 + r;
      ok[r] = row < n && (valid == nullptr || valid[row] != 0);
      sc[r] = scales != nullptr && row < n ? scales[row] : 1.f;
#pragma unroll
      for (int s = 0; s < STEPS; ++s)
        raw[r][s] = row < n ? *reinterpret_cast<const uint4*>(
                                  emb + row * D + (s * 32 + lane) * V)
                            : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (row0 + r >= n) break;          // warp-uniform
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        float f[V];
        R::unpack(raw[r][s], f);
#pragma unroll
        for (int t = 0; t < V; ++t) acc = fmaf(f[t], q[s][t], acc);
      }
      acc = warp_sum(acc);
      if (lane == 0)
        out[row0 + r] = !ok[r] ? -INFINITY
                        : scales != nullptr ? acc * sc[r] : acc;
    }
  }
}

// Any shape: one warp per row, queries read from global memory.
template <class R>
__global__ void __launch_bounds__(LP_THREADS)
lowp_scores_any(const typename R::T* __restrict__ emb,
                const float* __restrict__ scales,
                const float* __restrict__ queries,
                const uint8_t* __restrict__ valid,
                float* __restrict__ out, int n, int d, int nq) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * LP_WARPS;
  for (long long row = (long long)blockIdx.x * LP_WARPS + threadIdx.x / 32;
       row < n; row += warps) {
    const typename R::T* e = emb + row * d;
    for (int j = 0; j < nq; ++j) {
      const float* qv = queries + (long long)j * d;
      float acc = 0.f;
      for (int c = lane; c < d; c += 32)
        acc = fmaf(R::load(e + c), bf16_round(qv[c]), acc);
      acc = warp_sum(acc);
      if (lane == 0) out[row * nq + j] = finish(acc, scales, valid, row);
    }
  }
}

template <class R, int STEPS>
void launch_fast(const typename R::T* emb, const float* scales,
                 const float* query, const uint8_t* valid, float* out, int n,
                 cudaStream_t stream) {
  const long long per_block = (long long)LP_WARPS * fast_rows(STEPS);
  long long blocks = ((long long)n + per_block - 1) / per_block;
  if (blocks > 8192) blocks = 8192;
  lowp_scores_fast<R, STEPS><<<(int)blocks, LP_THREADS, 0, stream>>>(
      emb, scales, query, valid, out, n);
}

template <class R>
int launch_lowp(const typename R::T* emb, const float* scales,
                const float* queries, const uint8_t* valid, float* out,
                int n, int d, int nq, cudaStream_t stream) {
  constexpr int WIDTH = 32 * R::V;     // elements of one 16-byte load a lane
  const int steps = d % WIDTH == 0 && (uintptr_t)emb % 16 == 0 && nq == 1
                        ? d / WIDTH : 0;
  switch (steps) {
    case 1: launch_fast<R, 1>(emb, scales, queries, valid, out, n, stream);
      break;
    case 2: launch_fast<R, 2>(emb, scales, queries, valid, out, n, stream);
      break;
    case 3: launch_fast<R, 3>(emb, scales, queries, valid, out, n, stream);
      break;
    case 4: launch_fast<R, 4>(emb, scales, queries, valid, out, n, stream);
      break;
    default: {
      long long blocks = ((long long)n + LP_WARPS - 1) / LP_WARPS;
      if (blocks > 8192) blocks = 8192;
      lowp_scores_any<R><<<(int)blocks, LP_THREADS, 0, stream>>>(
          emb, scales, queries, valid, out, n, d, nq);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// valid may be null (every row valid). Output is [n, nq], row-major.
extern "C" int avede_cosine_scores_f32(const float* emb, const float* queries,
                                       const uint8_t* valid, float* out,
                                       int n, int d, int nq, void* stream) {
  const int blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  cosine_scores_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      emb, queries, valid, out, n, d, nq);
  return (int)cudaGetLastError();
}

// bf16 table [n, d] (raw bf16 bits), f32 queries [nq, d]; out [n, nq] f32.
extern "C" int avede_cosine_scores_bf16(const void* emb, const float* queries,
                                        const uint8_t* valid, float* out,
                                        int n, int d, int nq, void* stream) {
  return launch_lowp<Bf16Rows>(static_cast<const __nv_bfloat16*>(emb),
                               nullptr, queries, valid, out, n, d, nq,
                               (cudaStream_t)stream);
}

// int8 table [n, d] with f32 row scales [n]; out [n, nq] f32.
extern "C" int avede_cosine_scores_int8(const signed char* emb,
                                        const float* scales,
                                        const float* queries,
                                        const uint8_t* valid, float* out,
                                        int n, int d, int nq, void* stream) {
  return launch_lowp<Int8Rows>(emb, scales, queries, valid, out, n, d, nq,
                               (cudaStream_t)stream);
}
