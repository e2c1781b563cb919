// Cosine scores for Hopper (sm_90a): scores[n, j] = emb[n, :] . query[j, :]
// in f32, with padded rows (valid[n] == 0) written as -inf, and the fused
// entries that score, select and sort on the device.
//
// Replaces avede_tpu/ops/pallas_kernels.py: cosine_scores_pallas /
// _score_kernel (the pl.pallas_call at :139) and the top-k that the JAX
// package's programs run after it (window_topk, window_topk_multi,
// avede_tpu/ops/similarity.py:55-95; the index's search programs,
// avede_tpu/services/library_index.py:83-105).
//
// Serving entries (only (values [k], indices [k]) come out; the library
// pipeline keeps the scores as a 4-byte scratch):
// - avede_window_topk_f32: the mvp query. One block per query scores the
//   window-middle rows only (the gather is fused into the row loads: W
//   rows of the [Nb, D] table are read, not all Nb), keeps (key, window)
//   pairs in shared memory and sorts them: up to 1024 keys by rank (each
//   thread counts the keys above its own), more with a bitonic sort; W
//   above the block's SORT_CAP keys runs as a running merge (keep k,
//   refill, sort).
// - avede_topk_f32 / _bf16 / _int8: the library index's tiers, one query
//   over every row. The contract entry's own scoring kernel writes the
//   f32 scores; then select passes over those 4 MB (at 2^20 rows): each
//   counts 13 bits of the (key, row) composite, top bits first, in a
//   shared-memory histogram among the rows still in play, and the last
//   block to finish finds the bin that holds the k-th composite, until at
//   most SORT_CAP rows lie at or above the threshold; one pass gathers
//   them and its last block sorts them (by rank up to 512, else bitonic)
//   and writes k. 2 + ND launches (ND = 4 digits at 2^20 rows); passes
//   after the data settled return at once.
// Contract entries (the TPU kernel's own function, scores out, on no
// serving path at the default settings): avede_cosine_scores_f32 / _bf16
// / _int8. The library index takes them for k above MAX_K (1024), where
// the top-k is a stable sort outside the kernel.
//
// Exactness: every fused entry scores a row with the same device code as
// the contract entry of its type (the library entries launch the contract
// kernel itself; the mvp entry shares dot_f32 with it, whose float4-chunk
// order of FMAs depends on d alone), so its (values,
// indices) are bit-for-bit the stable descending sort of the contract
// entry's scores: equal scores lower index first, -inf below every finite
// score. The order key is the float's bits with negatives inverted, -0.0
// folded onto +0.0 (a comparison sort treats them as equal); a row's
// composite (key, ~row) is unique, so the select and the sorts need no
// stability. Values are written from the scores themselves (the mvp
// composite carries a -0.0 flag), so -0.0 stays -0.0.
//
// Bound on the H100: two FLOP per table element, so every entry is bound
// by bytes. mvp: the W gathered rows (74 x 2 KB at 600 frames) read by
// one block, about 150 KB, far under a microsecond: the launch costs more
// than the work. Library: the table (2 GB f32, 1 GB bf16, 0.5 GB in int8
// at 2^20 x 512); the scores' scratch (written once, read by each select
// pass that runs) is this design's overhead, not part of the bound. For
// one query and a width that is a whole number of 16-byte loads per lane
// (f32: 1-8, D = 512 four; bf16 and int8: 1-4, D = 512 two and one), the
// scoring is templated on that number: the query (bf16-rounded for the
// lowp tiers) sits in registers, loaded once a warp, nothing inside a row
// is masked, each warp has 4 KB of rows in flight per step (f32: 4-warp
// blocks, one step of every warp covering the rows, so the contract's
// 1024 rows fill 128 SMs); the mask bytes and scales are loaded with the
// rows. An int8 value becomes a float on the ALU (a byte
// spliced into the mantissa of 2^23, then one exact subtraction) rather
// than through the quarter-rate integer-to-float conversion. Other shapes
// (several queries, an unaligned table, other widths) take a plain
// warp-per-row loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

// the top-k select
constexpr int DIGIT = 13;                  // bits a histogram pass counts
constexpr int BINS = 1 << DIGIT;
constexpr int SORT_CAP = 4096;             // keys a block sorts in smem
constexpr int MAX_K = 1024;                // largest k of the fused entries
constexpr int SEL_THREADS = 256;           // the select passes' blocks
constexpr int WT_THREADS = 1024;           // the mvp entry's block
constexpr int STATE_INTS = 8;
constexpr int SEL_BLOCKS_PER_SM = 2;
enum : unsigned int { REFINE = 0, COMPACT = 1, DONE = 2 };

static_assert(SORT_CAP * 8 == BINS * 4, "the sort reuses the histogram");
static_assert(MAX_K < SORT_CAP, "the running merge keeps k and refills");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows a warp loads per step in the fast kernels: 8 / STEPS (at least 1),
// i.e. 4 KB of 16-byte loads per warp
__host__ __device__ constexpr int fast_rows(int steps) {
  return steps >= 8 ? 1 : 8 / steps;
}

__device__ __forceinline__ float fma4(float4 e, float4 q, float acc) {
  acc = fmaf(e.x, q.x, acc);
  acc = fmaf(e.y, q.y, acc);
  acc = fmaf(e.z, q.z, acc);
  return fmaf(e.w, q.w, acc);
}

__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  return vec ? *reinterpret_cast<const float4*>(p)
             : make_float4(p[0], p[1], p[2], p[3]);
}

// A row's f32 score, the one definition every f32 kernel uses. For d a
// multiple of 128, lane l owns the four columns of each float4 chunk
// 32 s + l (s = 0 .. d/128 - 1), FMA in that order from 0; other widths
// stride the row by lanes, FMA in column order. Then a butterfly sum
// (every lane ends with the same value). The result depends on d alone:
// an unaligned row loads the same chunks as scalars. This form takes the
// lane's chunks already loaded (the fast contract kernel's registers).
template <int STEPS>
__device__ __forceinline__ float dot_f32(const float4 (&e)[STEPS],
                                         const float4 (&q)[STEPS]) {
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) acc = fma4(e[s], q[s], acc);
  return warp_sum(acc);
}

__device__ __forceinline__ float dot_f32(const float* __restrict__ e,
                                         const float* __restrict__ q,
                                         int d, int lane) {
  if (d % 128 == 0) {
    const bool vec = (((uintptr_t)e | (uintptr_t)q) & 15) == 0;
    if (d == 512) {              // every load before the first FMA
      float4 ev[4], qv[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        ev[s] = load4(e + 4 * (s * 32 + lane), vec);
        qv[s] = load4(q + 4 * (s * 32 + lane), vec);
      }
      return dot_f32<4>(ev, qv);
    }
    float acc = 0.f;
    for (int s = 0; s < d / 128; ++s)
      acc = fma4(load4(e + 4 * (s * 32 + lane), vec),
                 load4(q + 4 * (s * 32 + lane), vec), acc);
    return warp_sum(acc);
  }
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(e[c], q[c], acc);
  return warp_sum(acc);
}

// Order-preserving key: larger score, larger key; -0.0 is +0.0, -inf is
// below every finite score.
__device__ __forceinline__ uint32_t order_key(float s) {
  uint32_t b = __float_as_uint(s);
  if ((b << 1) == 0u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Block-wide bitonic sort of n (a power of two) keys, descending.
// Callers synchronise before; it synchronises after every stage.
__device__ void bitonic_desc(unsigned long long* buf, int n) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
        const int lo = 2 * stride * (i / stride) + i % stride;
        const int hi = lo + stride;
        const unsigned long long a = buf[lo], b = buf[hi];
        if ((a < b) == ((lo & size) == 0)) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
}

// Block-wide sort of n <= KPT * blockDim.x unique keys, descending: a
// key's place is the number of keys above it, one pass over shared
// memory instead of log^2 synchronised stages. Callers synchronise
// before; it synchronises after.
template <int KPT>
__device__ void rank_sort_desc(unsigned long long* buf, int n) {
  unsigned long long mine[KPT];
  int rank[KPT];
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    mine[j] = i < n ? buf[i] : 0ull;
    rank[j] = 0;
  }
  for (int i = 0; i < n; ++i) {
    const unsigned long long other = buf[i];
#pragma unroll
    for (int j = 0; j < KPT; ++j) rank[j] += other > mine[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < KPT; ++j)
    if (threadIdx.x + j * blockDim.x < n) buf[rank[j]] = mine[j];
  __syncthreads();
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// ---------------------------------------------------------------------------
// f32 rows

constexpr int F32_THREADS = 128;
constexpr int F32_WARPS = F32_THREADS / 32;
constexpr long long F32_MAX_BLOCKS = 1 << 20;   // past it, grid-stride

// One query, d == STEPS * 128, 16-byte aligned table and query: the query
// sits in registers as float4 (loaded once a warp, not once a row), and a
// warp walks ROWS rows a step, grid-stride, with their float4 loads (4 KB)
// and mask bytes all in flight before the first FMA.
template <int STEPS>
__global__ void __launch_bounds__(F32_THREADS)
f32_scores_fast(const float* __restrict__ emb, const float* __restrict__ query,
                const uint8_t* __restrict__ valid, float* __restrict__ out,
                int n) {
  constexpr int ROWS = fast_rows(STEPS), D = STEPS * 128;
  const int lane = threadIdx.x % 32;
  const float4* q4 = reinterpret_cast<const float4*>(query);
  float4 q[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) q[s] = q4[s * 32 + lane];
  const long long step = (long long)gridDim.x * F32_WARPS * ROWS;
  for (long long row0 =
           ((long long)blockIdx.x * F32_WARPS + threadIdx.x / 32) * ROWS;
       row0 < n; row0 += step) {
    float4 raw[ROWS][STEPS];
    bool ok[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const long long row = row0 + r;
      ok[r] = row < n && (valid == nullptr || valid[row] != 0);
      const float4* e4 = reinterpret_cast<const float4*>(emb + row * D);
#pragma unroll
      for (int s = 0; s < STEPS; ++s)
        raw[r][s] = row < n ? e4[s * 32 + lane]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (row0 + r >= n) break;          // warp-uniform
      const float acc = dot_f32<STEPS>(raw[r], q);
      if (lane == 0) out[row0 + r] = ok[r] ? acc : -INFINITY;
    }
  }
}

// Any shape: one warp per row, each query read from global memory.
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
    const float acc = dot_f32(e, queries + (long long)j * d, d, lane);
    if (lane == 0) out[(long long)row * nq + j] = ok ? acc : -INFINITY;
  }
}

// the fast kernel's grid: one step of every warp covers the rows (a grid
// of as many blocks as the SMs hold at once, walking 2^20 rows by
// strides, was slower there)
template <int STEPS>
void launch_f32_fast(const float* emb, const float* query,
                     const uint8_t* valid, float* out, int n,
                     cudaStream_t stream) {
  const long long per_block = (long long)F32_WARPS * fast_rows(STEPS);
  long long blocks = ((long long)n + per_block - 1) / per_block;
  if (blocks > F32_MAX_BLOCKS) blocks = F32_MAX_BLOCKS;
  f32_scores_fast<STEPS><<<(int)blocks, F32_THREADS, 0, stream>>>(
      emb, query, valid, out, n);
}

int launch_f32(const float* emb, const float* queries, const uint8_t* valid,
               float* out, int n, int d, int nq, cudaStream_t stream) {
  const bool fast = nq == 1 && d % 128 == 0 &&
                    (((uintptr_t)emb | (uintptr_t)queries) & 15) == 0;
  switch (fast ? d / 128 : 0) {
    case 1: launch_f32_fast<1>(emb, queries, valid, out, n, stream); break;
    case 2: launch_f32_fast<2>(emb, queries, valid, out, n, stream); break;
    case 3: launch_f32_fast<3>(emb, queries, valid, out, n, stream); break;
    case 4: launch_f32_fast<4>(emb, queries, valid, out, n, stream); break;
    case 5: launch_f32_fast<5>(emb, queries, valid, out, n, stream); break;
    case 6: launch_f32_fast<6>(emb, queries, valid, out, n, stream); break;
    case 7: launch_f32_fast<7>(emb, queries, valid, out, n, stream); break;
    case 8: launch_f32_fast<8>(emb, queries, valid, out, n, stream); break;
    default: {
      const int blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
      cosine_scores_kernel<<<blocks, THREADS, 0, stream>>>(
          emb, queries, valid, out, n, d, nq);
    }
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 and int8 rows

constexpr int LP_THREADS = 256;
constexpr int LP_WARPS = LP_THREADS / 32;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// ---------------------------------------------------------------------------
// mvp entry: score the window middles, sort in shared memory

// (key, window, -0.0 flag): descending order is score descending, then
// window ascending; the flag sits below the window, so it never decides
__device__ __forceinline__ unsigned long long window_key(float s, int w) {
  return ((unsigned long long)order_key(s) << 32) |
         ((unsigned long long)(0x7fffffffu - (uint32_t)w) << 1) |
         (__float_as_uint(s) == 0x80000000u ? 1ull : 0ull);
}

__device__ __forceinline__ float window_value(unsigned long long c) {
  const uint32_t key = (uint32_t)(c >> 32);
  const uint32_t b = (c & 1ull) ? 0x80000000u
                     : (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
  return __uint_as_float(b);
}

__global__ void __launch_bounds__(WT_THREADS)
window_topk_kernel(const float* __restrict__ emb,
                   const float* __restrict__ queries,
                   const uint8_t* __restrict__ valid,
                   const int* __restrict__ mids, float* __restrict__ vals,
                   long long* __restrict__ idx, int d, int w, int k) {
  __shared__ unsigned long long buf[SORT_CAP];
  constexpr int WARPS = WT_THREADS / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* q = queries + (long long)blockIdx.x * d;
  int kept = 0;
  for (int base = 0; base < w;) {
    const int take = min(w - base, SORT_CAP - kept);
    for (int t = warp; t < take; t += WARPS) {
      const int win = base + t;
      const int m = mids[win];
      float s = -INFINITY;                    // a padded window (-1)
      if (m >= 0) {                           // warp-uniform
        const float dot = dot_f32(emb + (long long)m * d, q, d, lane);
        if (valid == nullptr || valid[m] != 0) s = dot;
      }
      if (lane == 0) buf[kept + t] = window_key(s, win);
    }
    const int total = kept + take;
    __syncthreads();
    if (total <= WT_THREADS) {
      rank_sort_desc<1>(buf, total);
    } else {
      const int np = pow2_at_least(total);
      for (int i = total + threadIdx.x; i < np; i += WT_THREADS)
        buf[i] = 0ull;                        // below every real key
      __syncthreads();
      bitonic_desc(buf, np);
    }
    kept = min(k, total);
    base += take;
  }
  const long long out = (long long)blockIdx.x * k;
  for (int i = threadIdx.x; i < k; i += WT_THREADS) {
    vals[out + i] = window_value(buf[i]);
    idx[out + i] = 0x7fffffff - (int)((buf[i] >> 1) & 0x7fffffffull);
  }
}

// ---------------------------------------------------------------------------
// library entries: radix-select passes over the contract kernel's scores

struct SelState {
  unsigned long long prefix;  // the digits chosen so far, in place
  unsigned int above;         // rows with a composite above the prefix's range
  unsigned int digit;         // the digit the next refine pass counts
  unsigned int phase;         // REFINE, COMPACT or DONE
  unsigned int blocks_done;   // tickets of the pass that is running
  unsigned int n_cand;        // rows gathered by the COMPACT pass
  unsigned int pad;
};
static_assert(sizeof(SelState) == STATE_INTS * 4, "workspace layout");

struct Select {
  unsigned int* hist;          // [BINS], zero between passes
  SelState* st;
  int* cand;                   // [SORT_CAP] row ids
  const float* scores;         // [n], written by the scoring kernel
  float* vals;                 // [k]
  long long* idx;              // [k]
  int n, k, ib;                // rows, k, bits of a row id
};

// the block's histogram; the final sort reuses it as SORT_CAP keys
__device__ __forceinline__ unsigned int* block_hist() {
  __shared__ unsigned long long h[BINS / 2];
  return reinterpret_cast<unsigned int*>(h);
}

__device__ __forceinline__ unsigned long long composite(const Select& s,
                                                        float score,
                                                        int row) {
  const unsigned long long mask = (1ull << s.ib) - 1ull;
  return ((unsigned long long)order_key(score) << s.ib) |
         (mask - (unsigned long long)row);
}

// low bit of digit j of the (32 + ib)-bit composite (j = -1: its width)
__device__ __forceinline__ int digit_shift(const Select& s, int j) {
  return max(32 + s.ib - DIGIT * (j + 1), 0);
}

// Every block calls this at the end of a pass; true in the last block
// to finish, which then sees every other block's writes.
__device__ bool last_block(const Select& s) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&s.st->blocks_done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The last block of a counting pass: find the bin of digit j that holds
// the k-th largest composite, narrow the prefix to it, and either ask
// for the next digit or, once at most SORT_CAP rows lie at or above the
// bin, gather those.
__device__ void select_digit(const Select& s, int j) {
  constexpr int PER = BINS / SEL_THREADS;
  __shared__ unsigned int part[SEL_THREADS];
  SelState* st = s.st;
  const unsigned int k_rem = (unsigned int)s.k - st->above;
  // the global histogram into this block's own (its counts are flushed):
  // coalesced loads, all in flight at once
  unsigned int* h = block_hist();
#pragma unroll 8
  for (int b = threadIdx.x; b < BINS; b += SEL_THREADS)
    h[b] = __ldcg(&s.hist[b]);
  __syncthreads();
  // thread t owns bins [BINS - PER (t + 1), BINS - PER t), so counts
  // accumulate from the highest bin down
  const int top = BINS - PER * threadIdx.x - 1;
  unsigned int own = 0;
  for (int i = 0; i < PER; ++i) own += h[top - i];
  part[threadIdx.x] = own;
  __syncthreads();
  for (int off = 1; off < SEL_THREADS; off <<= 1) {   // inclusive scan
    const unsigned int add =
        (int)threadIdx.x >= off ? part[threadIdx.x - off] : 0u;
    __syncthreads();
    part[threadIdx.x] += add;
    __syncthreads();
  }
  const unsigned int before = part[threadIdx.x] - own;   // bins above mine
  if (before < k_rem && before + own >= k_rem) {
    unsigned int cum = before, cnt = 0;
    int b = top;
    for (int i = 0; i < PER; ++i, --b) {
      cnt = h[b];
      if (cum + cnt >= k_rem) break;
      cum += cnt;
    }
    const int shift = digit_shift(s, j);
    const unsigned long long prefix =
        st->prefix | ((unsigned long long)b << shift);
    const unsigned int above = st->above + cum;
    st->prefix = prefix;
    if (above + cnt <= (unsigned int)SORT_CAP || shift == 0) {
      st->phase = COMPACT;
    } else {
      st->above = above;
      st->digit = (unsigned int)(j + 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < BINS; b += blockDim.x) s.hist[b] = 0u;
  if (threadIdx.x == 0) st->blocks_done = 0u;
}

// The last block of the gather pass: sort the candidates, write k.
__device__ void sort_candidates(const Select& s) {
  unsigned long long* buf =
      reinterpret_cast<unsigned long long*>(block_hist());
  const int c = (int)__ldcg(&s.st->n_cand);
  const int np = c <= 2 * SEL_THREADS ? c : pow2_at_least(c);
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    if (i < c) {
      const int row = __ldcg(&s.cand[i]);
      buf[i] = composite(s, __ldcg(&s.scores[row]), row);
    } else {
      buf[i] = 0ull;                           // below every real key
    }
  }
  __syncthreads();
  if (c <= 2 * SEL_THREADS)
    rank_sort_desc<2>(buf, c);
  else
    bitonic_desc(buf, np);
  const unsigned long long mask = (1ull << s.ib) - 1ull;
  for (int i = threadIdx.x; i < s.k; i += blockDim.x) {
    const int row = (int)(mask - (buf[i] & mask));
    s.vals[i] = __ldcg(&s.scores[row]);
    s.idx[i] = row;
  }
  if (threadIdx.x == 0) {
    s.st->phase = DONE;
    s.st->blocks_done = 0u;
  }
}

// One pass over the scores: count digit j of the composites that match
// the prefix so far (the first pass counts digit 0 of every row), or
// gather the rows at or above the threshold; returns at once when the
// select is done.
__global__ void __launch_bounds__(SEL_THREADS) select_pass(Select s) {
  const unsigned int phase = s.st->phase;
  if (phase == DONE) return;                   // the whole grid
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned long long prefix = s.st->prefix;
  if (phase == REFINE) {
    unsigned int* h = block_hist();
    for (int b = threadIdx.x; b < BINS; b += blockDim.x) h[b] = 0u;
    __syncthreads();
    const int j = (int)s.st->digit;
    const int hi = digit_shift(s, j - 1), lo = digit_shift(s, j);
    const unsigned long long mask = (1ull << (hi - lo)) - 1ull;
    for (long long i = first; i < s.n; i += stride) {
      const unsigned long long c = composite(s, s.scores[i], (int)i);
      if ((c >> hi) == (prefix >> hi))
        atomicAdd(&h[(c >> lo) & mask], 1u);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < BINS; b += blockDim.x)
      if (h[b] != 0u) atomicAdd(&s.hist[b], h[b]);
    if (last_block(s)) select_digit(s, j);
  } else {
    for (long long i = first; i < s.n; i += stride)
      if (composite(s, s.scores[i], (int)i) >= prefix)
        s.cand[atomicAdd(&s.st->n_cand, 1u)] = (int)i;
    if (last_block(s)) sort_candidates(s);
  }
}

// The current device's SM count, kept per device (a process may launch
// on several cards; the caller makes the tensors' device current); 0 on
// an error, which the launch bounds then report.
constexpr int MAX_DEVICES = 64;

int sm_count() {
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return 0;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// The select passes after a scoring launch that wrote `scores` [n].
// `work` holds the histogram, the state and the candidates
// (avede_topk_work_ints ints). The grid is persistent, two blocks an SM:
// each block ends in a 32 KB histogram flush, so fewer blocks flush less.
template <class Score>
int run_topk(Score score, float* scores, int* work, float* vals,
             long long* idx, int n, int k, cudaStream_t stream) {
  if (k < 1 || k > MAX_K || k > n) return (int)cudaErrorInvalidValue;
  Select s;
  s.hist = reinterpret_cast<unsigned int*>(work);
  s.st = reinterpret_cast<SelState*>(work + BINS);
  s.cand = work + BINS + STATE_INTS;
  s.scores = scores;
  s.vals = vals;
  s.idx = idx;
  s.n = n;
  s.k = k;
  s.ib = 1;
  while ((1LL << s.ib) < n) ++s.ib;
  cudaError_t err = cudaMemsetAsync(
      work, 0, (BINS + STATE_INTS) * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const int code = score();
  if (code != 0) return code;
  // one refine pass a digit at most, then the gather
  const int passes = (32 + s.ib + DIGIT - 1) / DIGIT + 1;
  const long long want = ((long long)n + SEL_THREADS - 1) / SEL_THREADS;
  const long long cap = (long long)SEL_BLOCKS_PER_SM * sm_count();
  const int blocks = (int)(want < cap ? want : cap);
  for (int p = 0; p < passes; ++p)
    select_pass<<<blocks, SEL_THREADS, 0, stream>>>(s);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// contract entries

// valid may be null (every row valid). Output is [n, nq], row-major.
extern "C" int avede_cosine_scores_f32(const float* emb, const float* queries,
                                       const uint8_t* valid, float* out,
                                       int n, int d, int nq, void* stream) {
  return launch_f32(emb, queries, valid, out, n, d, nq,
                    (cudaStream_t)stream);
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

// ---------------------------------------------------------------------------
// serving entries

extern "C" int avede_topk_work_ints() {
  return BINS + STATE_INTS + SORT_CAP;
}

// mvp: queries [nq, d]; mids [w] row ids (-1 = padded window). vals
// [nq, k] f32, idx [nq, k] int64 window ids, k <= min(w, MAX_K).
extern "C" int avede_window_topk_f32(const float* emb, const float* queries,
                                     const uint8_t* valid, const int* mids,
                                     float* vals, long long* idx, int d,
                                     int nq, int w, int k, void* stream) {
  if (k < 1 || k > MAX_K || k > w) return (int)cudaErrorInvalidValue;
  window_topk_kernel<<<nq, WT_THREADS, 0, (cudaStream_t)stream>>>(
      emb, queries, valid, mids, vals, idx, d, w, k);
  return (int)cudaGetLastError();
}

// library tiers, one query [d] over every row: the contract kernel of
// the tier writes scores [n] (f32 scratch), then the select passes; work
// [avede_topk_work_ints()] int32 scratch; vals [k], idx [k] int64.
extern "C" int avede_topk_f32(const float* emb, const float* query,
                              const uint8_t* valid, float* scores, int* work,
                              float* vals, long long* idx, int n, int d,
                              int k, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return run_topk([&] {
    return launch_f32(emb, query, valid, scores, n, d, 1, st);
  }, scores, work, vals, idx, n, k, st);
}

extern "C" int avede_topk_bf16(const void* emb, const float* query,
                               const uint8_t* valid, float* scores,
                               int* work, float* vals, long long* idx, int n,
                               int d, int k, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return run_topk([&] {
    return launch_lowp<Bf16Rows>(static_cast<const __nv_bfloat16*>(emb),
                                 nullptr, query, valid, scores, n, d, 1, st);
  }, scores, work, vals, idx, n, k, st);
}

extern "C" int avede_topk_int8(const signed char* emb, const float* scales,
                               const float* query, const uint8_t* valid,
                               float* scores, int* work, float* vals,
                               long long* idx, int n, int d, int k,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return run_topk([&] {
    return launch_lowp<Int8Rows>(emb, scales, query, valid, scores, n, d, 1,
                                 st);
  }, scores, work, vals, idx, n, k, st);
}
