// Symmetric int8 quantization for Hopper (sm_90a):
//   scale = max(amax / 127, 1e-12),  q = clip(rint(x / scale), -127, 127)
// with amax taken over a row ([N, D] -> int8 [N, D], scales [N]) or over a
// column ([K, N] -> int8 [K, N], scales [N]).
//
// Replaces avede_tpu/ops/quant.py: quantize_kernel_pallas / _quant_kernel
// (the pl.pallas_call at :70), which quantizes a [K, N] weight per output
// column in one block. The per-column entry keeps that contract; the
// per-row entries are the layout of the library index's int8 tier:
// avede_quantize_rows for growth, and avede_quantize_rows_into for an add
// or a remove, which also writes the block's valid bytes (row < n_valid),
// the one program the JAX package runs for that write
// (avede_tpu/services/library_index.py:70-79) in one launch.
//
// Bound by bytes on the H100: 4 bytes read and 1 byte written per element
// for a few operations each.
// - Per row: one warp per row, four warps a block, so an add block (768
//   rows) runs 192 blocks over the 132 SMs; rows past the grid (growth,
//   1,024,000 rows) are walked grid-stride by 131072 warps. For D a multiple of 128 up to
//   1024 the row sits in registers (float4 loads, all issued before the
//   first use, D/32 values a lane), so it is read from device memory once;
//   amax is reduced with shuffles and the int8 row is written from the
//   registers as char4. Other widths take a loop that reads the row twice
//   (the second time from L1/L2). At an add block the kernel is latency
//   and launch: each warp's chain (loads, 5 shuffles, the scale's
//   division, D/32 divisions) is what the launch waits for, and a zero
//   row, which every bucket-padded add block and every removal holds,
//   skips its divisions (the slowest warp was the one dividing zeros).
// - Per column: a thread-block cluster of 8 blocks owns 32 neighbouring
//   columns (each warp reads 128 contiguous bytes of a row) and splits K
//   into 8 slabs, one a block, so [3072, 768] runs 192 blocks on the 132
//   SMs instead of 24. A block's 16 row-lanes keep their slab in
//   registers (K <= 8 * 16 * COL_VALS; taller matrices read their slab a
//   second time, from L2) and reduce amax through shared memory; each
//   block then writes its column maxima into every block of the cluster
//   (distributed shared memory, map_shared_rank), so one cluster barrier
//   (plus one whose arrival overlaps the loads) leaves all 8 in every
//   block, and each block quantizes its own slab.
//   x is read from device memory once.
//
// Exactness against numpy and JAX, which compute in f32 and round half to
// even: IEEE division x / scale (never x * (1 / scale); the build has no
// --use_fast_math), rintf for the rounding, and max of |x| is the same in
// any order. An all-zero row or column gives q = 0 and scale = 1e-12.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROW_THREADS = 128;
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int ROW_MAX_WARPS = 131072;   // the grid-stride walk's warps
constexpr int MAX_VEC = 8;              // float4 loads a lane keeps: D <= 1024
constexpr int COL_X = 32;               // columns per cluster
constexpr int COL_Y = 16;               // row-lanes per block
constexpr int CLUSTER = 8;              // blocks per cluster, splitting K
constexpr int COL_VALS = 24;            // slab values a thread keeps
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float scale_of(float amax) {
  return fmaxf(amax / 127.0f, 1e-12f);
}

// A zero row (a block's padding, a removal) skips the divisions: a zero
// dividend sends IEEE division down its slow path, which made the warp
// of a zero row the slowest of an add block; 0 / scale is 0 and
// max(0 / 127, 1e-12) is 1e-12, so q and the scale are the division's.
constexpr float ZERO_SCALE = 1e-12f;

__device__ __forceinline__ signed char quant(float x, float scale) {
  const float r = fminf(fmaxf(rintf(x / scale), -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(r));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float abs_max4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// valid (may be null) gets 1 for rows below n_valid, else 0
__device__ __forceinline__ void row_done(float* scales, uint8_t* valid,
                                         long long row, float s,
                                         int n_valid) {
  scales[row] = s;
  if (valid != nullptr) valid[row] = row < n_valid ? 1 : 0;
}

// One warp per row, the row held in registers (d % 128 == 0, d <= 1024).
__global__ void __launch_bounds__(ROW_THREADS)
quantize_rows_reg(const float* __restrict__ x, signed char* __restrict__ q,
                  float* __restrict__ scales, uint8_t* __restrict__ valid,
                  int n, int d, int n_valid) {
  const int lane = threadIdx.x % 32;
  const int nv = d / 128;
  const long long warps = (long long)gridDim.x * ROW_WARPS;
  for (long long row = (long long)blockIdx.x * ROW_WARPS + threadIdx.x / 32;
       row < n; row += warps) {
    const float4* src = reinterpret_cast<const float4*>(x + row * d);
    float4 v[MAX_VEC];
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_VEC; ++j) {
      if (j < nv) {
        v[j] = src[j * 32 + lane];
        amax = fmaxf(amax, abs_max4(v[j]));
      }
    }
    amax = warp_max(amax);
    char4* dst = reinterpret_cast<char4*>(q + row * d);
    if (amax == 0.f) {                        // warp-uniform: see ZERO_SCALE
#pragma unroll
      for (int j = 0; j < MAX_VEC; ++j)
        if (j < nv) dst[j * 32 + lane] = make_char4(0, 0, 0, 0);
      if (lane == 0) row_done(scales, valid, row, ZERO_SCALE, n_valid);
      continue;
    }
    const float s = scale_of(amax);
#pragma unroll
    for (int j = 0; j < MAX_VEC; ++j) {
      if (j < nv)
        dst[j * 32 + lane] = make_char4(quant(v[j].x, s), quant(v[j].y, s),
                                        quant(v[j].z, s), quant(v[j].w, s));
    }
    if (lane == 0) row_done(scales, valid, row, s, n_valid);
  }
}

// One warp per row, any width: amax pass, then a quantize pass.
__global__ void __launch_bounds__(ROW_THREADS)
quantize_rows_loop(const float* __restrict__ x, signed char* __restrict__ q,
                   float* __restrict__ scales, uint8_t* __restrict__ valid,
                   int n, int d, int n_valid) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * ROW_WARPS;
  for (long long row = (long long)blockIdx.x * ROW_WARPS + threadIdx.x / 32;
       row < n; row += warps) {
    const float* src = x + row * d;
    float amax = 0.f;
    for (int c = lane; c < d; c += 32) amax = fmaxf(amax, fabsf(src[c]));
    amax = warp_max(amax);
    float s = ZERO_SCALE;
    if (amax == 0.f) {                        // warp-uniform: see ZERO_SCALE
      for (int c = lane; c < d; c += 32) q[row * d + c] = 0;
    } else {
      s = scale_of(amax);
      for (int c = lane; c < d; c += 32) q[row * d + c] = quant(src[c], s);
    }
    if (lane == 0) row_done(scales, valid, row, s, n_valid);
  }
}

// Per column of a row-major [k, n] matrix (the TPU kernel's contract).
// blockIdx.x picks 32 columns; the cluster's 8 blocks split K.
template <bool IN_REGS>
__global__ void __cluster_dims__(1, CLUSTER, 1)
__launch_bounds__(COL_X * COL_Y, 2)
quantize_cols(const float* __restrict__ x, signed char* __restrict__ q,
              float* __restrict__ scales, int k, int n) {
  namespace cg = cooperative_groups;
  __shared__ float part[COL_Y][COL_X];
  __shared__ float cluster_max[CLUSTER][COL_X];   // each block's, pushed
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int slab = (k + CLUSTER - 1) / CLUSTER;
  const int r0 = min(k, rank * slab), r1 = min(k, r0 + slab);
  const int col = blockIdx.x * COL_X + threadIdx.x;
  const bool live = col < n;
  // a block's shared memory may be written by the others only once it
  // runs: arrive now, wait after the loads
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  float v[IN_REGS ? COL_VALS : 1];
  float amax = 0.f;
  if constexpr (IN_REGS) {
#pragma unroll
    for (int i = 0; i < COL_VALS; ++i) {
      const int r = r0 + threadIdx.y + i * COL_Y;
      v[i] = live && r < r1 ? x[(long long)r * n + col] : 0.f;
      amax = fmaxf(amax, fabsf(v[i]));
    }
  } else if (live) {
    for (int r = r0 + threadIdx.y; r < r1; r += COL_Y)
      amax = fmaxf(amax, fabsf(x[(long long)r * n + col]));
  }
  part[threadIdx.y][threadIdx.x] = amax;
  __syncthreads();
  // row-lane y < CLUSTER writes this block's column max into block y's
  // shared memory; after one cluster barrier every block reads its own
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (threadIdx.y < CLUSTER) {
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < COL_Y; ++i) m = fmaxf(m, part[i][threadIdx.x]);
    cluster.map_shared_rank(&cluster_max[0][0], threadIdx.y)
        [rank * COL_X + threadIdx.x] = m;
  }
  cluster.sync();
  float m = 0.f;
#pragma unroll
  for (int b = 0; b < CLUSTER; ++b) m = fmaxf(m, cluster_max[b][threadIdx.x]);
  if (!live) return;
  const float s = scale_of(m);
  if constexpr (IN_REGS) {
#pragma unroll
    for (int i = 0; i < COL_VALS; ++i) {
      const int r = r0 + threadIdx.y + i * COL_Y;
      if (r < r1) q[(long long)r * n + col] = quant(v[i], s);
    }
  } else {
    for (int r = r0 + threadIdx.y; r < r1; r += COL_Y)
      q[(long long)r * n + col] = quant(x[(long long)r * n + col], s);
  }
  if (rank == 0 && threadIdx.y == 0) scales[col] = s;
}

int launch_rows(const float* x, signed char* q, float* scales,
                uint8_t* valid, int n, int d, int n_valid,
                cudaStream_t stream) {
  const long long want = ((long long)n + ROW_WARPS - 1) / ROW_WARPS;
  const int blocks = (int)(want < ROW_MAX_WARPS / ROW_WARPS
                               ? want : ROW_MAX_WARPS / ROW_WARPS);
  const bool in_regs = d % 128 == 0 && d <= 128 * MAX_VEC &&
                       (uintptr_t)x % 16 == 0 && (uintptr_t)q % 4 == 0;
  if (in_regs)
    quantize_rows_reg<<<blocks, ROW_THREADS, 0, stream>>>(
        x, q, scales, valid, n, d, n_valid);
  else
    quantize_rows_loop<<<blocks, ROW_THREADS, 0, stream>>>(
        x, q, scales, valid, n, d, n_valid);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n, d] f32 -> q [n, d] int8, scales [n] f32, all row-major.
extern "C" int avede_quantize_rows(const float* x, signed char* q,
                                   float* scales, int n, int d,
                                   void* stream) {
  return launch_rows(x, q, scales, nullptr, n, d, 0, (cudaStream_t)stream);
}

// The int8 index's add write: as avede_quantize_rows, and valid [n]
// (bytes, a bool tensor) gets valid[r] = r < n_valid.
extern "C" int avede_quantize_rows_into(const float* x, signed char* q,
                                        float* scales, uint8_t* valid, int n,
                                        int d, int n_valid, void* stream) {
  return launch_rows(x, q, scales, valid, n, d, n_valid,
                     (cudaStream_t)stream);
}

// x [k, n] f32 -> q [k, n] int8, scales [n] f32, all row-major.
extern "C" int avede_quantize_cols(const float* x, signed char* q,
                                   float* scales, int k, int n,
                                   void* stream) {
  const dim3 block(COL_X, COL_Y), grid((n + COL_X - 1) / COL_X, CLUSTER);
  const int slab = (k + CLUSTER - 1) / CLUSTER;
  if (slab <= COL_Y * COL_VALS)
    quantize_cols<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        x, q, scales, k, n);
  else
    quantize_cols<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        x, q, scales, k, n);
  return (int)cudaGetLastError();
}
