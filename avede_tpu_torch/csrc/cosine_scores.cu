// Cosine scores for Hopper (sm_90a): scores[n, j] = emb[n, :] . query[j, :]
// in f32, with padded rows (valid[n] == 0) written as -inf.
//
// Replaces avede_tpu/ops/pallas_kernels.py: cosine_scores_pallas /
// _score_kernel (the pl.pallas_call at :139), and serves the scoring
// product of every warm query ([Nb, 512] table against one or a few
// text embeddings).
//
// One warp per table row: lanes read the row in coalesced 128-byte
// steps, multiply by each query (a few KB, cached in L1) and reduce
// with shuffles; lane 0 writes the score, or -inf for a padded row,
// which is what window_topk applies next.
//
// Bound on the H100: two FLOP per 4-byte table element, so it is bound
// by bytes; at the largest FRAME_BUCKETS table (1024 x 512 f32, 2 MB)
// that is under a microsecond, and the launch costs more than the work.
// Fusing the window gather and top-k into this launch is later work.

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
