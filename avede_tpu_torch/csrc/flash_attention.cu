// Flash attention for Hopper (sm_90a): non-causal, unmasked softmax
// attention on [B*H, L, D] f32, with online softmax over K/V tiles.
//
// Replaces avede_tpu/ops/attention.py: flash_attention / _flash_kernel
// (the pl.pallas_call at :85).
//
// One block takes 64 query rows of one (frame, head) pair, one thread
// per row: the thread keeps its q row and its output accumulator in
// registers and the running max and sum in f32, exactly the recurrence
// of _flash_kernel. K and V stream through shared memory in tiles of 32
// rows, read by all threads at once (broadcast). Any L works: K/V rows
// past L load as zeros and their scores are -inf, and query rows past L
// write nothing, so the caller pads nothing.
//
// Bound on the H100: at the CLIP ViT-B/32 vision shape (L = 50, D = 64)
// each (frame, head) reads 50 KB and does 0.64 MFLOP, about 13 FLOP per
// byte, below the 20 that f32 (67 TFLOP/s) over HBM (3.35 TB/s) balances
// at, so it is bound by bytes. The score matrix never leaves registers;
// moving the products onto tensor cores and the inputs to bf16 is later
// work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 32;

template <int D>
__global__ void __launch_bounds__(BQ)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int L, float scale) {
  __shared__ float Ks[BKV][D];
  __shared__ float Vs[BKV][D];

  const long long base = (long long)blockIdx.x * L * D;
  const int row = blockIdx.y * BQ + threadIdx.x;
  const bool active = row < L;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = active ? q[base + (long long)row * D + c] : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int t0 = 0; t0 < L; t0 += BKV) {
    for (int i = threadIdx.x; i < BKV * D; i += BQ) {
      const int r = i / D;
      const int c = i % D;
      const bool in = t0 + r < L;
      const long long off = base + (long long)(t0 + r) * D + c;
      Ks[r][c] = in ? k[off] : 0.f;
      Vs[r][c] = in ? v[off] : 0.f;
    }
    __syncthreads();
    if (active) {
      const int nk = min(BKV, L - t0);
      float sc[BKV];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < BKV; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) dot = fmaf(qr[c], Ks[j][c], dot);
        sc[j] = j < nk ? dot * scale : -INFINITY;
        tmax = fmaxf(tmax, sc[j]);
      }
      const float m_new = fmaxf(m, tmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < BKV; ++j) {
        sc[j] = expf(sc[j] - m_new);
        psum += sc[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
      for (int j = 0; j < BKV; ++j)
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] = fmaf(sc[j], Vs[j][c], acc[c]);
      m = m_new;
    }
    __syncthreads();
  }

  if (active) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < D; ++c) o[base + (long long)row * D + c] = acc[c] * inv;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int bh,
           int L, void* stream) {
  dim3 grid(bh, (L + BQ - 1) / BQ);
  const float scale = 1.f / sqrtf((float)D);
  flash_attention_kernel<D><<<grid, BQ, 0, (cudaStream_t)stream>>>(
      q, k, v, o, L, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError(), or cudaErrorInvalidValue for a head
// dimension without an instantiation.
extern "C" int avede_flash_attention_f32(const float* q, const float* k,
                                         const float* v, float* o, int bh,
                                         int L, int D, void* stream) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, bh, L, stream);
    case 32: return launch<32>(q, k, v, o, bh, L, stream);
    case 64: return launch<64>(q, k, v, o, bh, L, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
