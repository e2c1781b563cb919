// Fused patch embedding for Hopper (sm_90a).
//
// Replaces avede_tpu/ops/pallas_kernels.py: fused_patch_embed /
// _patch_matmul_kernel (the pl.pallas_call at :95).
//
// Computes out[img, gy*G+gx, :] = patch(img, gy, gx) @ W' + b', where the
// patch row is read in (py, px, c) order straight from the NHWC frame
// tensor while the GEMM loads its A tile: the patchified [N*G*G, P*P*3]
// matrix never exists in device memory (on the TPU, XLA materialised
// it because Mosaic could not lower the relayout). W' and b' hold the
// /255 rescale and the CLIP normalisation (fold_for_uint8), so the
// normalised image never exists either. Frames are f32 in 0..255 (the
// I420 unpack) or uint8 (the rgb transfer mode).
//
// Bound on the H100: at ViT-B/32 (K = 3072, D = 768) the product does
// about 300 operations per byte it must move (f32 frames in, f32 tokens
// out), far above the 20 that the f32 rate (67 TFLOP/s) over HBM
// (3.35 TB/s) balances at, so it is bound by operations.
// This first version is a plain f32 SIMT tile GEMM (64x64 output tile,
// K step 16, 4x4 outputs per thread, shared-memory staged) with f32
// accumulation; moving it onto wgmma with TMA-fed tiles is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(uint8_t x) { return (float)x; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
patch_embed_kernel(const T* __restrict__ frames, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int n, int s, int p, int d) {
  const int g = s / p;
  const int gg = g * g;
  const int M = n * gg;
  const int K = p * p * 3;
  const int pk = p * 3;                  // contiguous floats per patch row
  const long long row_stride = (long long)s * 3;

  __shared__ __align__(16) float As[BK][BM + 4];   // A tile, k-major
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // A loads: thread covers k = tid % BK of rows tid / BK + 16 * i.
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  long long a_base[BM / 16];
  bool a_ok[BM / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int m = m0 + a_m + 16 * i;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    const int img = mm / gg;
    const int r = mm % gg;
    const int gy = r / g;
    const int gx = r % g;
    a_base[i] = (long long)img * s * row_stride
              + (long long)(gy * p) * row_stride + (long long)gx * pk;
  }
  // B loads: thread covers column tid % BN of k rows tid / BN + 4 * i.
  const int b_n = tid % BN;
  const int b_k = tid / BN;

  const int tx = tid % 16;               // output columns tx*4 .. +3
  const int ty = tid / 16;               // output rows    ty*4 .. +3
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int k = k0 + a_k;
    const bool k_ok = k < K;
    const int py = k_ok ? k / pk : 0;
    const int rem = k_ok ? k % pk : 0;
    const long long k_off = (long long)py * row_stride + rem;
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      As[a_k][a_m + 16 * i] =
          (a_ok[i] && k_ok) ? to_float(frames[a_base[i] + k_off]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BK / (THREADS / BN); ++i) {
      const int kk = k0 + b_k + (THREADS / BN) * i;
      const int nn = n0 + b_n;
      Bs[b_k + (THREADS / BN) * i][b_n] =
          (kk < K && nn < d) ? w[(long long)kk * d + nn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx * 4 + j;
      if (nn < d) out[(long long)m * d + nn] = acc[i][j] + bias[nn];
    }
  }
}

template <typename T>
int launch(const T* frames, const float* w, const float* bias, float* out,
           int n, int s, int p, int d, void* stream) {
  const int g = s / p;
  const int M = n * g * g;
  dim3 grid((d + BN - 1) / BN, (M + BM - 1) / BM);
  patch_embed_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      frames, w, bias, out, n, s, p, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int avede_patch_embed_f32(const float* frames, const float* w,
                                     const float* bias, float* out, int n,
                                     int s, int p, int d, void* stream) {
  return launch<float>(frames, w, bias, out, n, s, p, d, stream);
}

extern "C" int avede_patch_embed_u8(const uint8_t* frames, const float* w,
                                    const float* bias, float* out, int n,
                                    int s, int p, int d, void* stream) {
  return launch<uint8_t>(frames, w, bias, out, n, s, p, d, stream);
}
