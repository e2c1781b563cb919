// Grouped expert GEMM for a sparse-expert (MoE) SwiGLU layer, and the
// gather that combines its rows.
//
// Replaces no TPU kernel: the JAX package has no sparse-expert layer. It
// was added for Kimi-VL's decoder (models/kimi_vl.py), whose 26 MoE layers
// route each token to 6 of 64 experts of width 1408 and add 2 shared
// experts; ops/moe.py runs the shared ones as two more experts that every
// token takes, so one launch covers all 66 "experts" of a layer.
//
// The caller (ops/moe.py) sorts the (token, expert) assignments by expert
// on the device and passes the sorted rows' tokens, each expert's first
// row (offsets, E + 1) and each expert's first tile (tile_start, E + 1:
// the prefix sum of ceil(rows / BM)). Nothing is read back to the host:
// the grid covers the most tiles any routing can need (ceil(A / BM) + E),
// and a block past tile_start[E] returns at once. No token is dropped and
// nothing is padded to a capacity.
//
//   gate_up: h[a, f] = silu(x[tok(a)] . Wg[e, f]) * (x[tok(a)] . Wu[e, f])
//            for the sorted assignments a of expert e (bf16 out, the
//            product taken in f32 and rounded once);
//   down:    y[a, d] = h[a] . Wd[e, d]                          (bf16 out);
//   combine: out[t, d] = sum_j w[t, j] y[inv[t, j], d], in f32, j in order
//            (a gather, no atomics: the result does not depend on timing).
//
// Bounds on the H100 (Kimi-VL, D = 2048, F = 1408): the prefill's 30 x 600
// tokens give each routed expert ~1700 rows: 2.5 TFLOP a layer, compute
// bound at 989 TFLOP/s. A decode step's 30 tokens touch at most the 66
// experts, most with 1-5 rows: the touched experts' weights (17.3 MB an
// expert; 1.14 GB, 0.34 ms at 3.35 TB/s, when all 66 are touched) are the
// whole cost. One design serves both, at two tile heights chosen by the
// wrapper from the shapes (rows per expert):
// - A block computes a BM x BN tile of one expert's rows (gate_up: BN
//   features of gate and of up, two accumulators) on mma.sync m16n8k16,
//   bf16 in, f32 accumulation, from a 4-stage cp.async ring of 32-deep
//   k slices (64-byte rows, chunk index XOR-swizzled by (row >> 1) & 3 so
//   ldmatrix reads 8 rows from 8 distinct bank groups). gate_up gathers
//   its A rows by token index straight from x (no permuted copy).
// - Prefill: BM = 128, 8 warps as 4 x 2, a warp 32 rows x 32 (gate_up,
//   two matrices) or 64 (down) columns: 64 KB of shared memory, 64 f32
//   accumulators a thread.
// - Decode: BM = 16, 4 warps side by side on N: an expert's 1-5 rows in one
//   m16 tile, so the MMA work wasted on empty rows stays under the weight
//   reads; ~1400 blocks a launch keep enough loads in flight for HBM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;          // k slice: 32 bf16 = 64-byte rows, 4 chunks
constexpr int STAGES = 4;
constexpr int MAX_DEVICES = 64;

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, bool GATED_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr bool GATED = GATED_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int TM = BM / WARPS_M, TN = BN / WARPS_N;  // warp tile
  static constexpr int MI = TM / 16, NI = TN / 8;
  static constexpr int NB = GATED ? 2 : 1;                    // B matrices
  static constexpr int STAGE = (BM + NB * BN) * BK;           // elements
  static constexpr int SMEM = STAGES * STAGE * 2 + BM * 4;    // + row tokens
  static_assert(TM % 16 == 0 && TN % 16 == 0, "warp tile of m16, n16 steps");
};

using PrefillGateUp = Cfg<128, 64, 4, 2, true>;
using PrefillDown = Cfg<128, 128, 4, 2, false>;
using DecodeGateUp = Cfg<16, 64, 1, 4, true>;
using DecodeDown = Cfg<16, 128, 1, 4, false>;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of (row, 16-byte chunk) in a tile of 64-byte rows
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * BK + ((chunk ^ ((row >> 1) & 3)) << 3);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float silu(float x) {
  return x / (1.f + __expf(-x));
}

// One BM x BN output tile of one expert. A: [*, K] bf16 rows (gate_up: x,
// its rows picked by `tokens`; down: h, the sorted rows themselves);
// W0 (and W1 when GATED): [E, N, K]; out: [A_total, N].
template <class C>
__global__ void __launch_bounds__(C::THREADS)
grouped_kernel(const __nv_bfloat16* __restrict__ a,
               const int* __restrict__ tokens,
               const __nv_bfloat16* __restrict__ w0,
               const __nv_bfloat16* __restrict__ w1,
               __nv_bfloat16* __restrict__ out,
               const int* __restrict__ tile_start,
               const int* __restrict__ offsets, int E, int K, int N,
               int lda) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int* s_tok = reinterpret_cast<int*>(smem_raw + STAGES * C::STAGE * 2);

  const int tile = blockIdx.x;
  if (tile >= tile_start[E]) return;
  // the expert whose tiles hold this one: tile_start[e] <= tile < [e + 1]
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tile_start[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  const int e = lo;
  const int m0 = offsets[e] + (tile - tile_start[e]) * C::BM;
  const int rows = min(C::BM, offsets[e + 1] - m0);
  const int n0 = blockIdx.y * C::BN;

  for (int r = threadIdx.x; r < C::BM; r += C::THREADS)
    s_tok[r] = r < rows ? (tokens != nullptr ? tokens[m0 + r] : m0 + r) : -1;
  __syncthreads();

  const __nv_bfloat16* b0 = w0 + ((long long)e * N + n0) * K;
  const __nv_bfloat16* b1 = C::GATED ? w1 + ((long long)e * N + n0) * K
                                     : nullptr;
  const int ksteps = K / BK;

  auto load = [&](int stage, int ks) {
    __nv_bfloat16* sa = sm + stage * C::STAGE;
    const int k0 = ks * BK;
    for (int i = threadIdx.x; i < C::BM * 4; i += C::THREADS) {
      const int r = i >> 2, c = i & 3;
      const int tok = s_tok[r];
      const __nv_bfloat16* src =
          tok >= 0 ? a + (long long)tok * lda + k0 + c * 8 : a;
      cp16(sa + swz(r, c), src, tok >= 0);
    }
#pragma unroll
    for (int nb = 0; nb < C::NB; ++nb) {
      __nv_bfloat16* sb = sa + C::BM * BK + nb * C::BN * BK;
      const __nv_bfloat16* w = nb == 0 ? b0 : b1;
      for (int i = threadIdx.x; i < C::BN * 4; i += C::THREADS) {
        const int r = i >> 2, c = i & 3;
        cp16(sb + swz(r, c), w + (long long)r * K + k0 + c * 8, true);
      }
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  float acc[C::NB][C::MI][C::NI][4];
#pragma unroll
  for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nb][mi][ni][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ksteps) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2) : "memory");
    __syncthreads();
    const int next = ks + STAGES - 1;
    if (next < ksteps) load(next % STAGES, next);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const __nv_bfloat16* sa = sm + (ks % STAGES) * C::STAGE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[C::MI][4];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
        ldsm_x4(af[mi], sa + swz(wm * C::TM + mi * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8,
                                 2 * kk + (lane >> 4)));
#pragma unroll
      for (int nb = 0; nb < C::NB; ++nb) {
        const __nv_bfloat16* sb = sa + C::BM * BK + nb * C::BN * BK;
#pragma unroll
        for (int ni = 0; ni < C::NI; ni += 2) {
          uint32_t bf[4];
          ldsm_x4(bf, sb + swz(wn * C::TN + ni * 8 + (lane & 7) +
                                   (lane >> 4) * 8,
                               2 * kk + ((lane >> 3) & 1)));
#pragma unroll
          for (int mi = 0; mi < C::MI; ++mi) {
            mma_bf16(acc[nb][mi][ni], af[mi], bf[0], bf[1]);
            mma_bf16(acc[nb][mi][ni + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * C::TM + mi * 16 + g + 8 * half;
      if (r >= rows) continue;
      __nv_bfloat16* dst = out + (long long)(m0 + r) * N + n0 + wn * C::TN;
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        float v0 = acc[0][mi][ni][2 * half], v1 = acc[0][mi][ni][2 * half + 1];
        if constexpr (C::GATED) {
          v0 = silu(v0) * acc[C::NB - 1][mi][ni][2 * half];
          v1 = silu(v1) * acc[C::NB - 1][mi][ni][2 * half + 1];
        }
        *reinterpret_cast<__nv_bfloat162*>(dst + ni * 8 + 2 * t) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
}

// out[t] = sum_j w[t, j] * y[inv[t, j]] over the S rows of token t, f32
// sums in the order j; 8 columns a thread
__global__ void combine_kernel(const __nv_bfloat16* __restrict__ y,
                               const int* __restrict__ inv,
                               const float* __restrict__ w,
                               __nv_bfloat16* __restrict__ out, int S, int D) {
  const int t = blockIdx.x;
  for (int c = threadIdx.x; c < D / 8; c += blockDim.x) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < S; ++j) {
      const float wt = w[(long long)t * S + j];
      const uint4 raw = *reinterpret_cast<const uint4*>(
          y + (long long)inv[(long long)t * S + j] * D + c * 8);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(p[q]);
        acc[2 * q] = fmaf(wt, f.x, acc[2 * q]);
        acc[2 * q + 1] = fmaf(wt, f.y, acc[2 * q + 1]);
      }
    }
    uint4 res;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      o[q] = __floats2bfloat162_rn(acc[2 * q], acc[2 * q + 1]);
    *reinterpret_cast<uint4*>(out + (long long)t * D + c * 8) = res;
  }
}

// the shared-memory attribute is a device's own: set once a device
template <class C>
cudaError_t prepare() {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(grouped_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <class C>
int launch(const void* a, const int* tokens, const void* w0, const void* w1,
           void* out, const int* tile_start, const int* offsets, int E,
           int max_tiles, int K, int N, int lda, void* stream) {
  if (K % BK != 0 || N % C::BN != 0 || lda % 8 != 0 || max_tiles < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = prepare<C>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(max_tiles, N / C::BN);
  grouped_kernel<C><<<grid, C::THREADS, C::SMEM, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(a), tokens,
      static_cast<const __nv_bfloat16*>(w0),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<__nv_bfloat16*>(out), tile_start, offsets, E, K, N, lda);
  return (int)cudaGetLastError();
}

}  // namespace

// h [A, N] = silu(x[tokens] . Wg^T) * (x[tokens] . Wu^T), expert by expert:
// x bf16 [T, K] (row stride lda), tokens int32 [A] (sorted assignments'
// tokens), Wg, Wu bf16 [E, N, K], tile_start and offsets int32 [E + 1]
// on the device (tile_start counted in the shape's tile height: 128 rows,
// or 16 with decode != 0); max_tiles >= tile_start[E]. Returns
// cudaGetLastError() or cudaErrorInvalidValue.
extern "C" int avede_moe_gate_up_bf16(const void* x, const int* tokens,
                                      const void* wg, const void* wu,
                                      void* h, const int* tile_start,
                                      const int* offsets, int E,
                                      int max_tiles, int K, int N, int lda,
                                      int decode, void* stream) {
  if (decode)
    return launch<DecodeGateUp>(x, tokens, wg, wu, h, tile_start, offsets, E,
                                max_tiles, K, N, lda, stream);
  return launch<PrefillGateUp>(x, tokens, wg, wu, h, tile_start, offsets, E,
                               max_tiles, K, N, lda, stream);
}

// y [A, N] = h . Wd^T, expert by expert: h bf16 [A, K] (the sorted rows),
// Wd bf16 [E, N, K].
extern "C" int avede_moe_down_bf16(const void* h, const void* wd, void* y,
                                   const int* tile_start, const int* offsets,
                                   int E, int max_tiles, int K, int N,
                                   int decode, void* stream) {
  if (decode)
    return launch<DecodeDown>(h, nullptr, wd, nullptr, y, tile_start, offsets,
                              E, max_tiles, K, N, K, stream);
  return launch<PrefillDown>(h, nullptr, wd, nullptr, y, tile_start, offsets,
                             E, max_tiles, K, N, K, stream);
}

// out [T, D] = sum_j w[t, j] y[inv[t, j]]: y bf16 [A, D], inv int32 and w
// f32 [T, S]. D a multiple of 8.
extern "C" int avede_moe_combine_bf16(const void* y, const int* inv,
                                      const float* w, void* out, int T, int S,
                                      int D, void* stream) {
  if (T < 1 || S < 1 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  const int threads = D / 8 < 256 ? ((D / 8 + 31) / 32) * 32 : 256;
  combine_kernel<<<T, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(y), inv, w,
      static_cast<__nv_bfloat16*>(out), S, D);
  return (int)cudaGetLastError();
}
