// Flash attention for Hopper (sm_90a): non-causal, unmasked softmax
// attention with an online softmax over K/V tiles. Two entries:
//
// - avede_flash_attention_bf16 (the serving path): bf16 q, k, v in the
//   projections' own layout [B, L, H, hd] (hd = 64, 88 for BLIP-2's
//   ViT-g, 16 for the tiny 32 px towers, or 24 for the detection eval's
//   OWL-ViT), token rows at a stride of ldi
//   elements: H*hd for the contiguous [B, L, D] output of an nn.Linear
//   viewed per head (CLIP), 3*H*hd for the q, k and v thirds of one fused
//   qkv projection's [B, L, 3D] output (BLIP's vision tower), read in
//   place. Output bf16 [B, L, H*hd] that out_proj reads as it is. No
//   transpose or copy exists around it.
// - avede_flash_attention_f32 (the TPU kernel's contract): f32
//   [B*H, L, D], one thread per query row (kept from the first port).
//
// Replaces avede_tpu/ops/attention.py: flash_attention / _flash_kernel
// (the pl.pallas_call at :85).
//
// Bound on the H100: at the CLIP ViT-B/32 vision shape (L = 50, hd = 64,
// bf16) each (frame, head) pair moves 25.6 KB for about 0.64 MFLOP,
// some 25 FLOP per byte, far under the ~295 at which the bf16 tensor
// cores (989 TFLOP/s) become the limit over HBM (3.35 TB/s): it is bound
// by bytes. At BLIP's vision shape (L = 577: ten 64-key tiles, the last
// holding one key) the products grow with L^2 to about 290 FLOP per byte
// of the function's own work (QK^T and P.V once each): still bound by
// bytes, just under the ridge; the second P.V term below (see the last
// point) takes this design to about 430. At BLIP-2's ViT-g shape (L = 257,
// hd = 88: 30 frames x 16 heads move 86.8 MB for 11.2 GFLOP) it is about
// 130 FLOP per byte: bound by bytes.
// The bf16 design spends on bytes in flight and on launches, not on the
// widest tensor-core instruction:
// - 4 warps per block, one warp per 16 query rows (a 64-row q tile),
//   mma.sync m16n8k16 (bf16 in, f32 accumulate); a 64-row wgmma tile
//   would waste a fifth of its rows at L = 50.
// - A persistent block walks several (pair, q tile) items. The q tile and
//   each 64-key K/V tile go into shared memory by 16-byte cp.async
//   (rows past L zero-filled), double-buffered: the next item's loads
//   are in flight while this one computes. Rows are 128 B at hd = 64
//   (192 B at hd = 88, padded to 96 columns), stored with the 16-byte
//   chunks XOR-swizzled by row so ldmatrix is conflict-free.
// - Scores stay in the mma accumulator fragments; row max and sum use
//   quad shuffles; keys past L score -inf.
// - P.V splits P into two bf16 terms (hi = bf16(p), lo = bf16(p - hi))
//   and runs both products into one f32 accumulator, which keeps the
//   result within f32 softmax.V at the 1e-4 bar (one bf16 term would
//   not). The output goes through shared memory to 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// bf16 [B, L, H, hd] entry (hd = 16, 24, 64 or 88)
// ---------------------------------------------------------------------------
//
// One kernel, instantiated per head dim. hd = 64 (CLIP, BLIP-base,
// OWL-ViT) is one 128-byte row of 8 16-byte chunks. hd = 16 (the tiny
// CLIP, BLIP and OWL-ViT towers: 4 heads of 16 at L = 17) is a 32-byte
// row of 2 chunks: Q.K^T is one k16 step and P.V two n8 tiles. hd = 88 (BLIP-2's
// ViT-g: 1408 = 16 x 88) is 11 chunks; Q.K^T's m16n8k16 steps need a
// depth that is a multiple of 16, so the tiles hold 96 columns in shared
// memory and the twelfth chunk is zero-filled by cp.async with src-size
// 0 (the global read never passes the head: the next head's columns lie
// there). P.V's n dimension covers 88 = 11 n8 tiles exactly, so the
// padded output tile is never computed and only 88 columns are written.
// hd = 24 (the `detection` eval mode's OWL-ViT: 96 = 4 x 24 at L = 65)
// is the same padding at a smaller size: 3 chunks of the head and a
// zero-filled fourth, 32 columns (64-byte rows) in shared memory, two
// k16 steps of Q.K^T, and P.V over 3 n8 tiles (its ldmatrix pair reads
// the zero chunk beside the third and drops that half).

namespace {

constexpr int TR = 64;              // rows of a q or K/V tile
constexpr int TT = 128;             // threads: 4 warps x 16 query rows

// HD: the head dim; HP: its width in shared memory (a multiple of 16)
template <int HD, int HP>
struct Geo {
  static constexpr int CH = HP / 8;     // 16-byte chunks a tile row
  static constexpr int HC = HD / 8;     // chunks that hold the head
  static constexpr int TILE = TR * HP;  // bf16 elements of one tile
  static_assert(HD % 8 == 0 && HP % 16 == 0 && HP >= HD && HP - HD < 16,
                "head padded to the next multiple of 16");
  static_assert(CH == 2 || CH == 4 || CH == 8 || CH == 12,
                "swizzle for 2, 4, 8 or 12 chunks a row");
  // Element offset of (row, chunk). ldmatrix reads one chunk column of 8
  // consecutive rows; those 8 addresses must hit 8 distinct 16-byte
  // bank groups (of 8 in 128 bytes). With 8 chunks a row the XOR with
  // row & 7 does it. With 12 (192-byte rows) or 4 (64-byte rows), row r
  // starts at bank group 4 * (r & 1); the XOR with (r >> 1) & 3 moves
  // the chunk within its aligned group of 4 (it stays below 12, or 4)
  // and gives the four row pairs distinct groups: without it a column
  // of 8 rows would hit 2 groups, 4 rows each. With 2 (32-byte rows:
  // row r starts at group 2 * (r & 3), so rows r and r + 4 share one),
  // the XOR with (r >> 2) & 1 moves the upper four rows to the odd
  // groups.
  static __device__ __forceinline__ int swz(int row, int chunk) {
    if constexpr (CH == 2) return row * HP + ((chunk ^ ((row >> 2) & 1)) << 3);
    if constexpr (CH == 8) return row * HP + ((chunk ^ (row & 7)) << 3);
    return row * HP + ((chunk ^ ((row >> 1) & 3)) << 3);
  }
};

template <int HP>
struct Stage {
  __nv_bfloat16 q[TR * HP];
  __nv_bfloat16 k[TR * HP];
  __nv_bfloat16 v[TR * HP];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// rows row0.. of a matrix with row stride ld (elements); rows >= L and
// the chunks past the head are zero-filled (src-size 0)
template <int HD, int HP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int ld,
                                          int row0, int L) {
  using G = Geo<HD, HP>;
#pragma unroll
  for (int i = threadIdx.x; i < TR * G::CH; i += TT) {
    const int r = i / G::CH, c = i % G::CH;
    const int gr = row0 + r;
    const bool ok = gr < L && c < G::HC;
    const __nv_bfloat16* g = ok ? src + (long long)gr * ld + c * 8 : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst + G::swz(r, c))), "l"(g),
                    "r"(ok ? 16 : 0) : "memory");
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// p -> (hi, lo) bf16 pairs with hi + lo = p to about 2^-17 relative
__device__ __forceinline__ void split2(float p0, float p1, uint32_t& hi,
                                       uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

template <int HD, int HP>
__global__ void __launch_bounds__(TT)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int B, int L, int H,
                  int ldi, float scale_log2) {
  using G = Geo<HD, HP>;
  constexpr int KS = HP / 16;                 // Q.K^T k16 steps
  constexpr int NO = G::HC;                   // output n8 tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Stage<HP>* st = reinterpret_cast<Stage<HP>*>(smem_raw);
  const int ld = H * HD;                      // output row stride
  const int nt = (L + TR - 1) / TR;           // q tiles = K/V tiles
  const int items = B * H * nt;
  const int mine = (int)blockIdx.x < items
      ? (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x : 0;
  const int steps = mine * nt;                // (item, kv tile) steps
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // offset of step s's (batch, head) in a matrix with row stride `rows`
  auto item_base = [&](int s, int& qt, int& kt, int rows) -> long long {
    const int item = (int)blockIdx.x + (s / nt) * (int)gridDim.x;
    kt = s % nt;
    const int pair = item / nt;
    qt = item % nt;
    const int b = pair / H, h = pair % H;
    return (long long)b * L * rows + (long long)h * HD;
  };
  auto issue = [&](int s) {
    int qt, kt;
    const long long base = item_base(s, qt, kt, ldi);
    Stage<HP>& S = st[s & 1];
    if (kt == 0) load_tile<HD, HP>(S.q, q + base, ldi, qt * TR, L);
    load_tile<HD, HP>(S.k, k + base, ldi, kt * TR, L);
    load_tile<HD, HP>(S.v, v + base, ldi, kt * TR, L);
  };

  if (steps > 0) issue(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  uint32_t qf[KS][4];
  float acc[NO][4];
  float m[2], l[2];

  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) issue(s + 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    Stage<HP>& S = st[s & 1];
    int qt, kt;
    const long long base = item_base(s, qt, kt, ld);    // of the output

    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], &S.q[G::swz(warp * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8,
                                    2 * kk + (lane >> 4))]);
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
    }

    // scores: 16 query rows x 64 keys per warp
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, &S.k[G::swz(8 * j + (lane & 7) + (lane >> 4) * 8,
                               2 * kk + ((lane >> 3) & 1))]);
        mma_bf16(sc[j], qf[kk], b[0], b[1]);
        mma_bf16(sc[j + 1], qf[kk], b[2], b[3]);
      }
    }
    const int key0 = kt * TR + 2 * (lane & 3);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (key0 + 8 * j + (e & 1) >= L) sc[j][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float alpha[2], ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      alpha[i] = exp2f((m[i] - mx[i]) * scale_log2);
      ms[i] = mx[i] * scale_log2;
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = exp2f(fmaf(sc[j][e], scale_log2, -ms[e >> 1]));
        rs[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }

    // P.V with P = hi + lo, 16 keys per step; output tiles in pairs (an
    // odd last tile takes its pair's first half)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      split2(sc[2 * kk][0], sc[2 * kk][1], ah[0], al[0]);
      split2(sc[2 * kk][2], sc[2 * kk][3], ah[1], al[1]);
      split2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ah[2], al[2]);
      split2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, &S.v[G::swz(16 * kk + (lane & 7) +
                                     ((lane >> 3) & 1) * 8,
                                 n + (lane >> 4))]);
        mma_bf16(acc[n], ah, b[0], b[1]);
        mma_bf16(acc[n], al, b[0], b[1]);
        if (n + 1 < NO) {
          mma_bf16(acc[n + 1], ah, b[2], b[3]);
          mma_bf16(acc[n + 1], al, b[2], b[3]);
        }
      }
    }

    if (kt == nt - 1) {
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float t = l[i];
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
        inv[i] = 1.f / t;
      }
      // stage this warp's 16 output rows in its own rows of the q tile
      __nv_bfloat16* stg = S.q;
      const int r = warp * 16 + (lane >> 2);
      const int cc = 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        *reinterpret_cast<uint32_t*>(&stg[G::swz(r, n) + cc]) =
            pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
        *reinterpret_cast<uint32_t*>(&stg[G::swz(r + 8, n) + cc]) =
            pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
      }
      __syncwarp();
#pragma unroll
      for (int i = lane; i < 16 * G::HC; i += 32) {
        const int row = warp * 16 + i / G::HC, c = i % G::HC;
        const int grow = qt * TR + row;
        if (grow < L)
          *reinterpret_cast<uint4*>(o + base + (long long)grow * ld + c * 8) =
              *reinterpret_cast<const uint4*>(&stg[G::swz(row, c)]);
      }
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int HD, int HP>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int L, int H, int ldi, void* stream) {
  static int grid_cap = 0;
  const int smem = 2 * (int)sizeof(Stage<HP>);
  if (grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(flash_bf16_kernel<HD, HP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, flash_bf16_kernel<HD, HP>, TT, smem);
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int items = B * H * ((L + TR - 1) / TR);
  const int grid = items < grid_cap ? items : grid_cap;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  flash_bf16_kernel<HD, HP><<<grid, TT, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, B, L, H, ldi, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 [B, L, H, D] with token rows ldi elements apart (ldi >=
// H*D, a multiple of 8, each pointer 16-byte aligned); o: contiguous
// bf16 [B, L, H*D]. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for D not in {16, 24, 64, 88} or a bad ldi.
extern "C" int avede_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int L, int H, int D, int ldi,
                                          void* stream) {
  if ((D != 16 && D != 24 && D != 64 && D != 88) || ldi < H * D ||
      ldi % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (D == 16) return launch_bf16<16, 16>(q, k, v, o, B, L, H, ldi, stream);
  if (D == 24) return launch_bf16<24, 32>(q, k, v, o, B, L, H, ldi, stream);
  if (D == 64) return launch_bf16<64, 64>(q, k, v, o, B, L, H, ldi, stream);
  return launch_bf16<88, 96>(q, k, v, o, B, L, H, ldi, stream);
}
