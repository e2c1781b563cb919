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
// - avede_flash_attention_f32 (the TPU kernel's contract, and the path
//   of an f32 model's flash layers): f32 [B*H, L, D] in and out, D any
//   multiple of 8 up to 128 in the template (instantiated at 16, 24,
//   32, 64 and 88), 3xTF32 on the tensor cores; its design is described
//   above its kernel, after the bf16 entry's.
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

// ---------------------------------------------------------------------------
// bf16 [B, L, H, hd] entry (hd = 16, 24, 64, 72 or 88)
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
// the zero chunk beside the third and drops that half). hd = 72 (Kimi-VL's
// MoonViT: 1152 = 16 x 72) takes hd = 88's 96-column tiles: 9 chunks of
// the head and three zero-filled, six k16 steps of Q.K^T (the last over
// zeros), P.V over 9 n8 tiles (the odd last as at hd = 24).

namespace {

constexpr int TR = 64;              // rows of a q or K/V tile
constexpr int TT = 128;             // threads: 4 warps x 16 query rows

// HD: the head dim; HP: its width in shared memory (a multiple of 16)
template <int HD, int HP>
struct Geo {
  static constexpr int CH = HP / 8;     // 16-byte chunks a tile row
  static constexpr int HC = HD / 8;     // chunks that hold the head
  static constexpr int TILE = TR * HP;  // bf16 elements of one tile
  static_assert(HD % 8 == 0 && HP % 16 == 0 && HP >= HD && HP - HD < 32,
                "head padded to a multiple of 16 the swizzle takes");
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

// The current device's index into the per-device launch state below
// (the shared-memory attribute and the SM count are a device's own, so a
// process that launches on several cards keeps them per card), or -1.
constexpr int MAX_DEVICES = 64;

int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return -1;
  return dev;
}

template <int HD, int HP>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int L, int H, int ldi, void* stream) {
  static int grid_cap[MAX_DEVICES] = {};
  const int smem = 2 * (int)sizeof(Stage<HP>);
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (grid_cap[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bf16_kernel<HD, HP>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, flash_bf16_kernel<HD, HP>, TT, smem);
    if (err != cudaSuccess) return (int)err;
    grid_cap[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int items = B * H * ((L + TR - 1) / TR);
  const int grid = items < grid_cap[dev] ? items : grid_cap[dev];
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
// for D not in {16, 24, 64, 72, 88} or a bad ldi.
extern "C" int avede_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int L, int H, int D, int ldi,
                                          void* stream) {
  if ((D != 16 && D != 24 && D != 64 && D != 72 && D != 88) || ldi < H * D ||
      ldi % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (D == 16) return launch_bf16<16, 16>(q, k, v, o, B, L, H, ldi, stream);
  if (D == 24) return launch_bf16<24, 32>(q, k, v, o, B, L, H, ldi, stream);
  if (D == 64) return launch_bf16<64, 64>(q, k, v, o, B, L, H, ldi, stream);
  if (D == 72) return launch_bf16<72, 96>(q, k, v, o, B, L, H, ldi, stream);
  return launch_bf16<88, 96>(q, k, v, o, B, L, H, ldi, stream);
}

// ---------------------------------------------------------------------------
// f32 [B, H, L, D] entry (the TPU kernel's contract): 3xTF32 tensor cores
// ---------------------------------------------------------------------------
//
// The block structure of the bf16 entry: 4 warps of 16 query rows (a
// 64-row q tile), a persistent grid walking (pair, q tile) items, 64-key
// K/V tiles brought in by 16-byte cp.async (rows past L zero-filled) and
// double-buffered, the online softmax in the accumulator fragments with
// quad shuffles for row max and sum, keys past L scored -inf. What
// differs is f32 accuracy on the tensor cores:
// - 3xTF32 on mma.sync m16n8k8 (tf32 in, f32 accumulate): each operand
//   x is split into big = x rounded to tf32 and small = x - big, and
//   small.big + big.small + big.big accumulate in f32, about 21 bits of
//   mantissa. bf16 x3 (about 16 bits) would not do here: a score's
//   error goes through exp into p, and at |s| near 10 it would sit on
//   the entry's 1e-4 bar. The split is integer rounding and one
//   subtraction (split_tf32), not two cvt.rna.tf32.f32: the kernel
//   spends its time issuing the splits beside the products, and the
//   conversions ran slower on the H100 at the same accuracy.
// - The m16n8k8 accumulator holds columns (2t, 2t+1) of rows g and g+8,
//   its A operand columns t and t+4, so P cannot feed P.V in the
//   accumulator's layout as it does in m16n8k16. Rather than move P
//   between lanes, P.V's k dimension is permuted: A column t stands for
//   key 2t of the k8 step and column t+4 for key 2t+1, and V's B
//   fragment reads rows 2t and 2t+1 to match. Q.K^T does the same over
//   the head dim, so each lane reads (2t, 2t+1) of a Q or K row as one
//   float2.
// - Shared rows are padded so the fragment reads are conflict-free: K
//   rows (float2 reads, rows g by lanes t) at a stride of 8 mod 16
//   words, V rows (single floats, rows 2t and 2t+1 by column g) at 4
//   mod 8.
// - Q never enters shared memory: at an item's first tile each warp
//   loads its 16 rows' fragments from global memory into registers (D/2
//   floats, raw; split at each K/V tile), in flight while the K/V tile
//   lands. That leaves Q, O (D/2) and S (32) in registers at D = 88, and
//   shared memory to the K/V ring alone (72 KB at D = 64: three blocks
//   an SM; 92 KB at D = 88: two). Staging Q beside K and V, as the bf16
//   entry does, held D = 88 to one block an SM, which ran slower. A
//   warp whose 16 query rows all lie past L skips the tile, and key
//   groups of 8 past L skip their products (L = 257: the last q tile
//   has one row, the last K/V tile one key).
// Bound: f32 [128, 12, 50, 64] moves 78.6 MB for 0.98 GFLOP (x3 passes:
// 0.0060 ms on the TF32 tensor cores' 495 TFLOP/s), bound by bytes;
// [30, 16, 257, 88] moves 173.7 MB for 11.2 GFLOP (x3: 0.0677 ms), bound
// by operations.

namespace {

template <int D>
struct F32Geo {
  static_assert(D % 8 == 0 && D >= 8 && D <= 128,
                "head dim a multiple of 8 up to 128");
  static constexpr int SK = D % 16 == 0 ? D + 8 : D;   // k row stride
  static constexpr int SV = D + 4;                      // v row stride
  static constexpr int CH = D / 4;                      // 16-byte chunks
};

template <int D>
struct F32Stage {
  float k[TR * F32Geo<D>::SK];
  float v[TR * F32Geo<D>::SV];
};

// rows row0.. of a [L, D] matrix into rows of stride S; rows >= L are
// zero-filled (src-size 0)
template <int D, int S>
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         int row0, int L) {
  constexpr int CH = F32Geo<D>::CH;
#pragma unroll 4
  for (int i = threadIdx.x; i < TR * CH; i += TT) {
    const int r = i / CH, c = i % CH;
    const int gr = row0 + r;
    const bool ok = gr < L;
    const float* g = ok ? src + (long long)gr * D + c * 4 : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst + r * S + c * 4)), "l"(g),
                    "r"(ok ? 16 : 0) : "memory");
  }
}

// x -> (big, small): big is x rounded to tf32 (half an ulp up in
// magnitude, then the low 13 bits cleared), small = x - big exactly
// (|small| <= 2^-11 |x|), passed as f32 bits: the tensor core reads the
// top 19 bits of each operand, so small keeps about 10 more and
// big + small = x to about 2^-21 relative
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32: the two small terms, then big.big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

template <int D>
__global__ void __launch_bounds__(TT)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int bh,
                 int L, float scale_log2) {
  using G = F32Geo<D>;
  constexpr int KS = D / 8;                   // Q.K^T k8 steps, P.V n8 tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  F32Stage<D>* st = reinterpret_cast<F32Stage<D>*>(smem_raw);
  const int nt = (L + TR - 1) / TR;           // q tiles = K/V tiles
  const int items = bh * nt;
  const int mine = (int)blockIdx.x < items
      ? (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x : 0;
  const int steps = mine * nt;                // (item, kv tile) steps
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // step s's pair offset, q tile and kv tile
  auto where = [&](int s, int& qt, int& kt) -> long long {
    const int item = (int)blockIdx.x + (s / nt) * (int)gridDim.x;
    kt = s % nt;
    qt = item % nt;
    return (long long)(item / nt) * L * D;
  };
  auto issue = [&](int s) {
    int qt, kt;
    const long long base = where(s, qt, kt);
    F32Stage<D>& S = st[s & 1];
    load_f32<D, G::SK>(S.k, k + base, kt * TR, L);
    load_f32<D, G::SV>(S.v, v + base, kt * TR, L);
  };

  if (steps > 0) issue(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // Q fragments, raw: qf[kk] = rows (g, g+8) x dims (8kk+2t, 8kk+2t+1)
  float qf[KS][4];
  float acc[KS][4];
  float m[2], l[2];

  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) issue(s + 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    int qt, kt;
    const long long base = where(s, qt, kt);
    const int row = qt * TR + warp * 16 + g;  // this lane's first q row
    const bool live = qt * TR + warp * 16 < L;  // the warp has a live row
    if (live && kt == 0) {
      // a new item: its Q fragments straight from global memory into
      // registers, in flight while the K/V tile lands
      const float* q0 = q + base + (long long)row * D + 2 * t;
      const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const float2 r0 = row < L
            ? *reinterpret_cast<const float2*>(q0 + 8 * kk) : zero;
        const float2 r1 = row + 8 < L
            ? *reinterpret_cast<const float2*>(q0 + 8 * D + 8 * kk) : zero;
        qf[kk][0] = r0.x; qf[kk][1] = r1.x;
        qf[kk][2] = r0.y; qf[kk][3] = r1.y;
      }
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const F32Stage<D>& S = st[s & 1];

    if (live) {
      const int keys = L - kt * TR;           // live keys of this tile

      // scores: 16 query rows x 64 keys per warp
      float sc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ab[4], as[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(qf[kk][e], ab[e], as[e]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (8 * j < keys) {
            const float2 kv = *reinterpret_cast<const float2*>(
                &S.k[(8 * j + g) * G::SK + 8 * kk + 2 * t]);
            mma_3xtf32(sc[j], ab, as, kv.x, kv.y);
          }
        }
      }
      const int key0 = kt * TR + 2 * t;
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
      for (int n = 0; n < KS; ++n) {
        acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
      }

      // P.V, 8 keys a step: A column t is key 2t, column t+4 key 2t+1,
      // so P's accumulator fragment is the A fragment as it stands
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (8 * kk < keys) {
          uint32_t pb[4], ps[4];
          split_tf32(sc[kk][0], pb[0], ps[0]);
          split_tf32(sc[kk][2], pb[1], ps[1]);
          split_tf32(sc[kk][1], pb[2], ps[2]);
          split_tf32(sc[kk][3], pb[3], ps[3]);
          const float* v0 = &S.v[(8 * kk + 2 * t) * G::SV + g];
#pragma unroll
          for (int n = 0; n < KS; ++n)
            mma_3xtf32(acc[n], pb, ps, v0[8 * n], v0[G::SV + 8 * n]);
        }
      }

      if (kt == nt - 1) {
        float inv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float r = l[i];
          r += __shfl_xor_sync(0xffffffffu, r, 1);
          r += __shfl_xor_sync(0xffffffffu, r, 2);
          inv[i] = 1.f / r;
        }
        float* o0 = o + base + (long long)row * D + 2 * t;
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          if (row < L)
            *reinterpret_cast<float2*>(o0 + 8 * n) =
                make_float2(acc[n][0] * inv[0], acc[n][1] * inv[0]);
          if (row + 8 < L)
            *reinterpret_cast<float2*>(o0 + 8 * D + 8 * n) =
                make_float2(acc[n][2] * inv[1], acc[n][3] * inv[1]);
        }
      }
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, float* o,
               int bh, int L, void* stream) {
  static int grid_cap[MAX_DEVICES] = {};
  const int smem = 2 * (int)sizeof(F32Stage<D>);
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (grid_cap[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_f32_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, flash_f32_kernel<D>, TT, smem);
    if (err != cudaSuccess) return (int)err;
    grid_cap[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int items = bh * ((L + TR - 1) / TR);
  const int grid = items < grid_cap[dev] ? items : grid_cap[dev];
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  flash_f32_kernel<D><<<grid, TT, smem, (cudaStream_t)stream>>>(
      q, k, v, o, bh, L, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous f32 [B*H, L, D], each pointer 16-byte aligned.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a head
// dimension without an instantiation.
extern "C" int avede_flash_attention_f32(const float* q, const float* k,
                                         const float* v, float* o, int bh,
                                         int L, int D, void* stream) {
  switch (D) {
    case 16: return launch_f32<16>(q, k, v, o, bh, L, stream);
    case 24: return launch_f32<24>(q, k, v, o, bh, L, stream);
    case 32: return launch_f32<32>(q, k, v, o, bh, L, stream);
    case 64: return launch_f32<64>(q, k, v, o, bh, L, stream);
    case 88: return launch_f32<88>(q, k, v, o, bh, L, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
