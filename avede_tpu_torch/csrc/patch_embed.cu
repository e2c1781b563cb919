// Fused patch embedding for Hopper (sm_90a): patchify + @ W' + b' on
// the tensor cores, with the frame decode fused into the A operand.
//
// Replaces avede_tpu/ops/pallas_kernels.py: fused_patch_embed /
// _patch_matmul_kernel (the pl.pallas_call at :95).
//
// out[img, gy*G+gx, :] = patch(img, gy, gx) @ W' + b', where W' and b'
// hold the /255 rescale and the CLIP normalisation (fold_for_uint8), so
// neither the normalised image nor the patchified [N*G*G, P*P*3] matrix
// exists in device memory. One templated kernel, three entries:
// - avede_patch_embed_i420 (the serving path): packed I420 uint8
//   [N, S*3/2, S] in, bf16 tokens out. The producer unpacks YUV to RGB
//   in f32 exactly as clip_preprocess_i420 does (same products and sums,
//   no contraction, clamp to [0, 255]), so the 0..255 image never exists
//   either;
// - avede_patch_embed_u8 / avede_patch_embed_f32 (the TPU kernel's
//   contract): RGB uint8 or 0..255 f32 [N, S, S, 3] in, f32 out.
//
// Bound on the H100: at ViT-B/32 (M = 49 patches a frame, K = 3072,
// D = 768) the product does some 300 operations per byte it must move,
// so it is bound by operations. The design:
// - bf16 x3 on wgmma: A = a_hi + a_lo and W' = w_hi + w_lo in bf16, and
//   a_hi.w_hi + a_hi.w_lo + a_lo.w_hi accumulate in f32, which keeps the
//   f32 result (the dropped a_lo.w_lo term is ~2^-17 relative). uint8
//   pixels are exact in bf16, so the u8 entry runs two passes.
// - W' is split once by the caller into w_hi, w_lo [D, K] (K-major), with
//   K in (row pair, channel, row, px) order, so each K step of 64 is one
//   channel of two pixel rows of a patch. Their tiles arrive by TMA (128-
//   byte swizzle) into a 4-stage ring guarded by mbarriers.
// - Two producer warpgroups build the A tile, two threads a patch, one
//   pixel row of the K step's row pair each. A thread reads its row's 32
//   luma bytes and the 16 bytes of each chroma plane that cover it with
//   16-byte loads once for the pair's three channel steps, a pair ahead
//   (the loads are in flight while it builds the current pair), converts
//   to the step's channel in f32, splits hi/lo, stores both to swizzled
//   shared memory, then issues fence.proxy.async before it arrives on the
//   stage's barrier. (One warpgroup, one thread a patch and loads at use,
//   ran at 0.288 ms on 128 frames: the producer, not the tensor cores,
//   set the pace.)
// - Two consumer warpgroups run wgmma m64n96k16 on a 128 x 96 output
//   tile; a persistent grid of one block per SM walks the tiles, so the
//   producers fill the next tile's stages during the epilogue (b' added
//   in f32, bf16 or f32 stored). At 128 frames that is 392 tiles, 2.97
//   per SM: 96 columns waste less of the last wave than 128 (294 tiles,
//   2.23 per SM), 0.178 against 0.199 ms on the H100.
// P is 32 (K step = 2 rows x 32 px); D must be a multiple of 96.
//
// Every other shape (any P that divides S, any D: the tiny 32 px CLIP's
// P = 8, D = 64) takes a second kernel with the same three entries
// (avede_patch_embed_any_*), on mma.sync m16n8k16 over the same split
// bf16 operands and three products: 16 patches x 32 output channels a
// block (64 blocks at the tiny CLIP's 32-frame batch, M = 512, D = 64),
// the block's whole K (192 there) staged once in shared memory, then one
// barrier and the products (its design is described above it). At the
// tiny shape it moves 0.16 MB for 12.6 MFLOP (x3): bound by its launch
// and latency, far from bytes or operations.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 32;                   // patch size
constexpr int BM = 128;                 // patches per tile
constexpr int BN = 96;                  // output channels per tile
constexpr int BK = 64;                  // K step: 2 rows x 32 px, 1 channel
constexpr int STAGES = 4;
constexpr int OP_BYTES = BM * BK * 2;   // one bf16 A tile, 16 KB
constexpr int W_BYTES = BN * BK * 2;    // one bf16 W' tile
constexpr int STAGE_BYTES = 2 * OP_BYTES + 2 * W_BYTES;  // a_hi, a_lo, w_hi, w_lo
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
constexpr int THREADS = 512;            // 2 consumer + 2 producer warpgroups
constexpr int MAX_DEVICES = 64;         // cards with their own launch state

enum Mode { I420 = 0, RGB_U8 = 1, RGB_F32 = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar) : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte rows and the 128-byte
// swizzle: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
       | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D += A·B^T for one 64-row A slice and a 96-row B tile, both K-major
// bf16 with the 128-byte swizzle, k = 16
__device__ __forceinline__ void wgmma_m64n96(float (&d)[48], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

// byte b of w as an exact float (spliced into the mantissa of 2^23)
__device__ __forceinline__ float byte_f(uint32_t w, int b) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | b)) - 8388608.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// 8 values → one 16-byte chunk of hi and one of lo
__device__ __forceinline__ void split8(const float (&x)[8], uint4& hi,
                                       uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 t = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    h[i] = *reinterpret_cast<uint32_t*>(&t);
    l[i] = pack_bf16(x[2 * i] - __low2float(t), x[2 * i + 1] - __high2float(t));
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

__device__ __forceinline__ float clamp255(float x) {
  return fminf(fmaxf(x, 0.f), 255.f);
}

// channel C of the I420 unpack, in clip_preprocess_i420's order of
// operations (u, v already minus 128)
template <int C>
__device__ __forceinline__ float yuv_channel(float y, float u, float v) {
  if (C == 0) return clamp255(__fadd_rn(y, __fmul_rn(1.402f, v)));
  if (C == 1)
    return clamp255(__fsub_rn(__fsub_rn(y, __fmul_rn(0.344136f, u)),
                              __fmul_rn(0.714136f, v)));
  return clamp255(__fadd_rn(y, __fmul_rn(1.772f, u)));
}

__device__ __forceinline__ uint32_t word(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// What a producer thread keeps of one pixel row of a patch for the three
// K steps of its row pair: the raw bytes, loaded once, a pair ahead.
// I420: the row's 32 luma bytes and the 16 bytes of each chroma plane
// that cover it; RGB uint8: the row's 96 bytes; RGB f32 loads at use.
struct Raw {
  uint4 w[6];
};

template <int MODE>
__device__ __forceinline__ Raw load_row(const void* frames, bool ok,
                                        long long img, int yrow, int gx,
                                        int s) {
  Raw raw;
#pragma unroll
  for (int i = 0; i < 6; ++i) raw.w[i] = make_uint4(0, 0, 0, 0);
  if (!ok) return raw;
  if (MODE == I420) {
    const uint8_t* f = static_cast<const uint8_t*>(frames)
                     + img * (long long)s * s * 3 / 2;
    const uint4* yp = reinterpret_cast<const uint4*>(
        f + (long long)yrow * s + gx * P);
    const long long coff = (long long)(yrow / 2) * (s / 2) + gx * (P / 2);
    raw.w[0] = yp[0];
    raw.w[1] = yp[1];
    raw.w[2] = *reinterpret_cast<const uint4*>(f + (long long)s * s + coff);
    raw.w[3] = *reinterpret_cast<const uint4*>(
        f + (long long)s * s * 5 / 4 + coff);
  } else if (MODE == RGB_U8) {
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const uint8_t*>(frames)
        + ((img * s + yrow) * (long long)s + gx * P) * 3);
#pragma unroll
    for (int i = 0; i < 6; ++i) raw.w[i] = src[i];
  }
  return raw;
}

// Producer: the 4 chunks (32 px, hi and lo) of one pixel row of a patch
// for the K step of channel C; chunk 4r + q holds px 8q..8q+7 of row r.
template <int MODE, int C>
__device__ __forceinline__ void build_row(const Raw& raw, const void* frames,
                                          bool ok, long long img, int yrow,
                                          int gx, int s, int r,
                                          uint8_t* a_hi, uint8_t* a_lo,
                                          int row) {
  uint4 hi[4], lo[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float x[8];
    if (MODE == I420) {
      const uint32_t yw0 = word(raw.w[q >> 1], 2 * (q & 1));
      const uint32_t yw1 = word(raw.w[q >> 1], 2 * (q & 1) + 1);
      const uint32_t uw = word(raw.w[2], q), vw = word(raw.w[3], q);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float y = byte_f(e < 4 ? yw0 : yw1, e & 3);
        const float u = byte_f(uw, e >> 1) - 128.f;
        const float v = byte_f(vw, e >> 1) - 128.f;
        x[e] = yuv_channel<C>(y, u, v);
      }
    } else if (MODE == RGB_U8) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int b = 24 * q + 3 * e + C;       // byte of the row
        x[e] = byte_f(word(raw.w[b >> 4], (b >> 2) & 3), b & 3);
      }
    } else {
      const float4* src = reinterpret_cast<const float4*>(
          static_cast<const float*>(frames)
          + ((img * s + yrow) * (long long)s + gx * P) * 3 + 24 * q);
      float w[24];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float4 t = ok ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
        w[4 * i] = t.x; w[4 * i + 1] = t.y; w[4 * i + 2] = t.z;
        w[4 * i + 3] = t.w;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = w[3 * e + C];
    }
    split8(x, hi[q], lo[q]);
  }
  // 128-byte rows, 16-byte chunk j stored at j ^ (row % 8) (TMA's
  // SWIZZLE_128B pattern, which the wgmma descriptor reads)
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int off = row * 128 + (((4 * r + q) ^ (row & 7)) << 4);
    *reinterpret_cast<uint4*>(a_hi + off) = hi[q];
    if (MODE != RGB_U8) *reinterpret_cast<uint4*>(a_lo + off) = lo[q];
  }
}

template <int MODE, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
patch_embed_kernel(const __grid_constant__ CUtensorMap w_hi_map,
                   const __grid_constant__ CUtensorMap w_lo_map,
                   const void* __restrict__ frames,
                   const float* __restrict__ bias, OutT* __restrict__ out,
                   int n, int s, int d) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr bool kLo = MODE != RGB_U8;       // a_lo = 0 for uint8 pixels

  const int g = s / P;
  const int gg = g * g;
  const int M = n * gg;
  const int K = P * P * 3;
  const int ksteps = K / BK;                 // 48
  const int nb = d / BN;
  const int tiles = ((M + BM - 1) / BM) * nb;
  const int tid = threadIdx.x;
  const int wg = tid / 128;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(smem_u32(&full[i]), 256 + 1);   // producers + the TMA issue
      mbar_init(smem_u32(&empty[i]), 256);      // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg >= 2) {
    // ---------------- producer warpgroups ----------------
    // two threads a patch: thread pt builds pixel row pt % 2 of each row
    // pair of patch row pt / 2 of the A tile
    const int pt = tid - 256;
    const int prow = pt >> 1, r = pt & 1;
    struct Where { bool ok; long long img; int gy, gx; };
    auto where = [&](int tile) {
      const int m = (tile / nb) * BM + prow;
      const int mm = m < M ? m : 0;
      return Where{m < M, mm / gg, (mm % gg) / g, (mm % gg) % g};
    };
    int stage = 0;
    uint32_t phase = 0;
    int tile = blockIdx.x;
    Where at = where(tile);
    Raw cur = tile < tiles
        ? load_row<MODE>(frames, at.ok, at.img, at.gy * P + r, at.gx, s)
        : Raw{};
    for (; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % nb) * BN;
      for (int pair = 0; pair < P / 2; ++pair) {
        // the next pair's bytes are in flight during this pair's 3 steps
        const bool last = pair + 1 == P / 2;
        const int ntile = last ? tile + (int)gridDim.x : tile;
        const Where nat = last ? where(ntile) : at;
        Raw nxt = Raw{};
        if (ntile < tiles)
          nxt = load_row<MODE>(frames, nat.ok, nat.img,
                               nat.gy * P + 2 * (last ? 0 : pair + 1) + r,
                               nat.gx, s);
        const int yrow = at.gy * P + 2 * pair + r;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int ks = 3 * pair + c;
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          uint8_t* st = ring + stage * STAGE_BYTES;
          const uint32_t fb = smem_u32(&full[stage]);
          if (pt == 0) {
            mbar_expect_tx(fb, 2 * W_BYTES);
            tma_load(smem_u32(st + 2 * OP_BYTES), &w_hi_map, ks * BK, n0, fb);
            tma_load(smem_u32(st + 2 * OP_BYTES + W_BYTES), &w_lo_map,
                     ks * BK, n0, fb);
          }
          if (c == 0)
            build_row<MODE, 0>(cur, frames, at.ok, at.img, yrow, at.gx, s, r,
                               st, st + OP_BYTES, prow);
          else if (c == 1)
            build_row<MODE, 1>(cur, frames, at.ok, at.img, yrow, at.gx, s, r,
                               st, st + OP_BYTES, prow);
          else
            build_row<MODE, 2>(cur, frames, at.ok, at.img, yrow, at.gx, s, r,
                               st, st + OP_BYTES, prow);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(fb);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
        cur = nxt;
        at = nat;
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    int stage = 0;
    uint32_t phase = 0;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / nb) * BM, n0 = (tile % nb) * BN;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int ks = 0; ks < ksteps; ++ks) {
        mbar_wait(smem_u32(&full[stage]), phase);
        uint8_t* st = ring + stage * STAGE_BYTES;
        const uint32_t a_hi = smem_u32(st) + wg * 64 * 128;
        const uint32_t a_lo = a_hi + OP_BYTES;
        const uint32_t w_hi = smem_u32(st + 2 * OP_BYTES);
        const uint32_t w_lo = w_hi + W_BYTES;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {   // 32 bytes per k16 step
          wgmma_m64n96(acc, desc(a_hi + 32 * kk), desc(w_hi + 32 * kk));
          wgmma_m64n96(acc, desc(a_hi + 32 * kk), desc(w_lo + 32 * kk));
          if (kLo)
            wgmma_m64n96(acc, desc(a_lo + 32 * kk), desc(w_hi + 32 * kk));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (prev >= 0) mbar_arrive(smem_u32(&empty[prev]));
        prev = stage;
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      mbar_arrive(smem_u32(&empty[prev]));

      // epilogue: row 16*warp + lane/4 (+8), columns 8j + 2(lane%4) (+1)
      const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          if (row >= M) continue;
          const float x0 = acc[4 * j + 2 * h] + b0;
          const float x1 = acc[4 * j + 2 * h + 1] + b1;
          OutT* dst = out + (long long)row * d + col;
          if constexpr (sizeof(OutT) == 2) {
            *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x0, x1);
          } else {
            *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [d, k] bf16, K-major, boxes of 64 k x 128 rows, 128-byte swizzle.
// Returns the CUresult of the encode (CUDA_ERROR_NOT_FOUND without it).
int weight_map(CUtensorMap* map, const void* w, int d, int k) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)d};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t box[2] = {BK, BN};
  const cuuint32_t elem[2] = {1, 1};
  return (int)enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(w), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Codes: cudaErrorInvalidValue for a shape the kernel does not take,
// 10000 + CUresult for a failed tensor-map encode, else the CUDA error
// of the set-up or of the launch.
template <int MODE, typename OutT>
int launch(const void* frames, const void* w_hi, const void* w_lo,
           const float* bias, OutT* out, int n, int s, int d, void* stream) {
  if (s % P != 0 || d % BN != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap hi_map, lo_map;
  const int k = P * P * 3;
  int res = weight_map(&hi_map, w_hi, d, k);
  if (res == 0) res = weight_map(&lo_map, w_lo, d, k);
  if (res != 0) return 10000 + res;
  // the SM count and the shared-memory attribute are a device's own:
  // kept per device, set on the current one (the caller makes the
  // tensors' device current)
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(patch_embed_kernel<MODE, OutT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    sms[dev] = count;
  }
  const int g = s / P;
  const int tiles = ((n * g * g + BM - 1) / BM) * (d / BN);
  const int grid = tiles < sms[dev] ? tiles : sms[dev];
  patch_embed_kernel<MODE, OutT>
      <<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
          hi_map, lo_map, frames, bias, out, n, s, d);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Any P that divides S, any D: mma.sync on the split operands
// ---------------------------------------------------------------------------
//
// A block computes 16 patches x 32 output channels, one m16 tile: each of
// its 4 warps one n8 tile of them, on mma.sync m16n8k16 (bf16 in, f32
// accumulate) over the same three products as the wgmma kernel. The
// block stages its K whole (up to ANY_KC values; past that, in chunks of
// whole row pairs) and once: the A hi/lo tile [16, K] built from the
// frames, each pixel unpacked once for its three channels, and the W'
// hi/lo tile [32, K] from split_patch_weights' operands by 16-byte
// cp.async where P % 4 == 0 (K and each chunk a multiple of 8), else by
// 2-byte loads; K is zero-padded to a multiple of 16 (P = 7: 147 ->
// 160), then one barrier. Rows are padded by 8 bf16 so the 32-bit
// fragment reads (rows g by lanes t) are conflict-free. Ragged D columns
// read zero weights and are masked on store; the bias is added in f32.

constexpr int ANY_BM = 16;              // patches a block (one m16 tile)
constexpr int ANY_BN = 32;              // output channels a block
constexpr int ANY_THREADS = 128;        // 4 warps, one n8 tile each
constexpr int ANY_KC = 192;             // K staged at once (P = 8: all)

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the three channels of pixel (y, x) of image img, 0..255, as the wgmma
// producers compute them
template <int MODE>
__device__ __forceinline__ void pixel3(const void* frames, long long img,
                                       int y, int x, int s, float (&c)[3]) {
  if (MODE == I420) {
    const uint8_t* f = static_cast<const uint8_t*>(frames)
                     + img * (long long)s * s * 3 / 2;
    const float yv = (float)f[(long long)y * s + x];
    const long long coff = (long long)(y / 2) * (s / 2) + x / 2;
    const float u = (float)f[(long long)s * s + coff] - 128.f;
    const float v = (float)f[(long long)s * s * 5 / 4 + coff] - 128.f;
    c[0] = yuv_channel<0>(yv, u, v);
    c[1] = yuv_channel<1>(yv, u, v);
    c[2] = yuv_channel<2>(yv, u, v);
    return;
  }
  const long long at = ((img * s + y) * (long long)s + x) * 3;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    c[i] = MODE == RGB_U8
        ? (float)static_cast<const uint8_t*>(frames)[at + i]
        : static_cast<const float*>(frames)[at + i];
}

// pc: row pairs a chunk; ks: the shared row stride in bf16 elements
template <int MODE, typename OutT>
__global__ void __launch_bounds__(ANY_THREADS)
patch_embed_any_kernel(const void* __restrict__ frames,
                       const __nv_bfloat16* __restrict__ w_hi,
                       const __nv_bfloat16* __restrict__ w_lo,
                       const float* __restrict__ bias, OutT* __restrict__ out,
                       int n, int s, int d, int p, int pc, int ks) {
  // a_hi, a_lo [ANY_BM][ks]; w_hi, w_lo [ANY_BN][ks] (rows along K)
  extern __shared__ __align__(16) unsigned char any_smem[];
  __nv_bfloat16* a_hi = reinterpret_cast<__nv_bfloat16*>(any_smem);
  __nv_bfloat16* a_lo = a_hi + ANY_BM * ks;
  __nv_bfloat16* wh = a_lo + ANY_BM * ks;
  __nv_bfloat16* wl = wh + ANY_BN * ks;
  __shared__ long long img_of[ANY_BM];  // -1 past the last patch
  __shared__ int y_of[ANY_BM], x_of[ANY_BM];
  constexpr bool kLo = MODE != RGB_U8;  // a_lo = 0 for uint8 pixels

  const int g = s / p, gg = g * g, k = 3 * p * p, pairs = (p + 1) / 2;
  const long long m_total = (long long)n * gg;
  const long long m0 = (long long)blockIdx.x * ANY_BM;
  const int n0 = blockIdx.y * ANY_BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const bool vec = p % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(w_hi) | reinterpret_cast<uintptr_t>(w_lo))
       & 15) == 0;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  if (tid < ANY_BM) {
    const long long m = m0 + tid;
    const int cell = (int)((m < m_total ? m : 0) % gg);
    img_of[tid] = m < m_total ? m / gg : -1;
    y_of[tid] = (cell / g) * p;
    x_of[tid] = (cell % g) * p;
  }
  __syncthreads();

  float acc0[4] = {0.f, 0.f, 0.f, 0.f};   // a_hi.w_hi
  float acc1[4] = {0.f, 0.f, 0.f, 0.f};   // a_hi.w_lo + a_lo.w_hi
  for (int pa = 0; pa < pairs; pa += pc) {
    const int pb = min(pa + pc, pairs);
    const int k0 = pa * 6 * p, clen = min(pb * 6 * p, k) - k0;
    const int kp = (clen + 15) & ~15;
    // W' rows n0.., K positions k0.. (zero past D and past clen)
    if (vec) {
      const int cpr = kp / 8;
      for (int i = tid; i < ANY_BN * cpr; i += ANY_THREADS) {
        const int r = i / cpr, c = i % cpr;
        const bool ok = n0 + r < d && 8 * c < clen;
        const long long at = ok ? (long long)(n0 + r) * k + k0 + 8 * c : 0;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(smem_u32(wh + r * ks + 8 * c)), "l"(w_hi + at),
                        "r"(ok ? 16 : 0) : "memory");
        asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(smem_u32(wl + r * ks + 8 * c)), "l"(w_lo + at),
                        "r"(ok ? 16 : 0) : "memory");
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else {
      for (int i = tid; i < ANY_BN * kp; i += ANY_THREADS) {
        const int r = i / kp, c = i % kp;
        const bool ok = n0 + r < d && c < clen;
        const long long at = (long long)(n0 + r) * k + k0 + c;
        wh[r * ks + c] = ok ? w_hi[at] : zero;
        wl[r * ks + c] = ok ? w_lo[at] : zero;
      }
    }
    // the A tile: the K pad, then each pixel of the chunk's rows once,
    // its channels at (row pair, channel, row, px) positions
    for (int i = tid; i < ANY_BM * (kp - clen); i += ANY_THREADS) {
      const int r = i / (kp - clen), c = clen + i % (kp - clen);
      a_hi[r * ks + c] = zero;
      a_lo[r * ks + c] = zero;
    }
    const int py0 = 2 * pa, nr = min(2 * pb, p) - py0;
    for (int i = tid; i < ANY_BM * nr * p; i += ANY_THREADS) {
      const int px = i % p, rest = i / p;
      const int py = py0 + rest % nr, r = rest / nr;
      float x[3] = {0.f, 0.f, 0.f};
      if (img_of[r] >= 0)
        pixel3<MODE>(frames, img_of[r], y_of[r] + py, x_of[r] + px, s, x);
      const int pair = py >> 1, rows = min(2, p - 2 * pair);
      const int at = r * ks + pair * 6 * p + (py & 1) * p + px - k0;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const __nv_bfloat16 hi = __float2bfloat16_rn(x[c]);
        a_hi[at + c * rows * p] = hi;
        if (kLo)
          a_lo[at + c * rows * p] =
              __float2bfloat16_rn(x[c] - __bfloat162float(hi));
      }
    }
    if (vec) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // warp w: output channels n0 + 8w .. + 8 of the 16 patches
    const __nv_bfloat16* wr_hi = wh + (8 * warp + gq) * ks + 2 * t;
    const __nv_bfloat16* wr_lo = wl + (8 * warp + gq) * ks + 2 * t;
    const int ra = gq * ks + 2 * t, rb = ra + 8 * ks;
    for (int kk = 0; kk < kp; kk += 16) {
      const uint32_t ah[4] = {ld32(a_hi + ra + kk), ld32(a_hi + rb + kk),
                              ld32(a_hi + ra + kk + 8),
                              ld32(a_hi + rb + kk + 8)};
      const uint32_t bh0 = ld32(wr_hi + kk), bh1 = ld32(wr_hi + kk + 8);
      mma_bf16(acc0, ah, bh0, bh1);
      mma_bf16(acc1, ah, ld32(wr_lo + kk), ld32(wr_lo + kk + 8));
      if (kLo) {
        const uint32_t al[4] = {ld32(a_lo + ra + kk), ld32(a_lo + rb + kk),
                                ld32(a_lo + ra + kk + 8),
                                ld32(a_lo + rb + kk + 8)};
        mma_bf16(acc1, al, bh0, bh1);
      }
    }
    __syncthreads();
  }

  // accumulator: rows gq and gq + 8, columns 2t and 2t + 1 of the n8 tile
  const int col = n0 + 8 * warp + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long m = m0 + gq + 8 * h;
    if (m >= m_total) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (col + e >= d) continue;
      const float x = acc0[2 * h + e] + acc1[2 * h + e] + bias[col + e];
      if constexpr (sizeof(OutT) == 2) {
        out[m * d + col + e] = __float2bfloat16_rn(x);
      } else {
        out[m * d + col + e] = x;
      }
    }
  }
}

// cudaErrorInvalidValue for a P that does not divide S (or an odd S for
// I420) or a P whose row pair overflows shared memory, else the CUDA
// error of the set-up or of the launch.
template <int MODE, typename OutT>
int launch_any(const void* frames, const void* w_hi, const void* w_lo,
               const float* bias, OutT* out, int n, int s, int d, int p,
               void* stream) {
  if (p < 1 || s % p != 0 || (MODE == I420 && s % 2 != 0) || d < 1)
    return (int)cudaErrorInvalidValue;
  const int pc = ANY_KC / (6 * p) > 1 ? ANY_KC / (6 * p) : 1;
  const int chunk = pc * 6 * p < 3 * p * p ? pc * 6 * p : 3 * p * p;
  const int ks = ((chunk + 15) & ~15) + 8;
  const int smem = 2 * (ANY_BM + ANY_BN) * ks * (int)sizeof(__nv_bfloat16);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        patch_embed_any_kernel<MODE, OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long m = (long long)n * (s / p) * (s / p);
  const dim3 grid((unsigned)((m + ANY_BM - 1) / ANY_BM),
                  (unsigned)((d + ANY_BN - 1) / ANY_BN));
  patch_embed_any_kernel<MODE, OutT>
      <<<grid, ANY_THREADS, smem, (cudaStream_t)stream>>>(
          frames, static_cast<const __nv_bfloat16*>(w_hi),
          static_cast<const __nv_bfloat16*>(w_lo), bias, out, n, s, d, p,
          pc, ks);
  return (int)cudaGetLastError();
}

}  // namespace

// w_hi, w_lo: bf16 [d, 3072] from split_patch_weights; bias f32 [d].
// Return 0 or an error code (see launch).
extern "C" int avede_patch_embed_i420(const uint8_t* packed, const void* w_hi,
                                      const void* w_lo, const float* bias,
                                      void* out, int n, int s, int d,
                                      void* stream) {
  return launch<I420, __nv_bfloat16>(packed, w_hi, w_lo, bias,
                                     static_cast<__nv_bfloat16*>(out), n, s,
                                     d, stream);
}

extern "C" int avede_patch_embed_u8(const uint8_t* frames, const void* w_hi,
                                    const void* w_lo, const float* bias,
                                    float* out, int n, int s, int d,
                                    void* stream) {
  return launch<RGB_U8, float>(frames, w_hi, w_lo, bias, out, n, s, d, stream);
}

extern "C" int avede_patch_embed_f32(const float* frames, const void* w_hi,
                                     const void* w_lo, const float* bias,
                                     float* out, int n, int s, int d,
                                     void* stream) {
  return launch<RGB_F32, float>(frames, w_hi, w_lo, bias, out, n, s, d,
                                stream);
}

// The any-shape kernel's entries: any p that divides s, any d; w_hi, w_lo
// bf16 [d, p*p*3] from split_patch_weights. Return 0 or an error code
// (see launch_any).
extern "C" int avede_patch_embed_any_i420(const uint8_t* packed,
                                          const void* w_hi, const void* w_lo,
                                          const float* bias, void* out, int n,
                                          int s, int d, int p, void* stream) {
  return launch_any<I420, __nv_bfloat16>(packed, w_hi, w_lo, bias,
                                         static_cast<__nv_bfloat16*>(out), n,
                                         s, d, p, stream);
}

extern "C" int avede_patch_embed_any_u8(const uint8_t* frames,
                                        const void* w_hi, const void* w_lo,
                                        const float* bias, float* out, int n,
                                        int s, int d, int p, void* stream) {
  return launch_any<RGB_U8, float>(frames, w_hi, w_lo, bias, out, n, s, d, p,
                                   stream);
}

extern "C" int avede_patch_embed_any_f32(const float* frames,
                                         const void* w_hi, const void* w_lo,
                                         const float* bias, float* out, int n,
                                         int s, int d, int p, void* stream) {
  return launch_any<RGB_F32, float>(frames, w_hi, w_lo, bias, out, n, s, d, p,
                                    stream);
}
