// Flash attention for Hopper (sm_90a) at long sequences: the bf16 serving
// entry's function on wgmma, TMA and an mbarrier ring.
//
// Replaces avede_tpu/ops/attention.py: flash_attention / _flash_kernel
// (the pl.pallas_call at :85), as flash_attention.cu's bf16 entry does,
// for the shapes ops/attention.py routes here: hd = 64, 72 or 88 at L at
// or above its crossover (BLIP-base's and OWL-ViT's L = 577, BLIP-2's
// L = 257, Kimi-VL's MoonViT L = 2304 at hd = 72). The contract is that
// entry's: bf16 q, k, v [B, L, H, hd] with
// token rows ldi elements apart (H*hd for contiguous heads, 3*H*hd for the
// thirds of a fused qkv, read in place), bf16 [B, L, H*hd] out, softmax
// and accumulation in f32, P.V with P split into bf16 hi + lo terms.
//
// Bound on the H100: at [16, 577, 12, 64] the function moves 56.7 MB for
// 16.4 GFLOP (Q.K^T and P.V once each), 290 FLOP a byte, just under the
// bf16 ridge (~295); the lo term takes the tensor work to 1.5x that, and
// the softmax's instructions (an exp and some eight more a score) take
// about three quarters of the tensor cores' time at hd = 64 to issue, so
// the design is bound by issue: tensor-core products, which only wgmma
// issues at the full rate, with the softmax running beside them.
// The mma.sync kernel of flash_attention.cu ran these shapes at ~100
// TFLOP/s, each 64-row q tile fetching every K/V tile again. The design:
// - A block is one producer warpgroup (one thread issues every TMA load;
//   setmaxnreg cuts its registers to 40) and two consumer warpgroups
//   (raised to 232), each owning 64 rows of a 128-row q tile,
//   so a K/V tile in shared memory serves 128 queries. A persistent grid
//   of one block an SM walks (pair, q tile) items; the producer loads the
//   next item's Q and K/V tiles while the consumers finish this one.
//   ptxas reports the kernel at 168 registers (what 384 threads leave)
//   but allocates each branch within its setmaxnreg count: without the
//   pair the consumers spilled.
// - Q, K and V arrive by TMA through 4-d tensor maps over [B, L, H, hd]
//   (dims hd, H, L, B; L's stride ldi * 2 bytes), so the fused-qkv thirds
//   are read in place and rows past L come back zero. Columns 0-63 land
//   in a panel of 128-byte rows with the 128-byte swizzle; at hd = 88
//   columns 64-95 land in a second panel of 64-byte rows with the 64-byte
//   swizzle (the map's dim 0 is 88 wide, so columns 88-95 are zeros, not
//   the next head). hd = 72 is the same 96-column layout: the map's dim 0
//   is 72 wide, so columns 72-95 of the second panel are zeros; the
//   products and the softmax are hd = 88's, only the scale, the map and
//   the columns written (72) differ. K/V tiles of 128 keys sit in a ring
//   (4 stages at hd = 64, 3 at 72 and 88) with full and empty mbarriers;
//   Q in two buffers.
// - S = Q.K^T: wgmma m64nNk16 with Q and K both K-major in shared
//   memory, 4 k16 steps in the first panel (+2 in the second at hd = 88).
// - O += P.V: wgmma with A = P from registers (the S accumulator's
//   layout is the A fragment's: converted to bf16 hi and lo, two products
//   into one f32 accumulator, which keeps the result within one bf16 ulp
//   + 1e-5 of f32 attention) and B = V from shared memory with the
//   transpose bit (V's rows are keys, hd contiguous). At hd = 88 the
//   output is 64 + 32 columns (n64 on the first panel, n32 on the second).
// - Overlap: a tile's S is issued together with the previous tile's P.V,
//   and its online softmax (row max and sum by quad shuffles, exp2 on the
//   SFUs) runs while that P.V is on the tensor cores. The two consumer
//   warpgroups take turns to issue (named barriers), so one's softmax
//   runs beside the other's products instead of both computing the same
//   stage at once.
// - Only the last K/V tile masks keys past L, and it computes its live
//   keys rounded up to 16 (L = 577: 80 of its 128 rows; L = 257: 16).
// - Epilogue: each warpgroup normalises by the row sums, stages its 64
//   rows in shared memory and writes 16-byte chunks of rows < L and
//   columns < hd.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 128;        // query rows an item: two warpgroups of 64
constexpr int KT = 128;        // keys a K/V tile
constexpr int THREADS = 384;   // a producer and two consumer warpgroups
constexpr int P0 = KT * 128;   // bytes of a panel of 64 columns (128-B rows)
constexpr int P1 = KT * 64;    // bytes of a panel of 32 columns (64-B rows)
constexpr int MAX_DEVICES = 64;  // cards with their own launch state

// Shared memory of a block at a padded head width HP (64 or 96): two Q
// buffers, the K/V ring, and each consumer warpgroup's staged output.
// Every tile starts on a 1024-byte boundary (the 128-byte swizzle's
// period).
template <int HP>
struct Lay {
  static constexpr int TILE = HP == 96 ? P0 + P1 : P0;   // one 128-row tile
  static constexpr int STAGES = HP == 96 ? 3 : 4;
  static constexpr int OUT = 64 * HP * 2;
  static constexpr int KV = 2 * TILE;                    // ring offset
  static constexpr int STG = KV + STAGES * 2 * TILE;     // staging offset
  static constexpr int BYTES = STG + 2 * OUT + 1024;     // + alignment
};

struct Maps {
  CUtensorMap q[2], k[2], v[2];  // [panel]: columns 0-63, 64-95
};

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

// box (columns c0.., head h, rows r0.., batch b) of a [B, L, H, hd] map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int h, int r0, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(h),
         "r"(r0), "r"(b), "r"(bar) : "memory");
}

// wgmma descriptor of a panel as the TMA swizzled it: SW = 128 (128-byte
// rows, 8-row groups 1024 bytes apart) or 64 (64-byte rows, 512), the
// group stride in the stride field. A K-major operand (Q, K) leaves the
// leading field at 1 (unused with a swizzle). An MN-major one (V, read
// with the transpose bit) is one swizzle atom wide (64 or 32 columns), so
// its leading field, the stride between atoms along MN, is never used
// either; it carries the group stride too (MN = true).
template <int SW, bool MN = false>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t group = 8 * SW >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((MN ? group : 1) << 16)
       | (group << 32) | ((uint64_t)(SW == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most W committed groups of this warpgroup are in flight
template <int W>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(W) : "memory");
}

// pin registers after a wait, so no use of them moves above the wait
template <int N>
__device__ __forceinline__ void keep(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void keep(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(x[i][e]) :: "memory");
}

// named barriers over the two consumer warpgroups (256 threads)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (+)= A.B^T, A and B in shared memory (K-major), 64 x N, k = 16;
// N a multiple of 16
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 128)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  if constexpr (N == 112)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, %56, %57, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "l"(da), "l"(db), "r"(scale_d));
  if constexpr (N == 96)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(scale_d));
  if constexpr (N == 80)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(da), "l"(db), "r"(scale_d));
  if constexpr (N == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  if constexpr (N == 48)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(scale_d));
  if constexpr (N == 32)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  if constexpr (N == 16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
}

// D += A.B, A from registers (the m16n8k16 A fragment of each warp's 16
// rows), B = V in shared memory, MN-major (transposed), 64 x N, k = 16
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  if constexpr (N == 32)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

// Element offset of (row, 16-byte chunk) in a warpgroup's staged output,
// 64 rows of HP columns, chunks XOR-swizzled so a warp's 4-byte writes
// (8 rows x 4 lanes) hit 32 distinct banks: 128-byte rows by row & 7;
// 192-byte rows (row r at bank group 4 (r & 1)) by (r >> 1) & 3, within
// the chunk's aligned group of 4.
template <int HP>
__device__ __forceinline__ int swz(int row, int chunk) {
  if constexpr (HP == 64) return row * 64 + ((chunk ^ (row & 7)) << 3);
  return row * HP + ((chunk ^ ((row >> 1) & 3)) << 3);
}

// A consumer thread holds rows g = lane / 4 and g + 8 of its warp's 16:
// S[4j + 2i + e] is key 8j + 2(lane % 4) + e of row g + 8i, and O[4j + 2i
// + e] likewise column 8j + 2(lane % 4) + e.

// issue S = Q.K^T over the first N keys of the K tile at k (no fence, no
// commit)
template <int HP, int N>
__device__ __forceinline__ void issue_s(float (&s)[N / 2], uint32_t q0,
                                        uint32_t q1, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<N>(s, desc<128>(q0 + 32 * kk), desc<128>(k + 32 * kk), kk > 0);
  if constexpr (HP == 96) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_ss<N>(s, desc<64>(q1 + 32 * kk), desc<64>(k + P0 + 32 * kk), 1);
  }
}

// issue O += (P hi + P lo).V over the first N keys of the V tile at v
template <int HP, int N>
__device__ __forceinline__ void issue_pv(float (&acc)[HP / 2],
                                         uint32_t (&ph)[N / 16][4],
                                         uint32_t (&pl)[N / 16][4],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t vr = v + 16 * kk * 128;
    wgmma_rs<64>(acc, ph[kk], desc<128, true>(vr));
    wgmma_rs<64>(acc, pl[kk], desc<128, true>(vr));
    if constexpr (HP == 96) {
      const uint32_t vr1 = v + P0 + 16 * kk * 64;
      wgmma_rs<32>(acc + 32, ph[kk], desc<64, true>(vr1));
      wgmma_rs<32>(acc + 32, pl[kk], desc<64, true>(vr1));
    }
  }
}

// online softmax of one tile's scores in place: keys at or past `keys`
// score -inf when MASK; m, l updated, alpha the factor for O
template <int N, bool MASK>
__device__ __forceinline__ void softmax(float (&s)[N / 2], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        int keys, float sl2, int t) {
  if constexpr (MASK) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t + (e & 1) >= keys) s[4 * j + e] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  float ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = ex2((m[i] - mx[i]) * sl2);
    ms[i] = mx[i] * sl2;
    m[i] = mx[i];
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, -ms[e >> 1]));
      rs[e >> 1] += s[4 * j + e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
}

template <int HP>
__device__ __forceinline__ void rescale(float (&acc)[HP / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < HP / 8; ++n) {
    acc[4 * n] *= alpha[0]; acc[4 * n + 1] *= alpha[0];
    acc[4 * n + 2] *= alpha[1]; acc[4 * n + 3] *= alpha[1];
  }
}

// P (the exponentiated scores) -> the bf16 A fragments of its hi and lo
// terms, one k16 step (16 keys) a row of ph, pl
template <int N>
__device__ __forceinline__ void split(const float (&s)[N / 2],
                                      uint32_t (&ph)[N / 16][4],
                                      uint32_t (&pl)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a)
      split2(s[8 * kk + 2 * a], s[8 * kk + 2 * a + 1], ph[kk][a], pl[kk][a]);
}

// The two consumer warpgroups take turns to issue their products
// (bar_sync on their own barrier, bar_arrive on the other's), so one's
// softmax runs while the other's products keep the tensor cores busy,
// rather than both computing the same stage at once.
struct Turns {
  int mine, other;
  __device__ __forceinline__ void begin() const { bar_sync(mine); }
  __device__ __forceinline__ void end() const { bar_arrive(other); }
};

// What a consumer warpgroup carries from one K/V tile to the next.
template <int HP>
struct Carry {
  float acc[HP / 2];
  float m[2], l[2];
  uint32_t ph[KT / 16][4], pl[KT / 16][4];   // P of the previous tile
};

// A full tile (K at k): its S is issued together with P.V of the
// previous tile (V at pv; none for the item's FIRST tile), in one turn,
// and its softmax runs while that P.V is on the tensor cores. Releases
// the previous tile's stage (prev_empty) once its P.V is done; this
// tile's P is left in c for the next tile's turn.
template <int HP, bool FIRST>
__device__ __forceinline__ void full_tile(Carry<HP>& c, uint32_t q0,
                                          uint32_t q1, uint32_t k,
                                          uint32_t pv, float sl2, int t,
                                          const Turns& turns,
                                          uint32_t prev_empty) {
  float s[KT / 2];
  float alpha[2];
  turns.begin();
  wg_fence();
  issue_s<HP, KT>(s, q0, q1, k);
  wg_commit();
  if constexpr (!FIRST) {
    issue_pv<HP, KT>(c.acc, c.ph, c.pl, pv);
    wg_commit();
  }
  turns.end();
  wg_wait<FIRST ? 0 : 1>();
  keep(s);
  softmax<KT, false>(s, c.m, c.l, alpha, KT, sl2, t);
  wg_wait<0>();
  keep(c.acc);
  keep(c.ph);
  keep(c.pl);
  if constexpr (!FIRST) mbar_arrive(prev_empty);
  rescale<HP>(c.acc, alpha);
  split<KT>(s, c.ph, c.pl);
}

// The item's last tile (K at k, V at v), R of its keys (`keys` live, R =
// keys rounded up to 16): its S with P.V of the previous tile (none when
// it is the FIRST) in one turn, then its own P.V in a second. Releases Q
// (q_empty), the previous tile's stage and this one's.
template <int HP, int R, bool FIRST>
__device__ __forceinline__ void last_tile(Carry<HP>& c, uint32_t q0,
                                          uint32_t q1, uint32_t k,
                                          uint32_t v, uint32_t pv, int keys,
                                          float sl2, int t,
                                          const Turns& turns,
                                          uint32_t q_empty,
                                          uint32_t prev_empty,
                                          uint32_t empty) {
  float s[R / 2];
  float alpha[2];
  turns.begin();
  wg_fence();
  issue_s<HP, R>(s, q0, q1, k);
  wg_commit();
  if constexpr (!FIRST) {
    issue_pv<HP, KT>(c.acc, c.ph, c.pl, pv);
    wg_commit();
  }
  turns.end();
  wg_wait<FIRST ? 0 : 1>();
  keep(s);
  mbar_arrive(q_empty);                 // every S of the item is done
  softmax<R, true>(s, c.m, c.l, alpha, keys, sl2, t);
  wg_wait<0>();
  keep(c.acc);
  keep(c.ph);
  keep(c.pl);
  if constexpr (!FIRST) mbar_arrive(prev_empty);
  rescale<HP>(c.acc, alpha);
  uint32_t ph[R / 16][4], pl[R / 16][4];
  split<R>(s, ph, pl);
  turns.begin();
  wg_fence();
  issue_pv<HP, R>(c.acc, ph, pl, v);
  wg_commit();
  turns.end();
  wg_wait<0>();
  keep(c.acc);
  keep(ph);
  keep(pl);
  mbar_arrive(empty);
}

template <int HD, int HP>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ Maps maps,
                   __nv_bfloat16* __restrict__ out, int B, int L, int H,
                   float sl2) {
  using Y = Lay<HP>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t qfull[2], qempty[2];
  __shared__ __align__(8) uint64_t full[Y::STAGES], empty[Y::STAGES];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int nq = (L + QT - 1) / QT;          // q tiles a pair
  const int nk = (L + KT - 1) / KT;          // K/V tiles a pair
  const int items = B * H * nq;
  // the warpgroup's index, broadcast from lane 0 so the compiler knows it
  // is uniform (the products are issued under conditions derived from it)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(smem_u32(&qfull[i]), 1);      // the producer's expect_tx
      mbar_init(smem_u32(&qempty[i]), 256);   // every consumer thread
    }
    for (int i = 0; i < Y::STAGES; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&empty[i]), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer warpgroup: one thread issues the TMA ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0, item = blockIdx.x; item < items;
           ++it, item += gridDim.x) {
        const int pair = item / nq, qt = item % nq;
        const int b = pair / H, h = pair % H;
        const int qb = it & 1;
        mbar_wait(smem_u32(&qempty[qb]), ((it >> 1) & 1) ^ 1);
        const uint32_t qf = smem_u32(&qfull[qb]);
        const uint32_t qa = smem_u32(base + qb * Y::TILE);
        mbar_expect_tx(qf, Y::TILE);
        tma_load(qa, &maps.q[0], 0, h, qt * QT, b, qf);
        if constexpr (HP == 96)
          tma_load(qa + P0, &maps.q[1], 64, h, qt * QT, b, qf);
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const uint32_t fb = smem_u32(&full[stage]);
          const uint32_t kb = smem_u32(base + Y::KV + stage * 2 * Y::TILE);
          mbar_expect_tx(fb, 2 * Y::TILE);
          tma_load(kb, &maps.k[0], 0, h, kt * KT, b, fb);
          tma_load(kb + Y::TILE, &maps.v[0], 0, h, kt * KT, b, fb);
          if constexpr (HP == 96) {
            tma_load(kb + P0, &maps.k[1], 64, h, kt * KT, b, fb);
            tma_load(kb + Y::TILE + P0, &maps.v[1], 64, h, kt * KT, b, fb);
          }
          if (++stage == Y::STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups: 64 query rows each ----------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;
    const int wt = threadIdx.x & 127, warp = wt >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    __nv_bfloat16* stg =
        reinterpret_cast<__nv_bfloat16*>(base + Y::STG + cw * Y::OUT);
    const Turns turns{3 + cw, 4 - cw};
    if (cw == 1) bar_arrive(3);           // the first turn is the other's
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0, item = blockIdx.x; item < items;
         ++it, item += gridDim.x) {
      const int pair = item / nq, qt = item % nq;
      const int b = pair / H, h = pair % H;
      const int r0 = qt * QT + cw * 64;       // this warpgroup's first row
      const bool live = r0 < L;
      const int qb = it & 1;
      const uint32_t qa = smem_u32(base + qb * Y::TILE);
      const uint32_t q0 = qa + cw * 64 * 128, q1 = qa + P0 + cw * 64 * 64;
      mbar_wait(smem_u32(&qfull[qb]), (it >> 1) & 1);
      if (!live) {
        // no live rows: only the turns and releases of a live warpgroup
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(smem_u32(&full[stage]), phase);
          for (int n = kt + 1 < nk ? 1 : 2; n > 0; --n) {
            turns.begin();
            turns.end();
          }
          mbar_arrive(smem_u32(&empty[stage]));
          if (++stage == Y::STAGES) { stage = 0; phase ^= 1; }
        }
        mbar_arrive(smem_u32(&qempty[qb]));
        continue;
      }
      auto kv = [&](int i) {
        return smem_u32(base + Y::KV + i * 2 * Y::TILE);
      };
      Carry<HP> cr;
#pragma unroll
      for (int i = 0; i < HP / 2; ++i) cr.acc[i] = 0.f;
      cr.m[0] = cr.m[1] = -INFINITY;
      cr.l[0] = cr.l[1] = 0.f;
      int prev = 0;                            // the previous tile's stage
      for (int kt = 0; kt + 1 < nk; ++kt) {
        mbar_wait(smem_u32(&full[stage]), phase);
        if (kt == 0)
          full_tile<HP, true>(cr, q0, q1, kv(stage), 0, sl2, t, turns, 0);
        else
          full_tile<HP, false>(cr, q0, q1, kv(stage), kv(prev) + Y::TILE,
                               sl2, t, turns, smem_u32(&empty[prev]));
        prev = stage;
        if (++stage == Y::STAGES) { stage = 0; phase ^= 1; }
      }
      // the last tile, its live keys rounded up to 16
      mbar_wait(smem_u32(&full[stage]), phase);
      {
        const int keys = L - (nk - 1) * KT;
        const uint32_t k = kv(stage), pv = kv(prev) + Y::TILE;
        const uint32_t qe = smem_u32(&qempty[qb]);
        const uint32_t pe = smem_u32(&empty[prev]);
        const uint32_t e = smem_u32(&empty[stage]);
#define AVEDE_LAST(R)                                                      \
  case R:                                                                  \
    if (nk == 1)                                                           \
      last_tile<HP, R, true>(cr, q0, q1, k, k + Y::TILE, pv, keys, sl2, t, \
                             turns, qe, pe, e);                            \
    else                                                                   \
      last_tile<HP, R, false>(cr, q0, q1, k, k + Y::TILE, pv, keys, sl2,   \
                              t, turns, qe, pe, e);                        \
    break;
        switch ((keys + 15) & ~15) {
          AVEDE_LAST(16) AVEDE_LAST(32) AVEDE_LAST(48) AVEDE_LAST(64)
          AVEDE_LAST(80) AVEDE_LAST(96) AVEDE_LAST(112) AVEDE_LAST(128)
        }
#undef AVEDE_LAST
      }
      if (++stage == Y::STAGES) { stage = 0; phase ^= 1; }
      const float* acc = cr.acc;
      const float* l = cr.l;

      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float r = l[i];
        r += __shfl_xor_sync(0xffffffffu, r, 1);
        r += __shfl_xor_sync(0xffffffffu, r, 2);
        inv[i] = 1.f / r;
      }
      // the warpgroup's last reads of its staging rows are done
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
      const int r = warp * 16 + g;
#pragma unroll
      for (int n = 0; n < HP / 8; ++n) {
        *reinterpret_cast<uint32_t*>(&stg[swz<HP>(r, n) + 2 * t]) =
            pack_bf16(acc[4 * n] * inv[0], acc[4 * n + 1] * inv[0]);
        *reinterpret_cast<uint32_t*>(&stg[swz<HP>(r + 8, n) + 2 * t]) =
            pack_bf16(acc[4 * n + 2] * inv[1], acc[4 * n + 3] * inv[1]);
      }
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
      constexpr int HC = HD / 8;                // chunks of the head
      __nv_bfloat16* dst = out + ((long long)b * L * H + h) * HD;
      for (int i = wt; i < 64 * HC; i += 128) {
        const int row = i / HC, c = i % HC;
        if (r0 + row < L)
          *reinterpret_cast<uint4*>(dst + (long long)(r0 + row) * H * HD
                                    + c * 8) =
              *reinterpret_cast<const uint4*>(&stg[swz<HP>(row, c)]);
      }
    }
    // the other warpgroup's last arrival on barrier 3 has no turn after it
    if (cw == 0) bar_sync(3);
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

// [B, L, H, hd] bf16, token rows ldi elements apart: boxes of `cols`
// columns x one head x 128 rows x one batch, with the swizzle `sw`; rows
// past L and columns past hd read as zeros. Returns the CUresult of the
// encode (CUDA_ERROR_NOT_FOUND without it).
int head_map(CUtensorMap* map, const void* p, int B, int L, int H, int hd,
             int ldi, int cols, CUtensorMapSwizzle sw) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)ldi * 2,
                                 (cuuint64_t)L * ldi * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, KT, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return (int)enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(p), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Codes: 10000 + CUresult for a failed tensor-map encode, else the CUDA
// error of the set-up or of the launch.
template <int HD, int HP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int L, int H, int ldi, void* stream) {
  using Y = Lay<HP>;
  Maps maps = {};
  const void* src[3] = {q, k, v};
  CUtensorMap* dst[3] = {maps.q, maps.k, maps.v};
  for (int i = 0; i < 3; ++i) {
    int res = head_map(&dst[i][0], src[i], B, L, H, HD, ldi, 64,
                       CU_TENSOR_MAP_SWIZZLE_128B);
    if (res == 0 && HP == 96)
      res = head_map(&dst[i][1], src[i], B, L, H, HD, ldi, 32,
                     CU_TENSOR_MAP_SWIZZLE_64B);
    if (res != 0) return 10000 + res;
  }
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
      err = cudaFuncSetAttribute(flash_wgmma_kernel<HD, HP>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Y::BYTES);
    if (err != cudaSuccess) return (int)err;
    sms[dev] = count;
  }
  const int items = B * H * ((L + QT - 1) / QT);
  const int grid = items < sms[dev] ? items : sms[dev];
  const float sl2 = 1.4426950408889634f / sqrtf((float)HD);
  flash_wgmma_kernel<HD, HP><<<grid, THREADS, Y::BYTES,
                               (cudaStream_t)stream>>>(
      maps, static_cast<__nv_bfloat16*>(o), B, L, H, sl2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 [B, L, H, D] with token rows ldi elements apart (ldi >=
// H*D, a multiple of 8, each pointer 16-byte aligned); o: contiguous
// bf16 [B, L, H*D]. Returns 0 or an error code (see launch_wgmma), or
// cudaErrorInvalidValue for D not in {64, 72, 88} or a bad shape.
extern "C" int avede_flash_attention_wgmma_bf16(const void* q, const void* k,
                                                const void* v, void* o, int B,
                                                int L, int H, int D, int ldi,
                                                void* stream) {
  if ((D != 64 && D != 72 && D != 88) || B < 1 || L < 1 || H < 1 ||
      ldi < H * D || ldi % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (D == 64) return launch_wgmma<64, 64>(q, k, v, o, B, L, H, ldi, stream);
  if (D == 72) return launch_wgmma<72, 96>(q, k, v, o, B, L, H, ldi, stream);
  return launch_wgmma<88, 96>(q, k, v, o, B, L, H, ldi, stream);
}
