// Hopper (sm_90a) building blocks shared by the bf16 kernels of
// csrc/tiled_attention_sm90.cu (K1, K4, K6) and csrc/fused_mlp_sm90.cu (K5),
// and by csrc/sparsemax.cu (K2) and csrc/decode.cu (K3): mbarriers, bulk
// copies, TMA tile copies and the host-side tensor maps they read,
// wgmma shared-memory descriptors for K-major and MN-major tiles, fences,
// setmaxnreg and the wgmma products in raw PTX. Everything sits in an
// anonymous namespace, so each source that includes it has its own copy.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// Shared-memory layout of a (rows x D) bf16 tile as TMA writes it: boxes of
// kCols columns, each kSpan-byte row swizzled, one box after another. D a
// multiple of 64 takes the 128-byte swizzle (64-column boxes), D = 32 the
// 64-byte one, and any other multiple of 16 (d = 80: five boxes) the 32-byte
// one, so that one descriptor names one swizzle over the whole tile.
template <int D>
struct Tile {
  static_assert(D % 16 == 0, "a head width of whole 16-column boxes");
  static constexpr int kSpan = D % 64 == 0 ? 128 : D == 32 ? 64 : 32;  // bytes per row
  static constexpr int kCols = kSpan / 2;  // columns per box
  static constexpr int kBoxes = D / kCols;
  static constexpr uint64_t kLayout = kSpan == 128 ? 1 : kSpan == 64 ? 2 : 3;  // wgmma's code
  static constexpr CUtensorMapSwizzle kSwizzle =
      kSpan == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : kSpan == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr uint32_t bytes(int rows) { return static_cast<uint32_t>(rows) * D * 2; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, as one bulk copy completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Rows row0 .. row0 + rows - 1 of columns col0 .. col0 + D - 1 of batch item
// b into the tile at `dst`, completing on `bar` (rows past N come as zeros).
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col0, int row0, int b, int rows) {
  using T = Tile<D>;
#pragma unroll
  for (int c = 0; c < T::kBoxes; ++c) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst + c * rows * T::kSpan),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col0 + c * T::kCols), "r"(row0),
        "r"(b)
        : "memory");
  }
}

// Rows row0 .. row0 + rows - 1 of slot `slot` of batch item b from a map
// of `make_head_map` into the tile at `dst`, completing on `bar`. Columns
// past the slot's d and rows past N come as zeros.
template <int D>
__device__ __forceinline__ void tma_head(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int slot, int row0, int b, int rows) {
  using T = Tile<D>;
#pragma unroll
  for (int c = 0; c < T::kBoxes; ++c) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst + c * rows * T::kSpan),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c * T::kCols), "r"(slot),
        "r"(row0), "r"(b)
        : "memory");
  }
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// Operand whose contraction runs along the tile's columns (K-major): k-step
// kk (columns 16 kk ..) of rows r0 .. of a tile of `rows` rows.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int r0, int kk) {
  using T = Tile<D>;
  const int col = kk * 16;
  const uint32_t addr = tile + (col / T::kCols) * rows * T::kSpan + r0 * T::kSpan +
                        (col % T::kCols) * 2;
  return make_desc(addr, 16, 8 * T::kSpan, T::kLayout);
}

// Operand whose contraction runs along the tile's rows (MN-major): k-step kk
// (rows 16 kk ..) over all D columns, the boxes rows * kSpan bytes apart.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  using T = Tile<D>;
  return make_desc(tile + kk * 16 * T::kSpan, rows * T::kSpan, 8 * T::kSpan, T::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of wgmma's registers across it.
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// The products. Accumulator layout of m64nNk16 (f32): thread t of the
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8), columns
// 8 j + 2 (t % 4) (+ 1), at d[4 j + {0, 1}] (row) and d[4 j + {2, 3}] (row
// + 8). A register A operand for k-step kk is the bf16 pairs of
// d[8 kk .. 8 kk + 7] in order.

// D (64 x 64, f32) (+)= A (64 x 16, smem) . B (64 x 16, smem)^T, both
// K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) (+)= A (64 x 16, smem) . B (128 x 16, smem)^T, both
// K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N, f32) += A (64 x 16, bf16 pairs in registers) . B (16 x N,
// smem, MN-major): the register-A products of the attention kernels, one
// for every N = 16 K (K = 1 .. 16, their padded head widths), generated
// here from one asm template. The A pairs and the descriptor are operands
// %0 - %4 and the accumulate flag %5 (read-write copies, so that they come
// first), and the accumulators %6 on, PROBPOSE_RS_ACC<K> naming 8 K of them.
template <int N>
struct WgmmaRs;

#define PROBPOSE_RS_ACC1 "%6, %7, %8, %9, %10, %11, %12, %13"
#define PROBPOSE_RS_ACC2 PROBPOSE_RS_ACC1 ", %14, %15, %16, %17, %18, %19, %20, %21"
#define PROBPOSE_RS_ACC3 PROBPOSE_RS_ACC2 ", %22, %23, %24, %25, %26, %27, %28, %29"
#define PROBPOSE_RS_ACC4 PROBPOSE_RS_ACC3 ", %30, %31, %32, %33, %34, %35, %36, %37"
#define PROBPOSE_RS_ACC5 PROBPOSE_RS_ACC4 ", %38, %39, %40, %41, %42, %43, %44, %45"
#define PROBPOSE_RS_ACC6 PROBPOSE_RS_ACC5 ", %46, %47, %48, %49, %50, %51, %52, %53"
#define PROBPOSE_RS_ACC7 PROBPOSE_RS_ACC6 ", %54, %55, %56, %57, %58, %59, %60, %61"
#define PROBPOSE_RS_ACC8 PROBPOSE_RS_ACC7 ", %62, %63, %64, %65, %66, %67, %68, %69"
#define PROBPOSE_RS_ACC9 PROBPOSE_RS_ACC8 ", %70, %71, %72, %73, %74, %75, %76, %77"
#define PROBPOSE_RS_ACC10 PROBPOSE_RS_ACC9 ", %78, %79, %80, %81, %82, %83, %84, %85"
#define PROBPOSE_RS_ACC11 PROBPOSE_RS_ACC10 ", %86, %87, %88, %89, %90, %91, %92, %93"
#define PROBPOSE_RS_ACC12 PROBPOSE_RS_ACC11 ", %94, %95, %96, %97, %98, %99, %100, %101"
#define PROBPOSE_RS_ACC13 PROBPOSE_RS_ACC12 ", %102, %103, %104, %105, %106, %107, %108, %109"
#define PROBPOSE_RS_ACC14 PROBPOSE_RS_ACC13 ", %110, %111, %112, %113, %114, %115, %116, %117"
#define PROBPOSE_RS_ACC15 PROBPOSE_RS_ACC14 ", %118, %119, %120, %121, %122, %123, %124, %125"
#define PROBPOSE_RS_ACC16 PROBPOSE_RS_ACC15 ", %126, %127, %128, %129, %130, %131, %132, %133"
#define PROBPOSE_RS_F8(i)                                                                    \
  "+f"(d[8 * (i)]), "+f"(d[8 * (i) + 1]), "+f"(d[8 * (i) + 2]), "+f"(d[8 * (i) + 3]),        \
      "+f"(d[8 * (i) + 4]), "+f"(d[8 * (i) + 5]), "+f"(d[8 * (i) + 6]), "+f"(d[8 * (i) + 7])
#define PROBPOSE_RS_OPS1 PROBPOSE_RS_F8(0)
#define PROBPOSE_RS_OPS2 PROBPOSE_RS_OPS1, PROBPOSE_RS_F8(1)
#define PROBPOSE_RS_OPS3 PROBPOSE_RS_OPS2, PROBPOSE_RS_F8(2)
#define PROBPOSE_RS_OPS4 PROBPOSE_RS_OPS3, PROBPOSE_RS_F8(3)
#define PROBPOSE_RS_OPS5 PROBPOSE_RS_OPS4, PROBPOSE_RS_F8(4)
#define PROBPOSE_RS_OPS6 PROBPOSE_RS_OPS5, PROBPOSE_RS_F8(5)
#define PROBPOSE_RS_OPS7 PROBPOSE_RS_OPS6, PROBPOSE_RS_F8(6)
#define PROBPOSE_RS_OPS8 PROBPOSE_RS_OPS7, PROBPOSE_RS_F8(7)
#define PROBPOSE_RS_OPS9 PROBPOSE_RS_OPS8, PROBPOSE_RS_F8(8)
#define PROBPOSE_RS_OPS10 PROBPOSE_RS_OPS9, PROBPOSE_RS_F8(9)
#define PROBPOSE_RS_OPS11 PROBPOSE_RS_OPS10, PROBPOSE_RS_F8(10)
#define PROBPOSE_RS_OPS12 PROBPOSE_RS_OPS11, PROBPOSE_RS_F8(11)
#define PROBPOSE_RS_OPS13 PROBPOSE_RS_OPS12, PROBPOSE_RS_F8(12)
#define PROBPOSE_RS_OPS14 PROBPOSE_RS_OPS13, PROBPOSE_RS_F8(13)
#define PROBPOSE_RS_OPS15 PROBPOSE_RS_OPS14, PROBPOSE_RS_F8(14)
#define PROBPOSE_RS_OPS16 PROBPOSE_RS_OPS15, PROBPOSE_RS_F8(15)

#define PROBPOSE_WGMMA_RS(N, K)                                                            \
  template <>                                                                               \
  struct WgmmaRs<N> {                                                                       \
    static __device__ __forceinline__ void mma(float (&d)[N / 2], const uint32_t* a,       \
                                               uint64_t db) {                              \
      uint32_t a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3], one = 1;                         \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"                             \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"             \
                   PROBPOSE_RS_ACC##K "}, {%0, %1, %2, %3}, %4, p, 1, 1, 1;\n}\n"          \
                   : "+r"(a0), "+r"(a1), "+r"(a2), "+r"(a3), "+l"(db), "+r"(one),          \
                     PROBPOSE_RS_OPS##K);                                                  \
    }                                                                                       \
  };

PROBPOSE_WGMMA_RS(16, 1)
PROBPOSE_WGMMA_RS(32, 2)
PROBPOSE_WGMMA_RS(48, 3)
PROBPOSE_WGMMA_RS(64, 4)
PROBPOSE_WGMMA_RS(80, 5)
PROBPOSE_WGMMA_RS(96, 6)
PROBPOSE_WGMMA_RS(112, 7)
PROBPOSE_WGMMA_RS(128, 8)
PROBPOSE_WGMMA_RS(144, 9)
PROBPOSE_WGMMA_RS(160, 10)
PROBPOSE_WGMMA_RS(176, 11)
PROBPOSE_WGMMA_RS(192, 12)
PROBPOSE_WGMMA_RS(208, 13)
PROBPOSE_WGMMA_RS(224, 14)
PROBPOSE_WGMMA_RS(240, 15)
PROBPOSE_WGMMA_RS(256, 16)

__device__ __forceinline__ uint32_t aligned_base(unsigned char* smem) {
  return (smem_u32(smem) + 1023u) & ~1023u;
}

// The wgmma products of the GEMM kernels, with either operand's majorness.

// D (64 x N, f32) (+)= A (64 x 16) . B (16 x N), N in {128, 192, 256},
// both from shared memory; TA / TB: 0 for an operand whose contraction runs
// along its tile's columns (K-major, desc_k), 1 along its rows (MN-major,
// desc_mn); scale_d = 0 overwrites D.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95 "
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime so that the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 3-D map over `width` bf16 columns of N rows of B items, with element
// strides `row` and `batch`, boxes of `rows` rows and Tile<D>::kCols columns
// with the swizzle the wgmma descriptors expect.
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int width, long long row, int N,
             long long batch, int B, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row) * 2,
                                 static_cast<cuuint64_t>(batch) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Tile<D>::kCols),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            Tile<D>::kSwizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The same over a contiguous (B, N, width) tensor.
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int width, int N, int B, int rows) {
  return make_map<D>(map, ptr, width, width, N, static_cast<long long>(width) * N, B, rows);
}

// 4-D map over head slots of d bf16 columns each: element (c, s, n, b) at
// ptr + b * batch + n * row + s * d + c, c < d, s < slots (a packed qkv
// projection is 3 H slots, a (B, N, C) context H), boxes of Tile<D>::kCols
// columns of `rows` rows of one slot, D the padded width 16 ceil(d / 16).
// A box's columns past d come as zeros, so a tile of a head whose d is
// 8 (mod 16) holds nothing of the neighbouring slot.
template <int D>
int make_head_map(CUtensorMap* map, const void* ptr, int d, int slots, int N, long long row,
                  int B, long long batch, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(slots),
                              static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(row) * 2,
                                 static_cast<cuuint64_t>(batch) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Tile<D>::kCols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            Tile<D>::kSwizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
