// Multi-head attention in bf16 for Hopper (sm_90a), read straight from the
// packed qkv with TMA and multiplied with wgmma: kernel K4 (row-tiled, long
// sequences, forward and backward) and K1's bf16 forward for N <= 256 (the
// ViT trunks' short sequences). K4's backward serves K1's bf16 shapes too.
//
// Replaces the TPU kernels `_tiled_fwd_kernel` and `_tiled_bwd_kernel`
// (probpose_pytorch_tpu/ops/pallas/attention_tiled.py:119-192), which the JAX
// package's `packed_attention` takes wherever the packed kernel's (N, N)
// scores do not fit (a ViT trunk on 768 x 768 inputs, N = 2304), and, in
// bf16 with d in {32, 64, 80, 128}, `_packed_fwd_kernel` and `_packed_bwd_kernel`
// (attention_kernel.py:120-191). The float32 path stays on the CUDA cores in
// csrc/tiled_attention.cu and csrc/packed_attention.cu.
//
// Short-sequence forward (N <= 256, e.g. N = 192, d = 64): ~100 FLOP per
// byte, under the ~295 FLOP/byte ridge, so it is bound by reading qkv and
// writing the context, not by the products. A block is one warpgroup that
// owns 64 query rows of one (b, h) (N = 192 fills three blocks with no
// padded row); one TMA barrier brings its Q rows and the head's whole K and
// V (56 KB at N = 192, d = 64), so three blocks share an SM and one block's
// loads overlap another's math; the blocks of one head run side by side and
// share its K and V through L2. S = Q K^T by wgmma m64n64k16 over the keys
// padded to a multiple of 64 stays in registers, so the softmax is exact in
// one pass; P is normalised and rounded to bf16 before P.V, the TPU kernel's
// order, and fed as wgmma's register A operand.
//
// What it computes, per (batch b, head h), with q, k, v the column slices of
// the qkv-major (B, N, 3C) projection and the context written h-major into
// (B, N, C): ctx = softmax_f32(q k^T * scale) v, the softmax exact in f32, P
// rounded to bf16 before P.V, f32 sums. The backward gives dqkv (B, N, 3C)
// with dS = round(P * (dP - D) * scale), dQ = dS K, dK = dS^T Q and
// dV = round(P)^T dO, f32 sums.
//
// What bounds it on an H100: at (64, 2304, 1152) the forward does two
// products of 2 N^2 d FLOP per (b, h) against ~0.45 GB of qkv in and context
// out, ~1,100 FLOP per byte, far above the ~295 FLOP/byte ridge: it is bound
// by operations, and only wgmma reaches the card's bf16 rate. So:
//
// Forward, one sweep over the keys (online softmax). A block owns 128 query
// rows of one (b, h): two consumer warpgroups of 64 rows and one producer
// warpgroup whose single thread keeps a ring of K/V tiles of 128 keys in
// flight with TMA (3-D tensor map over (B, N, 3C); rows past N arrive as
// zeros). Per tile: S = Q K^T by wgmma m64n128k16 from shared memory into
// registers; the row max and sum over the accumulator's quads; P =
// exp2(S * scale * log2 e - m), rounded to bf16 in registers and fed as
// wgmma's register A operand against V (read MN-major); O is rescaled in
// registers when the max grows and divided by l once at the end. It also
// writes, when asked, the row log-sum-exp lse = m * scale + log l, which the
// backward uses instead of a statistics sweep. This rounds exp(s - m_running)
// rather than the TPU's normalised P; the difference stays within the K1/K4
// bound (plain twin: tiled_attention_online_reference).
//
// Backward, two kernels, seven products (nine with the TPU's D below), no
// atomics (two runs give the same bits):
//   dQ kernel (128 query rows a block, K and V streamed in tiles of 64 keys):
//     D for its rows, kept in a (B, H, N) f32 buffer; per tile S = Q K^T,
//     dP = dO V^T, P = exp(S * scale - lse), dS = round(P * (dP - D) *
//     scale) in registers, dQ += dS K. D is rowsum(dP * P) over the
//     unrounded P, the TPU's order, from a first sweep over the key tiles
//     (S and dP only) at N <= 256 (`exact_d`), and rowsum(dO * O) past that.
//   dK/dV kernel (128 keys a block, Q, dO and their lse / D streamed in tiles
//     of 64 rows): S^T = K Q^T, dP^T = V dO^T, dV += round(P^T) dO,
//     dK += dS^T Q; dK and dV stay in f32 registers and are written once.
// D from dO * O is the FlashAttention identity; the TPU sums dP * P over the
// unrounded P, so the two differ by the bf16 rounding of O. That is within
// the bound at N = 2304, but at N = 192 it moved K1's backward 2 bf16 ulps
// from the TPU-order plain version on one of eight draws, so short
// sequences pay the second sweep (two products a tile) for the TPU's D.
//
// Shared-memory tiles carry TMA's 128-byte swizzle (64-byte at d = 32), the
// layout the wgmma descriptors name; d = 128 loads each tile as two 64-column
// boxes. Head widths d in {32, 64, 80, 128}. d = 80 (the vit-h preset) is 160
// bytes a row, past the 128-byte swizzle's span and no multiple of it, and a
// wgmma descriptor names one swizzle: its tiles are five 16-column boxes of
// the 32-byte swizzle from one tensor map, so every product keeps one
// descriptor per operand (QK^T's k = 80 is five k16 steps, one a box; P.V
// is one m64n80k16 whose B operand walks the boxes by its leading offset).
// The 32-byte swizzle reads an 8 x 16-byte core matrix without bank
// conflicts as the wider ones do; the TMA copies are 32-byte rows, five a
// tile.
//
// Plain-C interface, loaded with ctypes (ops/kernels/attention_tiled.py).
// Every entry point returns a cudaError_t as int (0 = success).

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kStages = 2;     // depth of every TMA ring
constexpr int kBlockRows = 128;
constexpr int kTileRows = 64;  // keys per dQ step, query rows per dK/dV step
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Rs;
template <>
struct Rs<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t* a, uint64_t b) {
    wgmma_rs_n32(d, a, b);
  }
};
template <>
struct Rs<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t* a, uint64_t b) {
    wgmma_rs_n64(d, a, b);
  }
};
template <>
struct Rs<80> {
  static __device__ __forceinline__ void mma(float (&d)[40], const uint32_t* a, uint64_t b) {
    wgmma_rs_n80(d, a, b);
  }
};
template <>
struct Rs<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t* a, uint64_t b) {
    wgmma_rs_n128(d, a, b);
  }
};

// Shared memory: tiles at 1024-byte boundaries (the swizzle's period), then
// the mbarriers, then f32 row statistics.
template <int D>
struct Fwd {
  static constexpr uint32_t kQ = Tile<D>::bytes(kBlockRows);
  static constexpr uint32_t kKV = Tile<D>::bytes(kBlockRows);  // one K or V tile
  static constexpr uint32_t kBars = kQ + kStages * 2 * kKV;
  static constexpr size_t kSmem = 1024 + kBars + 8 * (1 + 2 * kStages);
};

template <int D>
struct Dq {
  static constexpr uint32_t kQ = Tile<D>::bytes(kBlockRows);  // Q, then dO
  static constexpr uint32_t kKV = Tile<D>::bytes(kTileRows);
  static constexpr uint32_t kBars = 2 * kQ + kStages * 2 * kKV;
  static constexpr uint32_t kStats = kBars + 8 * (1 + 2 * kStages);
  static constexpr size_t kSmem = 1024 + kStats + 2 * kBlockRows * 4;
};

template <int D>
struct Dkv {
  static constexpr uint32_t kKV = Tile<D>::bytes(kBlockRows);  // K, then V
  static constexpr uint32_t kQ = Tile<D>::bytes(kTileRows);    // one Q or dO tile
  static constexpr uint32_t kBars = 2 * kKV + kStages * 2 * kQ;
  static constexpr uint32_t kStats = kBars + 8 * (1 + 2 * kStages);
  static constexpr size_t kSmem = 1024 + kStats + kStages * 2 * kTileRows * 4;
};


// ----------------------------------------------------------------- forward

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap qkv_map, bf16* __restrict__ out,
               float* __restrict__ lse, int N, int C, int H, int ts, int hs, float scale) {
  using L = Fwd<D>;
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  const uint32_t q_s = base;
  const uint32_t kv_s = base + L::kQ;  // stage s: K, then V
  const uint32_t q_bar = base + L::kBars;
  const uint32_t full = q_bar + 8;  // full(s) = full + 8 s
  const uint32_t empty = full + 8 * kStages;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * kBlockRows;
  const int n_tiles = (N + kBlockRows - 1) / kBlockRows;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every copy
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_bar, L::kQ);
      tma_tile<D>(q_s, &qkv_map, q_bar, h * hs, row0, b, kBlockRows);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty + 8 * s, ((j / kStages) - 1) & 1);
        const uint32_t k_s = kv_s + s * 2 * L::kKV;
        mbar_expect_tx(full + 8 * s, 2 * L::kKV);
        tma_tile<D>(k_s, &qkv_map, full + 8 * s, ts + h * hs, j * kBlockRows, b, kBlockRows);
        tma_tile<D>(k_s + L::kKV, &qkv_map, full + 8 * s, 2 * ts + h * hs, j * kBlockRows, b,
                    kBlockRows);
      }
    }
  } else {  // consumers: 64 query rows each
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int g = (tid % 32) / 4;
    const int t = tid % 4;
    const float sl2 = scale * kLog2e;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running row max of the raw scores
    float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums
    mbar_wait(q_bar, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(full + 8 * s, (j / kStages) & 1);
      const uint32_t k_s = kv_s + s * 2 * L::kKV;
      const uint32_t v_s = k_s + L::kKV;

      float sc[64];  // S = Q K^T, 64 rows x 128 keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128(sc, desc_k<D>(q_s, kBlockRows, wg * 64, kk),
                      desc_k<D>(k_s, kBlockRows, 0, kk), kk);
      wgmma_commit_wait();
      reg_fence(sc);

      const int key0 = j * kBlockRows;
      if (key0 + kBlockRows > N) {
#pragma unroll
        for (int jn = 0; jn < 16; ++jn)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (key0 + 8 * jn + 2 * t + c >= N) sc[4 * jn + c] = sc[4 * jn + 2 + c] = -INFINITY;
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * jn], sc[4 * jn + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * jn + 2], sc[4 * jn + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float c0 = exp2f((m0 - mx0) * sl2);  // 0 on the first tile
      const float c1 = exp2f((m1 - mx1) * sl2);
      m0 = mx0;
      m1 = mx1;
      const float b0 = mx0 * sl2, b1 = mx1 * sl2;
      float r0 = 0.f, r1 = 0.f;
      uint32_t pa[32];
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const float p00 = exp2f(fmaf(sc[4 * jn], sl2, -b0));
        const float p01 = exp2f(fmaf(sc[4 * jn + 1], sl2, -b0));
        const float p10 = exp2f(fmaf(sc[4 * jn + 2], sl2, -b1));
        const float p11 = exp2f(fmaf(sc[4 * jn + 3], sl2, -b1));
        r0 += p00 + p01;
        r1 += p10 + p11;
        pa[2 * jn] = pack_bf16(p00, p01);
        pa[2 * jn + 1] = pack_bf16(p10, p11);
      }
      l0 = l0 * c0 + r0;
      l1 = l1 * c1 + r1;
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn) {
        o[4 * jn] *= c0;
        o[4 * jn + 1] *= c0;
        o[4 * jn + 2] *= c1;
        o[4 * jn + 3] *= c1;
      }

      reg_fence(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockRows / 16; ++kk)
        Rs<D>::mma(o, &pa[4 * kk], desc_mn<D>(v_s, kBlockRows, kk));
      wgmma_commit_wait();
      reg_fence(o);
      mbar_arrive(empty + 8 * s);
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const int ra = row0 + wg * 64 + (tid / 32) * 16 + g;
    const int rb = ra + 8;
    bf16* ob = out + static_cast<size_t>(b) * N * C + h * D + 2 * t;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      if (ra < N)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(ra) * C + 8 * jn) =
            __floats2bfloat162_rn(o[4 * jn] / l0, o[4 * jn + 1] / l0);
      if (rb < N)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(rb) * C + 8 * jn) =
            __floats2bfloat162_rn(o[4 * jn + 2] / l1, o[4 * jn + 3] / l1);
    }
    if (lse != nullptr && t == 0) {
      float* lp = lse + (static_cast<size_t>(b) * H + h) * N;
      if (ra < N) lp[ra] = m0 * scale + logf(l0);
      if (rb < N) lp[rb] = m1 * scale + logf(l1);
    }
  }
}

// ------------------------------------------------- short-sequence forward

// Keys of a head padded to 64 * NT (N <= 256). One block owns 64 query rows
// of one (b, h) and is one warpgroup; its single TMA barrier brings its Q
// rows and the head's whole K and V.
template <int D, int NT>
struct Short {
  static constexpr int kKeys = 64 * NT;
  static constexpr uint32_t kQ = Tile<D>::bytes(64);
  static constexpr uint32_t kKV = Tile<D>::bytes(kKeys);
  static constexpr uint32_t kBar = kQ + 2 * kKV;
  static constexpr size_t kSmem = 1024 + kBar + 8;
};

// K1's forward for N <= 256 (packed_attention's "sm90 short" route), and
// K6's: the score row of every query stays in registers, so the softmax is
// exact and single-pass, and P is normalised and rounded to bf16 before
// P.V, the TPU kernel's order (plain twin: packed_attention_reference).
// Head h of q, k and v is columns col + h * hs of their maps (K1: one packed
// qkv, col 0, C, 2C and hs = D qkv-major, col 0, D, 2D and hs = 3D
// head-major; K6: three (B, N, heads, d) views, col 0, hs = D). Writes the
// row log-sum-exp when lse is not null.
template <int D, int NT>
__global__ void __launch_bounds__(128)
    short_fwd_kernel(const __grid_constant__ CUtensorMap q_map,  // boxes of 64 rows
                     const __grid_constant__ CUtensorMap k_map,  // boxes of 64 NT rows
                     const __grid_constant__ CUtensorMap v_map,  // boxes of 64 NT rows
                     int q_col, int k_col, int v_col, int hs, bf16* __restrict__ out,
                     float* __restrict__ lse, int N, int C, int H, float scale) {
  using L = Short<D, NT>;
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  const uint32_t q_s = base;
  const uint32_t k_s = base + L::kQ;
  const uint32_t v_s = k_s + L::kKV;
  const uint32_t bar = base + L::kBar;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * 64;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, L::kQ + 2 * L::kKV);
    tma_tile<D>(q_s, &q_map, bar, q_col + h * hs, row0, b, 64);
    tma_tile<D>(k_s, &k_map, bar, k_col + h * hs, 0, b, L::kKeys);
    tma_tile<D>(v_s, &v_map, bar, v_col + h * hs, 0, b, L::kKeys);
  }
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const float sl2 = scale * kLog2e;
  mbar_wait(bar, 0);

  float sc[NT][32];  // S = Q K^T, 64 rows x 64 keys per tile
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc[j], desc_k<D>(q_s, 64, 0, kk), desc_k<D>(k_s, L::kKeys, 64 * j, kk), kk);
  wgmma_commit_wait();
#pragma unroll
  for (int j = 0; j < NT; ++j) reg_fence(sc[j]);

  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (64 * j + 8 * jn + 2 * t + c >= N) sc[j][4 * jn + c] = sc[j][4 * jn + 2 + c] = -INFINITY;
        mx0 = fmaxf(mx0, sc[j][4 * jn + c]);
        mx1 = fmaxf(mx1, sc[j][4 * jn + 2 + c]);
      }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  const float b0 = mx0 * sl2, b1 = mx1 * sl2;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      sc[j][i] = exp2f(fmaf(sc[j][i], sl2, -b0));
      sc[j][i + 1] = exp2f(fmaf(sc[j][i + 1], sl2, -b0));
      sc[j][i + 2] = exp2f(fmaf(sc[j][i + 2], sl2, -b1));
      sc[j][i + 3] = exp2f(fmaf(sc[j][i + 3], sl2, -b1));
      l0 += sc[j][i] + sc[j][i + 1];
      l1 += sc[j][i + 2] + sc[j][i + 3];
    }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float r0 = 1.f / l0, r1 = 1.f / l1;
  uint32_t pa[NT][16];  // round(P), the register A operand of P.V
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      pa[j][2 * jn] = pack_bf16(sc[j][4 * jn] * r0, sc[j][4 * jn + 1] * r0);
      pa[j][2 * jn + 1] = pack_bf16(sc[j][4 * jn + 2] * r1, sc[j][4 * jn + 3] * r1);
    }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  reg_fence(o);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Rs<D>::mma(o, &pa[j][4 * kk], desc_mn<D>(v_s, L::kKeys, 4 * j + kk));
  wgmma_commit_wait();
  reg_fence(o);

  const int ra = row0 + (tid / 32) * 16 + g;
  const int rb = ra + 8;
  bf16* ob = out + static_cast<size_t>(b) * N * C + h * D + 2 * t;
#pragma unroll
  for (int jn = 0; jn < D / 8; ++jn) {
    if (ra < N)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(ra) * C + 8 * jn) =
          __floats2bfloat162_rn(o[4 * jn], o[4 * jn + 1]);
    if (rb < N)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(rb) * C + 8 * jn) =
          __floats2bfloat162_rn(o[4 * jn + 2], o[4 * jn + 3]);
  }
  if (lse != nullptr && t == 0) {
    float* lp = lse + (static_cast<size_t>(b) * H + h) * N;
    if (ra < N) lp[ra] = mx0 * scale + logf(l0);
    if (rb < N) lp[rb] = mx1 * scale + logf(l1);
  }
}

// --------------------------------------------------------- backward: dQ

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,  // qkv, boxes of 128 rows
                  const __grid_constant__ CUtensorMap kv_map,  // qkv, boxes of 64 rows
                  const __grid_constant__ CUtensorMap do_map,  // dout, boxes of 128 rows
                  const bf16* __restrict__ out, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ dsum,
                  bf16* __restrict__ dqkv, int N, int C, int H, int ts, int hs, float scale,
                  int exact_d) {
  using L = Dq<D>;
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  const uint32_t q_s = base;
  const uint32_t do_s = base + L::kQ;
  const uint32_t kv_s = base + 2 * L::kQ;  // stage s: K, then V
  const uint32_t q_bar = base + L::kBars;
  const uint32_t full = q_bar + 8;
  const uint32_t empty = full + 8 * kStages;
  float* stat_l = reinterpret_cast<float*>(smem + (base - smem_u32(smem)) + L::kStats);
  float* stat_d = stat_l + kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * kBlockRows;
  const int n_tiles = (N + kTileRows - 1) / kTileRows;
  const int wg = threadIdx.x / 128;
  const size_t C3 = 3 * static_cast<size_t>(C);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_bar, 2 * L::kQ);
      tma_tile<D>(q_s, &q_map, q_bar, h * hs, row0, b, kBlockRows);
      tma_tile<D>(do_s, &do_map, q_bar, h * D, row0, b, kBlockRows);
      // exact_d: every K/V tile twice, once for D and once for dQ
      const int n_loads = exact_d ? 2 * n_tiles : n_tiles;
      for (int j = 0; j < n_loads; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty + 8 * s, ((j / kStages) - 1) & 1);
        const uint32_t k_s = kv_s + s * 2 * L::kKV;
        const int key0 = (j % n_tiles) * kTileRows;
        mbar_expect_tx(full + 8 * s, 2 * L::kKV);
        tma_tile<D>(k_s, &kv_map, full + 8 * s, ts + h * hs, key0, b, kTileRows);
        tma_tile<D>(k_s + L::kKV, &kv_map, full + 8 * s, 2 * ts + h * hs, key0, b, kTileRows);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int g = (tid % 32) / 4;
    const int t = tid % 4;
    const float sl2 = scale * kLog2e;

    // lse of this warpgroup's 64 rows and, unless exact_d, D = rowsum(dO * O),
    // two threads a row.
    {
      const int r = wg * 64 + tid / 2;
      const int n = row0 + r;
      const int half = tid % 2;
      float acc = 0.f;
      if (n < N && !exact_d) {
        const size_t off = (static_cast<size_t>(b) * N + n) * C + h * D + half * (D / 2);
#pragma unroll
        for (int i = 0; i < D / 2; i += 8) {
          const uint4 ov = *reinterpret_cast<const uint4*>(out + off + i);
          const uint4 dv = *reinterpret_cast<const uint4*>(dout + off + i);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]);
            const float2 df = __bfloat1622float2(d2[e]);
            acc = fmaf(of.x, df.x, acc);
            acc = fmaf(of.y, df.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) {
        const size_t at = (static_cast<size_t>(b) * H + h) * N + n;
        stat_d[r] = acc;
        stat_l[r] = n < N ? lse[at] * kLog2e : 0.f;
        if (n < N && !exact_d) dsum[at] = acc;
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
    const int ra = wg * 64 + (tid / 32) * 16 + g;
    const float la = stat_l[ra], lb = stat_l[ra + 8];
    float da = stat_d[ra], db = stat_d[ra + 8];
    mbar_wait(q_bar, 0);

    // exact_d: D = rowsum(dP * P) over the unrounded P, the TPU kernel's
    // order, in a first sweep over the key tiles (S and dP, no dQ).
    int j0 = 0;  // tiles taken from the ring so far
    if (exact_d) {
      float sa = 0.f, sb = 0.f;
      for (; j0 < n_tiles; ++j0) {
        const int s = j0 % kStages;
        mbar_wait(full + 8 * s, (j0 / kStages) & 1);
        const uint32_t k_s = kv_s + s * 2 * L::kKV;
        float sc[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(sc, desc_k<D>(q_s, kBlockRows, wg * 64, kk),
                       desc_k<D>(k_s, kTileRows, 0, kk), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(dp, desc_k<D>(do_s, kBlockRows, wg * 64, kk),
                       desc_k<D>(k_s + L::kKV, kTileRows, 0, kk), kk);
        wgmma_commit_wait();
        reg_fence(sc);
        reg_fence(dp);
        mbar_arrive(empty + 8 * s);
        const int key0 = j0 * kTileRows;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (key0 + 8 * jn + 2 * t + c < N) {
              sa = fmaf(exp2f(fmaf(sc[4 * jn + c], sl2, -la)), dp[4 * jn + c], sa);
              sb = fmaf(exp2f(fmaf(sc[4 * jn + 2 + c], sl2, -lb)), dp[4 * jn + 2 + c], sb);
            }
      }
      // the four threads of a row pair hold its columns 2 t, 2 t + 1 (mod 8)
      sa += __shfl_xor_sync(0xffffffffu, sa, 1);
      sa += __shfl_xor_sync(0xffffffffu, sa, 2);
      sb += __shfl_xor_sync(0xffffffffu, sb, 1);
      sb += __shfl_xor_sync(0xffffffffu, sb, 2);
      da = sa;
      db = sb;
      const size_t at = (static_cast<size_t>(b) * H + h) * N + row0 + ra;
      if (t == 0 && row0 + ra < N) dsum[at] = da;
      if (t == 0 && row0 + ra + 8 < N) dsum[at + 8] = db;
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    for (int j = 0; j < n_tiles; ++j) {
      const int s = (j0 + j) % kStages;
      mbar_wait(full + 8 * s, ((j0 + j) / kStages) & 1);
      const uint32_t k_s = kv_s + s * 2 * L::kKV;
      const uint32_t v_s = k_s + L::kKV;

      float sc[32], dp[32];  // S = Q K^T and dP = dO V^T, 64 rows x 64 keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, desc_k<D>(q_s, kBlockRows, wg * 64, kk),
                     desc_k<D>(k_s, kTileRows, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, desc_k<D>(do_s, kBlockRows, wg * 64, kk),
                     desc_k<D>(v_s, kTileRows, 0, kk), kk);
      wgmma_commit_wait();
      reg_fence(sc);
      reg_fence(dp);

      const int key0 = j * kTileRows;
      uint32_t ds[16];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        float ga[2], gb[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool in = key0 + 8 * jn + 2 * t + c < N;
          const float pa = in ? exp2f(fmaf(sc[4 * jn + c], sl2, -la)) : 0.f;
          const float pb = in ? exp2f(fmaf(sc[4 * jn + 2 + c], sl2, -lb)) : 0.f;
          ga[c] = pa * (dp[4 * jn + c] - da) * scale;
          gb[c] = pb * (dp[4 * jn + 2 + c] - db) * scale;
        }
        ds[2 * jn] = pack_bf16(ga[0], ga[1]);
        ds[2 * jn + 1] = pack_bf16(gb[0], gb[1]);
      }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileRows / 16; ++kk)
        Rs<D>::mma(dq, &ds[4 * kk], desc_mn<D>(k_s, kTileRows, kk));
      wgmma_commit_wait();
      reg_fence(dq);
      mbar_arrive(empty + 8 * s);
    }

    const int na = row0 + ra, nb = na + 8;
    bf16* gq = dqkv + static_cast<size_t>(b) * N * C3 + h * hs + 2 * t;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      if (na < N)
        *reinterpret_cast<__nv_bfloat162*>(gq + na * C3 + 8 * jn) =
            __floats2bfloat162_rn(dq[4 * jn], dq[4 * jn + 1]);
      if (nb < N)
        *reinterpret_cast<__nv_bfloat162*>(gq + nb * C3 + 8 * jn) =
            __floats2bfloat162_rn(dq[4 * jn + 2], dq[4 * jn + 3]);
    }
  }
}

// ------------------------------------------------------ backward: dK, dV

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkv_kernel(const __grid_constant__ CUtensorMap kv_map,  // qkv, boxes of 128 rows
                   const __grid_constant__ CUtensorMap q_map,   // qkv, boxes of 64 rows
                   const __grid_constant__ CUtensorMap do_map,  // dout, boxes of 64 rows
                   const float* __restrict__ lse, const float* __restrict__ dsum,
                   bf16* __restrict__ dqkv, int N, int C, int H, int ts, int hs, float scale) {
  using L = Dkv<D>;
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  const uint32_t k_s = base;
  const uint32_t v_s = base + L::kKV;
  const uint32_t qd_s = base + 2 * L::kKV;  // stage s: Q, then dO
  const uint32_t kv_bar = base + L::kBars;
  const uint32_t full = kv_bar + 8;
  const uint32_t empty = full + 8 * kStages;
  // stage s: lse * log2 e, then D, of its 64 query rows
  float* stats = reinterpret_cast<float*>(smem + (base - smem_u32(smem)) + L::kStats);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int key0 = static_cast<int>(blockIdx.x) * kBlockRows;
  const int n_tiles = (N + kTileRows - 1) / kTileRows;
  const int wg = threadIdx.x / 128;
  const size_t C3 = 3 * static_cast<size_t>(C);

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: one warp stages the statistics, its lane 0 the tiles
    setmaxnreg_dec<40>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(kv_bar, 2 * L::kKV);
        tma_tile<D>(k_s, &kv_map, kv_bar, ts + h * hs, key0, b, kBlockRows);
        tma_tile<D>(v_s, &kv_map, kv_bar, 2 * ts + h * hs, key0, b, kBlockRows);
      }
      const size_t row = (static_cast<size_t>(b) * H + h) * N;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty + 8 * s, ((j / kStages) - 1) & 1);
        float* st = stats + s * 2 * kTileRows;
        for (int i = lane; i < kTileRows; i += 32) {
          const int n = j * kTileRows + i;
          st[i] = n < N ? lse[row + n] * kLog2e : 0.f;
          st[kTileRows + i] = n < N ? dsum[row + n] : 0.f;
        }
        if (lane == 0) {
          const uint32_t q_s = qd_s + s * 2 * L::kQ;
          mbar_expect_tx(full + 8 * s, 2 * L::kQ);
          tma_tile<D>(q_s, &q_map, full + 8 * s, h * hs, j * kTileRows, b, kTileRows);
          tma_tile<D>(q_s + L::kQ, &do_map, full + 8 * s, h * D, j * kTileRows, b, kTileRows);
        } else {
          mbar_arrive(full + 8 * s);
        }
      }
    }
  } else {  // consumers: 64 keys each
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int g = (tid % 32) / 4;
    const int t = tid % 4;
    const float sl2 = scale * kLog2e;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kv_bar, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(full + 8 * s, (j / kStages) & 1);
      const uint32_t q_s = qd_s + s * 2 * L::kQ;
      const uint32_t do_s = q_s + L::kQ;
      const float* st = stats + s * 2 * kTileRows;

      float sc[32], dp[32];  // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, desc_k<D>(k_s, kBlockRows, wg * 64, kk),
                     desc_k<D>(q_s, kTileRows, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, desc_k<D>(v_s, kBlockRows, wg * 64, kk),
                     desc_k<D>(do_s, kTileRows, 0, kk), kk);
      wgmma_commit_wait();
      reg_fence(sc);
      reg_fence(dp);

      const int q0 = j * kTileRows;
      uint32_t pt[16], dst[16];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        float pa[2], pb[2], ga[2], gb[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 8 * jn + 2 * t + c;
          const bool in = q0 + i < N;
          const float lq = st[i], dq = st[kTileRows + i];
          pa[c] = in ? exp2f(fmaf(sc[4 * jn + c], sl2, -lq)) : 0.f;
          pb[c] = in ? exp2f(fmaf(sc[4 * jn + 2 + c], sl2, -lq)) : 0.f;
          ga[c] = pa[c] * (dp[4 * jn + c] - dq) * scale;
          gb[c] = pb[c] * (dp[4 * jn + 2 + c] - dq) * scale;
        }
        pt[2 * jn] = pack_bf16(pa[0], pa[1]);
        pt[2 * jn + 1] = pack_bf16(pb[0], pb[1]);
        dst[2 * jn] = pack_bf16(ga[0], ga[1]);
        dst[2 * jn + 1] = pack_bf16(gb[0], gb[1]);
      }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileRows / 16; ++kk) {
        Rs<D>::mma(dv, &pt[4 * kk], desc_mn<D>(do_s, kTileRows, kk));
        Rs<D>::mma(dk, &dst[4 * kk], desc_mn<D>(q_s, kTileRows, kk));
      }
      wgmma_commit_wait();
      reg_fence(dk);
      reg_fence(dv);
      mbar_arrive(empty + 8 * s);
    }

    const int na = key0 + wg * 64 + (tid / 32) * 16 + g, nb = na + 8;
    bf16* gk = dqkv + static_cast<size_t>(b) * N * C3 + ts + h * hs + 2 * t;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      if (na < N) {
        *reinterpret_cast<__nv_bfloat162*>(gk + na * C3 + 8 * jn) =
            __floats2bfloat162_rn(dk[4 * jn], dk[4 * jn + 1]);
        *reinterpret_cast<__nv_bfloat162*>(gk + ts + na * C3 + 8 * jn) =
            __floats2bfloat162_rn(dv[4 * jn], dv[4 * jn + 1]);
      }
      if (nb < N) {
        *reinterpret_cast<__nv_bfloat162*>(gk + nb * C3 + 8 * jn) =
            __floats2bfloat162_rn(dk[4 * jn + 2], dk[4 * jn + 3]);
        *reinterpret_cast<__nv_bfloat162*>(gk + ts + nb * C3 + 8 * jn) =
            __floats2bfloat162_rn(dv[4 * jn + 2], dv[4 * jn + 3]);
      }
    }
  }
}

// ------------------------------------------------------------------ launch

template <int D>
int launch_fwd(const void* qkv, void* out, float* lse, int B, int N, int C, int H,
               bool head_major, cudaStream_t stream) {
  CUtensorMap map;
  int err = make_map<D>(&map, qkv, 3 * C, N, B, kBlockRows);
  if (err == cudaSuccess) err = allow_smem(fwd_kernel<D>, Fwd<D>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBlockRows - 1) / kBlockRows, H, B);
  fwd_kernel<D><<<grid, kThreads, Fwd<D>::kSmem, stream>>>(
      map, static_cast<bf16*>(out), lse, N, C, H, head_major ? D : C, head_major ? 3 * D : D,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

// q, k and v: (B, N, width) bf16 column ranges with element strides
// (batch, row) and unit stride along the columns; head h at column
// col + h * head_stride.
struct ShortArgs {
  const void *q, *k, *v;
  int q_col, k_col, v_col, width, head_stride;
  long long batch, row;
};

template <int D, int NT>
int launch_short(const ShortArgs& a, void* out, float* lse, int B, int N, int C, int H,
                 cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  int err = make_map<D>(&q_map, a.q, a.width, a.row, N, a.batch, B, 64);
  if (err == cudaSuccess) err = make_map<D>(&k_map, a.k, a.width, a.row, N, a.batch, B, 64 * NT);
  if (err == cudaSuccess) err = make_map<D>(&v_map, a.v, a.width, a.row, N, a.batch, B, 64 * NT);
  if (err == cudaSuccess) err = allow_smem(short_fwd_kernel<D, NT>, Short<D, NT>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + 63) / 64, H, B);
  short_fwd_kernel<D, NT><<<grid, 128, Short<D, NT>::kSmem, stream>>>(
      q_map, k_map, v_map, a.q_col, a.k_col, a.v_col, a.head_stride, static_cast<bf16*>(out),
      lse, N, C, H,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

int launch_short_any(const ShortArgs& a, void* out, float* lse, int B, int N, int C, int H,
                     cudaStream_t stream) {
  const int nt = (N + 63) / 64;
  if (N < 1 || nt > 4) return cudaErrorInvalidValue;
#define PROBPOSE_SHORT(D)                                                    \
  switch (nt) {                                                              \
    case 1: return launch_short<D, 1>(a, out, lse, B, N, C, H, stream);      \
    case 2: return launch_short<D, 2>(a, out, lse, B, N, C, H, stream);      \
    case 3: return launch_short<D, 3>(a, out, lse, B, N, C, H, stream);      \
    default: return launch_short<D, 4>(a, out, lse, B, N, C, H, stream);     \
  }
  switch (C / H) {
    case 32: PROBPOSE_SHORT(32)
    case 64: PROBPOSE_SHORT(64)
    case 80: PROBPOSE_SHORT(80)
    case 128: PROBPOSE_SHORT(128)
    default: return cudaErrorInvalidValue;
  }
#undef PROBPOSE_SHORT
}

template <int D>
int launch_bwd(const void* qkv, const void* out, const void* dout, const float* lse,
               float* dsum, void* dqkv, int B, int N, int C, int H, bool head_major,
               int exact_d, cudaStream_t stream) {
  CUtensorMap qkv128, qkv64, do128, do64;
  int err = make_map<D>(&qkv128, qkv, 3 * C, N, B, kBlockRows);
  if (err == cudaSuccess) err = make_map<D>(&qkv64, qkv, 3 * C, N, B, kTileRows);
  if (err == cudaSuccess) err = make_map<D>(&do128, dout, C, N, B, kBlockRows);
  if (err == cudaSuccess) err = make_map<D>(&do64, dout, C, N, B, kTileRows);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_kernel<D>, Dq<D>::kSmem);
  if (err == cudaSuccess) err = allow_smem(bwd_dkv_kernel<D>, Dkv<D>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBlockRows - 1) / kBlockRows, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  bf16* g = static_cast<bf16*>(dqkv);
  const int ts = head_major ? D : C, hs = head_major ? 3 * D : D;
  bwd_dq_kernel<D><<<grid, kThreads, Dq<D>::kSmem, stream>>>(
      qkv128, qkv64, do128, static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse,
      dsum, g, N, C, H, ts, hs, scale, exact_d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkv_kernel<D><<<grid, kThreads, Dkv<D>::kSmem, stream>>>(qkv128, qkv64, do64, lse, dsum,
                                                               g, N, C, H, ts, hs, scale);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of the forward (pass 0), the dQ kernel (1) or the dK/dV
// kernel (2) at head width d; -1 for a d it does not take.
extern "C" long long tiled_attention_sm90_smem_bytes(int d, int pass) {
  switch (d) {
    case 32: return pass == 0 ? Fwd<32>::kSmem : pass == 1 ? Dq<32>::kSmem : Dkv<32>::kSmem;
    case 64: return pass == 0 ? Fwd<64>::kSmem : pass == 1 ? Dq<64>::kSmem : Dkv<64>::kSmem;
    case 80: return pass == 0 ? Fwd<80>::kSmem : pass == 1 ? Dq<80>::kSmem : Dkv<80>::kSmem;
    case 128: return pass == 0 ? Fwd<128>::kSmem : pass == 1 ? Dq<128>::kSmem : Dkv<128>::kSmem;
    default: return -1;
  }
}

// Shared memory of the short-sequence forward at head width d and N keys
// (1 <= N <= 256); -1 for a shape it does not take.
extern "C" long long short_attention_sm90_smem_bytes(int d, int N) {
  if (N < 1 || N > 256) return -1;
  const int nt = (N + 63) / 64;
  switch (d) {
    case 32: return Short<32, 1>::kSmem + (nt - 1) * 2 * Tile<32>::bytes(64);
    case 64: return Short<64, 1>::kSmem + (nt - 1) * 2 * Tile<64>::bytes(64);
    case 80: return Short<80, 1>::kSmem + (nt - 1) * 2 * Tile<80>::bytes(64);
    case 128: return Short<128, 1>::kSmem + (nt - 1) * 2 * Tile<128>::bytes(64);
    default: return -1;
  }
}

// Short-sequence forward, 1 <= N <= 256: bf16 qkv (B, N, 3C) qkv-major, or
// head-major with head_major (column of (t, h, c): t * d + h * 3d + c), in ->
// context (B, N, C) out and, unless lse is null, the row log-sum-exp
// (B, heads, N) f32.
extern "C" int short_attention_sm90_fwd(const void* qkv, void* out, void* lse, int B, int N,
                                        int C, int heads, int head_major, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long row = 3LL * C;
  const int d = C / heads, ts = head_major ? d : C;
  const ShortArgs a{qkv, qkv, qkv, 0, ts, 2 * ts, 3 * C, head_major ? 3 * d : d, row * N, row};
  return launch_short_any(a, out, static_cast<float*>(lse), B, N, C, heads,
                          static_cast<cudaStream_t>(stream));
}

// Kernel K6 on the same kernel, 1 <= N <= 256: q, k and v (B, N, heads, d)
// bf16 views sharing the element strides (batch, row), head stride d and unit
// stride along d (e.g. the q, k, v views of one packed projection) in ->
// context (B, N, heads, d) out.
extern "C" int flat_short_attention_sm90_fwd(const void* q, const void* k, const void* v,
                                             void* out, int B, int N, int heads, int d,
                                             long long batch_stride, long long row_stride,
                                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const ShortArgs a{q, k, v, 0, 0, 0, heads * d, d, batch_stride, row_stride};
  return launch_short_any(a, out, nullptr, B, N, heads * d, heads,
                          static_cast<cudaStream_t>(stream));
}

// bf16 qkv (B, N, 3C) qkv-major, or head-major with head_major, in ->
// context (B, N, C) out and, unless lse is null, the row log-sum-exp
// (B, heads, N) f32.
extern "C" int tiled_attention_sm90_fwd(const void* qkv, void* out, void* lse, int B, int N,
                                        int C, int heads, int head_major, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (C / heads) {
    case 32: return launch_fwd<32>(qkv, out, l, B, N, C, heads, head_major, s);
    case 64: return launch_fwd<64>(qkv, out, l, B, N, C, heads, head_major, s);
    case 80: return launch_fwd<80>(qkv, out, l, B, N, C, heads, head_major, s);
    case 128: return launch_fwd<128>(qkv, out, l, B, N, C, heads, head_major, s);
    default: return cudaErrorInvalidValue;
  }
}

// bf16 qkv (B, N, 3C) (head-major with head_major), the forward's context out
// and its lse, and dout (B, N, C) in -> dqkv (B, N, 3C) out, in qkv's layout;
// dsum is (B, heads, N) f32 scratch
// for D: rowsum(dP * P) over the unrounded P (the TPU's order) when exact_d,
// else rowsum(dout * out), which reads out instead of sweeping the keys twice.
extern "C" int tiled_attention_sm90_bwd(const void* qkv, const void* out, const void* dout,
                                        const void* lse, void* dsum, void* dqkv, int B, int N,
                                        int C, int heads, int head_major, int exact_d,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  switch (C / heads) {
    case 32:
      return launch_bwd<32>(qkv, out, dout, l, ds, dqkv, B, N, C, heads, head_major,
                             exact_d, s);
    case 64:
      return launch_bwd<64>(qkv, out, dout, l, ds, dqkv, B, N, C, heads, head_major,
                             exact_d, s);
    case 80:
      return launch_bwd<80>(qkv, out, dout, l, ds, dqkv, B, N, C, heads, head_major,
                             exact_d, s);
    case 128:
      return launch_bwd<128>(qkv, out, dout, l, ds, dqkv, B, N, C, heads, head_major,
                             exact_d, s);
    default: return cudaErrorInvalidValue;
  }
}
