// Kernel K5 in bf16 for Hopper (sm_90a): the ViT block's second half,
//   out = x + fc2(gelu(fc1(LayerNorm(x)))),
// forward and backward, as wgmma products fed by TMA.
//
// Replaces the TPU kernels `_fwd_kernel` (mlp_kernel.py:49) and `_bwd_kernel`
// (:57) of probpose_pytorch_tpu/ops/pallas/mlp_kernel.py for bf16 x and
// weights. The float32 path stays on the CUDA cores in csrc/fused_mlp.cu.
// Rounding points are the TPU kernel's (`_tile_forward` and its in-kernel
// jax.vjp): y and h are rounded to bf16 before their products, u, o, the
// biases and the residual stay f32, one cast at the end; dh and dy are
// rounded to bf16; du = round(dh) gelu'(u) is rounded to bf16 for the dy and
// dW1 products (the TPU kernel keeps it f32 there; the plain twin
// `fused_ln_mlp_bwd_kernel_order_reference` rounds it as here), and db1 sums
// the unrounded du; every other sum is f32.
//
// What bounds it on an H100: both directions are operation-bound. At ViT-B
// (C = 768, Hd = 3072) a row costs 4 C Hd FLOPs forward (10 C Hd backward)
// against a few bytes of x and dO, far above the card's ~295 FLOP/byte bf16
// ridge, so only wgmma at a good share of 989 TFLOP/s moves it.
//
// Why the hidden state goes to device memory. The TPU kernel keeps a row
// tile's (rows, 4C) hidden state in 16 MB of VMEM. Here fc2's f32
// accumulator for even 64 rows at C = 768 is 384 registers a thread of one
// warpgroup, so a fused kernel either takes few rows and streams all of W1
// and W2 from L2 for each of them (the design this file replaces: 32 rows a
// block, ~14.5 TB of L2 reads at 49,152 rows, three times what L2 gives the
// tensor cores), or writes h. h in bf16 at 49,152 rows is 302 MB written and
// read once, ~0.18 ms at 3.35 TB/s, against two products of ~0.12 ms each
// that are compute-bound with tiles of 128 x 256. The bits do not change:
// the stored h is the value the TPU kernel rounds before fc2, and so for y,
// dh, dy and du.
//
// The GEMM core. One block per SM walks over output tiles (persistent):
// W consumer warpgroups own 64 rows each and issue wgmma m64nBNk16 into f32
// registers, and one producer thread keeps a ring of stages in flight with
// TMA (128-byte swizzle, 64 columns of contraction a stage; TMA fills
// zeros past the tensor, so ragged rows, ragged output columns and a ragged
// last stage of contraction all arrive as zeros and add nothing). A
// consumer releases a stage once the wgmma group after
// it has been issued (wait_group 1), one thread of each warpgroup arriving.
// The operands arrive in nn.Linear's layout, w1t = W1^T (Hd, C) and
// w2t = W2^T (C, Hd), read K-major or MN-major as each product needs:
//   u  = y W1        A = y  K-major       B = w1t K-major
//   o  = h W2        A = h  K-major       B = w2t K-major
//   dh = g W2^T      A = g  K-major       B = w2t MN-major
//   dy = du W1^T     A = du K-major       B = w1t MN-major
//   dW1^T = du^T y   A = du MN-major      B = y   MN-major
//   dW2^T = g^T h    A = g  MN-major      B = h   MN-major
//
// Tiles, and what the card taught (an H100 at 700 W; each kernel's device
// time at ViT-B's widths from scripts/k5_kernel_times.py, 49,152 rows):
//   * The products are bound by moving A and B from L2 into shared memory,
//     not by the tensor cores: a variant of o = h W2 with its wgmmas removed
//     took as long as the product. So tiles are as large as registers
//     allow: 192 x 192 with W = 3 (96 accumulators a thread, 98 FLOP a byte
//     loaded; 384 and 768 with Hd = 4 C), 128 x 256 with W = 2 (128
//     accumulators, 87 FLOP a byte; 1024, 1280), or 128 x 128, whichever
//     pads the least work (`shape_of`). 192 x 192 took o = h W2 from 459 to
//     383 us. The ring
//     holds 4 stages of 48 KB (197 KB of shared memory, one block an SM).
//   * Pairs of blocks in 2-block clusters sharing B by TMA multicast read a
//     third less from L2 but made the forward slower (u = y W1 622 -> 710
//     us, o = h W2 459 -> 430 us); L2 prefetches ahead of the ring and
//     rotating each tile's first stage did not help either. None is used.
//   * Written from the accumulator's layout (4 bytes a thread, 16 a row per
//     warp store), h's stores were most of u = y W1's epilogue. Each quad
//     now transposes its column groups with shuffles and writes 16 bytes a
//     thread: u = y W1 629 -> 463 us, the dual product (12,288 rows)
//     360 -> 252 us.
//   * The GELU form is a template argument: as a runtime flag both forms
//     were evaluated per element (u = y W1 1,085 us against 622).
// ptxas fits the W = 2 kernels in 168 registers and the W = 3 ones in 128,
// with no spills; after setmaxnreg the consumers may use 232 or 160, the
// producer 40 or 24 (phase 0 of chip_smoke.py prints each kernel's count).
//
// Forward, three launches: a LayerNorm row pass writes y = round(LN_f32(x))
// (two-pass variance, eps 1e-6); u = y W1 whose epilogue adds b1, applies
// GELU in f32 (tanh or erf) and writes h = round(gelu(u)); o = h W2 whose
// epilogue adds b2 and x in f32 and casts once. The wrapper allocates y and
// h; the kernels allocate nothing.
//
// Backward, six launches, no atomics (two runs give the same bits):
//   1. the LayerNorm row pass, writing y and each row's mean and rstd;
//   2. the dual product: u = y W1 and dh = g W2^T on the same (128-row,
//      128-hidden) tile, two accumulators of 64 registers (W = 2); its
//      epilogue writes h and du = round(dh) gelu'(u + b1) in bf16, and the
//      tile's f32 column sums of the unrounded du (rows past R left out)
//      for db1;
//   3. dy = round(du W1^T);
//   4. a row pass: dx = g + rstd (dy s - mean(dy s) - xhat mean(dy s xhat)),
//      and per-64-row partial sums of dscale, dbias and db2;
//   5. dW1^T = du^T y and dW2^T = g^T h in one launch, split over fixed row
//      chunks chosen against the 132-SM wave (`split_k`; at ViT-B's step
//      the 128 tiles fill one wave unsplit), each chunk's f32 partial
//      written once;
//   6. the partials summed in order, in f32; dW1 and dW2 cast to bf16.
//
// Shapes: every C <= 2048 and Hd <= 8192 that are multiples of 8 (ViT-g's
// 1408 and 6144 among them). TMA reads rows of 16-byte multiples and fills
// zeros past the tensor, so the grids round up (ceil(N / BN) tiles,
// ceil(K / 64) stages) and the zeros past C or Hd add nothing to the sums.
// An epilogue stores 8 columns a thread (16 bytes of bf16, 32 of f32) from a
// multiple of 8, so each store lies wholly inside or wholly past the
// columns and is masked as a whole; the bias, residual and db1 reads are
// masked with it, and db1's and the split partials hold only real rows and
// columns. The LayerNorm passes take C at run time, P pairs a lane from a
// few buckets (the pairs past C / 2 masked). At the widths taken before
// (C in {384, 768, 1024, 1280}, Hd a multiple of 256) every tile, stage and
// sum is the same, and so are the bits. Plain-C interface, loaded with
// ctypes (ops/kernels/mlp.py, which mirrors the tile rule and the scratch
// layout in `_shape` and `mlp_workspace_bytes`); every entry point returns
// a cudaError_t as int (0 = success).

#include <math.h>

#include <algorithm>

#include "sm90.cuh"

namespace {

constexpr int kBK = 64;             // contraction columns of a stage: one swizzled row
constexpr uint32_t kRing = 192 * 1024;  // shared-memory bytes of every ring
// The dual product's block: consumer warpgroups 0 and 1 (64 rows each of a
// 128-row tile), producer warpgroup 2; db1's partials are per 128 rows.
constexpr int kThreads = 384;
constexpr int kBM = 128;
constexpr uint32_t kTileA = kBM * kBK * 2;
constexpr int kLnWarps = 8;         // rows per block of the LayerNorm row pass
constexpr int kLnRows = 64;         // rows per block of the LayerNorm backward
constexpr int kWaveSms = 132;       // H100 SXM: the wave split_k fills
constexpr int kEpilogueSteps = 8;   // split_k's cost of a tile's epilogue, in stages
constexpr int kMaxSplits = 16;
constexpr int kMaxC = 2048;         // the CUDA-core kernels' limits (csrc/fused_mlp.cu)
constexpr int kMaxHidden = 8192;
constexpr float kEps = 1e-6f;
constexpr float kLog2e = 1.4426950408889634f;

// What a GEMM's epilogue does with its tile (kGeluOut: the tanh form,
// kGeluExactOut: the erf form, a template argument so that each kernel
// compiles one form).
enum Epi { kGeluOut, kGeluExactOut, kResidualOut, kRoundOut, kPartialOut };

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// jax.nn.gelu and its derivative in f32. The tanh form through
// 0.5 (1 + tanh z) = s = 1 / (1 + exp(-2 z)): two multi-function-unit
// operations an element, within a few f32 ulps of tanhf; the exact form
// is 0.5 u erfc(-u / sqrt 2).
__device__ __forceinline__ float gelu_s(float u) {
  const float z = 0.7978845608028654f * (u + 0.044715f * (u * u * u));
  return __fdividef(1.f, 1.f + exp2f(-2.f * kLog2e * z));
}

template <int EXACT>
__device__ __forceinline__ float gelu(float u) {
  if (EXACT) return 0.5f * u * erfcf(-u * 0.70710678118654752f);
  return u * gelu_s(u);
}

// gelu'(u); with h = gelu(u) also written to *h.
template <int EXACT>
__device__ __forceinline__ float gelu_and_grad(float u, float* h) {
  if (EXACT) {
    const float e = 0.5f * erfcf(-u * 0.70710678118654752f);
    *h = u * e;
    return e + u * 0.3989422804014327f * expf(-0.5f * u * u);
  }
  const float s = gelu_s(u);
  *h = u * s;
  return s + 2.f * u * s * (1.f - s) * 0.7978845608028654f *
                 (1.f + 3.f * 0.044715f * u * u);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// ---------------------------------------------------------- LayerNorm rows

// y = round(LN_f32(x) * scale + bias), one warp a row, two-pass variance;
// the row's mean and rstd too when `mean` is not null. P bf16 pairs a lane
// (columns 2 (lane + 32 i) + {0, 1}), at least C / 64: the pairs past C / 2
// are neither read nor summed, so a width that fills its P gives the bits
// of one that fills it exactly.
template <int P>
__global__ void __launch_bounds__(kLnWarps * 32)
    ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, bf16* __restrict__ y,
                   float* __restrict__ mean, float* __restrict__ rstd, int R, int C) {
  const int lane = threadIdx.x % 32;
  const int n = static_cast<int>(blockIdx.x) * kLnWarps + threadIdx.x / 32;
  if (n >= R) return;
  const int pairs = C / 2;
  const auto* xr = reinterpret_cast<const __nv_bfloat162*>(x + static_cast<size_t>(n) * C);
  float2 v[P];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = lane + 32 * i;
    if (p < pairs) {
      v[i] = __bfloat1622float2(xr[p]);
      s += v[i].x + v[i].y;
    }
  }
  const float mu = warp_sum(s) / static_cast<float>(C);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (lane + 32 * i < pairs) {
      const float a = v[i].x - mu, b = v[i].y - mu;
      q += a * a + b * b;
    }
  }
  const float rs = rsqrtf(warp_sum(q) / static_cast<float>(C) + kEps);
  const auto* sc = reinterpret_cast<const float2*>(scale);
  const auto* bi = reinterpret_cast<const float2*>(bias);
  auto* yr = reinterpret_cast<__nv_bfloat162*>(y + static_cast<size_t>(n) * C);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = lane + 32 * i;
    if (p < pairs) {
      const float2 a = sc[p], b = bi[p];
      yr[p] = __floats2bfloat162_rn((v[i].x - mu) * rs * a.x + b.x,
                                    (v[i].y - mu) * rs * a.y + b.y);
    }
  }
  if (mean != nullptr && lane == 0) {
    mean[n] = mu;
    rstd[n] = rs;
  }
}

// The LayerNorm backward of 64 rows from dy (bf16), 32 ceil(C / 64) threads:
// per row (one warp each) the means of dy s and dy s xhat over P pairs a
// lane (those past C / 2 left out), then per column pair (one thread each;
// the threads past C / 2 idle) dx and the block's partial sums of dscale,
// dbias and db2 into part (3, tiles, C), reading the rows eight at a time.
template <int P>
__global__ void __launch_bounds__(32 * P)
    ln_bwd_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ x,
                  const bf16* __restrict__ g, const float* __restrict__ scale,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  bf16* __restrict__ dx, float* __restrict__ part, int R, int C) {
  constexpr int kBatch = 8;
  __shared__ float s1_s[kLnRows], s2_s[kLnRows], mu_s[kLnRows], rs_s[kLnRows];
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int pairs = C / 2;
  const int row0 = static_cast<int>(blockIdx.x) * kLnRows;
  const auto* sc = reinterpret_cast<const float2*>(scale);
  for (int r = threadIdx.x / 32; r < kLnRows; r += warps) {
    const int n = row0 + r;
    float a = 0.f, b = 0.f, mu = 0.f, rs = 0.f;
    if (n < R) {
      mu = mean[n];
      rs = rstd[n];
      const size_t at = static_cast<size_t>(n) * C;
      const auto* dr = reinterpret_cast<const __nv_bfloat162*>(dy + at);
      const auto* xr = reinterpret_cast<const __nv_bfloat162*>(x + at);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int p = lane + 32 * i;
        if (p < pairs) {
          const float2 d = __bfloat1622float2(dr[p]), xv = __bfloat1622float2(xr[p]);
          const float2 s = sc[p];
          const float h0 = d.x * s.x, h1 = d.y * s.y;
          a += h0 + h1;
          b += h0 * ((xv.x - mu) * rs) + h1 * ((xv.y - mu) * rs);
        }
      }
    }
    a = warp_sum(a) / static_cast<float>(C);
    b = warp_sum(b) / static_cast<float>(C);
    if (lane == 0) {
      s1_s[r] = a;
      s2_s[r] = b;
      mu_s[r] = mu;
      rs_s[r] = rs;
    }
  }
  __syncthreads();
  const int p = threadIdx.x;
  if (p >= pairs) return;
  const int rows = min(kLnRows, R - row0);
  const float2 s = sc[p];
  const auto* dy2 = reinterpret_cast<const __nv_bfloat162*>(dy);
  const auto* x2 = reinterpret_cast<const __nv_bfloat162*>(x);
  const auto* g2 = reinterpret_cast<const __nv_bfloat162*>(g);
  float2 dsc = make_float2(0.f, 0.f), dbi = dsc, db2 = dsc;
  for (int r0 = 0; r0 < rows; r0 += kBatch) {
    __nv_bfloat162 d[kBatch], xv[kBatch], gv[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (r0 + q < rows) {
        const size_t at = static_cast<size_t>(row0 + r0 + q) * pairs + p;
        d[q] = dy2[at];
        xv[q] = x2[at];
        gv[q] = g2[at];
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int r = r0 + q;
      if (r >= rows) break;
      const float2 df = __bfloat1622float2(d[q]), xf = __bfloat1622float2(xv[q]);
      const float2 gf = __bfloat1622float2(gv[q]);
      const float mu = mu_s[r], rs = rs_s[r], m1 = s1_s[r], m2 = s2_s[r];
      const float xh0 = (xf.x - mu) * rs, xh1 = (xf.y - mu) * rs;
      reinterpret_cast<__nv_bfloat162*>(dx)[static_cast<size_t>(row0 + r) * pairs + p] =
          __floats2bfloat162_rn(gf.x + rs * (df.x * s.x - m1 - xh0 * m2),
                                gf.y + rs * (df.y * s.y - m1 - xh1 * m2));
      dsc.x += df.x * xh0;
      dsc.y += df.y * xh1;
      dbi.x += df.x;
      dbi.y += df.y;
      db2.x += gf.x;
      db2.y += gf.y;
    }
  }
  const size_t plane = static_cast<size_t>(gridDim.x) * pairs;  // float2s of one sum
  auto* out = reinterpret_cast<float2*>(part) + static_cast<size_t>(blockIdx.x) * pairs + p;
  out[0] = dsc;
  out[plane] = dbi;
  out[2 * plane] = db2;
}

// ----------------------------------------------------------------- the ring

// A ring of stages of kStage bytes at 1024-byte boundaries (the swizzle's
// period), then full and empty mbarriers per stage. A stage is full when the
// producer's copies have landed, empty when one thread of each of the W
// consumer warpgroups has arrived after its wgmma reads of the stage
// completed (the wait is warpgroup-wide); an arrival from every thread cost
// more.
template <uint32_t kStage>
struct Ring {
  static constexpr int kStages = kRing / kStage;
  static constexpr uint32_t kBars = kStages * kStage;
  static constexpr size_t kSmem = 1024 + kBars + 16 * kStages;
};

template <typename R, int W>
__device__ __forceinline__ void init_ring(uint32_t base) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(base + R::kBars + 8 * s, 1);                    // full: the producer
      mbar_init(base + R::kBars + 8 * (R::kStages + s), W);  // empty: the consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ------------------------------------------------------------------- GEMMs

// A GEMM block: W consumer warpgroups of 64 output rows each (a tile of
// 64 W rows) and one producer warpgroup; the note at the top says why 3 or 2.
template <int W>
struct Block {
  static constexpr int kBM = 64 * W;
  static constexpr int kThreads = 128 * (W + 1);
  static constexpr uint32_t kTileA = kBM * kBK * 2;
  static constexpr int kConsumerRegs = W == 3 ? 160 : 232;
  static constexpr int kProducerRegs = W == 3 ? 24 : 40;
};

// What a GEMM launch computes. Up to two problems (the weight gradients'
// dW1^T and dW2^T; the others have one) of M x N outputs in tiles of
// 64 W x BN, each contracted over K in stages of 64, the contraction split
// into `splits` chunks of `chunk` stages. Work items run split-major, then
// problem, then tile (N fastest), so neighbouring blocks share A rows.
struct Gemm {
  int tiles_n[2];   // ceil(N / BN)
  int tiles[2];     // ceil(M / 64 W) x tiles_n; 0 for an absent problem
  int m[2];         // M: output rows that exist (R for the row products)
  int n[2];         // N: output columns that exist, the row stride of the output
  int steps;        // contraction stages in all: ceil(K / 64), the last one
                    // ragged where 64 does not divide K (zeros from TMA)
  int chunk;        // stages of one split
  int splits;
  const float* bias;  // b1 (kGelu*Out), b2 (kResidualOut)
  const bf16* x;      // the residual (kResidualOut)
  bf16* out;          // h, out or dy
  float* part;        // kPartialOut: f32 partials, split-major
  long long split_stride;  // floats of one split's partials (both problems)
};

struct Item {
  int p, m0, n0, k0, steps, split;
};

template <int BM, int BN>
__device__ __forceinline__ Item item_of(const Gemm& a, int i) {
  const int per = a.tiles[0] + a.tiles[1];
  Item w;
  w.split = i / per;
  int r = i - w.split * per;
  w.p = r >= a.tiles[0];
  if (w.p) r -= a.tiles[0];
  w.m0 = (r / a.tiles_n[w.p]) * BM;
  w.n0 = (r % a.tiles_n[w.p]) * BN;
  w.k0 = w.split * a.chunk;
  w.steps = min(a.chunk, a.steps - w.k0);
  return w;
}

// A: rows m0.. (K-major, one box of 64 x BM) or columns m0.. (MN-major,
// boxes of 64 x 64); B likewise over n0.. with BN rows or columns.
template <int BM, int BN, int TA, int TB>
__device__ __forceinline__ void load_stage(uint32_t a_s, const CUtensorMap* a_map,
                                           const CUtensorMap* b_map, uint32_t bar, int m0,
                                           int n0, int k) {
  if (TA == 0)
    tma_tile<64>(a_s, a_map, bar, k, m0, 0, BM);
  else
    tma_tile<BM>(a_s, a_map, bar, m0, k, 0, kBK);
  const uint32_t b_s = a_s + BM * kBK * 2;
  if (TB == 0)
    tma_tile<64>(b_s, b_map, bar, k, n0, 0, BN);
  else
    tma_tile<BN>(b_s, b_map, bar, n0, k, 0, kBK);
}

// Descriptors of k-step kk (16 contraction columns) of a stage for
// warpgroup wg's 64 rows of a BM-row A and all BN columns of B.
template <int BM, int TA>
__device__ __forceinline__ uint64_t desc_a(uint32_t a_s, int wg, int kk) {
  return TA == 0 ? desc_k<64>(a_s, BM, wg * 64, kk) : desc_mn<64>(a_s + wg * 64 * 128, kBK, kk);
}

template <int BN, int TB>
__device__ __forceinline__ uint64_t desc_b(uint32_t b_s, int kk) {
  return TB == 0 ? desc_k<64>(b_s, BN, 0, kk) : desc_mn<BN>(b_s, kBK, kk);
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 256)
    wgmma_n256<TA, TB>(d, da, db, scale_d);
  else if constexpr (BN == 192)
    wgmma_n192<TA, TB>(d, da, db, scale_d);
  else
    wgmma_n128<TA, TB>(d, da, db, scale_d);
}

__device__ __forceinline__ float2 shfl_xor2(float2 v, int m) {
  return make_float2(__shfl_xor_sync(0xffffffffu, v.x, m), __shfl_xor_sync(0xffffffffu, v.y, m));
}

__device__ __forceinline__ uint32_t shfl_xor2(uint32_t v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}

// A 4 x 4 transpose across the quad of lanes t = lane % 4: on entry p[jj] is
// this lane's value of column group jj, on exit p[s] is lane s's value of
// group t. Two butterfly stages (lanes t ^ 1, then t ^ 2); the indices stay
// compile-time, so p stays in registers.
template <typename T>
__device__ __forceinline__ void quad_transpose(T (&p)[4], int t) {
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    const bool hi = t & m;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (jj & m) continue;
      const T got = shfl_xor2(hi ? p[jj] : p[jj | m], m);
      if (hi)
        p[jj] = got;
      else
        p[jj | m] = got;
    }
  }
}

// Writes a consumer's accumulator. Thread t of warpgroup wg holds rows
// 16 (t / 32) + (t % 32) / 4 (+ 8) of the warpgroup's 64, columns
// 8 j + 2 (t % 4) (+ 1), at d[4 j + {0, 1}] (and d[4 j + {2, 3}]). Each quad
// first transposes four column groups with shuffles, so that a thread holds
// 8 consecutive columns of its row and reads and writes them as 16 bytes (32
// in f32): the h written from the accumulator's own layout, 4 bytes a thread
// and 16 a row per warp store, took 200 of u = y W1's 655 us on an H100 at
// 49,152 rows.
template <int BN, int E>
__device__ __forceinline__ void epilogue(const Gemm& a, const Item& w, int wg,
                                         float (&d)[BN / 2]) {
  const int tid = threadIdx.x % 128;
  const int t = tid % 4;
  const int ra = w.m0 + wg * 64 + (tid / 32) * 16 + (tid % 32) / 4;
  const size_t ld = static_cast<size_t>(a.n[w.p]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = ra + 8 * h;
    const bool live = row < a.m[w.p];
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      float2 p[4];  // this thread's pairs of column groups 4 q .. 4 q + 3
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        p[jj] = make_float2(d[4 * (4 * q + jj) + 2 * h], d[4 * (4 * q + jj) + 2 * h + 1]);
      quad_transpose(p, t);  // now the quad's pairs of group 4 q + t
      const int col = w.n0 + 8 * (4 * q + t);
      // N is a multiple of 8: a group lies wholly inside or past the columns
      if (!live || col >= a.n[w.p]) continue;
      const size_t at = static_cast<size_t>(row) * ld + col;
      float v[8] = {p[0].x, p[0].y, p[1].x, p[1].y, p[2].x, p[2].y, p[3].x, p[3].y};
      if constexpr (E == kPartialOut) {
        float* dst = a.part + w.split * a.split_stride +
                     (w.p ? static_cast<long long>(a.m[0]) * a.n[0] : 0) + at;
        reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        if constexpr (E != kRoundOut) {
          const float4 b0 = reinterpret_cast<const float4*>(a.bias + col)[0];
          const float4 b1 = reinterpret_cast<const float4*>(a.bias + col)[1];
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] += b[k];
        }
        if constexpr (E == kGeluOut || E == kGeluExactOut) {
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = gelu<E == kGeluExactOut>(v[k]);
        } else if constexpr (E == kResidualOut) {
          const uint4 xr = *reinterpret_cast<const uint4*>(a.x + at);
          const auto* x2 = reinterpret_cast<const __nv_bfloat162*>(&xr);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 xf = __bfloat1622float2(x2[k]);
            v[2 * k] += xf.x;
            v[2 * k + 1] += xf.y;
          }
        }
        uint4 packed;
        packed.x = pack_bf16(v[0], v[1]);
        packed.y = pack_bf16(v[2], v[3]);
        packed.z = pack_bf16(v[4], v[5]);
        packed.w = pack_bf16(v[6], v[7]);
        *reinterpret_cast<uint4*>(a.out + at) = packed;
      }
    }
  }
}

// out (or part) = A B over the launch's work items; persistent, one block an
// SM. a0/b0 are problem 0's operand maps, a1/b1 problem 1's.
template <int W, int BN, int TA, int TB, int E>
__global__ void __launch_bounds__(Block<W>::kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap b0,
                const __grid_constant__ CUtensorMap a1, const __grid_constant__ CUtensorMap b1,
                const __grid_constant__ Gemm args) {
  using B = Block<W>;
  constexpr uint32_t kStage = B::kTileA + BN * kBK * 2;
  using L = Ring<kStage>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  const uint32_t full = base + L::kBars;
  const uint32_t empty = full + 8 * S;
  const int items = args.splits * (args.tiles[0] + args.tiles[1]);
  const int wg = threadIdx.x / 128;
  init_ring<L, W>(base);

  if (wg == W) {  // producer: one thread issues every copy
    setmaxnreg_dec<B::kProducerRegs>();
    if (threadIdx.x == 128 * W) {
      int it = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const Item w = item_of<B::kBM, BN>(args, i);
        const CUtensorMap* am = w.p ? &a1 : &a0;
        const CUtensorMap* bm = w.p ? &b1 : &b0;
        for (int ks = 0; ks < w.steps; ++ks, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(empty + 8 * s, ((it / S) - 1) & 1);
          mbar_expect_tx(full + 8 * s, kStage);
          load_stage<B::kBM, BN, TA, TB>(base + s * kStage, am, bm, full + 8 * s, w.m0, w.n0,
                                         (w.k0 + ks) * kBK);
        }
      }
    }
  } else {  // consumers: 64 rows of each tile
    setmaxnreg_inc<B::kConsumerRegs>();
    const bool lead = threadIdx.x % 128 == 0;
    int it = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const Item w = item_of<B::kBM, BN>(args, i);
      float d[BN / 2];
      for (int ks = 0; ks < w.steps; ++ks, ++it) {
        const int s = it % S;
        mbar_wait(full + 8 * s, (it / S) & 1);
        const uint32_t a_s = base + s * kStage;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          mma<BN, TA, TB>(d, desc_a<B::kBM, TA>(a_s, wg, kk),
                          desc_b<BN, TB>(a_s + B::kTileA, kk), ks > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the stage before this one has been read
        if (ks > 0 && lead) mbar_arrive(empty + 8 * ((it - 1) % S));
      }
      wgmma_wait<0>();
      if (lead) mbar_arrive(empty + 8 * ((it - 1) % S));
      reg_fence(d);
      epilogue<BN, E>(args, w, wg, d);
    }
  }
}

// ------------------------------------------------- backward: u and dh

struct Dual {
  int tiles_n, tiles, steps, rows;
  int hd;           // hidden columns, the row stride of h and du
  const float* b1;
  bf16* h;
  bf16* du;
  float* db1_part;  // (ceil(R / 128), Hd): column sums of du per row tile
};

// u = y W1 and dh = g W2^T on one (128-row, 128-hidden) tile, then
// h = round(gelu(u + b1)), du = round(dh) gelu'(u + b1) (written in bf16),
// and the tile's column sums of the unrounded du. A stage holds y, g (K-
// major), w1t's rows (K-major) and w2t's columns (MN-major). EXACT: the
// GELU form.
template <int EXACT>
__global__ void __launch_bounds__(kThreads, 1)
    dual_kernel(const __grid_constant__ CUtensorMap y_map,
                const __grid_constant__ CUtensorMap g_map,
                const __grid_constant__ CUtensorMap w1_map,  // w1t, boxes of 128 rows
                const __grid_constant__ CUtensorMap w2_map,  // w2t, boxes of 64 rows
                const __grid_constant__ Dual args) {
  constexpr uint32_t kStage = 4 * kTileA;
  using L = Ring<kStage>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  const uint32_t full = base + L::kBars;
  const uint32_t empty = full + 8 * S;
  // after the barriers: the 8 consumer warps' column sums of a tile, then
  // the tile's 128 values of b1 (zeros past Hd)
  float* red = reinterpret_cast<float*>(smem + (base - smem_u32(smem)) + L::kBars + 16 * S);
  float* b1_s = red + 8 * 128;
  const int wg = threadIdx.x / 128;
  init_ring<L, 2>(base);

  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int i = blockIdx.x; i < args.tiles; i += gridDim.x) {
        const int m0 = (i / args.tiles_n) * kBM, n0 = (i % args.tiles_n) * 128;
        for (int ks = 0; ks < args.steps; ++ks, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(empty + 8 * s, ((it / S) - 1) & 1);
          const uint32_t st = base + s * kStage, bar = full + 8 * s;
          const int k = ks * kBK;
          mbar_expect_tx(bar, kStage);
          tma_tile<64>(st, &y_map, bar, k, m0, 0, kBM);
          tma_tile<64>(st + kTileA, &g_map, bar, k, m0, 0, kBM);
          tma_tile<64>(st + 2 * kTileA, &w1_map, bar, k, n0, 0, 128);
          tma_tile<128>(st + 3 * kTileA, &w2_map, bar, n0, k, 0, kBK);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int warp = threadIdx.x / 32;  // 0..7
    int it = 0;
    for (int i = blockIdx.x; i < args.tiles; i += gridDim.x) {
      const int mt = i / args.tiles_n;
      const int m0 = mt * kBM, n0 = (i % args.tiles_n) * 128;
      // read after the first consumers_sync below; the last tile's reads
      // ended before its second
      if (threadIdx.x < 128)
        b1_s[threadIdx.x] = n0 + static_cast<int>(threadIdx.x) < args.hd
                                ? args.b1[n0 + threadIdx.x] : 0.f;
      float u[64], dh[64];
      for (int ks = 0; ks < args.steps; ++ks, ++it) {
        const int s = it % S;
        mbar_wait(full + 8 * s, (it / S) & 1);
        const uint32_t st = base + s * kStage;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const int acc = ks > 0 || kk > 0;
          wgmma_n128<0, 0>(u, desc_a<kBM, 0>(st, wg, kk), desc_b<128, 0>(st + 2 * kTileA, kk), acc);
          wgmma_n128<0, 1>(dh, desc_a<kBM, 0>(st + kTileA, wg, kk),
                           desc_b<128, 1>(st + 3 * kTileA, kk), acc);
        }
        wgmma_commit();
        wgmma_wait<0>();
        if (tid == 0) mbar_arrive(empty + 8 * s);
      }
      reg_fence(u);
      reg_fence(dh);

      const int ra = m0 + wg * 64 + (tid / 32) * 16 + (tid % 32) / 4;
      consumers_sync();  // the last tile's column sums have been read
      const int t = tid % 4;
      // Four groups of 32 columns: each group's h and du as bf16 pairs of
      // rows ra and ra + 8, written as the GEMM epilogue writes (16 bytes a
      // thread) before the next group's are made, so that few of them live
      // beside the accumulators.
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t hp[2][4], dp[2][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * q + jj;
          // columns n0 + 8 j + 2 t (+ 1); past Hd u and dh are zeros (TMA),
          // so du is 0 there, and nothing is stored
          const float2 b = reinterpret_cast<const float2*>(b1_s)[4 * j + t];
          float sum[2] = {0.f, 0.f};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float hv[2], dv[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * j + 2 * hh + c;
              const float gd = gelu_and_grad<EXACT>(u[e] + (c ? b.y : b.x), &hv[c]);
              dv[c] = round_bf16(dh[e]) * gd;
            }
            hp[hh][jj] = pack_bf16(hv[0], hv[1]);
            dp[hh][jj] = pack_bf16(dv[0], dv[1]);
            if (ra + 8 * hh < args.rows) {
              sum[0] += dv[0];
              sum[1] += dv[1];
            }
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {  // over the 8 row pairs of the warp
            float v = sum[c];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (tid % 32 < 4) red[warp * 128 + 8 * j + 2 * t + c] = v;
          }
        }
        const int col = n0 + 8 * (4 * q + t);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          quad_transpose(hp[hh], t);
          quad_transpose(dp[hh], t);
          const int row = ra + 8 * hh;
          if (row >= args.rows || col >= args.hd) continue;
          const size_t at = static_cast<size_t>(row) * args.hd + col;
          *reinterpret_cast<uint4*>(args.h + at) = make_uint4(hp[hh][0], hp[hh][1], hp[hh][2],
                                                              hp[hh][3]);
          *reinterpret_cast<uint4*>(args.du + at) = make_uint4(dp[hh][0], dp[hh][1], dp[hh][2],
                                                               dp[hh][3]);
        }
      }
      consumers_sync();
      if (threadIdx.x < 128 && n0 + static_cast<int>(threadIdx.x) < args.hd) {
        float v = 0.f;
        for (int q = 0; q < 8; ++q) v += red[q * 128 + threadIdx.x];
        args.db1_part[static_cast<size_t>(mt) * args.hd + n0 + threadIdx.x] = v;
      }
    }
  }
}

// -------------------------------------------------------------- reductions

// Job j: out_j[i] = sum over p < parts_j of part_j[p * stride_j + i], in p
// order, in f32; cast to bf16 where to_bf16_j. Every n and stride is a
// multiple of 4.
struct Sums {
  const float* part[6];
  void* out[6];
  long long n[6], stride[6];
  int parts[6], to_bf16[6];
};

__global__ void __launch_bounds__(256) sum_kernel(const __grid_constant__ Sums s) {
  constexpr int kBatch = 8;  // loads in flight, added in order
  const int j = blockIdx.y;
  const long long n4 = s.n[j] / 4;
  const auto* part = reinterpret_cast<const float4*>(s.part[j]);
  const long long stride4 = s.stride[j] / 4;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p0 = 0; p0 < s.parts[j]; p0 += kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        if (p0 + q < s.parts[j]) v[q] = part[(p0 + q) * stride4 + i];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (p0 + q >= s.parts[j]) break;
        a.x += v[q].x;
        a.y += v[q].y;
        a.z += v[q].z;
        a.w += v[q].w;
      }
    }
    if (s.to_bf16[j]) {
      auto* o = reinterpret_cast<__nv_bfloat162*>(s.out[j]) + 2 * i;
      o[0] = __floats2bfloat162_rn(a.x, a.y);
      o[1] = __floats2bfloat162_rn(a.z, a.w);
    } else {
      reinterpret_cast<float4*>(s.out[j])[i] = a;
    }
  }
}

// ------------------------------------------------------------------ host

int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

size_t align256(size_t v) { return (v + 255) / 256 * 256; }

int pad(int n, int to) { return (n + to - 1) / to * to; }

// The GEMM blocks of a width: W = 3 consumer warpgroups with tiles of
// 192 x 192, or W = 2 with 128 x 256 or 128 x 128; every product of a call
// takes the one with the least padded work, the first in that order on a
// tie. The work counts the multiply-adds of the five products a row of R
// (u = y W1, o = h W2, dy = du W1^T) or a contraction step (dW1^T, dW2^T)
// over the tiles' padded output and the 64-column stages' padded depth.
// Where a tile divides C and Hd it pads nothing, so the widths taken first
// keep their tiles: 192 x 192 for 384 and 768 with the 4x hidden width,
// 128 x 256 for 1024 and 1280, 128 x 128 for C = 384 with a hidden width 192
// does not divide; ViT-g's 1408 takes 128 x 128 (11 x 128).
struct Shape {
  int w, bn;
};

long long padded_work(int C, int Hd, int bm, int bn) {
  const auto mac = [](int a, int b) { return static_cast<long long>(a) * b; };
  return mac(pad(Hd, bn), pad(C, kBK)) + 2 * mac(pad(C, bn), pad(Hd, kBK)) +
         mac(pad(Hd, bm), pad(C, bn)) + mac(pad(C, bm), pad(Hd, bn));
}

Shape shape_of(int C, int Hd) {
  const Shape shapes[3] = {{3, 192}, {2, 256}, {2, 128}};
  Shape best = shapes[0];
  long long least = padded_work(C, Hd, 192, 192);
  for (int i = 1; i < 3; ++i) {
    const long long w = padded_work(C, Hd, 64 * shapes[i].w, shapes[i].bn);
    if (w < least) {
      least = w;
      best = shapes[i];
    }
  }
  return best;
}

int sm_count() {
  int dev = 0, n = kWaveSms;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// Every C and Hd that are multiples of 8 (TMA's 16-byte row strides; the
// epilogues' 16-byte stores of 8 columns) up to the CUDA-core kernels' limits.
bool supported(int C, int Hd) {
  return C > 0 && C <= kMaxC && C % 8 == 0 && Hd > 0 && Hd <= kMaxHidden && Hd % 8 == 0;
}

// The weight gradients' split of the R rows into chunks of whole stages:
// the S <= 16 that minimises waves x (stages a chunk + an epilogue's worth),
// with waves = ceil(tiles S / 132); the first such S. At R = 12,288 and ViT-B
// widths (128 tiles of 192 x 192) it is one chunk: no split.
void split_k(int R, int tiles, int* splits, int* chunk) {
  const int steps = ceil_div(R, kBK);
  long long best = -1;
  for (int s = 1; s <= kMaxSplits; ++s) {
    const int per = ceil_div(steps, s);
    if (ceil_div(steps, per) != s) continue;  // a chunk would be empty
    const long long cost =
        static_cast<long long>(ceil_div(static_cast<long long>(tiles) * s, kWaveSms)) *
        (per + kEpilogueSteps);
    if (best < 0 || cost < best) {
      best = cost;
      *splits = s;
      *chunk = per;
    }
  }
}

// The backward's scratch, one allocation: y, h, du and dy in bf16, the row
// mean and rstd, the LayerNorm backward's partials (3, ceil(R / 64), C),
// db1's (ceil(R / 128), Hd), and the weight gradients' split partials
// (splits, dW1^T then dW2^T) in f32; each at a 256-byte boundary.
struct Work {
  int ln_tiles, m_tiles, tiles, splits, chunk;
  size_t y, h, du, dy, mean, rstd, pln, pb1, pw, bytes;
};

Work workspace(int R, int C, int Hd) {
  Work w{};
  const Shape sh = shape_of(C, Hd);
  const int bm = 64 * sh.w;
  w.ln_tiles = ceil_div(R, kLnRows);
  w.m_tiles = ceil_div(R, kBM);
  w.tiles = ceil_div(Hd, bm) * ceil_div(C, sh.bn) + ceil_div(C, bm) * ceil_div(Hd, sh.bn);
  split_k(R, w.tiles, &w.splits, &w.chunk);
  const size_t r = static_cast<size_t>(R);
  size_t off = 0;
  w.y = off;
  off = align256(off + r * C * 2);
  w.h = off;
  off = align256(off + r * Hd * 2);
  w.du = off;
  off = align256(off + r * Hd * 2);
  w.dy = off;
  off = align256(off + r * C * 2);
  w.mean = off;
  off = align256(off + r * 4);
  w.rstd = off;
  off = align256(off + r * 4);
  w.pln = off;
  off = align256(off + static_cast<size_t>(3) * w.ln_tiles * C * 4);
  w.pb1 = off;
  off = align256(off + static_cast<size_t>(w.m_tiles) * Hd * 4);
  w.pw = off;
  off = align256(off + static_cast<size_t>(w.splits) * 2 * C * Hd * 4);
  w.bytes = off;
  return w;
}

// A tensor map over a row-major (rows, cols) bf16 matrix, boxes of 64
// columns and box_rows rows, 128-byte swizzle; rows past the end read as 0.
int matrix_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  return make_map<64>(map, ptr, cols, rows, 1, box_rows);
}

template <int W, int BN, int TA, int TB, int E>
int launch_gemm(const CUtensorMap& a0, const CUtensorMap& b0, const CUtensorMap& a1,
                const CUtensorMap& b1, const Gemm& args, cudaStream_t stream) {
  using L = Ring<Block<W>::kTileA + BN * kBK * 2>;
  auto kernel = gemm_kernel<W, BN, TA, TB, E>;
  const int err = allow_smem(kernel, L::kSmem);
  if (err != cudaSuccess) return err;
  const int items = args.splits * (args.tiles[0] + args.tiles[1]);
  kernel<<<std::min(items, sm_count()), Block<W>::kThreads, L::kSmem, stream>>>(a0, b0, a1, b1,
                                                                                 args);
  return cudaGetLastError();
}

// The GEMM of `sh`'s blocks; A's maps have boxes of 64 W rows (K-major) or
// 64 (MN-major), B's of BN rows (K-major) or 64.
template <int TA, int TB, int E>
int launch_shape(const Shape& sh, const CUtensorMap& a0, const CUtensorMap& b0,
                 const CUtensorMap& a1, const CUtensorMap& b1, const Gemm& args,
                 cudaStream_t stream) {
  if (sh.w == 3) return launch_gemm<3, 192, TA, TB, E>(a0, b0, a1, b1, args, stream);
  if (sh.bn == 256) return launch_gemm<2, 256, TA, TB, E>(a0, b0, a1, b1, args, stream);
  return launch_gemm<2, 128, TA, TB, E>(a0, b0, a1, b1, args, stream);
}

// A row product (splits 1, one problem) of rows R, N columns, K = `depth`.
Gemm row_gemm(const Shape& sh, int R, int N, int depth) {
  Gemm g{};
  g.tiles_n[0] = ceil_div(N, sh.bn);
  g.tiles[0] = ceil_div(R, 64 * sh.w) * g.tiles_n[0];
  g.tiles_n[1] = 1;
  g.m[0] = R;
  g.n[0] = N;
  g.steps = ceil_div(depth, kBK);
  g.chunk = g.steps;
  g.splits = 1;
  return g;
}

template <int P>
int launch_ln_rows(const void* x, const float* scale, const float* bias, void* y, float* mean,
                   float* rstd, int R, int C, cudaStream_t s) {
  ln_rows_kernel<P><<<ceil_div(R, kLnWarps), kLnWarps * 32, 0, s>>>(
      static_cast<const bf16*>(x), scale, bias, static_cast<bf16*>(y), mean, rstd, R, C);
  return cudaGetLastError();
}

template <int P>
int launch_ln_bwd(const void* dy, const void* x, const void* g, const float* scale,
                  const float* mean, const float* rstd, void* dx, float* part, int R, int C,
                  cudaStream_t s) {
  ln_bwd_kernel<P><<<ceil_div(R, kLnRows), 32 * ceil_div(C, 64), 0, s>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      scale, mean, rstd, static_cast<bf16*>(dx), part, R, C);
  return cudaGetLastError();
}

// The LayerNorm passes at each pair count a lane in Ps; a width takes the
// least at or past C / 64 (the four preset widths fill theirs).
template <int... Ps>
struct LnPasses {
  static int bucket(int C) {
    constexpr int pairs[] = {Ps...};
    int i = 0;
    while (i + 1 < static_cast<int>(sizeof...(Ps)) && 64 * pairs[i] < C) ++i;
    return i;
  }
  static int rows(const void* x, const float* scale, const float* bias, void* y, float* mean,
                  float* rstd, int R, int C, cudaStream_t s) {
    constexpr decltype(&launch_ln_rows<2>) fns[] = {launch_ln_rows<Ps>...};
    return fns[bucket(C)](x, scale, bias, y, mean, rstd, R, C, s);
  }
  static int bwd(const void* dy, const void* x, const void* g, const float* scale,
                 const float* mean, const float* rstd, void* dx, float* part, int R, int C,
                 cudaStream_t s) {
    constexpr decltype(&launch_ln_bwd<2>) fns[] = {launch_ln_bwd<Ps>...};
    return fns[bucket(C)](dy, x, g, scale, mean, rstd, dx, part, R, C, s);
  }
};
using Ln = LnPasses<2, 4, 6, 8, 12, 16, 20, 24, 28, 32>;

}  // namespace

// Bytes of scratch `fused_mlp_sm90_bwd` needs at R rows (see `workspace`);
// -1 for a shape it does not take.
extern "C" long long fused_mlp_bwd_workspace_bytes(int R, int C, int Hd) {
  if (!supported(C, Hd) || R <= 0) return -1;
  return static_cast<long long>(workspace(R, C, Hd).bytes);
}

// Forward: x (R, C) bf16 -> out (R, C) bf16; w1t (Hd, C), w2t (C, Hd) bf16;
// scale, bias, b1, b2 f32; y (R, C) and h (R, Hd) bf16 are scratch.
extern "C" int fused_mlp_sm90_fwd(const void* x, const void* scale, const void* bias,
                                  const void* w1t, const void* b1, const void* w2t,
                                  const void* b2, void* y, void* h, void* out, int R, int C,
                                  int Hd, int exact, int device, void* stream) {
  if (!supported(C, Hd) || R <= 0) return cudaErrorInvalidValue;
  int err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = Ln::rows(x, static_cast<const float*>(scale), static_cast<const float*>(bias), y,
                 nullptr, nullptr, R, C, s);
  if (err != cudaSuccess) return err;
  const Shape sh = shape_of(C, Hd);
  const int bm = 64 * sh.w;
  CUtensorMap y_map, w1_map, h_map, w2_map;
  err = matrix_map(&y_map, y, R, C, bm);
  if (err == cudaSuccess) err = matrix_map(&w1_map, w1t, Hd, C, sh.bn);
  if (err == cudaSuccess) err = matrix_map(&h_map, h, R, Hd, bm);
  if (err == cudaSuccess) err = matrix_map(&w2_map, w2t, C, Hd, sh.bn);
  if (err != cudaSuccess) return err;
  Gemm g1 = row_gemm(sh, R, Hd, C);
  g1.bias = static_cast<const float*>(b1);
  g1.out = static_cast<bf16*>(h);
  err = exact ? launch_shape<0, 0, kGeluExactOut>(sh, y_map, w1_map, y_map, w1_map, g1, s)
              : launch_shape<0, 0, kGeluOut>(sh, y_map, w1_map, y_map, w1_map, g1, s);
  if (err != cudaSuccess) return err;
  Gemm g2 = row_gemm(sh, R, C, Hd);
  g2.bias = static_cast<const float*>(b2);
  g2.x = static_cast<const bf16*>(x);
  g2.out = static_cast<bf16*>(out);
  return launch_shape<0, 0, kResidualOut>(sh, h_map, w2_map, h_map, w2_map, g2, s);
}

template <int EXACT>
int launch_dual(const CUtensorMap& y, const CUtensorMap& g, const CUtensorMap& w1,
                const CUtensorMap& w2, const Dual& d, cudaStream_t s) {
  using L = Ring<4 * kTileA>;
  const size_t smem = L::kSmem + (8 + 1) * 128 * 4;
  const int err = allow_smem(dual_kernel<EXACT>, smem);
  if (err != cudaSuccess) return err;
  dual_kernel<EXACT><<<std::min(d.tiles, sm_count()), kThreads, smem, s>>>(y, g, w1, w2, d);
  return cudaGetLastError();
}

// Backward: dout (R, C) bf16 -> dx (R, C) bf16, dw1t (Hd, C) and dw2t
// (C, Hd) bf16, dscale, dbias, db2 (C,) and db1 (Hd,) f32. `work` holds
// work_bytes >= fused_mlp_bwd_workspace_bytes(R, C, Hd).
extern "C" int fused_mlp_sm90_bwd(const void* x, const void* scale, const void* bias,
                                  const void* w1t, const void* b1, const void* w2t,
                                  const void* dout, void* dx, void* dscale, void* dbias,
                                  void* dw1t, void* db1, void* dw2t, void* db2, void* work,
                                  long long work_bytes, int R, int C, int Hd, int exact,
                                  int device, void* stream) {
  if (!supported(C, Hd) || R <= 0) return cudaErrorInvalidValue;
  const Work w = workspace(R, C, Hd);
  if (work_bytes < static_cast<long long>(w.bytes)) return cudaErrorInvalidValue;
  int err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* wk = static_cast<unsigned char*>(work);
  auto* y = wk + w.y;
  auto* h = wk + w.h;
  auto* du = wk + w.du;
  auto* dy = wk + w.dy;
  auto* mean = reinterpret_cast<float*>(wk + w.mean);
  auto* rstd = reinterpret_cast<float*>(wk + w.rstd);
  auto* pln = reinterpret_cast<float*>(wk + w.pln);
  auto* pb1 = reinterpret_cast<float*>(wk + w.pb1);
  auto* pw = reinterpret_cast<float*>(wk + w.pw);
  const auto* sc = static_cast<const float*>(scale);
  const Shape sh = shape_of(C, Hd);
  const int bm = 64 * sh.w;

  err = Ln::rows(x, sc, static_cast<const float*>(bias), y, mean, rstd, R, C, s);
  if (err != cudaSuccess) return err;

  CUtensorMap y128, g128, w1_128, w2_64, du_bm, w1_64, du64, y64, g64, h64;
  err = matrix_map(&y128, y, R, C, kBM);
  if (err == cudaSuccess) err = matrix_map(&g128, dout, R, C, kBM);
  if (err == cudaSuccess) err = matrix_map(&w1_128, w1t, Hd, C, 128);
  if (err == cudaSuccess) err = matrix_map(&w2_64, w2t, C, Hd, kBK);
  if (err == cudaSuccess) err = matrix_map(&du_bm, du, R, Hd, bm);
  if (err == cudaSuccess) err = matrix_map(&w1_64, w1t, Hd, C, kBK);
  if (err == cudaSuccess) err = matrix_map(&du64, du, R, Hd, kBK);
  if (err == cudaSuccess) err = matrix_map(&y64, y, R, C, kBK);
  if (err == cudaSuccess) err = matrix_map(&g64, dout, R, C, kBK);
  if (err == cudaSuccess) err = matrix_map(&h64, h, R, Hd, kBK);
  if (err != cudaSuccess) return err;

  Dual d{};  // u and dh -> h, du, db1's partials
  d.tiles_n = ceil_div(Hd, 128);
  d.tiles = w.m_tiles * d.tiles_n;
  d.steps = ceil_div(C, kBK);
  d.rows = R;
  d.hd = Hd;
  d.b1 = static_cast<const float*>(b1);
  d.h = reinterpret_cast<bf16*>(h);
  d.du = reinterpret_cast<bf16*>(du);
  d.db1_part = pb1;
  err = exact ? launch_dual<1>(y128, g128, w1_128, w2_64, d, s)
              : launch_dual<0>(y128, g128, w1_128, w2_64, d, s);
  if (err != cudaSuccess) return err;

  Gemm g3 = row_gemm(sh, R, C, Hd);  // dy = round(du W1^T)
  g3.out = reinterpret_cast<bf16*>(dy);
  err = launch_shape<0, 1, kRoundOut>(sh, du_bm, w1_64, du_bm, w1_64, g3, s);
  if (err != cudaSuccess) return err;

  err = Ln::bwd(dy, x, dout, sc, mean, rstd, dx, pln, R, C, s);
  if (err != cudaSuccess) return err;

  Gemm g5{};  // dW1^T = du^T y (Hd x C), dW2^T = g^T h (C x Hd), split over rows
  g5.tiles_n[0] = ceil_div(C, sh.bn);
  g5.tiles[0] = ceil_div(Hd, bm) * g5.tiles_n[0];
  g5.m[0] = Hd;
  g5.n[0] = C;
  g5.tiles_n[1] = ceil_div(Hd, sh.bn);
  g5.tiles[1] = ceil_div(C, bm) * g5.tiles_n[1];
  g5.m[1] = C;
  g5.n[1] = Hd;
  g5.steps = ceil_div(R, kBK);
  g5.chunk = w.chunk;
  g5.splits = w.splits;
  g5.part = pw;
  g5.split_stride = 2LL * C * Hd;
  err = launch_shape<1, 1, kPartialOut>(sh, du64, y64, g64, h64, g5, s);
  if (err != cudaSuccess) return err;

  const long long CH = static_cast<long long>(C) * Hd;
  const long long lnp = static_cast<long long>(w.ln_tiles) * C;
  const Sums sums{{pln, pln + lnp, pln + 2 * lnp, pb1, pw, pw + CH},
                  {dscale, dbias, db2, db1, dw1t, dw2t},
                  {C, C, C, Hd, CH, CH},
                  {C, C, C, Hd, 2 * CH, 2 * CH},
                  {w.ln_tiles, w.ln_tiles, w.ln_tiles, w.m_tiles, w.splits, w.splits},
                  {0, 0, 0, 0, 1, 1}};
  sum_kernel<<<dim3(std::min(ceil_div(CH / 4, 256), 4 * sm_count()), 6), 256, 0, s>>>(sums);
  return cudaGetLastError();
}
