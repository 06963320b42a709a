// Kernel K5: the ViT block's second half fused per row,
//   out = x + fc2(gelu(fc1(LayerNorm(x)))),
// its forward and its recompute backward.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel`
// (probpose_pytorch_tpu/ops/pallas/mlp_kernel.py, called from `_fwd` / `_bwd`
// under the custom_vjp `fused_ln_mlp`). Per row, as `_tile_forward` does:
// f32 LayerNorm with the two-pass variance and eps 1e-6; y rounded to the
// weight type; u = y W1 + b1 summed in f32; GELU in f32 (tanh, or erf);
// h rounded to the weight type; o = h W2 + b2 in f32; o + x in f32, cast
// once to x's type. The (rows, 4C) hidden state never reaches device memory.
//
// Weights arrive in nn.Linear's layout: w1t = W1^T (Hd, C), w2t = W2^T
// (C, Hd), both row-major; the gradients dW1^T and dW2^T come back in the
// same layout.
//
// What bounds it on an H100: at ViT-B (C = 768, Hd = 3072) each row costs
// 4 C Hd FLOPs forward against 4 C bytes in and out, ~1,500 FLOP per byte,
// far above the card's ~295 FLOP/byte bf16 ridge: the tensor cores bound
// it. This first version reads its weight fragments straight from the L2
// (W1 + W2 in bf16 are 9.4 MB, resident in the 50 MB L2) with WMMA
// mma.sync; a later one should stage them with TMA and use wgmma.
//
// The budget. A block's (rows, C) f32 output accumulator lives in registers:
// each of 8 warps owns C / 8 output columns for all the block's rows, so
// rows x C x 4 bytes are spread over 256 threads. Instead of splitting the
// output columns across blocks, which would recompute fc1 once per split,
// the block takes fewer rows: 64 at C = 384, 32 at C = 768 and 16 at
// C = 1024 and 1280, which keeps the accumulator at <= 96 registers a thread.
// The hidden dimension streams in chunks of 128 columns (16 per warp): fc1
// of a chunk goes to shared memory as f32, takes b1 and GELU, is rounded
// and multiplied into the accumulator by fc2.
//
// The backward, per row (g = dO in f32, cotangents rounded where the TPU
// kernel's in-kernel jax.vjp rounds them: dh and dy to the weight type):
//   dh = round(g W2^T);  du = dh * gelu'(u);  dy = round(du W1^T)
//   dx = g + rstd (dy*s - mean(dy*s) - xhat mean(dy*s*xhat))
//   dW1 = y^T du, dW2 = h^T g, db1 = sum du, db2 = sum g,
//   dscale = sum dy*xhat, dbias = sum dy
// in three launches, no atomics, so two runs give the same bits:
//   rows pass    one block per row tile, the forward's shape: recomputes
//                u, dh, du chunk by chunk, accumulates dy in registers, then
//                the LayerNorm backward writes dx; per-tile partial sums of
//                dscale, dbias and db2. It also leaves y and g in a
//                zero-padded scratch for the next pass.
//   weights pass one block per (16 hidden columns, 1,024-row chunk):
//                recomputes u and dh of its columns tile by tile and
//                accumulates dW1^T and dW2^T of those columns in registers;
//                writes f32 partials per row chunk (18.9 MB each at ViT-B).
//   reduction    sums the partials of each gradient in chunk order, in f32,
//                and casts dW1 and dW2 to the weight type, as the TPU kernel
//                casts its f32 sums (mlp_kernel.py:202-204).
// On the tensor cores du is rounded to bf16 before the dy and dW1 products
// (the TPU kernel's product takes du in f32); ops/kernels/mlp.py's plain
// backward keeps du in f32 and the card's checks bound the difference.
//
// float32 inputs run on the CUDA cores (FMA, no TF32), with the same passes:
// 16-row tiles, 256 hidden columns a chunk (one per thread), weight slabs
// staged transposed in shared memory where a thread's reads would stride.
//
// Shapes: C in {384, 768, 1024, 1280}, Hd a multiple of 256. Plain-C
// interface, loaded with ctypes (ops/kernels/mlp.py); every entry point
// returns a cudaError_t as int (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr float kEps = 1e-6f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// jax.nn.gelu, f32: tanh form x * 0.5 (1 + tanh(k (x + 0.044715 x^3))), or
// the exact 0.5 x erfc(-x / sqrt 2).
__device__ __forceinline__ float gelu(float u, int exact) {
  if (exact) return 0.5f * u * erfcf(-u * 0.70710678118654752f);
  const float t = tanhf(0.7978845608028654f * (u + 0.044715f * (u * u * u)));
  return u * (0.5f * (1.f + t));
}

__device__ __forceinline__ float gelu_grad(float u, int exact) {
  if (exact)
    return 0.5f * erfcf(-u * 0.70710678118654752f) +
           u * 0.3989422804014327f * expf(-0.5f * u * u);
  const float t = tanhf(0.7978845608028654f * (u + 0.044715f * (u * u * u)));
  return 0.5f * (1.f + t) +
         0.5f * u * (1.f - t * t) * 0.7978845608028654f * (1.f + 3.f * 0.044715f * u * u);
}

// LayerNorm of rows row0 .. row0 + BM of x (R, C) into y_s (row stride ys),
// rounded to T, two-pass variance. Rows past R give zeros. Optionally the
// row's mean and rstd (mu_s, rs_s) and a copy of y in y_out (rows < the
// padded row count, which the grid covers).
template <typename T, int BM>
__device__ void layer_norm_tile(const T* __restrict__ x, const float* __restrict__ scale,
                                const float* __restrict__ bias, int C, int row0, int R,
                                T* y_s, int ys, float* mu_s, float* rs_s, T* y_out) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kWarps) {
    const int n = row0 + r;
    T* yo = y_out ? y_out + static_cast<size_t>(n) * C : nullptr;
    if (n >= R) {
      for (int c = lane; c < C; c += 32) {
        y_s[r * ys + c] = from_f<T>(0.f);
        if (yo) yo[c] = from_f<T>(0.f);
      }
      if (mu_s && lane == 0) mu_s[r] = rs_s[r] = 0.f;
      continue;
    }
    const T* xr = x + static_cast<size_t>(n) * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
    const float mu = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f(xr[c]) - mu;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / C + kEps);
    for (int c = lane; c < C; c += 32) {
      const T yv = from_f<T>((to_f(xr[c]) - mu) * rstd * scale[c] + bias[c]);
      y_s[r * ys + c] = yv;
      if (yo) yo[c] = yv;
    }
    if (mu_s && lane == 0) {
      mu_s[r] = mu;
      rs_s[r] = rstd;
    }
  }
}

// The LayerNorm backward of a row tile, from the f32 dy in dy_s (row stride
// ds), rounded to T first: dx per row (warp per row), then per column the
// tile's partial sums of dscale, dbias and db2 into part (3, ntiles, C).
template <typename T, int BM>
__device__ void ln_backward_tile(const float* dy_s, int ds, const T* __restrict__ x,
                                 const T* __restrict__ dout, const float* __restrict__ scale,
                                 const float* mu_s, const float* rs_s, int C, int row0,
                                 int R, T* __restrict__ dx, float* __restrict__ part,
                                 int tile, int ntiles) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kWarps) {
    const int n = row0 + r;
    if (n >= R) continue;
    const float mu = mu_s[r], rstd = rs_s[r];
    const T* xr = x + static_cast<size_t>(n) * C;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dxh = round_to<T>(dy_s[r * ds + c]) * scale[c];
      s1 += dxh;
      s2 += dxh * ((to_f(xr[c]) - mu) * rstd);
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
    const T* gr = dout + static_cast<size_t>(n) * C;
    T* dr = dx + static_cast<size_t>(n) * C;
    for (int c = lane; c < C; c += 32) {
      const float dxh = round_to<T>(dy_s[r * ds + c]) * scale[c];
      const float xh = (to_f(xr[c]) - mu) * rstd;
      dr[c] = from_f<T>(to_f(gr[c]) + rstd * (dxh - s1 - xh * s2));
    }
  }
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float dsc = 0.f, dbi = 0.f, db2 = 0.f;
    for (int r = 0; r < BM && row0 + r < R; ++r) {
      const size_t i = static_cast<size_t>(row0 + r) * C + c;
      const float dyr = round_to<T>(dy_s[r * ds + c]);
      dsc += dyr * ((to_f(x[i]) - mu_s[r]) * rs_s[r]);
      dbi += dyr;
      db2 += to_f(dout[i]);
    }
    part[(static_cast<size_t>(0) * ntiles + tile) * C + c] = dsc;
    part[(static_cast<size_t>(1) * ntiles + tile) * C + c] = dbi;
    part[(static_cast<size_t>(2) * ntiles + tile) * C + c] = db2;
  }
}

// out[i] = cast(sum over p of part[p * n + i]), p in order.
template <typename T>
__global__ void sum_partials_kernel(const float* __restrict__ part, int P, long long n,
                                    T* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += part[p * n + i];
  out[i] = from_f<T>(s);
}

template <typename T>
cudaError_t sum_partials(const float* part, int P, long long n, void* out, cudaStream_t s) {
  const int blocks = static_cast<int>((n + 255) / 256);
  sum_partials_kernel<T><<<blocks, 256, 0, s>>>(part, P, n, static_cast<T*>(out));
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16, WMMA

constexpr int kHC = 128;      // hidden columns per chunk: 8 warps x 16
constexpr int kUS = kHC + 4;  // f32 row stride of a chunk's u and dh
constexpr int kHS = kHC + 8;  // bf16 row stride of a chunk's h and du
constexpr int kBT = 64;       // rows per tile of the weights pass
constexpr int kHB = 16;       // hidden columns per block of the weights pass
constexpr int kRC = 1024;     // rows per partial of the weight gradients
constexpr int kBU = kHB + 4;  // f32 row stride of the weights pass's u, dh
constexpr int kBS = kHB + 8;  // bf16 row stride of its h, du

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int C>
struct Geo {
  static constexpr int RF = C == 384 ? 4 : (C == 768 ? 2 : 1);  // 16-row fragments
  static constexpr int BM = 16 * RF;                            // rows per block
  static constexpr int NF = C / 128;     // 16-column output fragments per warp
  static constexpr int YS = C + 8;       // bf16 row stride of y and g tiles
  static constexpr int OS = C + 4;       // f32 row stride of the o / dy tile
  static constexpr int CS = C >= 1024 ? 2 : 1;       // column splits, weights pass
  static constexpr int NW = C / CS / 16 / kWarps;    // its fragments per warp
};

int rows_per_block(int C) { return C == 384 ? 64 : (C == 768 ? 32 : 16); }

template <int C>
size_t fwd_mma_smem() {
  using G = Geo<C>;
  const size_t loop = static_cast<size_t>(G::BM) * (G::YS * 2 + kUS * 4 + kHS * 2);
  const size_t epi = static_cast<size_t>(G::BM) * G::OS * 4;
  return loop > epi ? loop : epi;
}

template <int C>
size_t bwd_rows_mma_smem() {
  using G = Geo<C>;
  return static_cast<size_t>(G::BM) * (2 * G::YS * 2 + 2 * kUS * 4 + kHS * 2 + 2 * 4);
}

constexpr size_t kBwdWeightsMmaSmem =
    static_cast<size_t>(kBT) * (2 * kBU * 4 + 2 * kBS * 2) + kThreads * 4;

// u = y W1[:, c0 + 16 warp .. +16] for the block's RF row fragments, into
// u_s (row stride kUS), column 16 * warp.
template <int C>
__device__ __forceinline__ void chunk_fc1(const bf16* y_s, const bf16* __restrict__ w1t,
                                          int c0, float* u_s) {
  using G = Geo<C>;
  const int warp = threadIdx.x / 32;
  FragC acc[G::RF];
#pragma unroll
  for (int rf = 0; rf < G::RF; ++rf) wmma::fill_fragment(acc[rf], 0.f);
  const bf16* wb = w1t + static_cast<size_t>(c0 + 16 * warp) * C;
  for (int k = 0; k < C; k += 16) {
    FragBc b;
    wmma::load_matrix_sync(b, wb + k, C);
#pragma unroll
    for (int rf = 0; rf < G::RF; ++rf) {
      FragA a;
      wmma::load_matrix_sync(a, y_s + 16 * rf * G::YS + k, G::YS);
      wmma::mma_sync(acc[rf], a, b, acc[rf]);
    }
  }
#pragma unroll
  for (int rf = 0; rf < G::RF; ++rf)
    wmma::store_matrix_sync(u_s + 16 * rf * kUS + 16 * warp, acc[rf], kUS, wmma::mem_row_major);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_fwd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                             const float* __restrict__ bias, const bf16* __restrict__ w1t,
                             const float* __restrict__ b1, const bf16* __restrict__ w2t,
                             const float* __restrict__ b2, bf16* __restrict__ out, int R,
                             int Hd, int exact) {
  using G = Geo<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* y_s = reinterpret_cast<bf16*>(smem);
  float* u_s = reinterpret_cast<float*>(y_s + G::BM * G::YS);
  bf16* h_s = reinterpret_cast<bf16*>(u_s + G::BM * kUS);
  float* o_s = reinterpret_cast<float*>(smem);  // after the chunk loop
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = static_cast<int>(blockIdx.x) * G::BM;
  const int col0 = warp * G::NF * 16;

  layer_norm_tile<bf16, G::BM>(x, scale, bias, C, row0, R, y_s, G::YS, nullptr, nullptr,
                               nullptr);
  __syncthreads();

  FragC o[G::RF][G::NF];
#pragma unroll
  for (int rf = 0; rf < G::RF; ++rf)
#pragma unroll
    for (int nf = 0; nf < G::NF; ++nf) wmma::fill_fragment(o[rf][nf], 0.f);

  for (int c0 = 0; c0 < Hd; c0 += kHC) {
    chunk_fc1<C>(y_s, w1t, c0, u_s);
    __syncwarp();
    for (int e = lane; e < G::BM * 16; e += 32) {  // this warp's 16 columns
      const int r = e / 16, j = 16 * warp + e % 16;
      h_s[r * kHS + j] = __float2bfloat16_rn(gelu(u_s[r * kUS + j] + b1[c0 + j], exact));
    }
    __syncthreads();
    for (int k = 0; k < kHC; k += 16) {
      FragA a[G::RF];
#pragma unroll
      for (int rf = 0; rf < G::RF; ++rf)
        wmma::load_matrix_sync(a[rf], h_s + 16 * rf * kHS + k, kHS);
#pragma unroll
      for (int nf = 0; nf < G::NF; ++nf) {
        FragBc b;
        wmma::load_matrix_sync(b, w2t + static_cast<size_t>(col0 + 16 * nf) * Hd + c0 + k, Hd);
#pragma unroll
        for (int rf = 0; rf < G::RF; ++rf) wmma::mma_sync(o[rf][nf], a[rf], b, o[rf][nf]);
      }
    }
    __syncthreads();  // h_s is rewritten by the next chunk
  }
#pragma unroll
  for (int rf = 0; rf < G::RF; ++rf)
#pragma unroll
    for (int nf = 0; nf < G::NF; ++nf)
      wmma::store_matrix_sync(o_s + 16 * rf * G::OS + col0 + 16 * nf, o[rf][nf], G::OS,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < G::BM * C; e += kThreads) {
    const int r = e / C, c = e - r * C;
    const int n = row0 + r;
    if (n < R) {
      const size_t i = static_cast<size_t>(n) * C + c;
      out[i] = __float2bfloat16_rn((o_s[r * G::OS + c] + b2[c]) + __bfloat162float(x[i]));
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_bwd_rows_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                                  const float* __restrict__ bias, const bf16* __restrict__ w1t,
                                  const float* __restrict__ b1, const bf16* __restrict__ w2t,
                                  const bf16* __restrict__ dout, bf16* __restrict__ dx,
                                  bf16* __restrict__ ypad, bf16* __restrict__ gpad,
                                  float* __restrict__ part, int R, int Hd, int exact) {
  using G = Geo<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* y_s = reinterpret_cast<bf16*>(smem);
  bf16* g_s = y_s + G::BM * G::YS;
  float* u_s = reinterpret_cast<float*>(g_s + G::BM * G::YS);
  float* dh_s = u_s + G::BM * kUS;
  bf16* du_s = reinterpret_cast<bf16*>(dh_s + G::BM * kUS);
  float* mu_s = reinterpret_cast<float*>(du_s + G::BM * kHS);
  float* rs_s = mu_s + G::BM;
  float* dy_s = reinterpret_cast<float*>(smem);  // over y_s and g_s, after the loop
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = static_cast<int>(blockIdx.x) * G::BM;
  const int col0 = warp * G::NF * 16;

  layer_norm_tile<bf16, G::BM>(x, scale, bias, C, row0, R, y_s, G::YS, mu_s, rs_s, ypad);
  for (int e = threadIdx.x; e < G::BM * C / 8; e += kThreads) {
    const int r = e / (C / 8), c = (e - r * (C / 8)) * 8;
    const int n = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < R) v = *reinterpret_cast<const uint4*>(dout + static_cast<size_t>(n) * C + c);
    *reinterpret_cast<uint4*>(g_s + r * G::YS + c) = v;
    *reinterpret_cast<uint4*>(gpad + static_cast<size_t>(n) * C + c) = v;
  }
  __syncthreads();

  FragC dy[G::RF][G::NF];
#pragma unroll
  for (int rf = 0; rf < G::RF; ++rf)
#pragma unroll
    for (int nf = 0; nf < G::NF; ++nf) wmma::fill_fragment(dy[rf][nf], 0.f);

  for (int c0 = 0; c0 < Hd; c0 += kHC) {
    chunk_fc1<C>(y_s, w1t, c0, u_s);
    {  // dh = g W2^T for this warp's 16 hidden columns
      FragC acc[G::RF];
#pragma unroll
      for (int rf = 0; rf < G::RF; ++rf) wmma::fill_fragment(acc[rf], 0.f);
      for (int k = 0; k < C; k += 16) {
        FragBr b;
        wmma::load_matrix_sync(b, w2t + static_cast<size_t>(k) * Hd + c0 + 16 * warp, Hd);
#pragma unroll
        for (int rf = 0; rf < G::RF; ++rf) {
          FragA a;
          wmma::load_matrix_sync(a, g_s + 16 * rf * G::YS + k, G::YS);
          wmma::mma_sync(acc[rf], a, b, acc[rf]);
        }
      }
#pragma unroll
      for (int rf = 0; rf < G::RF; ++rf)
        wmma::store_matrix_sync(dh_s + 16 * rf * kUS + 16 * warp, acc[rf], kUS,
                                wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < G::BM * 16; e += 32) {
      const int r = e / 16, j = 16 * warp + e % 16;
      const float u = u_s[r * kUS + j] + b1[c0 + j];
      const float dh = round_to<bf16>(dh_s[r * kUS + j]);
      du_s[r * kHS + j] = __float2bfloat16_rn(dh * gelu_grad(u, exact));
    }
    __syncthreads();
    for (int k = 0; k < kHC; k += 16) {  // dy += du W1^T[c0 + k ..]
      FragA a[G::RF];
#pragma unroll
      for (int rf = 0; rf < G::RF; ++rf)
        wmma::load_matrix_sync(a[rf], du_s + 16 * rf * kHS + k, kHS);
#pragma unroll
      for (int nf = 0; nf < G::NF; ++nf) {
        FragBr b;
        wmma::load_matrix_sync(b, w1t + static_cast<size_t>(c0 + k) * C + col0 + 16 * nf, C);
#pragma unroll
        for (int rf = 0; rf < G::RF; ++rf) wmma::mma_sync(dy[rf][nf], a[rf], b, dy[rf][nf]);
      }
    }
    __syncthreads();  // du_s is rewritten by the next chunk
  }
#pragma unroll
  for (int rf = 0; rf < G::RF; ++rf)
#pragma unroll
    for (int nf = 0; nf < G::NF; ++nf)
      wmma::store_matrix_sync(dy_s + 16 * rf * G::OS + col0 + 16 * nf, dy[rf][nf], G::OS,
                              wmma::mem_row_major);
  __syncthreads();
  ln_backward_tile<bf16, G::BM>(dy_s, G::OS, x, dout, scale, mu_s, rs_s, C, row0, R, dx, part,
                                blockIdx.x, gridDim.x);
}

// Block (16 hidden columns j0.., row chunk blockIdx.y, column split
// blockIdx.z): dW1^T[j0.., cols] and dW2^T[cols, j0..] summed over the
// chunk's rows of the zero-padded y and g.
template <int C>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_bwd_weights_mma_kernel(const bf16* __restrict__ ypad, const bf16* __restrict__ gpad,
                                     const bf16* __restrict__ w1t, const float* __restrict__ b1,
                                     const bf16* __restrict__ w2t, float* __restrict__ pw1,
                                     float* __restrict__ pw2, float* __restrict__ pb1, int Rpad,
                                     int Hd, int exact) {
  using G = Geo<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* u_s = reinterpret_cast<float*>(smem);
  float* dh_s = u_s + kBT * kBU;
  bf16* du_s = reinterpret_cast<bf16*>(dh_s + kBT * kBU);
  bf16* h_s = du_s + kBT * kBS;
  float* red_s = reinterpret_cast<float*>(h_s + kBT * kBS);
  const int warp = threadIdx.x / 32;
  const int tid = threadIdx.x;
  const int j0 = static_cast<int>(blockIdx.x) * kHB;
  const int p = blockIdx.y;
  const int cbase = static_cast<int>(blockIdx.z) * (C / G::CS) + warp * G::NW * 16;
  const int r_end = min((p + 1) * kRC, Rpad);

  FragC a1[G::NW], a2[G::NW];
#pragma unroll
  for (int i = 0; i < G::NW; ++i) {
    wmma::fill_fragment(a1[i], 0.f);
    wmma::fill_fragment(a2[i], 0.f);
  }
  float db1 = 0.f;  // column tid % 16, rows tid / 16 + 16 i of each tile
  for (int r0 = p * kRC; r0 < r_end; r0 += kBT) {
    {  // warps 0-3: u of row fragment warp; warps 4-7: dh of row fragment warp - 4
      const int rf = warp & 3;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      const size_t arow = static_cast<size_t>(r0 + 16 * rf) * C;
      if (warp < 4) {
        for (int k = 0; k < C; k += 16) {
          FragA a;
          FragBc b;
          wmma::load_matrix_sync(a, ypad + arow + k, C);
          wmma::load_matrix_sync(b, w1t + static_cast<size_t>(j0) * C + k, C);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(u_s + 16 * rf * kBU, acc, kBU, wmma::mem_row_major);
      } else {
        for (int k = 0; k < C; k += 16) {
          FragA a;
          FragBr b;
          wmma::load_matrix_sync(a, gpad + arow + k, C);
          wmma::load_matrix_sync(b, w2t + static_cast<size_t>(k) * Hd + j0, Hd);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(dh_s + 16 * rf * kBU, acc, kBU, wmma::mem_row_major);
      }
    }
    __syncthreads();
    for (int e = tid; e < kBT * kHB; e += kThreads) {
      const int r = e / kHB, j = e % kHB;
      const float u = u_s[r * kBU + j] + b1[j0 + j];
      const float du = round_to<bf16>(dh_s[r * kBU + j]) * gelu_grad(u, exact);
      db1 += du;
      du_s[r * kBS + j] = __float2bfloat16_rn(du);
      h_s[r * kBS + j] = __float2bfloat16_rn(gelu(u, exact));
    }
    __syncthreads();
    for (int k = 0; k < kBT; k += 16) {
      FragAc du_t;  // du^T (hidden x rows)
      FragBr hb;    // h (rows x hidden)
      wmma::load_matrix_sync(du_t, du_s + k * kBS, kBS);
      wmma::load_matrix_sync(hb, h_s + k * kBS, kBS);
      const size_t grow = static_cast<size_t>(r0 + k) * C;
#pragma unroll
      for (int i = 0; i < G::NW; ++i) {
        const int col = cbase + 16 * i;
        FragBr yb;   // y (rows x C)
        FragAc g_t;  // g^T (C x rows)
        wmma::load_matrix_sync(yb, ypad + grow + col, C);
        wmma::load_matrix_sync(g_t, gpad + grow + col, C);
        wmma::mma_sync(a1[i], du_t, yb, a1[i]);
        wmma::mma_sync(a2[i], g_t, hb, a2[i]);
      }
    }
    __syncthreads();  // u_s .. h_s are rewritten by the next tile
  }
#pragma unroll
  for (int i = 0; i < G::NW; ++i) {
    const int col = cbase + 16 * i;
    wmma::store_matrix_sync(pw1 + (static_cast<size_t>(p) * Hd + j0) * C + col, a1[i], C,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(pw2 + (static_cast<size_t>(p) * C + col) * Hd + j0, a2[i], Hd,
                            wmma::mem_row_major);
  }
  red_s[tid] = db1;
  __syncthreads();
  if (blockIdx.z == 0 && tid < kHB) {
    float s = 0.f;
    for (int q = 0; q < kThreads / kHB; ++q) s += red_s[q * kHB + tid];
    pb1[static_cast<size_t>(p) * Hd + j0 + tid] = s;
  }
}

// ----------------------------------------------------- float32, CUDA cores

constexpr int kFR = 16;       // rows per tile
constexpr int kFH = 256;      // hidden columns per chunk, one per thread
constexpr int kFK = 32;       // depth of a staged weight slab
constexpr int kFWS = kFH + 1; // its row stride
constexpr int kFCols = 5;     // ceil(1280 / 256): output columns per thread
constexpr int kFHB = 8;       // hidden columns per block of the weights pass

// Rows j < nrows of a row-major matrix (row stride ld) from `src`, columns
// k0 .. k0 + 32, transposed into ws[kk * kFWS + j]; zeros for j >= nrows.
__device__ __forceinline__ void stage_t(float* ws, const float* __restrict__ src, size_t ld,
                                        int nrows, int k0) {
  for (int e = threadIdx.x; e < kFH * kFK; e += kThreads) {
    const int j = e / kFK, kk = e % kFK;
    ws[kk * kFWS + j] = j < nrows ? src[static_cast<size_t>(j) * ld + k0 + kk] : 0.f;
  }
}

// u[r] = sum_k y_s[r][k] W1[k][c0 + t] for the tile's rows, W1 from w1t.
__device__ __forceinline__ void f32_fc1(const float* y_s, const float* __restrict__ w1t,
                                        float* ws, int C, int c0, float (&u)[kFR]) {
#pragma unroll
  for (int r = 0; r < kFR; ++r) u[r] = 0.f;
  for (int k0 = 0; k0 < C; k0 += kFK) {
    stage_t(ws, w1t + static_cast<size_t>(c0) * C, C, kFH, k0);
    __syncthreads();
    for (int kk = 0; kk < kFK; ++kk) {
      const float w = ws[kk * kFWS + threadIdx.x];
#pragma unroll
      for (int r = 0; r < kFR; ++r) u[r] = fmaf(y_s[r * C + k0 + kk], w, u[r]);
    }
    __syncthreads();
  }
}

size_t fwd_f32_smem(int C) {
  return (static_cast<size_t>(kFR) * C + kFR * kFH + kFK * kFWS) * 4;
}
size_t bwd_rows_f32_smem(int C) {
  return (static_cast<size_t>(2 * kFR) * C + kFR * kFH + kFK * kFWS + 2 * kFR) * 4;
}
size_t bwd_weights_f32_smem(int C) {
  return (static_cast<size_t>(2 * kFR) * C + 4 * kFR * kFHB + kThreads) * 4;
}

__global__ void __launch_bounds__(kThreads)
    fused_mlp_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                             const float* __restrict__ bias, const float* __restrict__ w1t,
                             const float* __restrict__ b1, const float* __restrict__ w2t,
                             const float* __restrict__ b2, float* __restrict__ out, int R, int C,
                             int Hd, int exact) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* y_s = reinterpret_cast<float*>(smem);
  float* h_s = y_s + kFR * C;
  float* ws = h_s + kFR * kFH;
  const int t = threadIdx.x;
  const int row0 = static_cast<int>(blockIdx.x) * kFR;
  layer_norm_tile<float, kFR>(x, scale, bias, C, row0, R, y_s, C, nullptr, nullptr, nullptr);
  __syncthreads();
  float o[kFCols][kFR];
#pragma unroll
  for (int i = 0; i < kFCols; ++i)
#pragma unroll
    for (int r = 0; r < kFR; ++r) o[i][r] = 0.f;
  for (int c0 = 0; c0 < Hd; c0 += kFH) {
    float u[kFR];
    f32_fc1(y_s, w1t, ws, C, c0, u);
#pragma unroll
    for (int r = 0; r < kFR; ++r) h_s[r * kFH + t] = gelu(u[r] + b1[c0 + t], exact);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kFCols; ++i) {
      const int cb = kFH * i;
      if (cb >= C) continue;  // uniform across the block
      for (int j0 = 0; j0 < kFH; j0 += kFK) {
        stage_t(ws, w2t + static_cast<size_t>(cb) * Hd + c0, Hd, min(kFH, C - cb), j0);
        __syncthreads();
        if (cb + t < C)
          for (int jj = 0; jj < kFK; ++jj) {
            const float w = ws[jj * kFWS + t];
#pragma unroll
            for (int r = 0; r < kFR; ++r) o[i][r] = fmaf(h_s[r * kFH + j0 + jj], w, o[i][r]);
          }
        __syncthreads();
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kFCols; ++i) {
    const int c = kFH * i + t;
    if (c >= C) continue;
#pragma unroll
    for (int r = 0; r < kFR; ++r) {
      const int n = row0 + r;
      if (n < R) {
        const size_t idx = static_cast<size_t>(n) * C + c;
        out[idx] = (o[i][r] + b2[c]) + x[idx];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    fused_mlp_bwd_rows_f32_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                                  const float* __restrict__ bias, const float* __restrict__ w1t,
                                  const float* __restrict__ b1, const float* __restrict__ w2t,
                                  const float* __restrict__ dout, float* __restrict__ dx,
                                  float* __restrict__ ypad, float* __restrict__ gpad,
                                  float* __restrict__ part, int R, int C, int Hd, int exact) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* y_s = reinterpret_cast<float*>(smem);
  float* g_s = y_s + kFR * C;
  float* du_s = g_s + kFR * C;
  float* ws = du_s + kFR * kFH;
  float* mu_s = ws + kFK * kFWS;
  float* rs_s = mu_s + kFR;
  float* dy_s = y_s;  // after the chunk loop
  const int t = threadIdx.x;
  const int row0 = static_cast<int>(blockIdx.x) * kFR;
  layer_norm_tile<float, kFR>(x, scale, bias, C, row0, R, y_s, C, mu_s, rs_s, ypad);
  for (int e = t; e < kFR * C; e += kThreads) {
    const int r = e / C, c = e - r * C;
    const int n = row0 + r;
    const float v = n < R ? dout[static_cast<size_t>(n) * C + c] : 0.f;
    g_s[e] = v;
    gpad[static_cast<size_t>(n) * C + c] = v;
  }
  __syncthreads();
  float dy[kFCols][kFR];
#pragma unroll
  for (int i = 0; i < kFCols; ++i)
#pragma unroll
    for (int r = 0; r < kFR; ++r) dy[i][r] = 0.f;
  for (int c0 = 0; c0 < Hd; c0 += kFH) {
    float u[kFR], dh[kFR];
    f32_fc1(y_s, w1t, ws, C, c0, u);
#pragma unroll
    for (int r = 0; r < kFR; ++r) dh[r] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float w = w2t[static_cast<size_t>(c) * Hd + c0 + t];
#pragma unroll
      for (int r = 0; r < kFR; ++r) dh[r] = fmaf(g_s[r * C + c], w, dh[r]);
    }
#pragma unroll
    for (int r = 0; r < kFR; ++r)
      du_s[r * kFH + t] = dh[r] * gelu_grad(u[r] + b1[c0 + t], exact);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kFCols; ++i) {
      const int c = kFH * i + t;
      if (c >= C) continue;
      for (int j = 0; j < kFH; ++j) {
        const float w = w1t[static_cast<size_t>(c0 + j) * C + c];
#pragma unroll
        for (int r = 0; r < kFR; ++r) dy[i][r] = fmaf(du_s[r * kFH + j], w, dy[i][r]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kFCols; ++i) {
    const int c = kFH * i + t;
    if (c >= C) continue;
#pragma unroll
    for (int r = 0; r < kFR; ++r) dy_s[r * C + c] = dy[i][r];
  }
  __syncthreads();
  ln_backward_tile<float, kFR>(dy_s, C, x, dout, scale, mu_s, rs_s, C, row0, R, dx, part,
                               blockIdx.x, gridDim.x);
}

__global__ void __launch_bounds__(kThreads)
    fused_mlp_bwd_weights_f32_kernel(const float* __restrict__ ypad,
                                     const float* __restrict__ gpad,
                                     const float* __restrict__ w1t, const float* __restrict__ b1,
                                     const float* __restrict__ w2t, float* __restrict__ pw1,
                                     float* __restrict__ pw2, float* __restrict__ pb1, int Rpad,
                                     int C, int Hd, int exact) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* y_s = reinterpret_cast<float*>(smem);
  float* g_s = y_s + kFR * C;
  float* sc_s = g_s + kFR * C;      // (2, kFR, kFHB): u, then dh
  float* du_s = sc_s + 2 * kFR * kFHB;
  float* h_s = du_s + kFR * kFHB;
  float* red_s = h_s + kFR * kFHB;
  const int t = threadIdx.x;
  const int j0 = static_cast<int>(blockIdx.x) * kFHB;
  const int p = blockIdx.y;
  const int r_end = min((p + 1) * kRC, Rpad);
  float a1[kFCols][kFHB], a2[kFCols][kFHB];
#pragma unroll
  for (int i = 0; i < kFCols; ++i)
#pragma unroll
    for (int j = 0; j < kFHB; ++j) a1[i][j] = a2[i][j] = 0.f;
  float db1 = 0.f;
  for (int r0 = p * kRC; r0 < r_end; r0 += kFR) {
    for (int e = t; e < kFR * C; e += kThreads) {
      y_s[e] = ypad[static_cast<size_t>(r0) * C + e];
      g_s[e] = gpad[static_cast<size_t>(r0) * C + e];
    }
    __syncthreads();
    {
      const int which = t / (kFR * kFHB), r = (t % (kFR * kFHB)) / kFHB, j = t % kFHB;
      float s = 0.f;
      if (which == 0) {
        const float* wr = w1t + static_cast<size_t>(j0 + j) * C;
        for (int k = 0; k < C; ++k) s = fmaf(y_s[r * C + k], wr[k], s);
      } else {
        for (int c = 0; c < C; ++c)
          s = fmaf(g_s[r * C + c], w2t[static_cast<size_t>(c) * Hd + j0 + j], s);
      }
      sc_s[t] = s;
    }
    __syncthreads();
    if (t < kFR * kFHB) {
      const int j = t % kFHB;
      const float u = sc_s[t] + b1[j0 + j];
      const float du = sc_s[kFR * kFHB + t] * gelu_grad(u, exact);
      db1 += du;
      du_s[t] = du;
      h_s[t] = gelu(u, exact);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kFCols; ++i) {
      const int c = kFH * i + t;
      if (c >= C) continue;
      for (int r = 0; r < kFR; ++r) {
        const float yv = y_s[r * C + c], gv = g_s[r * C + c];
#pragma unroll
        for (int j = 0; j < kFHB; ++j) {
          a1[i][j] = fmaf(du_s[r * kFHB + j], yv, a1[i][j]);
          a2[i][j] = fmaf(gv, h_s[r * kFHB + j], a2[i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kFCols; ++i) {
    const int c = kFH * i + t;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < kFHB; ++j) {
      pw1[(static_cast<size_t>(p) * Hd + j0 + j) * C + c] = a1[i][j];
      pw2[(static_cast<size_t>(p) * C + c) * Hd + j0 + j] = a2[i][j];
    }
  }
  red_s[t] = db1;
  __syncthreads();
  if (t < kFHB) {
    float s = 0.f;
    for (int q = 0; q < kFR; ++q) s += red_s[q * kFHB + t];
    pb1[static_cast<size_t>(p) * Hd + j0 + t] = s;
  }
}

// ------------------------------------------------------------- host side

bool supported(int C, int Hd) {
  return (C == 384 || C == 768 || C == 1024 || C == 1280) && Hd > 0 && Hd % kFH == 0;
}

// Scratch of the backward, one allocation: y and g padded to the weights
// pass's tile (zeros past R), the rows pass's per-tile partials of dscale,
// dbias and db2, and the per-chunk partials of dW1^T, dW2^T and db1.
struct Work {
  int Rpad, tiles, P;
  size_t y, g, pa, pw1, pw2, pb1, bytes;
};

size_t align256(size_t v) { return (v + 255) / 256 * 256; }

Work workspace(int R, int C, int Hd, int dtype) {
  Work w{};
  const int tile = dtype == 1 ? kBT : kFR;
  const int bm = dtype == 1 ? rows_per_block(C) : kFR;
  const size_t esz = dtype == 1 ? 2 : 4;
  w.Rpad = (R + tile - 1) / tile * tile;
  w.tiles = w.Rpad / bm;
  w.P = (w.Rpad + kRC - 1) / kRC;
  size_t off = 0;
  w.y = off;
  off = align256(off + static_cast<size_t>(w.Rpad) * C * esz);
  w.g = off;
  off = align256(off + static_cast<size_t>(w.Rpad) * C * esz);
  w.pa = off;
  off = align256(off + static_cast<size_t>(3) * w.tiles * C * 4);
  w.pw1 = off;
  off = align256(off + static_cast<size_t>(w.P) * Hd * C * 4);
  w.pw2 = off;
  off = align256(off + static_cast<size_t>(w.P) * C * Hd * 4);
  w.pb1 = off;
  off = align256(off + static_cast<size_t>(w.P) * Hd * 4);
  w.bytes = off;
  return w;
}

template <typename K>
cudaError_t smem_attr(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int C>
cudaError_t fwd_mma(const void* x, const float* scale, const float* bias, const void* w1t,
                    const float* b1, const void* w2t, const float* b2, void* out, int R, int Hd,
                    int exact, cudaStream_t s) {
  const size_t smem = fwd_mma_smem<C>();
  cudaError_t err = smem_attr(fused_mlp_fwd_mma_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (R + Geo<C>::BM - 1) / Geo<C>::BM;
  fused_mlp_fwd_mma_kernel<C><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(x), scale, bias, static_cast<const bf16*>(w1t), b1,
      static_cast<const bf16*>(w2t), b2, static_cast<bf16*>(out), R, Hd, exact);
  return cudaGetLastError();
}

template <int C>
cudaError_t bwd_mma(const void* x, const float* scale, const float* bias, const void* w1t,
                    const float* b1, const void* w2t, const void* dout, void* dx,
                    unsigned char* work, const Work& w, int R, int Hd, int exact,
                    cudaStream_t s) {
  const size_t smem1 = bwd_rows_mma_smem<C>();
  cudaError_t err = smem_attr(fused_mlp_bwd_rows_mma_kernel<C>, smem1);
  if (err != cudaSuccess) return err;
  err = smem_attr(fused_mlp_bwd_weights_mma_kernel<C>, kBwdWeightsMmaSmem);
  if (err != cudaSuccess) return err;
  auto* ypad = reinterpret_cast<bf16*>(work + w.y);
  auto* gpad = reinterpret_cast<bf16*>(work + w.g);
  fused_mlp_bwd_rows_mma_kernel<C><<<w.tiles, kThreads, smem1, s>>>(
      static_cast<const bf16*>(x), scale, bias, static_cast<const bf16*>(w1t), b1,
      static_cast<const bf16*>(w2t), static_cast<const bf16*>(dout), static_cast<bf16*>(dx),
      ypad, gpad, reinterpret_cast<float*>(work + w.pa), R, Hd, exact);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(Hd / kHB, w.P, Geo<C>::CS);
  fused_mlp_bwd_weights_mma_kernel<C><<<grid, kThreads, kBwdWeightsMmaSmem, s>>>(
      ypad, gpad, static_cast<const bf16*>(w1t), b1, static_cast<const bf16*>(w2t),
      reinterpret_cast<float*>(work + w.pw1), reinterpret_cast<float*>(work + w.pw2),
      reinterpret_cast<float*>(work + w.pb1), w.Rpad, Hd, exact);
  return cudaGetLastError();
}

cudaError_t fwd_f32(const float* x, const float* scale, const float* bias, const float* w1t,
                    const float* b1, const float* w2t, const float* b2, float* out, int R,
                    int C, int Hd, int exact, cudaStream_t s) {
  const size_t smem = fwd_f32_smem(C);
  cudaError_t err = smem_attr(fused_mlp_fwd_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  fused_mlp_fwd_f32_kernel<<<(R + kFR - 1) / kFR, kThreads, smem, s>>>(
      x, scale, bias, w1t, b1, w2t, b2, out, R, C, Hd, exact);
  return cudaGetLastError();
}

cudaError_t bwd_f32(const float* x, const float* scale, const float* bias, const float* w1t,
                    const float* b1, const float* w2t, const float* dout, float* dx,
                    unsigned char* work, const Work& w, int R, int C, int Hd, int exact,
                    cudaStream_t s) {
  const size_t smem1 = bwd_rows_f32_smem(C), smem2 = bwd_weights_f32_smem(C);
  cudaError_t err = smem_attr(fused_mlp_bwd_rows_f32_kernel, smem1);
  if (err != cudaSuccess) return err;
  err = smem_attr(fused_mlp_bwd_weights_f32_kernel, smem2);
  if (err != cudaSuccess) return err;
  auto* ypad = reinterpret_cast<float*>(work + w.y);
  auto* gpad = reinterpret_cast<float*>(work + w.g);
  fused_mlp_bwd_rows_f32_kernel<<<w.tiles, kThreads, smem1, s>>>(
      x, scale, bias, w1t, b1, w2t, dout, dx, ypad, gpad,
      reinterpret_cast<float*>(work + w.pa), R, C, Hd, exact);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_mlp_bwd_weights_f32_kernel<<<dim3(Hd / kFHB, w.P), kThreads, smem2, s>>>(
      ypad, gpad, w1t, b1, w2t, reinterpret_cast<float*>(work + w.pw1),
      reinterpret_cast<float*>(work + w.pw2), reinterpret_cast<float*>(work + w.pb1), w.Rpad,
      C, Hd, exact);
  return cudaGetLastError();
}

}  // namespace

// dtype codes shared with ops/kernels/mlp.py: 0 = float32, 1 = bfloat16.

extern "C" int fused_mlp_supported(int C, int Hd, int dtype) {
  return (dtype == 0 || dtype == 1) && supported(C, Hd) ? 1 : 0;
}

extern "C" long long fused_mlp_bwd_workspace_bytes(int R, int C, int Hd, int dtype) {
  if (!fused_mlp_supported(C, Hd, dtype) || R <= 0) return -1;
  return static_cast<long long>(workspace(R, C, Hd, dtype).bytes);
}

// x (R, C) -> out (R, C), both of the weights' dtype; w1t (Hd, C), w2t
// (C, Hd); scale, bias, b1, b2 float32.
extern "C" int fused_mlp_fwd(const void* x, const void* scale, const void* bias,
                             const void* w1t, const void* b1, const void* w2t, const void* b2,
                             void* out, int R, int C, int Hd, int dtype, int exact, int device,
                             void* stream) {
  if (!fused_mlp_supported(C, Hd, dtype) || R <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const auto* c1 = static_cast<const float*>(b1);
  const auto* c2 = static_cast<const float*>(b2);
  if (dtype == 0)
    return fwd_f32(static_cast<const float*>(x), sc, bi, static_cast<const float*>(w1t), c1,
                   static_cast<const float*>(w2t), c2, static_cast<float*>(out), R, C, Hd,
                   exact, s);
  switch (C) {
    case 384: return fwd_mma<384>(x, sc, bi, w1t, c1, w2t, c2, out, R, Hd, exact, s);
    case 768: return fwd_mma<768>(x, sc, bi, w1t, c1, w2t, c2, out, R, Hd, exact, s);
    case 1024: return fwd_mma<1024>(x, sc, bi, w1t, c1, w2t, c2, out, R, Hd, exact, s);
    default: return fwd_mma<1280>(x, sc, bi, w1t, c1, w2t, c2, out, R, Hd, exact, s);
  }
}

// Backward: dout (R, C) -> dx (R, C) in x's dtype, dw1t (Hd, C) and dw2t
// (C, Hd) in the weights' dtype, dscale, dbias, db2 (C,) and db1 (Hd,) in
// float32. `work` holds fused_mlp_bwd_workspace_bytes(R, C, Hd, dtype).
extern "C" int fused_mlp_bwd(const void* x, const void* scale, const void* bias,
                             const void* w1t, const void* b1, const void* w2t,
                             const void* dout, void* dx, void* dscale, void* dbias, void* dw1t,
                             void* db1, void* dw2t, void* db2, void* work, int R, int C, int Hd,
                             int dtype, int exact, int device, void* stream) {
  if (!fused_mlp_supported(C, Hd, dtype) || R <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Work w = workspace(R, C, Hd, dtype);
  auto* wk = static_cast<unsigned char*>(work);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const auto* c1 = static_cast<const float*>(b1);
  if (dtype == 0) {
    err = bwd_f32(static_cast<const float*>(x), sc, bi, static_cast<const float*>(w1t), c1,
                  static_cast<const float*>(w2t), static_cast<const float*>(dout),
                  static_cast<float*>(dx), wk, w, R, C, Hd, exact, s);
  } else {
    switch (C) {
      case 384: err = bwd_mma<384>(x, sc, bi, w1t, c1, w2t, dout, dx, wk, w, R, Hd, exact, s); break;
      case 768: err = bwd_mma<768>(x, sc, bi, w1t, c1, w2t, dout, dx, wk, w, R, Hd, exact, s); break;
      case 1024: err = bwd_mma<1024>(x, sc, bi, w1t, c1, w2t, dout, dx, wk, w, R, Hd, exact, s); break;
      default: err = bwd_mma<1280>(x, sc, bi, w1t, c1, w2t, dout, dx, wk, w, R, Hd, exact, s); break;
    }
  }
  if (err != cudaSuccess) return err;
  const auto* pa = reinterpret_cast<const float*>(wk + w.pa);
  const long long nC = C, nW = static_cast<long long>(C) * Hd;
  if ((err = sum_partials<float>(pa, w.tiles, nC, dscale, s)) != cudaSuccess) return err;
  if ((err = sum_partials<float>(pa + static_cast<size_t>(w.tiles) * C, w.tiles, nC, dbias, s)) != cudaSuccess) return err;
  if ((err = sum_partials<float>(pa + static_cast<size_t>(2) * w.tiles * C, w.tiles, nC, db2, s)) != cudaSuccess) return err;
  if ((err = sum_partials<float>(reinterpret_cast<const float*>(wk + w.pb1), w.P, Hd, db1, s)) != cudaSuccess) return err;
  const auto* pw1 = reinterpret_cast<const float*>(wk + w.pw1);
  const auto* pw2 = reinterpret_cast<const float*>(wk + w.pw2);
  if (dtype == 0) {
    if ((err = sum_partials<float>(pw1, w.P, nW, dw1t, s)) != cudaSuccess) return err;
    return sum_partials<float>(pw2, w.P, nW, dw2t, s);
  }
  if ((err = sum_partials<bf16>(pw1, w.P, nW, dw1t, s)) != cudaSuccess) return err;
  return sum_partials<bf16>(pw2, w.P, nW, dw2t, s);
}
