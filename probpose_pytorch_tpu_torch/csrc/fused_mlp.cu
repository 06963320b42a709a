// Kernel K5 in float32: the ViT block's second half fused per row,
//   out = x + fc2(gelu(fc1(LayerNorm(x)))),
// its forward and its recompute backward, on the CUDA cores (FMA, no TF32).
// The bf16 path is csrc/fused_mlp_sm90.cu (wgmma + TMA).
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel`
// (probpose_pytorch_tpu/ops/pallas/mlp_kernel.py, called from `_fwd` / `_bwd`
// under the custom_vjp `fused_ln_mlp`) for float32 x and weights. Per row, as
// `_tile_forward` does: f32 LayerNorm with the two-pass variance and eps
// 1e-6; u = y W1 + b1; GELU (tanh, or erf); o = h W2 + b2; o + x. The
// (rows, 4C) hidden state never reaches device memory.
//
// Weights arrive in nn.Linear's layout: w1t = W1^T (Hd, C), w2t = W2^T
// (C, Hd), both row-major; the gradients dW1^T and dW2^T come back in the
// same layout.
//
// What bounds it on an H100: at ViT-B widths each row costs 4 C Hd FLOPs
// forward against 8 C bytes in and out, far above the ridge of the CUDA
// cores' 67 TFLOP/s: the FMA rate bounds it. The design keeps 16-row tiles,
// 256 hidden columns a chunk (one per thread), and stages weight slabs
// transposed in shared memory where a thread's reads would stride.
//
// The backward, per row (g = dO):
//   dh = g W2^T;  du = dh * gelu'(u);  dy = du W1^T
//   dx = g + rstd (dy*s - mean(dy*s) - xhat mean(dy*s*xhat))
//   dW1 = y^T du, dW2 = h^T g, db1 = sum du, db2 = sum g,
//   dscale = sum dy*xhat, dbias = sum dy
// in three launches, no atomics, so two runs give the same bits:
//   rows pass    one block per 16-row tile: recomputes u, dh, du chunk by
//                chunk, accumulates dy in registers, then the LayerNorm
//                backward writes dx; per-tile partial sums of dscale, dbias
//                and db2. It also leaves y and g in a zero-padded scratch.
//   weights pass one block per (8 hidden columns, 1,024-row chunk):
//                recomputes u and dh of its columns tile by tile and
//                accumulates dW1^T and dW2^T of those columns in registers;
//                writes f32 partials per row chunk.
//   reduction    sums the partials of each gradient in chunk order.
//
// Shapes: C in {384, 768, 1024, 1280}, Hd a multiple of 256. Plain-C
// interface, loaded with ctypes (ops/kernels/mlp.py); every entry point
// returns a cudaError_t as int (0 = success).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEps = 1e-6f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
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

// ----------------------------------------------------- float32, CUDA cores

constexpr int kFR = 16;       // rows per tile
constexpr int kFH = 256;      // hidden columns per chunk, one per thread
constexpr int kFK = 32;       // depth of a staged weight slab
constexpr int kFWS = kFH + 1; // its row stride
constexpr int kFCols = 5;     // ceil(1280 / 256): output columns per thread
constexpr int kFHB = 8;       // hidden columns per block of the weights pass
constexpr int kRC = 1024;     // rows per partial of the weight gradients

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

// Scratch of the backward, one allocation: y and g padded to the 16-row tile
// (zeros past R), the rows pass's per-tile partials of dscale, dbias and
// db2, and the per-chunk partials of dW1^T, dW2^T and db1.
struct Work {
  int Rpad, tiles, P;
  size_t y, g, pa, pw1, pw2, pb1, bytes;
};

size_t align256(size_t v) { return (v + 255) / 256 * 256; }

Work workspace(int R, int C, int Hd) {
  Work w{};
  w.Rpad = (R + kFR - 1) / kFR * kFR;
  w.tiles = w.Rpad / kFR;
  w.P = (w.Rpad + kRC - 1) / kRC;
  size_t off = 0;
  w.y = off;
  off = align256(off + static_cast<size_t>(w.Rpad) * C * 4);
  w.g = off;
  off = align256(off + static_cast<size_t>(w.Rpad) * C * 4);
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

}  // namespace

extern "C" long long fused_mlp_f32_bwd_workspace_bytes(int R, int C, int Hd) {
  if (!supported(C, Hd) || R <= 0) return -1;
  return static_cast<long long>(workspace(R, C, Hd).bytes);
}

// x (R, C) -> out (R, C), float32; w1t (Hd, C), w2t (C, Hd); scale, bias,
// b1, b2 float32.
extern "C" int fused_mlp_f32_fwd(const float* x, const float* scale, const float* bias,
                                 const float* w1t, const float* b1, const float* w2t,
                                 const float* b2, float* out, int R, int C, int Hd, int exact,
                                 int device, void* stream) {
  if (!supported(C, Hd) || R <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = fwd_f32_smem(C);
  err = smem_attr(fused_mlp_fwd_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  fused_mlp_fwd_f32_kernel<<<(R + kFR - 1) / kFR, kThreads, smem, s>>>(
      x, scale, bias, w1t, b1, w2t, b2, out, R, C, Hd, exact);
  return cudaGetLastError();
}

// Backward: dout (R, C) -> dx (R, C), dw1t (Hd, C), dw2t (C, Hd), dscale,
// dbias, db2 (C,) and db1 (Hd,), all float32. `work` holds
// fused_mlp_f32_bwd_workspace_bytes(R, C, Hd).
extern "C" int fused_mlp_f32_bwd(const float* x, const float* scale, const float* bias,
                                 const float* w1t, const float* b1, const float* w2t,
                                 const float* dout, float* dx, float* dscale, float* dbias,
                                 float* dw1t, float* db1, float* dw2t, float* db2, void* work,
                                 int R, int C, int Hd, int exact, int device, void* stream) {
  if (!supported(C, Hd) || R <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Work w = workspace(R, C, Hd);
  auto* wk = static_cast<unsigned char*>(work);
  const size_t smem1 = bwd_rows_f32_smem(C), smem2 = bwd_weights_f32_smem(C);
  err = smem_attr(fused_mlp_bwd_rows_f32_kernel, smem1);
  if (err != cudaSuccess) return err;
  err = smem_attr(fused_mlp_bwd_weights_f32_kernel, smem2);
  if (err != cudaSuccess) return err;
  auto* ypad = reinterpret_cast<float*>(wk + w.y);
  auto* gpad = reinterpret_cast<float*>(wk + w.g);
  auto* pa = reinterpret_cast<float*>(wk + w.pa);
  auto* pw1 = reinterpret_cast<float*>(wk + w.pw1);
  auto* pw2 = reinterpret_cast<float*>(wk + w.pw2);
  auto* pb1 = reinterpret_cast<float*>(wk + w.pb1);
  fused_mlp_bwd_rows_f32_kernel<<<w.tiles, kThreads, smem1, s>>>(
      x, scale, bias, w1t, b1, w2t, dout, dx, ypad, gpad, pa, R, C, Hd, exact);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fused_mlp_bwd_weights_f32_kernel<<<dim3(Hd / kFHB, w.P), kThreads, smem2, s>>>(
      ypad, gpad, w1t, b1, w2t, pw1, pw2, pb1, w.Rpad, C, Hd, exact);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long nC = C, nW = static_cast<long long>(C) * Hd;
  if ((err = sum_partials<float>(pa, w.tiles, nC, dscale, s)) != cudaSuccess) return err;
  if ((err = sum_partials<float>(pa + static_cast<size_t>(w.tiles) * C, w.tiles, nC, dbias, s)) != cudaSuccess) return err;
  if ((err = sum_partials<float>(pa + static_cast<size_t>(2) * w.tiles * C, w.tiles, nC, db2, s)) != cudaSuccess) return err;
  if ((err = sum_partials<float>(pb1, w.P, Hd, db1, s)) != cudaSuccess) return err;
  if ((err = sum_partials<float>(pw1, w.P, nW, dw1t, s)) != cudaSuccess) return err;
  return sum_partials<float>(pw2, w.P, nW, dw2t, s);
}
