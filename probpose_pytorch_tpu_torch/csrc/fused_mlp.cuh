// Kernel K5 on the CUDA cores (csrc/fused_mlp.cu has the design): the
// kernels and their launchers, templated on the dtype T and the row tile FR.
// csrc/fused_mlp.cu instantiates float32 and holds the plain-C interface;
// csrc/fused_mlp_bf16.cu instantiates bf16 (one nvcc each, built side by
// side).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace probpose_k5cc {

constexpr float kEps = 1e-6f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
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
// f32 values rounded to T, two-pass variance. Rows past R give zeros.
// Optionally the row's mean and rstd (mu_s, rs_s) and a copy of y in y_out
// (rows < the padded row count, which the grid covers).
template <typename T, int BM>
__device__ void layer_norm_tile(const T* __restrict__ x, const float* __restrict__ scale,
                                const float* __restrict__ bias, int C, int row0, int R,
                                float* y_s, int ys, float* mu_s, float* rs_s, float* y_out) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kWarps) {
    const int n = row0 + r;
    float* yo = y_out ? y_out + static_cast<size_t>(n) * C : nullptr;
    if (n >= R) {
      for (int c = lane; c < C; c += 32) {
        y_s[r * ys + c] = 0.f;
        if (yo) yo[c] = 0.f;
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
      const float yv = round_to<T>((to_f(xr[c]) - mu) * rstd * scale[c] + bias[c]);
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

// Both units use the reduction (dscale, dbias, db1 and db2 in f32): its
// kernels have internal linkage, one copy a unit.
namespace {

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
inline cudaError_t sum_partials(const float* part, int P, long long n, void* out, cudaStream_t s) {
  const int blocks = static_cast<int>((n + 255) / 256);
  sum_partials_kernel<T><<<blocks, 256, 0, s>>>(part, P, n, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------- kernels

constexpr int kFH = 256;      // hidden columns per chunk, one per thread
constexpr int kFK = 32;       // depth of a staged weight slab
constexpr int kFWS = kFH + 1; // its row stride
constexpr int kFCols = 8;     // ceil(2048 / 256): output columns per thread
constexpr int kFHB = 8;       // hidden columns per block of the weights pass
constexpr int kRC = 1024;     // rows per partial of the weight gradients
constexpr int kMaxC = kFH * kFCols;
constexpr int kMaxHd = 8192;

// Rows j < nrows, columns k0 .. k0 + 32 (those < k0 + ncols) of a row-major
// matrix (row stride ld) from `src`, transposed into ws[kk * kFWS + j];
// zeros elsewhere.
template <typename T>
__device__ __forceinline__ void stage_t(float* ws, const T* __restrict__ src, size_t ld,
                                        int nrows, int k0, int ncols) {
  for (int e = threadIdx.x; e < kFH * kFK; e += kThreads) {
    const int j = e / kFK, kk = e % kFK;
    ws[kk * kFWS + j] =
        j < nrows && kk < ncols ? to_f(src[static_cast<size_t>(j) * ld + k0 + kk]) : 0.f;
  }
}

// u[r] = sum_k y_s[r][k] W1[k][c0 + t] for the tile's rows, W1 from w1t;
// columns c0 + t >= Hd get 0.
template <typename T, int FR>
__device__ __forceinline__ void fc1(const float* y_s, const T* __restrict__ w1t, float* ws,
                                    int C, int Hd, int c0, float (&u)[FR]) {
#pragma unroll
  for (int r = 0; r < FR; ++r) u[r] = 0.f;
  for (int k0 = 0; k0 < C; k0 += kFK) {
    const int kn = min(kFK, C - k0);
    stage_t(ws, w1t + static_cast<size_t>(c0) * C, C, min(kFH, Hd - c0), k0, kn);
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      const float w = ws[kk * kFWS + threadIdx.x];
#pragma unroll
      for (int r = 0; r < FR; ++r) u[r] = fmaf(y_s[r * C + k0 + kk], w, u[r]);
    }
    __syncthreads();
  }
}

// Rows a tile: 16, or 8 past C = 1280 (two f32 (16, C) tiles of the rows
// pass would exceed an H100's 227 KB of shared memory).
inline int tile_rows(int C) { return C <= 1280 ? 16 : 8; }

inline size_t fwd_smem(int FR, int C) {
  return (static_cast<size_t>(FR) * C + FR * kFH + kFK * kFWS) * 4;
}
inline size_t bwd_rows_smem(int FR, int C) {
  return (static_cast<size_t>(2 * FR) * C + FR * kFH + kFK * kFWS + 2 * FR) * 4;
}
inline size_t bwd_weights_smem(int FR, int C) {
  return (static_cast<size_t>(2 * FR) * C + 4 * FR * kFHB + kThreads) * 4;
}

template <typename T, int FR>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                         const float* __restrict__ bias, const T* __restrict__ w1t,
                         const float* __restrict__ b1, const T* __restrict__ w2t,
                         const float* __restrict__ b2, T* __restrict__ out, int R, int C,
                         int Hd, int exact) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* y_s = reinterpret_cast<float*>(smem);
  float* h_s = y_s + FR * C;
  float* ws = h_s + FR * kFH;
  const int t = threadIdx.x;
  const int row0 = static_cast<int>(blockIdx.x) * FR;
  layer_norm_tile<T, FR>(x, scale, bias, C, row0, R, y_s, C, nullptr, nullptr, nullptr);
  __syncthreads();
  float o[kFCols][FR];
#pragma unroll
  for (int i = 0; i < kFCols; ++i)
#pragma unroll
    for (int r = 0; r < FR; ++r) o[i][r] = 0.f;
  for (int c0 = 0; c0 < Hd; c0 += kFH) {
    const int hn = min(kFH, Hd - c0);
    float u[FR];
    fc1<T, FR>(y_s, w1t, ws, C, Hd, c0, u);
#pragma unroll
    for (int r = 0; r < FR; ++r)
      h_s[r * kFH + t] = t < hn ? round_to<T>(gelu(u[r] + b1[c0 + t], exact)) : 0.f;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kFCols; ++i) {
      const int cb = kFH * i;
      if (cb >= C) continue;  // uniform across the block
      for (int j0 = 0; j0 < hn; j0 += kFK) {
        const int jn = min(kFK, hn - j0);
        stage_t(ws, w2t + static_cast<size_t>(cb) * Hd + c0, Hd, min(kFH, C - cb), j0, jn);
        __syncthreads();
        if (cb + t < C)
          for (int jj = 0; jj < jn; ++jj) {
            const float w = ws[jj * kFWS + t];
#pragma unroll
            for (int r = 0; r < FR; ++r) o[i][r] = fmaf(h_s[r * kFH + j0 + jj], w, o[i][r]);
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
    for (int r = 0; r < FR; ++r) {
      const int n = row0 + r;
      if (n < R) {
        const size_t idx = static_cast<size_t>(n) * C + c;
        out[idx] = from_f<T>((o[i][r] + b2[c]) + to_f(x[idx]));
      }
    }
  }
}

template <typename T, int FR>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                              const float* __restrict__ bias, const T* __restrict__ w1t,
                              const float* __restrict__ b1, const T* __restrict__ w2t,
                              const T* __restrict__ dout, T* __restrict__ dx,
                              float* __restrict__ ypad, float* __restrict__ gpad,
                              float* __restrict__ part, int R, int C, int Hd, int exact) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* y_s = reinterpret_cast<float*>(smem);
  float* g_s = y_s + FR * C;
  float* du_s = g_s + FR * C;
  float* ws = du_s + FR * kFH;
  float* mu_s = ws + kFK * kFWS;
  float* rs_s = mu_s + FR;
  float* dy_s = y_s;  // after the chunk loop
  const int t = threadIdx.x;
  const int row0 = static_cast<int>(blockIdx.x) * FR;
  layer_norm_tile<T, FR>(x, scale, bias, C, row0, R, y_s, C, mu_s, rs_s, ypad);
  for (int e = t; e < FR * C; e += kThreads) {
    const int r = e / C, c = e - r * C;
    const int n = row0 + r;
    const float v = n < R ? to_f(dout[static_cast<size_t>(n) * C + c]) : 0.f;
    g_s[e] = v;
    gpad[static_cast<size_t>(n) * C + c] = v;
  }
  __syncthreads();
  float dy[kFCols][FR];
#pragma unroll
  for (int i = 0; i < kFCols; ++i)
#pragma unroll
    for (int r = 0; r < FR; ++r) dy[i][r] = 0.f;
  for (int c0 = 0; c0 < Hd; c0 += kFH) {
    const int hn = min(kFH, Hd - c0);
    float u[FR], dh[FR];
    fc1<T, FR>(y_s, w1t, ws, C, Hd, c0, u);
#pragma unroll
    for (int r = 0; r < FR; ++r) dh[r] = 0.f;
    if (t < hn)
      for (int c = 0; c < C; ++c) {
        const float w = to_f(w2t[static_cast<size_t>(c) * Hd + c0 + t]);
#pragma unroll
        for (int r = 0; r < FR; ++r) dh[r] = fmaf(g_s[r * C + c], w, dh[r]);
      }
    // du = round_T(dh) gelu'(u), rounded again for the dy product
#pragma unroll
    for (int r = 0; r < FR; ++r)
      du_s[r * kFH + t] =
          t < hn ? round_to<T>(round_to<T>(dh[r]) * gelu_grad(u[r] + b1[c0 + t], exact)) : 0.f;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kFCols; ++i) {
      const int c = kFH * i + t;
      if (c >= C) continue;
      for (int j = 0; j < hn; ++j) {
        const float w = to_f(w1t[static_cast<size_t>(c0 + j) * C + c]);
#pragma unroll
        for (int r = 0; r < FR; ++r) dy[i][r] = fmaf(du_s[r * kFH + j], w, dy[i][r]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kFCols; ++i) {
    const int c = kFH * i + t;
    if (c >= C) continue;
#pragma unroll
    for (int r = 0; r < FR; ++r) dy_s[r * C + c] = dy[i][r];
  }
  __syncthreads();
  ln_backward_tile<T, FR>(dy_s, C, x, dout, scale, mu_s, rs_s, C, row0, R, dx, part,
                          blockIdx.x, gridDim.x);
}

template <typename T, int FR>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_bwd_weights_kernel(const float* __restrict__ ypad, const float* __restrict__ gpad,
                                 const T* __restrict__ w1t, const float* __restrict__ b1,
                                 const T* __restrict__ w2t, float* __restrict__ pw1,
                                 float* __restrict__ pw2, float* __restrict__ pb1, int Rpad,
                                 int C, int Hd, int exact) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* y_s = reinterpret_cast<float*>(smem);
  float* g_s = y_s + FR * C;
  float* sc_s = g_s + FR * C;      // (2, FR, kFHB): u, then dh
  float* du_s = sc_s + 2 * FR * kFHB;
  float* h_s = du_s + FR * kFHB;
  float* red_s = h_s + FR * kFHB;
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
  for (int r0 = p * kRC; r0 < r_end; r0 += FR) {
    for (int e = t; e < FR * C; e += kThreads) {
      y_s[e] = ypad[static_cast<size_t>(r0) * C + e];
      g_s[e] = gpad[static_cast<size_t>(r0) * C + e];
    }
    __syncthreads();
    if (t < 2 * FR * kFHB) {
      const int which = t / (FR * kFHB), r = (t % (FR * kFHB)) / kFHB, j = t % kFHB;
      float s = 0.f;
      if (j0 + j < Hd) {
        if (which == 0) {
          const T* wr = w1t + static_cast<size_t>(j0 + j) * C;
          for (int k = 0; k < C; ++k) s = fmaf(y_s[r * C + k], to_f(wr[k]), s);
        } else {
          for (int c = 0; c < C; ++c)
            s = fmaf(g_s[r * C + c], to_f(w2t[static_cast<size_t>(c) * Hd + j0 + j]), s);
        }
      }
      sc_s[t] = s;
    }
    __syncthreads();
    if (t < FR * kFHB) {
      const int j = t % kFHB;
      float du = 0.f, h = 0.f;
      if (j0 + j < Hd) {
        const float u = sc_s[t] + b1[j0 + j];
        du = round_to<T>(sc_s[FR * kFHB + t]) * gelu_grad(u, exact);  // dh rounded
        h = round_to<T>(gelu(u, exact));
      }
      db1 += du;
      du_s[t] = round_to<T>(du);
      h_s[t] = h;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kFCols; ++i) {
      const int c = kFH * i + t;
      if (c >= C) continue;
      for (int r = 0; r < FR; ++r) {
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
      if (j0 + j >= Hd) continue;
      pw1[(static_cast<size_t>(p) * Hd + j0 + j) * C + c] = a1[i][j];
      pw2[(static_cast<size_t>(p) * C + c) * Hd + j0 + j] = a2[i][j];
    }
  }
  red_s[t] = t < FR * kFHB ? db1 : 0.f;
  __syncthreads();
  if (t < kFHB && j0 + t < Hd) {
    float s = 0.f;
    for (int q = 0; q < FR; ++q) s += red_s[q * kFHB + t];
    pb1[static_cast<size_t>(p) * Hd + j0 + t] = s;
  }
}

// ------------------------------------------------------------- host side

inline bool supported(int C, int Hd) { return C >= 1 && C <= kMaxC && Hd >= 1 && Hd <= kMaxHd; }

// Scratch of the backward, one allocation: y and g in f32 padded to the
// row tile (zeros past R), the rows pass's per-tile partials of dscale,
// dbias and db2, and the per-chunk partials of dW1^T, dW2^T and db1
// (ops/kernels/mlp.py: mlp_workspace_bytes mirrors it).
struct Work {
  int FR, Rpad, tiles, P;
  size_t y, g, pa, pw1, pw2, pb1, bytes;
};

inline size_t align256(size_t v) { return (v + 255) / 256 * 256; }

inline Work workspace(int R, int C, int Hd) {
  Work w{};
  w.FR = tile_rows(C);
  w.Rpad = (R + w.FR - 1) / w.FR * w.FR;
  w.tiles = w.Rpad / w.FR;
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

template <typename T, int FR>
int fwd(const void* x, const float* scale, const float* bias, const void* w1t, const float* b1,
        const void* w2t, const float* b2, void* out, int R, int C, int Hd, int exact,
        cudaStream_t s) {
  const size_t smem = fwd_smem(FR, C);
  cudaError_t err = smem_attr(fused_mlp_fwd_kernel<T, FR>, smem);
  if (err != cudaSuccess) return err;
  fused_mlp_fwd_kernel<T, FR><<<(R + FR - 1) / FR, kThreads, smem, s>>>(
      static_cast<const T*>(x), scale, bias, static_cast<const T*>(w1t), b1,
      static_cast<const T*>(w2t), b2, static_cast<T*>(out), R, C, Hd, exact);
  return cudaGetLastError();
}

template <typename T, int FR>
int bwd(const void* x, const float* scale, const float* bias, const void* w1t, const float* b1,
        const void* w2t, const void* dout, void* dx, float* dscale, float* dbias, void* dw1t,
        float* db1, void* dw2t, float* db2, void* work, int R, int C, int Hd, int exact,
        cudaStream_t s) {
  const Work w = workspace(R, C, Hd);
  auto* wk = static_cast<unsigned char*>(work);
  const size_t smem1 = bwd_rows_smem(FR, C), smem2 = bwd_weights_smem(FR, C);
  cudaError_t err = smem_attr(fused_mlp_bwd_rows_kernel<T, FR>, smem1);
  if (err != cudaSuccess) return err;
  err = smem_attr(fused_mlp_bwd_weights_kernel<T, FR>, smem2);
  if (err != cudaSuccess) return err;
  auto* ypad = reinterpret_cast<float*>(wk + w.y);
  auto* gpad = reinterpret_cast<float*>(wk + w.g);
  auto* pa = reinterpret_cast<float*>(wk + w.pa);
  auto* pw1 = reinterpret_cast<float*>(wk + w.pw1);
  auto* pw2 = reinterpret_cast<float*>(wk + w.pw2);
  auto* pb1 = reinterpret_cast<float*>(wk + w.pb1);
  const T* w1 = static_cast<const T*>(w1t);
  const T* w2 = static_cast<const T*>(w2t);
  fused_mlp_bwd_rows_kernel<T, FR><<<w.tiles, kThreads, smem1, s>>>(
      static_cast<const T*>(x), scale, bias, w1, b1, w2, static_cast<const T*>(dout),
      static_cast<T*>(dx), ypad, gpad, pa, R, C, Hd, exact);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fused_mlp_bwd_weights_kernel<T, FR><<<dim3((Hd + kFHB - 1) / kFHB, w.P), kThreads, smem2, s>>>(
      ypad, gpad, w1, b1, w2, pw1, pw2, pb1, w.Rpad, C, Hd, exact);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long nC = C, nW = static_cast<long long>(C) * Hd;
  if ((err = sum_partials<float>(pa, w.tiles, nC, dscale, s)) != cudaSuccess) return err;
  if ((err = sum_partials<float>(pa + static_cast<size_t>(w.tiles) * C, w.tiles, nC, dbias, s)) != cudaSuccess) return err;
  if ((err = sum_partials<float>(pa + static_cast<size_t>(2) * w.tiles * C, w.tiles, nC, db2, s)) != cudaSuccess) return err;
  if ((err = sum_partials<float>(pb1, w.P, Hd, db1, s)) != cudaSuccess) return err;
  if ((err = sum_partials<T>(pw1, w.P, nW, dw1t, s)) != cudaSuccess) return err;
  return sum_partials<T>(pw2, w.P, nW, dw2t, s);
}


#define PROBPOSE_K5CC_FWD_SIG(T, FR)                                                      \
  int fwd<T, FR>(const void* x, const float* scale, const float* bias, const void* w1t,   \
                 const float* b1, const void* w2t, const float* b2, void* out, int R, int C, \
                 int Hd, int exact, cudaStream_t s)
#define PROBPOSE_K5CC_BWD_SIG(T, FR)                                                      \
  int bwd<T, FR>(const void* x, const float* scale, const float* bias, const void* w1t,   \
                 const float* b1, const void* w2t, const void* dout, void* dx,             \
                 float* dscale, float* dbias, void* dw1t, float* db1, void* dw2t, float* db2, \
                 void* work, int R, int C, int Hd, int exact, cudaStream_t s)

}  // namespace probpose_k5cc
