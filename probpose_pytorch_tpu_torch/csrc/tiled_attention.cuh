// Kernel K4 on the CUDA cores (csrc/tiled_attention.cu has the design):
// the kernels and their launchers, templated on the dtype T and on NC, the
// columns a lane owns (the wide kernels past d = 256 on T alone). csrc/tiled_attention.cu picks the instantiation and
// holds the plain-C interface; tiled_attention_fwd.cu and
// tiled_attention_bwd_{f32,bf16}.cu instantiate the launchers (one nvcc
// each, built side by side: one file of all 36 took ~75 s).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace probpose_k4cc {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back: P and dS before the products taking them.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

constexpr int kTile = 64;      // keys per sweep step (queries in pass 2)
constexpr int kWarpRows = 16;  // rows of one warp's tile

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kMaxD = 256;      // widest head staged whole (eight columns a lane)
constexpr int kWideCols = 128;  // columns a chunk past kMaxD (four a lane)

// Geometry of a launch at head width d (run time) with `warps` warps of 16
// query rows (4, 2 or 1: `pick_warps`). Shared memory holds f32 in both
// dtypes. Past kMaxD the tiles hold kWideCols columns of the head at a time
// (the wide kernels below).
struct Geo {
  int d, warps;
  __host__ __device__ int rows() const { return warps * kWarpRows; }  // rows a block owns
  // Columns of the head a staged tile holds.
  __host__ __device__ int dc() const { return d <= kMaxD ? d : kWideCols; }
  // Row stride of staged tiles: one extra word so lanes reading rows lane,
  // lane + 32 hit distinct banks.
  __host__ __device__ int ks() const { return dc() + 1; }
  // Row stride of a warp tile (16 x 64 scores, or 16 x d outputs), and of
  // the copy of P or dS written over a tile's own rows.
  __host__ __device__ int ss() const { return (dc() > kTile ? dc() : kTile) + 4; }
  size_t tile_bytes() const { return size_t(kWarpRows) * ss() * sizeof(float); }
  size_t fwd_smem() const {
    return (size_t(rows()) + 2 * kTile) * ks() * sizeof(float) + warps * tile_bytes();
  }
  size_t bwd_smem() const {
    return 2 * (size_t(rows()) + kTile) * ks() * sizeof(float) + 2 * warps * tile_bytes() +
           3 * kTile * sizeof(float);
  }
  size_t smem(bool backward) const { return backward ? bwd_smem() : fwd_smem(); }
};

// Warps a block (query rows / 16): the most of 4, 2, 1 whose shared memory
// fits `limit` bytes, or 0 where none does.
inline int pick_warps(int d, bool backward, long long limit) {
  if (d < 1) return 0;
  for (int w = 4; w >= 1; w /= 2)
    if (static_cast<long long>(Geo{d, w}.smem(backward)) <= limit) return w;
  return 0;
}

// Stage rows row0 .. row0 + rows - 1 (zero past N) of a d-column slice with
// element row stride `stride` into shared memory, as f32 with row stride
// ks.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, size_t stride, int row0,
                                      int rows, int N, int d, int ks) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    dst[r * ks + c] = row0 + r < N ? to_float(src[(row0 + r) * stride + c]) : 0.f;
  }
}

// The two products every pass is made of, per warp:
//   abt:  out (16 x 64, f32, stride ss) = A (16 x d) . B (64 x d)^T
//   Acc:  acc (16 x d, f32) += P (16 x 64, stride ss) . B (64 x d)
// with A and B staged with row stride ks. NC = ceil(d / 32) output columns
// a lane (lane + 32 t, t < NC); d itself is a run-time value.
template <int NC>
struct Mma {
  // Whether this lane owns output column lane + 32 t.
  static __device__ __forceinline__ bool owns(int lane, int t, int d) {
    return lane + 32 * t < d;
  }

  static __device__ __forceinline__ void abt(const float* a, const float* b, float* out,
                                             const Geo& g) {
    const int lane = threadIdx.x % 32;
    const int ks = g.ks(), ss = g.ss();
    float acc0[kWarpRows], acc1[kWarpRows];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) acc0[i] = acc1[i] = 0.f;
    for (int c = 0; c < g.d; ++c) {
      const float b0 = b[lane * ks + c];
      const float b1 = b[(lane + 32) * ks + c];
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
        const float x = a[i * ks + c];
        acc0[i] = fmaf(x, b0, acc0[i]);
        acc1[i] = fmaf(x, b1, acc1[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      out[i * ss + lane] = acc0[i];
      out[i * ss + lane + 32] = acc1[i];
    }
  }

  struct Acc {
    float a[kWarpRows][NC];

    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i)
#pragma unroll
        for (int t = 0; t < NC; ++t) a[i][t] = 0.f;
    }

    __device__ __forceinline__ void add(const float* p, const float* b, const Geo& g) {
      const int lane = threadIdx.x % 32;
      const int ks = g.ks(), ps = g.ss();
      for (int j = 0; j < kTile; ++j) {
        float bv[NC];
#pragma unroll
        for (int t = 0; t < NC; ++t)
          bv[t] = owns(lane, t, g.d) ? b[j * ks + lane + 32 * t] : 0.f;
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i) {
          const float x = p[i * ps + j];
#pragma unroll
          for (int t = 0; t < NC; ++t) a[i][t] = fmaf(x, bv[t], a[i][t]);
        }
      }
    }

    template <typename T>
    __device__ __forceinline__ void store(T* dst, size_t stride, int n0, int N, int d) {
      const int lane = threadIdx.x % 32;
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i)
        if (n0 + i < N)
#pragma unroll
          for (int t = 0; t < NC; ++t)
            if (owns(lane, t, d)) dst[(n0 + i) * stride + lane + 32 * t] = from_float<T>(a[i][t]);
      __syncwarp();
    }
  };
};

// ----------------------------------------------------------------- forward

template <typename T, int NC>
__global__ void __launch_bounds__(128)
    tiled_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int N, int C, int d,
                     int ts, int hs, float scale) {
  using M = Mma<NC>;
  const Geo G{d, static_cast<int>(blockDim.x) / 32};
  const int rows = G.rows(), ks = G.ks(), ss = G.ss();
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + rows * ks;
  float* v_s = k_s + kTile * ks;
  float* tiles = v_s + kTile * ks;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * rows;
  const size_t C3 = 3 * static_cast<size_t>(C);
  const T* base = qkv + static_cast<size_t>(b) * N * C3 + h * hs;
  stage(q_s, base, C3, row0, rows, N, d, ks);

  const int r0 = warp * kWarpRows;
  const bool active = row0 + r0 < N;  // inactive warps still meet every barrier
  const float* q_w = q_s + r0 * ks;
  float* s_w = tiles + warp * kWarpRows * ss;
  float* p_w = s_w;  // P row i over the start of S row i

  float m[kWarpRows], l[kWarpRows];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  // Sweep 1: row max and sum of exponentials over every key tile.
  for (int key0 = 0; key0 < N; key0 += kTile) {
    __syncthreads();  // the previous tile is no longer read
    stage(k_s, base + ts, C3, key0, kTile, N, d, ks);
    __syncthreads();
    if (!active) continue;
    M::abt(q_w, k_s, s_w, G);
    __syncwarp();
    const bool in0 = key0 + lane < N;
    const bool in1 = key0 + lane + 32 < N;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const float s0 = in0 ? s_w[i * ss + lane] * scale : -INFINITY;
      const float s1 = in1 ? s_w[i * ss + lane + 32] * scale : -INFINITY;
      const float mn = fmaxf(m[i], warp_max(fmaxf(s0, s1)));
      const float e = warp_sum(expf(s0 - mn) + expf(s1 - mn));
      l[i] = l[i] * expf(m[i] - mn) + e;
      m[i] = mn;
    }
    __syncwarp();
  }

  // Sweep 2: P = round_T(exp(s - m) / l), O += P V.
  typename M::Acc o;
  o.zero();
  for (int key0 = 0; key0 < N; key0 += kTile) {
    __syncthreads();
    stage(k_s, base + ts, C3, key0, kTile, N, d, ks);
    stage(v_s, base + 2 * ts, C3, key0, kTile, N, d, ks);
    __syncthreads();
    if (!active) continue;
    M::abt(q_w, k_s, s_w, G);
    __syncwarp();
    const bool in0 = key0 + lane < N;
    const bool in1 = key0 + lane + 32 < N;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const float p0 = in0 ? expf(s_w[i * ss + lane] * scale - m[i]) / l[i] : 0.f;
      const float p1 = in1 ? expf(s_w[i * ss + lane + 32] * scale - m[i]) / l[i] : 0.f;
      __syncwarp();  // all of S row i is read before any lane overwrites it
      p_w[i * ss + lane] = round_to<T>(p0);
      p_w[i * ss + lane + 32] = round_to<T>(p1);
    }
    __syncwarp();
    o.add(p_w, v_s, G);
    __syncwarp();
  }
  if (active) o.store(out + static_cast<size_t>(b) * N * C + h * d, C, row0 + r0, N, d);
}

// --------------------------------------------------------- backward, pass 1

template <typename T, int NC>
__global__ void __launch_bounds__(128)
    tiled_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                        T* __restrict__ dqkv, float* __restrict__ stats, int N, int C,
                        int H, int d, int ts, int hs, float scale) {
  using M = Mma<NC>;
  const Geo G{d, static_cast<int>(blockDim.x) / 32};
  const int rows = G.rows(), ks = G.ks(), ss = G.ss();
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* o_s = q_s + rows * ks;
  float* k_s = o_s + rows * ks;
  float* v_s = k_s + kTile * ks;
  float* tiles = v_s + kTile * ks;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * rows;
  const size_t C3 = 3 * static_cast<size_t>(C);
  const T* base = qkv + static_cast<size_t>(b) * N * C3 + h * hs;
  const T* obase = dout + static_cast<size_t>(b) * N * C + h * d;
  T* gbase = dqkv + static_cast<size_t>(b) * N * C3 + h * hs;
  stage(q_s, base, C3, row0, rows, N, d, ks);
  stage(o_s, obase, C, row0, rows, N, d, ks);

  const int r0 = warp * kWarpRows;
  const bool active = row0 + r0 < N;
  const float* q_w = q_s + r0 * ks;
  const float* o_w = o_s + r0 * ks;
  float* s_w = tiles + warp * 2 * kWarpRows * ss;
  float* dp_w = s_w + kWarpRows * ss;
  float* ds_w = dp_w;  // dS row i over the start of dP row i

  float m[kWarpRows], l[kWarpRows], u[kWarpRows];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    u[i] = 0.f;
  }

  // Sweep 1: m, l and u = sum dP exp(s - m), rescaled together.
  for (int key0 = 0; key0 < N; key0 += kTile) {
    __syncthreads();
    stage(k_s, base + ts, C3, key0, kTile, N, d, ks);
    stage(v_s, base + 2 * ts, C3, key0, kTile, N, d, ks);
    __syncthreads();
    if (!active) continue;
    M::abt(q_w, k_s, s_w, G);   // S = Q K^T
    M::abt(o_w, v_s, dp_w, G);  // dP = dO V^T
    __syncwarp();
    const bool in0 = key0 + lane < N;
    const bool in1 = key0 + lane + 32 < N;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const float s0 = in0 ? s_w[i * ss + lane] * scale : -INFINITY;
      const float s1 = in1 ? s_w[i * ss + lane + 32] * scale : -INFINITY;
      const float d0 = in0 ? dp_w[i * ss + lane] : 0.f;
      const float d1 = in1 ? dp_w[i * ss + lane + 32] : 0.f;
      const float mn = fmaxf(m[i], warp_max(fmaxf(s0, s1)));
      const float e0 = expf(s0 - mn);
      const float e1 = expf(s1 - mn);
      const float corr = expf(m[i] - mn);
      l[i] = l[i] * corr + warp_sum(e0 + e1);
      u[i] = u[i] * corr + warp_sum(d0 * e0 + d1 * e1);
      m[i] = mn;
    }
    __syncwarp();
  }

  float* st = stats + (static_cast<size_t>(b) * H + h) * N;
  const size_t plane = static_cast<size_t>(gridDim.z) * H * N;
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    u[i] = u[i] / l[i];  // dsum = rowsum(dP * P)
    const int n = row0 + r0 + i;
    if (active && lane == 0 && n < N) {
      st[n] = m[i];
      st[plane + n] = l[i];
      st[2 * plane + n] = u[i];
    }
  }

  // Sweep 2: dS = round_T(P * (dP - dsum) * scale), dQ += dS K.
  typename M::Acc dq;
  dq.zero();
  for (int key0 = 0; key0 < N; key0 += kTile) {
    __syncthreads();
    stage(k_s, base + ts, C3, key0, kTile, N, d, ks);
    stage(v_s, base + 2 * ts, C3, key0, kTile, N, d, ks);
    __syncthreads();
    if (!active) continue;
    M::abt(q_w, k_s, s_w, G);
    M::abt(o_w, v_s, dp_w, G);
    __syncwarp();
    const bool in0 = key0 + lane < N;
    const bool in1 = key0 + lane + 32 < N;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const float p0 = in0 ? expf(s_w[i * ss + lane] * scale - m[i]) / l[i] : 0.f;
      const float p1 = in1 ? expf(s_w[i * ss + lane + 32] * scale - m[i]) / l[i] : 0.f;
      const float g0 = p0 * (dp_w[i * ss + lane] - u[i]) * scale;
      const float g1 = p1 * (dp_w[i * ss + lane + 32] - u[i]) * scale;
      __syncwarp();  // all of dP row i is read before any lane overwrites it
      ds_w[i * ss + lane] = round_to<T>(g0);
      ds_w[i * ss + lane + 32] = round_to<T>(g1);
    }
    __syncwarp();
    dq.add(ds_w, k_s, G);
    __syncwarp();
  }
  if (active) dq.store(gbase, C3, row0 + r0, N, d);
}

// --------------------------------------------------------- backward, pass 2

template <typename T, int NC>
__global__ void __launch_bounds__(128)
    tiled_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                         T* __restrict__ dqkv, const float* __restrict__ stats, int N,
                         int C, int H, int d, int ts, int hs, float scale) {
  using M = Mma<NC>;
  const Geo G{d, static_cast<int>(blockDim.x) / 32};
  const int rows = G.rows(), ks = G.ks(), ss = G.ss();
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + rows * ks;
  float* q_s = v_s + rows * ks;
  float* o_s = q_s + kTile * ks;
  float* tiles = o_s + kTile * ks;
  float* m_s = tiles + 2 * G.warps * kWarpRows * ss;
  float* l_s = m_s + kTile;
  float* d_s = l_s + kTile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * rows;  // first key row
  const size_t C3 = 3 * static_cast<size_t>(C);
  const T* base = qkv + static_cast<size_t>(b) * N * C3 + h * hs;
  const T* obase = dout + static_cast<size_t>(b) * N * C + h * d;
  T* gbase = dqkv + static_cast<size_t>(b) * N * C3 + h * hs;
  stage(k_s, base + ts, C3, row0, rows, N, d, ks);
  stage(v_s, base + 2 * ts, C3, row0, rows, N, d, ks);

  const int r0 = warp * kWarpRows;
  const bool active = row0 + r0 < N;
  const float* k_w = k_s + r0 * ks;
  const float* v_w = v_s + r0 * ks;
  float* a_w = tiles + warp * 2 * kWarpRows * ss;  // S^T, then round(P)^T
  float* b_w = a_w + kWarpRows * ss;               // dP^T, then dS^T
  float* pb_w = a_w;
  float* ds_w = b_w;
  const float* st = stats + (static_cast<size_t>(b) * H + h) * N;
  const size_t plane = static_cast<size_t>(gridDim.z) * H * N;

  typename M::Acc dk, dv;
  dk.zero();
  dv.zero();
  for (int q0 = 0; q0 < N; q0 += kTile) {
    __syncthreads();
    stage(q_s, base, C3, q0, kTile, N, d, ks);
    stage(o_s, obase, C, q0, kTile, N, d, ks);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      const int n = q0 + i;
      m_s[i] = n < N ? st[n] : 0.f;
      l_s[i] = n < N ? st[plane + n] : 1.f;
      d_s[i] = n < N ? st[2 * plane + n] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    M::abt(k_w, q_s, a_w, G);  // S^T = K Q^T
    M::abt(v_w, o_s, b_w, G);  // dP^T = V dO^T
    __syncwarp();
    const bool in0 = q0 + lane < N;
    const bool in1 = q0 + lane + 32 < N;
    const float m0 = m_s[lane], m1 = m_s[lane + 32];
    const float l0 = l_s[lane], l1 = l_s[lane + 32];
    const float d0 = d_s[lane], d1 = d_s[lane + 32];
#pragma unroll
    for (int j = 0; j < kWarpRows; ++j) {
      const float p0 = in0 ? expf(a_w[j * ss + lane] * scale - m0) / l0 : 0.f;
      const float p1 = in1 ? expf(a_w[j * ss + lane + 32] * scale - m1) / l1 : 0.f;
      const float g0 = p0 * (b_w[j * ss + lane] - d0) * scale;
      const float g1 = p1 * (b_w[j * ss + lane + 32] - d1) * scale;
      __syncwarp();  // row j of both tiles is read before it is overwritten
      pb_w[j * ss + lane] = round_to<T>(p0);
      pb_w[j * ss + lane + 32] = round_to<T>(p1);
      ds_w[j * ss + lane] = round_to<T>(g0);
      ds_w[j * ss + lane + 32] = round_to<T>(g1);
    }
    __syncwarp();
    dv.add(pb_w, o_s, G);  // dV += round(P)^T dO
    dk.add(ds_w, q_s, G);  // dK += dS^T Q
    __syncwarp();
  }
  if (active) {
    dv.store(gbase + 2 * ts, C3, row0 + r0, N, d);
    dk.store(gbase + ts, C3, row0 + r0, N, d);
  }
}

// ------------------------------------------------------------ wide heads

// d > kMaxD: the staged tiles hold kWideCols columns of the head at a time.
// A score tile (16 x 64 a warp) sums over all d columns chunk by chunk in
// registers, so each score is one pass over the columns in order, as the
// kernels above take it; every product that yields d columns (O, dQ, dK,
// dV) runs a sweep over the other side's tiles for each chunk of kWideCols
// of its columns, recomputing the scores, with its accumulator Mma<4>::Acc
// for that chunk. Each output column sums over the keys (or query rows) in
// the order the kernels above do; the scores cost ceil(d / 128) times
// theirs. Fault-free coverage of the JAX kernels' widths, not a fast path.
using Wide = Mma<kWideCols / 32>;

// out (16 x 64 a warp, row stride g.ss()) = A B^T over all d columns: A is
// a_rows rows from a_row0 of `a` (element row stride sa), B kTile rows
// from b_row0 of `b` (row stride sb), staged a chunk at a time into a_s and
// b_s; the warp's rows are a_s's rows r0 .. r0 + 15. Every thread of the
// block calls it; warps with `active` false only stage.
template <typename T>
__device__ void wide_abt(const T* a, size_t sa, int a_row0, int a_rows, float* a_s,
                         const T* b, size_t sb, int b_row0, float* b_s, float* out, int r0,
                         bool active, int N, const Geo& g) {
  const int lane = threadIdx.x % 32;
  const int ks = g.ks(), ss = g.ss();
  float acc0[kWarpRows], acc1[kWarpRows];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) acc0[i] = acc1[i] = 0.f;
  for (int c0 = 0; c0 < g.d; c0 += kWideCols) {
    const int w = min(kWideCols, g.d - c0);
    __syncthreads();  // the previous chunk is no longer read
    stage(a_s, a + c0, sa, a_row0, a_rows, N, w, ks);
    stage(b_s, b + c0, sb, b_row0, kTile, N, w, ks);
    __syncthreads();
    if (!active) continue;
    const float* aw = a_s + r0 * ks;
    for (int c = 0; c < w; ++c) {
      const float b0 = b_s[lane * ks + c];
      const float b1 = b_s[(lane + 32) * ks + c];
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
        const float x = aw[i * ks + c];
        acc0[i] = fmaf(x, b0, acc0[i]);
        acc1[i] = fmaf(x, b1, acc1[i]);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    out[i * ss + lane] = acc0[i];
    out[i * ss + lane + 32] = acc1[i];
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(128)
    wide_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int N, int C, int d, int ts,
                    int hs, float scale) {
  const Geo G{d, static_cast<int>(blockDim.x) / 32};
  const int rows = G.rows(), ks = G.ks(), ss = G.ss();
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + rows * ks;
  float* v_s = k_s + kTile * ks;
  float* tiles = v_s + kTile * ks;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * rows;
  const size_t C3 = 3 * static_cast<size_t>(C);
  const T* base = qkv + static_cast<size_t>(b) * N * C3 + h * hs;
  const int r0 = warp * kWarpRows;
  const bool active = row0 + r0 < N;
  float* s_w = tiles + warp * kWarpRows * ss;
  float* p_w = s_w;

  float m[kWarpRows], l[kWarpRows];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  // Sweep 1: row max and sum of exponentials over every key tile.
  for (int key0 = 0; key0 < N; key0 += kTile) {
    wide_abt(base, C3, row0, rows, q_s, base + ts, C3, key0, k_s, s_w, r0, active, N, G);
    if (!active) continue;
    const bool in0 = key0 + lane < N;
    const bool in1 = key0 + lane + 32 < N;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const float s0 = in0 ? s_w[i * ss + lane] * scale : -INFINITY;
      const float s1 = in1 ? s_w[i * ss + lane + 32] * scale : -INFINITY;
      const float mn = fmaxf(m[i], warp_max(fmaxf(s0, s1)));
      const float e = warp_sum(expf(s0 - mn) + expf(s1 - mn));
      l[i] = l[i] * expf(m[i] - mn) + e;
      m[i] = mn;
    }
    __syncwarp();
  }

  // Per chunk of output columns: P = round_T(exp(s - m) / l), O += P V.
  for (int c0 = 0; c0 < d; c0 += kWideCols) {
    const int w = min(kWideCols, d - c0);
    typename Wide::Acc o;
    o.zero();
    for (int key0 = 0; key0 < N; key0 += kTile) {
      wide_abt(base, C3, row0, rows, q_s, base + ts, C3, key0, k_s, s_w, r0, active, N, G);
      if (active) {
        const bool in0 = key0 + lane < N;
        const bool in1 = key0 + lane + 32 < N;
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i) {
          const float p0 = in0 ? expf(s_w[i * ss + lane] * scale - m[i]) / l[i] : 0.f;
          const float p1 = in1 ? expf(s_w[i * ss + lane + 32] * scale - m[i]) / l[i] : 0.f;
          __syncwarp();  // all of S row i is read before any lane overwrites it
          p_w[i * ss + lane] = round_to<T>(p0);
          p_w[i * ss + lane + 32] = round_to<T>(p1);
        }
      }
      __syncthreads();  // k_s is no longer read
      stage(v_s, base + 2 * ts + c0, C3, key0, kTile, N, w, ks);
      __syncthreads();
      if (active) o.add(p_w, v_s, G);
      __syncwarp();
    }
    if (active) o.store(out + static_cast<size_t>(b) * N * C + h * d + c0, C, row0 + r0, N, w);
  }
}

template <typename T>
__global__ void __launch_bounds__(128)
    wide_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                       T* __restrict__ dqkv, float* __restrict__ stats, int N, int C, int H,
                       int d, int ts, int hs, float scale) {
  const Geo G{d, static_cast<int>(blockDim.x) / 32};
  const int rows = G.rows(), ks = G.ks(), ss = G.ss();
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* o_s = q_s + rows * ks;
  float* k_s = o_s + rows * ks;
  float* v_s = k_s + kTile * ks;
  float* tiles = v_s + kTile * ks;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * rows;
  const size_t C3 = 3 * static_cast<size_t>(C);
  const T* base = qkv + static_cast<size_t>(b) * N * C3 + h * hs;
  const T* obase = dout + static_cast<size_t>(b) * N * C + h * d;
  T* gbase = dqkv + static_cast<size_t>(b) * N * C3 + h * hs;
  const int r0 = warp * kWarpRows;
  const bool active = row0 + r0 < N;
  float* s_w = tiles + warp * 2 * kWarpRows * ss;
  float* dp_w = s_w + kWarpRows * ss;
  float* ds_w = dp_w;

  float m[kWarpRows], l[kWarpRows], u[kWarpRows];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    u[i] = 0.f;
  }
  // Sweep 1: m, l and u = sum dP exp(s - m), rescaled together.
  for (int key0 = 0; key0 < N; key0 += kTile) {
    wide_abt(base, C3, row0, rows, q_s, base + ts, C3, key0, k_s, s_w, r0, active, N, G);
    wide_abt(obase, C, row0, rows, o_s, base + 2 * ts, C3, key0, v_s, dp_w, r0, active, N, G);
    if (!active) continue;
    const bool in0 = key0 + lane < N;
    const bool in1 = key0 + lane + 32 < N;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const float s0 = in0 ? s_w[i * ss + lane] * scale : -INFINITY;
      const float s1 = in1 ? s_w[i * ss + lane + 32] * scale : -INFINITY;
      const float d0 = in0 ? dp_w[i * ss + lane] : 0.f;
      const float d1 = in1 ? dp_w[i * ss + lane + 32] : 0.f;
      const float mn = fmaxf(m[i], warp_max(fmaxf(s0, s1)));
      const float e0 = expf(s0 - mn);
      const float e1 = expf(s1 - mn);
      const float corr = expf(m[i] - mn);
      l[i] = l[i] * corr + warp_sum(e0 + e1);
      u[i] = u[i] * corr + warp_sum(d0 * e0 + d1 * e1);
      m[i] = mn;
    }
    __syncwarp();
  }

  float* st = stats + (static_cast<size_t>(b) * H + h) * N;
  const size_t plane = static_cast<size_t>(gridDim.z) * H * N;
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    u[i] = u[i] / l[i];  // dsum = rowsum(dP * P)
    const int n = row0 + r0 + i;
    if (active && lane == 0 && n < N) {
      st[n] = m[i];
      st[plane + n] = l[i];
      st[2 * plane + n] = u[i];
    }
  }

  // Per chunk of dQ's columns: dS = round_T(P * (dP - dsum) * scale), dQ += dS K.
  for (int c0 = 0; c0 < d; c0 += kWideCols) {
    const int w = min(kWideCols, d - c0);
    typename Wide::Acc dq;
    dq.zero();
    for (int key0 = 0; key0 < N; key0 += kTile) {
      wide_abt(base, C3, row0, rows, q_s, base + ts, C3, key0, k_s, s_w, r0, active, N, G);
      wide_abt(obase, C, row0, rows, o_s, base + 2 * ts, C3, key0, v_s, dp_w, r0, active, N,
               G);
      if (active) {
        const bool in0 = key0 + lane < N;
        const bool in1 = key0 + lane + 32 < N;
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i) {
          const float p0 = in0 ? expf(s_w[i * ss + lane] * scale - m[i]) / l[i] : 0.f;
          const float p1 = in1 ? expf(s_w[i * ss + lane + 32] * scale - m[i]) / l[i] : 0.f;
          const float g0 = p0 * (dp_w[i * ss + lane] - u[i]) * scale;
          const float g1 = p1 * (dp_w[i * ss + lane + 32] - u[i]) * scale;
          __syncwarp();  // all of dP row i is read before any lane overwrites it
          ds_w[i * ss + lane] = round_to<T>(g0);
          ds_w[i * ss + lane + 32] = round_to<T>(g1);
        }
      }
      __syncthreads();  // k_s is no longer read
      stage(k_s, base + ts + c0, C3, key0, kTile, N, w, ks);
      __syncthreads();
      if (active) dq.add(ds_w, k_s, G);
      __syncwarp();
    }
    if (active) dq.store(gbase + c0, C3, row0 + r0, N, w);
  }
}

template <typename T>
__global__ void __launch_bounds__(128)
    wide_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                        T* __restrict__ dqkv, const float* __restrict__ stats, int N, int C,
                        int H, int d, int ts, int hs, float scale) {
  const Geo G{d, static_cast<int>(blockDim.x) / 32};
  const int rows = G.rows(), ks = G.ks(), ss = G.ss();
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + rows * ks;
  float* q_s = v_s + rows * ks;
  float* o_s = q_s + kTile * ks;
  float* tiles = o_s + kTile * ks;
  float* m_s = tiles + 2 * G.warps * kWarpRows * ss;
  float* l_s = m_s + kTile;
  float* d_s = l_s + kTile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * rows;  // first key row
  const size_t C3 = 3 * static_cast<size_t>(C);
  const T* base = qkv + static_cast<size_t>(b) * N * C3 + h * hs;
  const T* obase = dout + static_cast<size_t>(b) * N * C + h * d;
  T* gbase = dqkv + static_cast<size_t>(b) * N * C3 + h * hs;
  const int r0 = warp * kWarpRows;
  const bool active = row0 + r0 < N;
  float* a_w = tiles + warp * 2 * kWarpRows * ss;  // S^T, then round(P)^T
  float* b_w = a_w + kWarpRows * ss;               // dP^T, then dS^T
  const float* st = stats + (static_cast<size_t>(b) * H + h) * N;
  const size_t plane = static_cast<size_t>(gridDim.z) * H * N;

  // Per chunk of dK's and dV's columns, a sweep over the query tiles.
  for (int c0 = 0; c0 < d; c0 += kWideCols) {
    const int w = min(kWideCols, d - c0);
    typename Wide::Acc dk, dv;
    dk.zero();
    dv.zero();
    for (int q0 = 0; q0 < N; q0 += kTile) {
      __syncthreads();  // the previous tile's statistics are no longer read
      for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
        const int n = q0 + i;
        m_s[i] = n < N ? st[n] : 0.f;
        l_s[i] = n < N ? st[plane + n] : 1.f;
        d_s[i] = n < N ? st[2 * plane + n] : 0.f;
      }
      wide_abt(base + ts, C3, row0, rows, k_s, base, C3, q0, q_s, a_w, r0, active, N, G);
      wide_abt(base + 2 * ts, C3, row0, rows, v_s, obase, C, q0, o_s, b_w, r0, active, N, G);
      if (active) {
        const bool in0 = q0 + lane < N;
        const bool in1 = q0 + lane + 32 < N;
        const float m0 = m_s[lane], m1 = m_s[lane + 32];
        const float l0 = l_s[lane], l1 = l_s[lane + 32];
        const float d0 = d_s[lane], d1 = d_s[lane + 32];
#pragma unroll
        for (int j = 0; j < kWarpRows; ++j) {
          const float p0 = in0 ? expf(a_w[j * ss + lane] * scale - m0) / l0 : 0.f;
          const float p1 = in1 ? expf(a_w[j * ss + lane + 32] * scale - m1) / l1 : 0.f;
          const float g0 = p0 * (b_w[j * ss + lane] - d0) * scale;
          const float g1 = p1 * (b_w[j * ss + lane + 32] - d1) * scale;
          __syncwarp();  // row j of both tiles is read before it is overwritten
          a_w[j * ss + lane] = round_to<T>(p0);
          a_w[j * ss + lane + 32] = round_to<T>(p1);
          b_w[j * ss + lane] = round_to<T>(g0);
          b_w[j * ss + lane + 32] = round_to<T>(g1);
        }
      }
      __syncthreads();  // q_s and o_s are no longer read
      stage(q_s, base + c0, C3, q0, kTile, N, w, ks);
      stage(o_s, obase + c0, C, q0, kTile, N, w, ks);
      __syncthreads();
      if (active) {
        dv.add(a_w, o_s, G);  // dV += round(P)^T dO
        dk.add(b_w, q_s, G);  // dK += dS^T Q
      }
      __syncwarp();
    }
    if (active) {
      dv.store(gbase + 2 * ts + c0, C3, row0 + r0, N, w);
      dk.store(gbase + ts + c0, C3, row0 + r0, N, w);
    }
  }
}

// ------------------------------------------------------------------ launch

inline long long device_smem_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return bytes;
}

template <typename T, int NC>
int launch_fwd(const void* qkv, void* out, int B, int N, int C, int heads, bool head_major,
               int warps, cudaStream_t stream) {
  const int d = C / heads;
  const Geo G{d, warps};
  cudaError_t err = cudaFuncSetAttribute(tiled_fwd_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G.fwd_smem()));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + G.rows() - 1) / G.rows(), heads, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  tiled_fwd_kernel<T, NC><<<grid, warps * 32, G.fwd_smem(), stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, C, d, head_major ? d : C,
      head_major ? 3 * d : d, scale);
  return cudaGetLastError();
}

template <typename T, int NC>
int launch_bwd(const void* qkv, const void* dout, void* dqkv, float* stats, int B, int N,
               int C, int heads, bool head_major, int warps, cudaStream_t stream) {
  const int d = C / heads;
  const Geo G{d, warps};
  cudaError_t err = cudaFuncSetAttribute(tiled_bwd_dq_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G.bwd_smem()));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tiled_bwd_dkv_kernel<T, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(G.bwd_smem()));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + G.rows() - 1) / G.rows(), heads, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  const T* q = static_cast<const T*>(qkv);
  const T* o = static_cast<const T*>(dout);
  T* g = static_cast<T*>(dqkv);
  const int ts = head_major ? d : C, hs = head_major ? 3 * d : d;
  tiled_bwd_dq_kernel<T, NC><<<grid, warps * 32, G.bwd_smem(), stream>>>(
      q, o, g, stats, N, C, heads, d, ts, hs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tiled_bwd_dkv_kernel<T, NC><<<grid, warps * 32, G.bwd_smem(), stream>>>(
      q, o, g, stats, N, C, heads, d, ts, hs, scale);
  return cudaGetLastError();
}

template <typename T>
int launch_wide_fwd(const void* qkv, void* out, int B, int N, int C, int heads,
                    bool head_major, int warps, cudaStream_t stream) {
  const int d = C / heads;
  const Geo G{d, warps};
  cudaError_t err = cudaFuncSetAttribute(wide_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G.fwd_smem()));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + G.rows() - 1) / G.rows(), heads, B);
  wide_fwd_kernel<T><<<grid, warps * 32, G.fwd_smem(), stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, C, d, head_major ? d : C,
      head_major ? 3 * d : d, 1.0f / sqrtf(static_cast<float>(d)));
  return cudaGetLastError();
}

template <typename T>
int launch_wide_bwd(const void* qkv, const void* dout, void* dqkv, float* stats, int B, int N,
                    int C, int heads, bool head_major, int warps, cudaStream_t stream) {
  const int d = C / heads;
  const Geo G{d, warps};
  cudaError_t err = cudaFuncSetAttribute(wide_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G.bwd_smem()));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wide_bwd_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(G.bwd_smem()));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + G.rows() - 1) / G.rows(), heads, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  const T* q = static_cast<const T*>(qkv);
  const T* o = static_cast<const T*>(dout);
  T* g = static_cast<T*>(dqkv);
  const int ts = head_major ? d : C, hs = head_major ? 3 * d : d;
  wide_bwd_dq_kernel<T><<<grid, warps * 32, G.bwd_smem(), stream>>>(
      q, o, g, stats, N, C, heads, d, ts, hs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wide_bwd_dkv_kernel<T><<<grid, warps * 32, G.bwd_smem(), stream>>>(
      q, o, g, stats, N, C, heads, d, ts, hs, scale);
  return cudaGetLastError();
}

// The NC a head width d takes: ceil(d / 32), rounded up to an instantiated
// one (5 -> 6, 7 -> 8: a masked column of registers).
inline int columns(int d) {
  const int nc = (d + 31) / 32;
  return nc == 5 ? 6 : nc == 7 ? 8 : nc;
}

// X(T, NC) for every instantiated NC.
#define PROBPOSE_K4CC_COLUMNS(X, T) X(T, 1) X(T, 2) X(T, 3) X(T, 4) X(T, 6) X(T, 8)

#define PROBPOSE_K4CC_FWD_SIG(T, NC)                                                      \
  int launch_fwd<T, NC>(const void* qkv, void* out, int B, int N, int C, int heads,       \
                        bool head_major, int warps, cudaStream_t stream)
#define PROBPOSE_K4CC_BWD_SIG(T, NC)                                                      \
  int launch_bwd<T, NC>(const void* qkv, const void* dout, void* dqkv, float* stats, int B, \
                        int N, int C, int heads, bool head_major, int warps,             \
                        cudaStream_t stream)
#define PROBPOSE_K4CC_FWD_EXTERN(T, NC) extern template PROBPOSE_K4CC_FWD_SIG(T, NC);
#define PROBPOSE_K4CC_BWD_EXTERN(T, NC) extern template PROBPOSE_K4CC_BWD_SIG(T, NC);
#define PROBPOSE_K4CC_FWD_INST(T, NC) template PROBPOSE_K4CC_FWD_SIG(T, NC);
#define PROBPOSE_K4CC_BWD_INST(T, NC) template PROBPOSE_K4CC_BWD_SIG(T, NC);
#define PROBPOSE_K4CC_WIDE_FWD_SIG(T)                                                  \
  int launch_wide_fwd<T>(const void* qkv, void* out, int B, int N, int C, int heads,    \
                         bool head_major, int warps, cudaStream_t stream)
#define PROBPOSE_K4CC_WIDE_BWD_SIG(T)                                                  \
  int launch_wide_bwd<T>(const void* qkv, const void* dout, void* dqkv, float* stats,   \
                         int B, int N, int C, int heads, bool head_major, int warps,     \
                         cudaStream_t stream)

}  // namespace probpose_k4cc
