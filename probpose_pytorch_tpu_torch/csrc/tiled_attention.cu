// Kernel K4 on the CUDA cores: row-tiled multi-head attention for long
// sequences, its forward and its recompute backward, read straight from the
// packed qkv, in float32 (d in {32, 64, 80, 128}) and in bf16 at the head
// width the wgmma kernels do not take, d = 80 (the vit-h preset past K1's
// shared memory). (bf16 with d in {32, 64, 128}, the path every shipped
// model runs, is the wgmma + TMA design of csrc/tiled_attention_sm90.cu.)
//
// Replaces the TPU kernels `_tiled_fwd_kernel` and `_tiled_bwd_kernel`
// (probpose_pytorch_tpu/ops/pallas/attention_tiled.py, reached through
// `_tiled_fwd` / `_tiled_bwd` under the custom_vjp `tiled_attention`), which
// the JAX package's `packed_attention` takes wherever the packed kernel's
// (N, N) scores do not fit (a ViT trunk on 768 x 768 inputs, N = 2304). Here
// it carries the float32 parity checks against the plain versions, and
// vit-h's bf16 attention past N = 645.
//
// What it computes, per (batch b, head h), as K1 does (csrc/packed_attention.cu):
//   ctx[b, :, h*d:(h+1)*d] = softmax_f32(q k^T * scale) v
// with q, k, v the column slices of the qkv-major or head-major (B, N, 3C)
// projection (the layout changes only the head stride and k and v offsets) and
// the context written h-major into (B, N, C). The softmax is exact over the
// whole key axis: p = exp(s - max) / sum in f32. bf16 inputs are widened to
// f32 as they are staged; P and dS are rounded to bf16 before the products
// that take them and every output once at its store, the TPU kernels' order.
//
// Design. K and V are streamed through shared memory in tiles of 64 keys,
// so nothing is bounded by N. A block owns 64 query rows of one (b, h), one
// warp per 16 rows, its Q rows staged once. The forward makes two sweeps
// over the key tiles:
//   sweep 1: S = Q K^T into the warp's tile; per row the running max m and
//            the sum of exponentials l (rescaled when m grows);
//   sweep 2: S again; p = exp(s - m) / l with the final m and l, written
//            over its own row of S; O += P V.
// The backward (the numerics of `_tiled_bwd_kernel`, dsum over P;
// dS = P * (dP - dsum) * scale; dQ = dS K, dK = dS^T Q, dV = P^T dO) runs
// in two passes, since blocks run in no order and no atomics are used (two
// runs give the same bits):
//   pass 1 (query tiles): sweep 1 streams K and V to build m, l and
//          u = sum dP exp(s - m) (rescaled with l), so dsum = u / l; it
//          stores (m, l, dsum) in a (3, B, H, N) scratch; sweep 2 forms dS
//          and accumulates dQ;
//   pass 2 (key tiles): streams Q, dO and their (m, l, dsum) to form P^T
//          and dS^T, and accumulates dK and dV.
// Products are fmaf on the CUDA cores, lanes over keys for the scores and
// over d for the accumulating products (d = 80: lanes 0-15 take a third
// column each).
//
// Plain-C interface, loaded with ctypes (ops/kernels/attention_tiled.py).
// Every entry point returns a cudaError_t as int (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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

// Geometry of one head width D: four warps of 16 query rows.
template <int D>
struct Geo {
  static constexpr int warps = 4;
  static constexpr int threads = warps * 32;
  static constexpr int rows = warps * kWarpRows;  // rows a block owns
  // Row stride of staged tiles: one extra word so lanes reading rows lane,
  // lane + 32 hit distinct banks.
  static constexpr int ks = D + 1;
  // Row stride of a warp tile (16 x 64 scores, or 16 x D outputs), and of
  // the copy of P or dS written over a tile's own rows.
  static constexpr int ss = (D > kTile ? D : kTile) + 4;
  static constexpr int ps = ss;
  static constexpr size_t tile_bytes = size_t(kWarpRows) * ss * sizeof(float);
  static constexpr size_t fwd_smem =
      (size_t(rows) + 2 * kTile) * ks * sizeof(float) + warps * tile_bytes;
  static constexpr size_t bwd_smem = 2 * (size_t(rows) + kTile) * ks * sizeof(float) +
                                     2 * warps * tile_bytes + 3 * kTile * sizeof(float);
};

// Stage rows row0 .. row0 + rows - 1 (zero past N) of a D-column slice with
// element row stride `stride` into shared memory, as f32 with row stride
// Geo::ks.
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, size_t stride, int row0,
                                      int rows, int N) {
  constexpr int ks = Geo<D>::ks;
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * ks + c] = row0 + r < N ? to_float(src[(row0 + r) * stride + c]) : 0.f;
  }
}

// The two products every pass is made of, per warp:
//   abt:  out (16 x 64, f32, stride ss) = A (16 x D) . B (64 x D)^T
//   Acc:  acc (16 x D, f32) += P (16 x 64, stride ps) . B (64 x D)
// with A and B staged with row stride ks.
template <int D>
struct Mma {
  using G = Geo<D>;
  static constexpr int kCols = (D + 31) / 32;  // output columns per lane

  // Whether this lane owns output column lane + 32 t (all but the last
  // third at D = 80).
  static __device__ __forceinline__ bool owns(int lane, int t) {
    return D % 32 == 0 || lane + 32 * t < D;
  }

  static __device__ __forceinline__ void abt(const float* a, const float* b, float* out) {
    const int lane = threadIdx.x % 32;
    float acc0[kWarpRows], acc1[kWarpRows];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) acc0[i] = acc1[i] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float b0 = b[lane * G::ks + c];
      const float b1 = b[(lane + 32) * G::ks + c];
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
        const float x = a[i * G::ks + c];
        acc0[i] = fmaf(x, b0, acc0[i]);
        acc1[i] = fmaf(x, b1, acc1[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      out[i * G::ss + lane] = acc0[i];
      out[i * G::ss + lane + 32] = acc1[i];
    }
  }

  struct Acc {
    float a[kWarpRows][kCols];

    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i)
#pragma unroll
        for (int t = 0; t < kCols; ++t) a[i][t] = 0.f;
    }

    __device__ __forceinline__ void add(const float* p, const float* b) {
      const int lane = threadIdx.x % 32;
      for (int j = 0; j < kTile; ++j) {
        float bv[kCols];
#pragma unroll
        for (int t = 0; t < kCols; ++t)
          bv[t] = owns(lane, t) ? b[j * G::ks + lane + 32 * t] : 0.f;
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i) {
          const float x = p[i * G::ps + j];
#pragma unroll
          for (int t = 0; t < kCols; ++t) a[i][t] = fmaf(x, bv[t], a[i][t]);
        }
      }
    }

    template <typename T>
    __device__ __forceinline__ void store(T* dst, size_t stride, int n0, int N) {
      const int lane = threadIdx.x % 32;
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i)
        if (n0 + i < N)
#pragma unroll
          for (int t = 0; t < kCols; ++t)
            if (owns(lane, t)) dst[(n0 + i) * stride + lane + 32 * t] = from_float<T>(a[i][t]);
      __syncwarp();
    }
  };
};

// ----------------------------------------------------------------- forward

template <typename T, int D>
__global__ void __launch_bounds__(Geo<D>::threads)
    tiled_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int N, int C,
                     int ts, int hs, float scale) {
  using G = Geo<D>;
  using M = Mma<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + G::rows * G::ks;
  float* v_s = k_s + kTile * G::ks;
  float* tiles = reinterpret_cast<float*>(v_s + kTile * G::ks);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * G::rows;
  const size_t C3 = 3 * static_cast<size_t>(C);
  const T* base = qkv + static_cast<size_t>(b) * N * C3 + h * hs;
  stage<D>(q_s, base, C3, row0, G::rows, N);

  const int r0 = warp * kWarpRows;
  const bool active = row0 + r0 < N;  // inactive warps still meet every barrier
  const float* q_w = q_s + r0 * G::ks;
  float* s_w = tiles + warp * kWarpRows * G::ss;
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
    stage<D>(k_s, base + ts, C3, key0, kTile, N);
    __syncthreads();
    if (!active) continue;
    M::abt(q_w, k_s, s_w);
    __syncwarp();
    const bool in0 = key0 + lane < N;
    const bool in1 = key0 + lane + 32 < N;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const float s0 = in0 ? s_w[i * G::ss + lane] * scale : -INFINITY;
      const float s1 = in1 ? s_w[i * G::ss + lane + 32] * scale : -INFINITY;
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
    stage<D>(k_s, base + ts, C3, key0, kTile, N);
    stage<D>(v_s, base + 2 * ts, C3, key0, kTile, N);
    __syncthreads();
    if (!active) continue;
    M::abt(q_w, k_s, s_w);
    __syncwarp();
    const bool in0 = key0 + lane < N;
    const bool in1 = key0 + lane + 32 < N;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const float p0 = in0 ? expf(s_w[i * G::ss + lane] * scale - m[i]) / l[i] : 0.f;
      const float p1 = in1 ? expf(s_w[i * G::ss + lane + 32] * scale - m[i]) / l[i] : 0.f;
      __syncwarp();  // all of S row i is read before any lane overwrites it
      p_w[i * G::ps + lane] = round_to<T>(p0);
      p_w[i * G::ps + lane + 32] = round_to<T>(p1);
    }
    __syncwarp();
    o.add(p_w, v_s);
    __syncwarp();
  }
  if (active) o.store(out + static_cast<size_t>(b) * N * C + h * D, C, row0 + r0, N);
}

// --------------------------------------------------------- backward, pass 1

template <typename T, int D>
__global__ void __launch_bounds__(Geo<D>::threads)
    tiled_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                        T* __restrict__ dqkv, float* __restrict__ stats, int N, int C,
                        int H, int ts, int hs, float scale) {
  using G = Geo<D>;
  using M = Mma<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* o_s = q_s + G::rows * G::ks;
  float* k_s = o_s + G::rows * G::ks;
  float* v_s = k_s + kTile * G::ks;
  float* tiles = reinterpret_cast<float*>(v_s + kTile * G::ks);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * G::rows;
  const size_t C3 = 3 * static_cast<size_t>(C);
  const T* base = qkv + static_cast<size_t>(b) * N * C3 + h * hs;
  const T* obase = dout + static_cast<size_t>(b) * N * C + h * D;
  T* gbase = dqkv + static_cast<size_t>(b) * N * C3 + h * hs;
  stage<D>(q_s, base, C3, row0, G::rows, N);
  stage<D>(o_s, obase, C, row0, G::rows, N);

  const int r0 = warp * kWarpRows;
  const bool active = row0 + r0 < N;
  const float* q_w = q_s + r0 * G::ks;
  const float* o_w = o_s + r0 * G::ks;
  float* s_w = tiles + warp * 2 * kWarpRows * G::ss;
  float* dp_w = s_w + kWarpRows * G::ss;
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
    stage<D>(k_s, base + ts, C3, key0, kTile, N);
    stage<D>(v_s, base + 2 * ts, C3, key0, kTile, N);
    __syncthreads();
    if (!active) continue;
    M::abt(q_w, k_s, s_w);   // S = Q K^T
    M::abt(o_w, v_s, dp_w);  // dP = dO V^T
    __syncwarp();
    const bool in0 = key0 + lane < N;
    const bool in1 = key0 + lane + 32 < N;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const float s0 = in0 ? s_w[i * G::ss + lane] * scale : -INFINITY;
      const float s1 = in1 ? s_w[i * G::ss + lane + 32] * scale : -INFINITY;
      const float d0 = in0 ? dp_w[i * G::ss + lane] : 0.f;
      const float d1 = in1 ? dp_w[i * G::ss + lane + 32] : 0.f;
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
    stage<D>(k_s, base + ts, C3, key0, kTile, N);
    stage<D>(v_s, base + 2 * ts, C3, key0, kTile, N);
    __syncthreads();
    if (!active) continue;
    M::abt(q_w, k_s, s_w);
    M::abt(o_w, v_s, dp_w);
    __syncwarp();
    const bool in0 = key0 + lane < N;
    const bool in1 = key0 + lane + 32 < N;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const float p0 = in0 ? expf(s_w[i * G::ss + lane] * scale - m[i]) / l[i] : 0.f;
      const float p1 = in1 ? expf(s_w[i * G::ss + lane + 32] * scale - m[i]) / l[i] : 0.f;
      const float g0 = p0 * (dp_w[i * G::ss + lane] - u[i]) * scale;
      const float g1 = p1 * (dp_w[i * G::ss + lane + 32] - u[i]) * scale;
      __syncwarp();  // all of dP row i is read before any lane overwrites it
      ds_w[i * G::ps + lane] = round_to<T>(g0);
      ds_w[i * G::ps + lane + 32] = round_to<T>(g1);
    }
    __syncwarp();
    dq.add(ds_w, k_s);
    __syncwarp();
  }
  if (active) dq.store(gbase, C3, row0 + r0, N);
}

// --------------------------------------------------------- backward, pass 2

template <typename T, int D>
__global__ void __launch_bounds__(Geo<D>::threads)
    tiled_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                         T* __restrict__ dqkv, const float* __restrict__ stats, int N,
                         int C, int H, int ts, int hs, float scale) {
  using G = Geo<D>;
  using M = Mma<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + G::rows * G::ks;
  float* q_s = v_s + G::rows * G::ks;
  float* o_s = q_s + kTile * G::ks;
  float* tiles = reinterpret_cast<float*>(o_s + kTile * G::ks);
  float* m_s = tiles + 2 * G::warps * kWarpRows * G::ss;
  float* l_s = m_s + kTile;
  float* d_s = l_s + kTile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * G::rows;  // first key row
  const size_t C3 = 3 * static_cast<size_t>(C);
  const T* base = qkv + static_cast<size_t>(b) * N * C3 + h * hs;
  const T* obase = dout + static_cast<size_t>(b) * N * C + h * D;
  T* gbase = dqkv + static_cast<size_t>(b) * N * C3 + h * hs;
  stage<D>(k_s, base + ts, C3, row0, G::rows, N);
  stage<D>(v_s, base + 2 * ts, C3, row0, G::rows, N);

  const int r0 = warp * kWarpRows;
  const bool active = row0 + r0 < N;
  const float* k_w = k_s + r0 * G::ks;
  const float* v_w = v_s + r0 * G::ks;
  float* a_w = tiles + warp * 2 * kWarpRows * G::ss;  // S^T, then round(P)^T
  float* b_w = a_w + kWarpRows * G::ss;               // dP^T, then dS^T
  float* pb_w = a_w;
  float* ds_w = b_w;
  const float* st = stats + (static_cast<size_t>(b) * H + h) * N;
  const size_t plane = static_cast<size_t>(gridDim.z) * H * N;

  typename M::Acc dk, dv;
  dk.zero();
  dv.zero();
  for (int q0 = 0; q0 < N; q0 += kTile) {
    __syncthreads();
    stage<D>(q_s, base, C3, q0, kTile, N);
    stage<D>(o_s, obase, C, q0, kTile, N);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      const int n = q0 + i;
      m_s[i] = n < N ? st[n] : 0.f;
      l_s[i] = n < N ? st[plane + n] : 1.f;
      d_s[i] = n < N ? st[2 * plane + n] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    M::abt(k_w, q_s, a_w);  // S^T = K Q^T
    M::abt(v_w, o_s, b_w);  // dP^T = V dO^T
    __syncwarp();
    const bool in0 = q0 + lane < N;
    const bool in1 = q0 + lane + 32 < N;
    const float m0 = m_s[lane], m1 = m_s[lane + 32];
    const float l0 = l_s[lane], l1 = l_s[lane + 32];
    const float d0 = d_s[lane], d1 = d_s[lane + 32];
#pragma unroll
    for (int j = 0; j < kWarpRows; ++j) {
      const float p0 = in0 ? expf(a_w[j * G::ss + lane] * scale - m0) / l0 : 0.f;
      const float p1 = in1 ? expf(a_w[j * G::ss + lane + 32] * scale - m1) / l1 : 0.f;
      const float g0 = p0 * (b_w[j * G::ss + lane] - d0) * scale;
      const float g1 = p1 * (b_w[j * G::ss + lane + 32] - d1) * scale;
      __syncwarp();  // row j of both tiles is read before it is overwritten
      pb_w[j * G::ps + lane] = round_to<T>(p0);
      pb_w[j * G::ps + lane + 32] = round_to<T>(p1);
      ds_w[j * G::ps + lane] = round_to<T>(g0);
      ds_w[j * G::ps + lane + 32] = round_to<T>(g1);
    }
    __syncwarp();
    dv.add(pb_w, o_s);  // dV += round(P)^T dO
    dk.add(ds_w, q_s);  // dK += dS^T Q
    __syncwarp();
  }
  if (active) {
    dv.store(gbase + 2 * ts, C3, row0 + r0, N);
    dk.store(gbase + ts, C3, row0 + r0, N);
  }
}

// ------------------------------------------------------------------ launch

template <typename T, int D>
int launch_fwd(const void* qkv, void* out, int B, int N, int C, int heads, bool head_major,
               cudaStream_t stream) {
  using G = Geo<D>;
  cudaError_t err = cudaFuncSetAttribute(tiled_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G::fwd_smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + G::rows - 1) / G::rows, heads, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  tiled_fwd_kernel<T, D><<<grid, G::threads, G::fwd_smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, C, head_major ? D : C,
      head_major ? 3 * D : D, scale);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const void* qkv, const void* dout, void* dqkv, float* stats, int B, int N,
               int C, int heads, bool head_major, cudaStream_t stream) {
  using G = Geo<D>;
  cudaError_t err = cudaFuncSetAttribute(tiled_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G::bwd_smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tiled_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(G::bwd_smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + G::rows - 1) / G::rows, heads, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const T* q = static_cast<const T*>(qkv);
  const T* o = static_cast<const T*>(dout);
  T* g = static_cast<T*>(dqkv);
  const int ts = head_major ? D : C, hs = head_major ? 3 * D : D;
  tiled_bwd_dq_kernel<T, D><<<grid, G::threads, G::bwd_smem, stream>>>(q, o, g, stats, N, C,
                                                                          heads, ts, hs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tiled_bwd_dkv_kernel<T, D><<<grid, G::threads, G::bwd_smem, stream>>>(q, o, g, stats, N,
                                                                           C, heads, ts, hs,
                                                                           scale);
  return cudaGetLastError();
}

template <int D>
long long smem(int backward) {
  return static_cast<long long>(backward ? Geo<D>::bwd_smem : Geo<D>::fwd_smem);
}

}  // namespace

// Head widths: float32 (dtype 0) d in {32, 64, 80, 128}; bf16 (dtype 1)
// d = 80 only (bf16 at d in {32, 64, 128} runs the wgmma kernels of
// csrc/tiled_attention_sm90.cu). Shared memory holds f32 in both.

// Shared memory of the forward (backward = 0) or of the larger backward
// pass (backward = 1) at head width d; -1 for a d it does not take.
extern "C" long long tiled_attention_smem_bytes(int d, int backward) {
  switch (d) {
    case 32: return smem<32>(backward);
    case 64: return smem<64>(backward);
    case 80: return smem<80>(backward);
    case 128: return smem<128>(backward);
    default: return -1;
  }
}

// qkv (B, N, 3C) qkv-major, or head-major with head_major (column of
// (t, h, c): t * d + h * 3d + c; csrc/packed_attention.cu), in -> context
// (B, N, C) out.
extern "C" int tiled_attention_fwd(const void* qkv, void* out, int B, int N, int C,
                                   int heads, int head_major, int dtype, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = C / heads;
  if (dtype == 1)
    return d == 80 ? launch_fwd<__nv_bfloat16, 80>(qkv, out, B, N, C, heads, head_major, s)
                   : cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch_fwd<float, 32>(qkv, out, B, N, C, heads, head_major, s);
    case 64: return launch_fwd<float, 64>(qkv, out, B, N, C, heads, head_major, s);
    case 80: return launch_fwd<float, 80>(qkv, out, B, N, C, heads, head_major, s);
    case 128: return launch_fwd<float, 128>(qkv, out, B, N, C, heads, head_major, s);
    default: return cudaErrorInvalidValue;
  }
}

// qkv (B, N, 3C) and dout (B, N, C) in -> dqkv (B, N, 3C) out, qkv and dqkv
// in one layout; stats is (3, B, heads, N) f32 scratch.
extern "C" int tiled_attention_bwd(const void* qkv, const void* dout, void* dqkv, void* stats,
                                   int B, int N, int C, int heads, int head_major, int dtype,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  const int d = C / heads;
  if (dtype == 1)
    return d == 80 ? launch_bwd<__nv_bfloat16, 80>(qkv, dout, dqkv, st, B, N, C, heads, head_major, s)
                   : cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch_bwd<float, 32>(qkv, dout, dqkv, st, B, N, C, heads, head_major, s);
    case 64: return launch_bwd<float, 64>(qkv, dout, dqkv, st, B, N, C, heads, head_major, s);
    case 80: return launch_bwd<float, 80>(qkv, dout, dqkv, st, B, N, C, heads, head_major, s);
    case 128: return launch_bwd<float, 128>(qkv, dout, dqkv, st, B, N, C, heads, head_major, s);
    default: return cudaErrorInvalidValue;
  }
}
