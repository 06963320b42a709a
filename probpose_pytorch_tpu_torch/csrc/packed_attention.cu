// Kernel K1 on the CUDA cores: multi-head attention read straight from the
// packed qkv, its forward here and its recompute backward further down
// ("backward"), for float32 (the f32 parity checks) and for bf16 head widths
// outside {32, 64, 128}. K1's bf16 shapes with d in {32, 64, 128} run the
// wgmma kernels of csrc/tiled_attention_sm90.cu (ops/kernels/attention.py
// routes them). Kernel K6 (`flat_attention_fwd` at the end) is the same
// forward body read from three (B, N, heads, d) views through their strides
// instead, for the shapes K6's wgmma route does not take.
//
// Replaces the TPU kernels `_packed_fwd_kernel` and `_packed_bwd_kernel`
// (probpose_pytorch_tpu/ops/pallas/attention_kernel.py, called from
// `_packed_fwd` / `_packed_bwd` under the custom_vjp `packed_attention`).
//
// What it computes, per (batch b, head h):
//   ctx[b, :, h*d:(h+1)*d] = round_T(softmax_f32(q k^T * scale)) v
// where q, k and v are column slices of the (B, N, 3C) projection in the
// qkv-major order `Dense(3C)` + `reshape(B, N, 3, H, d)` gives: q at column
// h*d, k at C + h*d, v at 2C + h*d; or, in the head-major layout of
// attn_impl="fused_tp" (JAX's `_qkv_offsets`), q at 3d*h, k at 3d*h + d, v at
// 3d*h + 2d, so a tensor-parallel rank's column slice holds whole heads.
// Scores and softmax are f32; the scale is
// applied after the q.k product and P is rounded to the input type before
// P.V, as the TPU kernel does. The context is written h-major into (B, N, C):
// no (B, H, N, N) matrix and no transpose ever reaches device memory.
//
// What bounds it on an H100: on the CUDA cores it is bound by its own
// shared-memory loads and FMAs. One block of 8 warps per (64 query rows,
// head, batch) stages K_h and V_h; each warp takes one query row at a time,
// lanes splitting the keys for q.k and the softmax and the d columns for
// P.V. K rows are padded by one 32-bit word so the lanes' strided reads hit
// distinct banks. Its f32 sums run in the same order as cuBLAS's and
// PyTorch's softmax, which the f32 checks show. The shared memory exceeds
// the 48 KB static limit, hence the opt-in attribute.
//
// Plain-C interface, loaded with ctypes (ops/kernels/attention.py). Every
// entry point returns a cudaError_t as int (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

// ------------------------------------------------------------------ common

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Element strides of a (B, N, heads, d) view with unit stride along d: row
// (b, n) of head h starts at b * batch + n * row + h * head.
struct Strides {
  size_t batch, row, head;
};

// ------------------------------------------------------- CUDA-core path

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;

// Row stride of the staged K tile in elements: d plus one 32-bit word.
template <typename T>
__host__ __device__ constexpr int k_stride(int d) {
  return d + static_cast<int>(4 / sizeof(T));
}

template <typename T>
size_t smem_bytes(int N, int d) {
  return static_cast<size_t>(N) * (k_stride<T>(d) + d) * sizeof(T) +
         static_cast<size_t>(kWarps) * (d + N) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    packed_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, Strides st,
                                T* __restrict__ out, int N, int C, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ks = k_stride<T>(d);
  T* k_s = reinterpret_cast<T*>(smem);            // (N, ks)
  T* v_s = k_s + static_cast<size_t>(N) * ks;     // (N, d)
  float* f_s = reinterpret_cast<float*>(v_s + static_cast<size_t>(N) * d);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* q_w = f_s + warp * (d + N);  // (d,) this warp's query row, f32
  float* p_w = q_w + d;               // (N,) its scores, then probabilities

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t off = b * st.batch + h * st.head;
  const T* qb = q + off;
  const T* kb = k + off;
  const T* vb = v + off;

  for (int i = threadIdx.x; i < N * d; i += kThreads) {
    const int j = i / d;
    const int c = i - j * d;
    k_s[j * ks + c] = kb[j * st.row + c];
    v_s[j * d + c] = vb[j * st.row + c];
  }
  __syncthreads();

  const int row0 = static_cast<int>(blockIdx.x) * kRowsPerBlock;
  const int row_end = min(row0 + kRowsPerBlock, N);
  for (int n = row0 + warp; n < row_end; n += kWarps) {
    const T* q_row = qb + n * st.row;
    for (int c = lane; c < d; c += 32) q_w[c] = to_float(q_row[c]);
    __syncwarp();

    // Scores: lane owns keys j = lane, lane + 32, ...
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      const T* k_row = k_s + j * ks;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(q_w[c], to_float(k_row[c]), s);
      s *= scale;
      p_w[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(p_w[j] - m);
      p_w[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < N; j += 32)
      p_w[j] = to_float(from_float<T>(p_w[j] / l));
    __syncwarp();

    // Context: lane owns columns c = lane, lane + 32, ...
    T* o_row = out + (static_cast<size_t>(b) * N + n) * C + h * d;
    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j)
        acc = fmaf(p_w[j], to_float(v_s[j * d + c]), acc);
      o_row[c] = from_float<T>(acc);
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, Strides st, void* out, int B,
           int N, int C, int heads, cudaStream_t stream) {
  const int d = C / heads;
  const size_t smem = smem_bytes<T>(N, d);
  cudaError_t err = cudaFuncSetAttribute(
      packed_attention_fwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, heads, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  packed_attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), st,
      static_cast<T*>(out), N, C, d, scale);
  return cudaGetLastError();
}

// ================================================================ backward
//
// Kernel K1 backward: replaces `_packed_bwd_kernel` (attention_kernel.py,
// reached through `_packed_bwd` and the custom_vjp bwd of `packed_attention`).
// Per (b, h), with P the f32 softmax recomputed from q and k:
//   dV = round_T(P)^T dO
//   dP = dO V^T                                   (f32)
//   dS = round_T(P * (dP - rowsum(dP * P)) * scale), row sum over f32 P
//   dQ = dS K,  dK = dS^T Q                       (f32 sums)
// written straight into the packed (B, N, 3C) dqkv at q, k and v's offsets.
// The two roundings are the TPU kernel's.
//
// dK and dV sum over all query rows, dQ over all key rows, and blocks run in
// no order, so the work is split in two passes, each over tiles of 64 rows:
//   pass 1 (query tiles): S, P, dP, D = rowsum(dP * P), dS, dQ; it leaves
//          each query row's softmax max m, sum l and D in a (3, B, H, N) f32
//          scratch (9 KB per (b, h) at N = 192 -- no N x N matrix);
//   pass 2 (key tiles):   S^T and dP^T for its keys against every query,
//          P from m and l, dS from D, then dV and dK.
// Pass 2 recomputes S with the same operands in the same order as pass 1,
// so both see the same P.
//
// What bounds it on an H100: each pass does 3 products of 2 N^2 d FLOPs per
// (b, h) on the CUDA cores, bound by its own shared-memory loads and FMAs.
// It serves float32 (the f32 parity checks) and the bf16 head widths the
// wgmma kernels do not take (d outside {32, 64, 128}); bf16 with d in
// {32, 64, 128} runs K4's backward in csrc/tiled_attention_sm90.cu.

// CUDA-core passes. Four warps, each taking one row at a time, lanes splitting the N
// rows of the other side and then the d columns. Shared memory is the
// forward's exactly (the staged (N, d) pair plus 2 * (d + N) f32 per warp),
// so every shape the forward takes, the backward takes too.
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = kBwdWarps * 32;

template <typename T>
size_t bwd_smem_bytes(int N, int d) {
  return static_cast<size_t>(N) * (k_stride<T>(d) + d) * sizeof(T) +
         static_cast<size_t>(kBwdWarps) * 2 * (d + N) * sizeof(float);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Pass 1: one query row per warp; K_h rows (padded stride) and V_h rows.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    packed_attention_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                                   T* __restrict__ dqkv, float* __restrict__ stats,
                                   int N, int C, int H, int d, int ts, int hs, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ks = k_stride<T>(d);
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + static_cast<size_t>(N) * ks;
  float* f_s = reinterpret_cast<float*>(v_s + static_cast<size_t>(N) * d);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* q_w = f_s + warp * 2 * (d + N);  // (d,) query row
  float* o_w = q_w + d;                   // (d,) dO row
  float* p_w = o_w + d;                   // (N,) scores, P, then dS
  float* dp_w = p_w + N;                  // (N,) dP

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t C3 = 3 * static_cast<size_t>(C);
  const T* base = qkv + static_cast<size_t>(b) * N * C3;
  const T* obase = dout + static_cast<size_t>(b) * N * C;
  T* gbase = dqkv + static_cast<size_t>(b) * N * C3;
  for (int i = threadIdx.x; i < N * d; i += kBwdThreads) {
    const int j = i / d;
    const int c = i - j * d;
    const T* row = base + j * C3;
    k_s[j * ks + c] = row[ts + h * hs + c];
    v_s[j * d + c] = row[2 * ts + h * hs + c];
  }
  __syncthreads();

  float* st = stats + (static_cast<size_t>(b) * H + h) * N;
  const size_t plane = static_cast<size_t>(gridDim.z) * H * N;
  const int row0 = static_cast<int>(blockIdx.x) * kRowsPerBlock;
  const int row_end = min(row0 + kRowsPerBlock, N);
  for (int n = row0 + warp; n < row_end; n += kBwdWarps) {
    for (int c = lane; c < d; c += 32) {
      q_w[c] = to_float(base[n * C3 + h * hs + c]);
      o_w[c] = to_float(obase[n * C + h * d + c]);
    }
    __syncwarp();
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < d; ++c) {
        s = fmaf(q_w[c], to_float(k_s[j * ks + c]), s);
        dp = fmaf(o_w[c], to_float(v_s[j * d + c]), dp);
      }
      s *= scale;
      p_w[j] = s;
      dp_w[j] = dp;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(p_w[j] - m);
      p_w[j] = e;
      l += e;
    }
    l = warp_sum(l);
    float dsum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float p = p_w[j] / l;
      p_w[j] = p;
      dsum += dp_w[j] * p;
    }
    dsum = warp_sum(dsum);
    for (int j = lane; j < N; j += 32)
      p_w[j] = round_to<T>(p_w[j] * (dp_w[j] - dsum) * scale);
    if (lane == 0) {
      st[n] = m;
      st[plane + n] = l;
      st[2 * plane + n] = dsum;
    }
    __syncwarp();
    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(p_w[j], to_float(k_s[j * ks + c]), acc);
      gbase[n * C3 + h * hs + c] = from_float<T>(acc);
    }
    __syncwarp();
  }
}

// Pass 2: one key row per warp; Q_h rows (padded stride) and dO_h rows.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    packed_attention_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                                    T* __restrict__ dqkv, const float* __restrict__ stats,
                                    int N, int C, int H, int d, int ts, int hs, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ks = k_stride<T>(d);
  T* q_s = reinterpret_cast<T*>(smem);
  T* o_s = q_s + static_cast<size_t>(N) * ks;
  float* f_s = reinterpret_cast<float*>(o_s + static_cast<size_t>(N) * d);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* k_w = f_s + warp * 2 * (d + N);  // (d,) key row
  float* v_w = k_w + d;                   // (d,) value row
  float* pb_w = v_w + d;                  // (N,) round(P) of this key
  float* ds_w = pb_w + N;                 // (N,) dS of this key

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t C3 = 3 * static_cast<size_t>(C);
  const T* base = qkv + static_cast<size_t>(b) * N * C3;
  const T* obase = dout + static_cast<size_t>(b) * N * C;
  T* gbase = dqkv + static_cast<size_t>(b) * N * C3;
  for (int i = threadIdx.x; i < N * d; i += kBwdThreads) {
    const int j = i / d;
    const int c = i - j * d;
    q_s[j * ks + c] = base[j * C3 + h * hs + c];
    o_s[j * d + c] = obase[j * C + h * d + c];
  }
  __syncthreads();

  const float* st = stats + (static_cast<size_t>(b) * H + h) * N;
  const size_t plane = static_cast<size_t>(gridDim.z) * H * N;
  const int row0 = static_cast<int>(blockIdx.x) * kRowsPerBlock;
  const int row_end = min(row0 + kRowsPerBlock, N);
  for (int j = row0 + warp; j < row_end; j += kBwdWarps) {
    for (int c = lane; c < d; c += 32) {
      k_w[c] = to_float(base[j * C3 + ts + h * hs + c]);
      v_w[c] = to_float(base[j * C3 + 2 * ts + h * hs + c]);
    }
    __syncwarp();
    for (int i = lane; i < N; i += 32) {
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < d; ++c) {
        s = fmaf(to_float(q_s[i * ks + c]), k_w[c], s);
        dp = fmaf(to_float(o_s[i * d + c]), v_w[c], dp);
      }
      s *= scale;
      const float p = expf(s - st[i]) / st[plane + i];
      pb_w[i] = round_to<T>(p);
      ds_w[i] = round_to<T>(p * (dp - st[2 * plane + i]) * scale);
    }
    __syncwarp();
    for (int c = lane; c < d; c += 32) {
      float dv = 0.f, dk = 0.f;
      for (int i = 0; i < N; ++i) {
        dv = fmaf(pb_w[i], to_float(o_s[i * d + c]), dv);
        dk = fmaf(ds_w[i], to_float(q_s[i * ks + c]), dk);
      }
      gbase[j * C3 + ts + h * hs + c] = from_float<T>(dk);
      gbase[j * C3 + 2 * ts + h * hs + c] = from_float<T>(dv);
    }
    __syncwarp();
  }
}

template <typename T>
int launch_bwd(const void* qkv, const void* dout, void* dqkv, float* stats, int B,
               int N, int C, int heads, bool head_major, cudaStream_t stream) {
  const int d = C / heads;
  // Column of (t, h, c), t in {q, k, v}: t * ts + h * hs + c.
  const int ts = head_major ? d : C;
  const int hs = head_major ? 3 * d : d;
  const size_t smem = bwd_smem_bytes<T>(N, d);
  cudaError_t err = cudaFuncSetAttribute(packed_attention_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(packed_attention_bwd_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, heads, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  const T* q = static_cast<const T*>(qkv);
  const T* o = static_cast<const T*>(dout);
  T* g = static_cast<T*>(dqkv);
  packed_attention_bwd_dq_kernel<T><<<grid, kBwdThreads, smem, stream>>>(
      q, o, g, stats, N, C, heads, d, ts, hs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  packed_attention_bwd_dkv_kernel<T><<<grid, kBwdThreads, smem, stream>>>(
      q, o, g, stats, N, C, heads, d, ts, hs, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes shared with ops/kernels/attention.py: 0 = float32, 1 = bfloat16.

extern "C" long long packed_attention_smem_bytes(int N, int d, int dtype) {
  if (dtype == 0) return static_cast<long long>(smem_bytes<float>(N, d));
  if (dtype == 1) return static_cast<long long>(smem_bytes<__nv_bfloat16>(N, d));
  return -1;
}

extern "C" int packed_attention_max_smem(int device, int* bytes) {
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                device);
}

namespace {

int attention_fwd(const void* q, const void* k, const void* v, Strides st, void* out,
                  int B, int N, int C, int heads, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = C / heads;
  if (dtype == 0) return launch<float>(q, k, v, st, out, B, N, C, heads, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, st, out, B, N, C, heads, s);
  return cudaErrorInvalidValue;
}

size_t element_size(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// K1: q, k and v are column slices of the packed (B, N, 3C) qkv, in the
// qkv-major layout ([q | k | v], heads within each) or, with head_major, in
// the head-major one ([h0 (q | k | v) | h1 (q | k | v) | ...]); only the
// head stride and the k and v offsets differ.
extern "C" int packed_attention_fwd(const void* qkv, void* out, int B, int N,
                                    int C, int heads, int head_major, int dtype, int device,
                                    void* stream) {
  const auto* base = static_cast<const unsigned char*>(qkv);
  const size_t row = 3 * static_cast<size_t>(C);
  const size_t d = static_cast<size_t>(C / heads);
  const Strides st{N * row, row, head_major ? 3 * d : d};
  const size_t col = (head_major ? d : static_cast<size_t>(C)) * element_size(dtype);
  return attention_fwd(base, base + col, base + 2 * col, st, out, B, N, C, heads, dtype,
                       device, stream);
}

// Kernel K6: the same forward from three (B, N, heads, d) views that share
// the element strides (batch, row, head) and have unit stride along d;
// replaces `_attn_kernel` (attention_kernel.py), which JAX feeds through
// transposes to (B * heads, N, d). The context is written as (B, N, C).
extern "C" int flat_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                  int B, int N, int heads, int d, long long batch_stride,
                                  long long row_stride, long long head_stride, int dtype,
                                  int device, void* stream) {
  const Strides st{static_cast<size_t>(batch_stride), static_cast<size_t>(row_stride),
                   static_cast<size_t>(head_stride)};
  return attention_fwd(q, k, v, st, out, B, N, heads * d, heads, dtype, device, stream);
}

// Shared memory of the backward's passes (both the same).
extern "C" long long packed_attention_bwd_smem_bytes(int N, int d, int dtype) {
  if (dtype == 0) return static_cast<long long>(bwd_smem_bytes<float>(N, d));
  if (dtype == 1) return static_cast<long long>(bwd_smem_bytes<__nv_bfloat16>(N, d));
  return -1;
}

// qkv (B, N, 3C) and dout (B, N, C) in -> dqkv (B, N, 3C) out, all of one
// dtype, qkv and dqkv in one layout (head_major as in packed_attention_fwd);
// stats is (3, B, heads, N) float32 scratch.
extern "C" int packed_attention_bwd(const void* qkv, const void* dout, void* dqkv,
                                    void* stats, int B, int N, int C, int heads,
                                    int head_major, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  const int d = C / heads;
  if (dtype == 0)
    return launch_bwd<float>(qkv, dout, dqkv, st, B, N, C, heads, head_major, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(qkv, dout, dqkv, st, B, N, C, heads, head_major, s);
  return cudaErrorInvalidValue;
}
