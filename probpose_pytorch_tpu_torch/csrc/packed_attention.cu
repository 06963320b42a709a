// Kernel K1: multi-head attention read straight from the packed qkv, its
// forward here and its recompute backward further down ("backward").
// Kernel K6 (`flat_attention_fwd` at the end) is the same forward body read
// from three (B, N, heads, d) views through their strides instead.
//
// Replaces the TPU kernels `_packed_fwd_kernel` and `_packed_bwd_kernel`
// (probpose_pytorch_tpu/ops/pallas/attention_kernel.py, called from
// `_packed_fwd` / `_packed_bwd` under the custom_vjp `packed_attention`).
//
// What it computes, per (batch b, head h):
//   ctx[b, :, h*d:(h+1)*d] = round_T(softmax_f32(q k^T * scale)) v
// where q, k and v are column slices of the (B, N, 3C) projection in the
// qkv-major order `Dense(3C)` + `reshape(B, N, 3, H, d)` gives: q at column
// h*d, k at C + h*d, v at 2C + h*d. Scores and softmax are f32; the scale is
// applied after the q.k product and P is rounded to the input type before
// P.V, as the TPU kernel does. The context is written h-major into (B, N, C):
// no (B, H, N, N) matrix and no transpose ever reaches device memory.
//
// What bounds it on an H100: at ViT-S serving shapes (N = 192, d = 64) the
// work is 2 * 2 * N * N * d = 9.4 MFLOP per (b, h) against 3 * N * d * 2 bytes
// read and N * d * 2 written (bf16): ~100 FLOP per byte, under the card's
// ~295 FLOP/byte bf16 tensor-core ridge, so with the products on the tensor
// cores the kernel is bound by moving qkv in and the context out; on the CUDA
// cores it is bound by its own shared-memory loads and FMAs.
//
// Two paths, one contract:
//  * bf16, d in {32, 64, 128}, N <= 256 (the ViT trunks): tensor cores via
//    WMMA (mma.sync 16x16x16 bf16 -> f32). One block of 4 warps per (64
//    query rows, head, batch) stages K_h, V_h and its Q rows in shared
//    memory with 16-byte copies (keys zero-padded to a multiple of 16).
//    Each warp owns 16 query rows: S = Q K^T lands in shared memory as f32,
//    the row softmax runs in f32 registers, P is rounded to bf16 and written
//    over its own row of S, and O = P V accumulates in f32 fragments. At
//    N = 192, d = 64 a block uses 112 KB, so two blocks share an SM.
//  * everything else (f32 inputs, other d or N): CUDA cores. One block of 8
//    warps per (64 query rows, head, batch) stages K_h and V_h; each warp
//    takes one query row at a time, lanes splitting the keys for q.k and the
//    softmax and the d columns for P.V. K rows are padded by one 32-bit word
//    so the lanes' strided reads hit distinct banks. Its f32 sums run in the
//    same order as cuBLAS's and PyTorch's softmax, which the f32 checks show.
// Either way the shared memory exceeds the 48 KB static limit, hence the
// opt-in attribute. Later versions should use wgmma and keep K/V resident
// across query tiles.
//
// Plain-C interface, loaded with ctypes (ops/kernels/attention.py). Every
// entry point returns a cudaError_t as int (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

namespace wmma = nvcuda::wmma;

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

// ---------------------------------------------------- tensor-core path (bf16)

constexpr int kMmaWarps = 4;
constexpr int kMmaRows = kMmaWarps * 16;  // query rows per block
constexpr int kMaxKeyChunks = 8;          // keys per lane in the softmax
constexpr int kMmaMaxN = 32 * kMaxKeyChunks;

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// f32 row stride of a warp's score tile, which later holds its (16, d)
// output tile too.
__host__ __device__ constexpr int score_stride(int np, int d) {
  return (np > d ? np : d) + 4;
}

// Shared memory of the tensor-core path: K, V (np rows) and Q (64 rows) in
// bf16 with row stride d + 8; per warp 16 score rows.
size_t mma_smem_bytes(int N, int d) {
  const int np = round16(N);
  return static_cast<size_t>(2 * np + kMmaRows) * (d + 8) * sizeof(__nv_bfloat16) +
         static_cast<size_t>(kMmaWarps) * 16 * score_stride(np, d) * sizeof(float);
}

bool mma_path(int N, int d, int dtype) {
  return dtype == 1 && (d == 32 || d == 64 || d == 128) && N <= kMmaMaxN;
}

template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
    packed_attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                    const __nv_bfloat16* __restrict__ k,
                                    const __nv_bfloat16* __restrict__ v,
                                    Strides st, __nv_bfloat16* __restrict__ out,
                                    int N, int C, float scale) {
  constexpr int ks = D + 8;  // bf16 row stride of K, V, Q tiles
  constexpr int vec = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  const int np = round16(N);
  const int ss = score_stride(np, D);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + np * ks;
  __nv_bfloat16* q_s = v_s + np * ks;
  float* s_all = reinterpret_cast<float*>(q_s + kMmaRows * ks);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * kMmaRows;
  const size_t off = b * st.batch + h * st.head;
  const __nv_bfloat16* qb = q + off;
  const __nv_bfloat16* kb = k + off;
  const __nv_bfloat16* vb = v + off;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = threadIdx.x; i < np * vec; i += blockDim.x) {
    const int j = i / vec;
    const int c = (i - j * vec) * 8;
    uint4 kv = zero, vv = zero;
    if (j < N) {
      kv = *reinterpret_cast<const uint4*>(kb + j * st.row + c);
      vv = *reinterpret_cast<const uint4*>(vb + j * st.row + c);
    }
    *reinterpret_cast<uint4*>(k_s + j * ks + c) = kv;
    *reinterpret_cast<uint4*>(v_s + j * ks + c) = vv;
  }
  for (int i = threadIdx.x; i < kMmaRows * vec; i += blockDim.x) {
    const int r = i / vec;
    const int c = (i - r * vec) * 8;
    uint4 qv = zero;
    if (row0 + r < N)
      qv = *reinterpret_cast<const uint4*>(qb + (row0 + r) * st.row + c);
    *reinterpret_cast<uint4*>(q_s + r * ks + c) = qv;
  }
  __syncthreads();

  const int r0 = warp * 16;
  if (row0 + r0 >= N) return;  // no block-wide barrier follows
  float* s_w = s_all + warp * 16 * ss;
  __nv_bfloat16* p_w = reinterpret_cast<__nv_bfloat16*>(s_w);
  const int ps = 2 * ss;  // P row i lives in the first half of S row i

  // S = Q K^T, f32 accumulation.
  for (int n = 0; n < np; n += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int k = 0; k < D; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kt;
      wmma::load_matrix_sync(a, q_s + r0 * ks + k, ks);
      wmma::load_matrix_sync(kt, k_s + n * ks + k, ks);
      wmma::mma_sync(acc, a, kt, acc);
    }
    wmma::store_matrix_sync(s_w + n, acc, ss, wmma::mem_row_major);
  }
  __syncwarp();

  // Row softmax in f32; P = round_bf16(e / sum), zero on padded keys.
  for (int i = 0; i < 16; ++i) {
    float e[kMaxKeyChunks];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      const int j = lane + 32 * t;
      e[t] = j < N ? s_w[i * ss + j] * scale : -INFINITY;
      m = fmaxf(m, e[t]);
    }
    m = warp_max(m);
    float l = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      e[t] = lane + 32 * t < N ? expf(e[t] - m) : 0.f;
      l += e[t];
    }
    l = warp_sum(l);
    __syncwarp();  // all of row i is read before any lane overwrites it
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      const int j = lane + 32 * t;
      if (j < np) p_w[i * ps + j] = __float2bfloat16_rn(e[t] / l);
    }
  }
  __syncwarp();

  // O = P V, f32 accumulation, all D/16 column tiles held in registers.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[D / 16];
#pragma unroll
  for (int c = 0; c < D / 16; ++c) wmma::fill_fragment(o[c], 0.f);
  for (int k = 0; k < np; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, p_w + k, ps);
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> v;
      wmma::load_matrix_sync(v, v_s + k * ks + c * 16, ks);
      wmma::mma_sync(o[c], a, v, o[c]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < D / 16; ++c)
    wmma::store_matrix_sync(s_w + c * 16, o[c], ss, wmma::mem_row_major);
  __syncwarp();
  for (int idx = lane; idx < 16 * D; idx += 32) {
    const int i = idx / D;
    const int c = idx - i * D;
    const int n = row0 + r0 + i;
    if (n < N)
      out[(static_cast<size_t>(b) * N + n) * C + h * D + c] =
          __float2bfloat16_rn(s_w[i * ss + c]);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, Strides st, void* out,
               int B, int N, int C, int heads, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(N, D);
  cudaError_t err = cudaFuncSetAttribute(
      packed_attention_fwd_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kMmaRows - 1) / kMmaRows, heads, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  using T = __nv_bfloat16;
  packed_attention_fwd_mma_kernel<D><<<grid, kMmaWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), st,
      static_cast<T*>(out), N, C, scale);
  return cudaGetLastError();
}

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
// (b, h) (pass 1: S, dP, dQ; pass 2: S, dP plus dV and dK) against reading
// qkv and dO once each per tile; at N = 192, d = 64 that is ~100 FLOP per
// byte, under the bf16 ridge, so with the products on the tensor cores the
// passes are bound by staging q, k, v and dO, and by the softmax between the
// products. Both bf16 passes keep two f32 16 x N tiles per warp (S and dP)
// in shared memory: ~175 KB a block at N = 192, d = 64, one block per SM.
// Later versions should keep K/V resident across query tiles with wgmma.

constexpr int kMaxSmemOptin = 232448;  // H100: 227 KB per block

// Pass 1, tensor cores: K, V (np rows), Q and dO (64 rows) in bf16; per warp
// two f32 tiles of 16 rows (scores, then dP / dS).
size_t mma_bwd_dq_smem_bytes(int N, int d) {
  const int np = round16(N);
  return static_cast<size_t>(2 * np + 2 * kMmaRows) * (d + 8) * sizeof(__nv_bfloat16) +
         static_cast<size_t>(2 * kMmaWarps) * 16 * score_stride(np, d) * sizeof(float);
}

// Pass 2, tensor cores: Q and dO (np rows), K and V (64 rows) in bf16; the
// (m, l, D) of every query row; per warp two f32 tiles of 16 key rows.
size_t mma_bwd_dkv_smem_bytes(int N, int d) {
  const int np = round16(N);
  return static_cast<size_t>(2 * np + 2 * kMmaRows) * (d + 8) * sizeof(__nv_bfloat16) +
         static_cast<size_t>(3 * np) * sizeof(float) +
         static_cast<size_t>(2 * kMmaWarps) * 16 * score_stride(np, d) * sizeof(float);
}

bool mma_bwd_path(int N, int d, int dtype) {
  return mma_path(N, d, dtype) &&
         mma_bwd_dq_smem_bytes(N, d) <= static_cast<size_t>(kMaxSmemOptin) &&
         mma_bwd_dkv_smem_bytes(N, d) <= static_cast<size_t>(kMaxSmemOptin);
}

// Stage `rows` rows of a (., N, row_stride) tensor's d-column slice at
// `col` into shared memory with row stride ks, zero past row N.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int row0, int rows, int N,
                                           size_t row_stride, int col) {
  constexpr int ks = D + 8;
  constexpr int vec = D / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < rows * vec; i += blockDim.x) {
    const int r = i / vec;
    const int c = (i - r * vec) * 8;
    uint4 v = zero;
    if (row0 + r < N)
      v = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + col + c);
    *reinterpret_cast<uint4*>(dst + r * ks + c) = v;
  }
}

// (16, np) x (np, D) product of a bf16 row tile `a` (row stride lda) with a
// staged bf16 matrix `b` (row stride D + 8), written as f32 into `out`
// (row stride ldo) and then as bf16 into rows n0.. of `dst` (row stride C3)
// at column `col`, rows past N left out.
template <int D>
__device__ __forceinline__ void tile_product_out(const __nv_bfloat16* a, int lda,
                                                 const __nv_bfloat16* b, int np,
                                                 float* out, int ldo,
                                                 __nv_bfloat16* dst, int n0, int N,
                                                 size_t C3, int col) {
  constexpr int ks = D + 8;
  const int lane = threadIdx.x % 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int c = 0; c < D / 16; ++c) wmma::fill_fragment(acc[c], 0.f);
  for (int k = 0; k < np; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + k, lda);
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + k * ks + c * 16, ks);
      wmma::mma_sync(acc[c], fa, fb, acc[c]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < D / 16; ++c)
    wmma::store_matrix_sync(out + c * 16, acc[c], ldo, wmma::mem_row_major);
  __syncwarp();
  for (int idx = lane; idx < 16 * D; idx += 32) {
    const int i = idx / D;
    const int c = idx - i * D;
    if (n0 + i < N)
      dst[(n0 + i) * C3 + col + c] = __float2bfloat16_rn(out[i * ldo + c]);
  }
  __syncwarp();
}

// (16, np) f32 tile out[i][j] = sum_c a[i][c] * b[j][c] over the staged bf16
// row tiles a (16 rows) and b (np rows), both with row stride D + 8.
template <int D>
__device__ __forceinline__ void tile_abt(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                         int np, float* out, int ldo) {
  constexpr int ks = D + 8;
  for (int n = 0; n < np; n += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int k = 0; k < D; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + k, ks);
      wmma::load_matrix_sync(fb, b + n * ks + k, ks);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + n, acc, ldo, wmma::mem_row_major);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
    packed_attention_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                                       const __nv_bfloat16* __restrict__ dout,
                                       __nv_bfloat16* __restrict__ dqkv,
                                       float* __restrict__ stats, int N, int C,
                                       int H, float scale) {
  constexpr int ks = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int np = round16(N);
  const int ss = score_stride(np, D);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + np * ks;
  __nv_bfloat16* q_s = v_s + np * ks;
  __nv_bfloat16* o_s = q_s + kMmaRows * ks;
  float* f_all = reinterpret_cast<float*>(o_s + kMmaRows * ks);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * kMmaRows;
  const size_t C3 = 3 * static_cast<size_t>(C);
  const __nv_bfloat16* base = qkv + static_cast<size_t>(b) * N * C3;
  const __nv_bfloat16* obase = dout + static_cast<size_t>(b) * N * C;
  __nv_bfloat16* gbase = dqkv + static_cast<size_t>(b) * N * C3;

  stage_rows<D>(k_s, base, 0, np, N, C3, C + h * D);
  stage_rows<D>(v_s, base, 0, np, N, C3, 2 * C + h * D);
  stage_rows<D>(q_s, base, row0, kMmaRows, N, C3, h * D);
  stage_rows<D>(o_s, obase, row0, kMmaRows, N, C, h * D);
  __syncthreads();

  const int r0 = warp * 16;
  if (row0 + r0 >= N) return;  // no block-wide barrier follows
  float* s_w = f_all + warp * 2 * 16 * ss;
  float* dp_w = s_w + 16 * ss;
  __nv_bfloat16* ds_w = reinterpret_cast<__nv_bfloat16*>(dp_w);
  const int ps = 2 * ss;  // dS row i lives in the first half of dP row i

  tile_abt<D>(q_s + r0 * ks, k_s, np, s_w, ss);   // S = Q K^T
  tile_abt<D>(o_s + r0 * ks, v_s, np, dp_w, ss);  // dP = dO V^T
  __syncwarp();

  float* st = stats + (static_cast<size_t>(b) * H + h) * N;
  const size_t plane = static_cast<size_t>(gridDim.z) * H * N;
  for (int i = 0; i < 16; ++i) {
    float e[kMaxKeyChunks], dp[kMaxKeyChunks];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      const int j = lane + 32 * t;
      e[t] = j < N ? s_w[i * ss + j] * scale : -INFINITY;
      dp[t] = j < np ? dp_w[i * ss + j] : 0.f;
      m = fmaxf(m, e[t]);
    }
    m = warp_max(m);
    float l = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      e[t] = lane + 32 * t < N ? expf(e[t] - m) : 0.f;
      l += e[t];
    }
    l = warp_sum(l);
    float dsum = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      e[t] = e[t] / l;  // P in f32, as the forward computes it
      dsum += dp[t] * e[t];
    }
    dsum = warp_sum(dsum);
    __syncwarp();  // all of dP row i is read before any lane overwrites it
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      const int j = lane + 32 * t;
      if (j < np) ds_w[i * ps + j] = __float2bfloat16_rn(e[t] * (dp[t] - dsum) * scale);
    }
    const int n = row0 + r0 + i;
    if (lane == 0 && n < N) {
      st[n] = m;
      st[plane + n] = l;
      st[2 * plane + n] = dsum;
    }
  }
  __syncwarp();

  // dQ = dS K, staged as f32 in the score tile, stored at q's columns.
  tile_product_out<D>(ds_w, ps, k_s, np, s_w, ss, gbase, row0 + r0, N, C3, h * D);
}

template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
    packed_attention_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                                        const __nv_bfloat16* __restrict__ dout,
                                        __nv_bfloat16* __restrict__ dqkv,
                                        const float* __restrict__ stats, int N,
                                        int C, int H, float scale) {
  constexpr int ks = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int np = round16(N);
  const int ss = score_stride(np, D);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* o_s = q_s + np * ks;
  __nv_bfloat16* k_s = o_s + np * ks;
  __nv_bfloat16* v_s = k_s + kMmaRows * ks;
  float* m_s = reinterpret_cast<float*>(v_s + kMmaRows * ks);
  float* l_s = m_s + np;
  float* d_s = l_s + np;
  float* f_all = d_s + np;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * kMmaRows;
  const size_t C3 = 3 * static_cast<size_t>(C);
  const __nv_bfloat16* base = qkv + static_cast<size_t>(b) * N * C3;
  const __nv_bfloat16* obase = dout + static_cast<size_t>(b) * N * C;
  __nv_bfloat16* gbase = dqkv + static_cast<size_t>(b) * N * C3;

  stage_rows<D>(q_s, base, 0, np, N, C3, h * D);
  stage_rows<D>(o_s, obase, 0, np, N, C, h * D);
  stage_rows<D>(k_s, base, row0, kMmaRows, N, C3, C + h * D);
  stage_rows<D>(v_s, base, row0, kMmaRows, N, C3, 2 * C + h * D);
  const float* st = stats + (static_cast<size_t>(b) * H + h) * N;
  const size_t plane = static_cast<size_t>(gridDim.z) * H * N;
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    m_s[i] = i < N ? st[i] : 0.f;
    l_s[i] = i < N ? st[plane + i] : 1.f;
    d_s[i] = i < N ? st[2 * plane + i] : 0.f;
  }
  __syncthreads();

  const int j0 = warp * 16;
  if (row0 + j0 >= N) return;  // no block-wide barrier follows
  float* a_w = f_all + warp * 2 * 16 * ss;  // S^T, then bf16 P^T, then dV / dK
  float* b_w = a_w + 16 * ss;               // dP^T, then bf16 dS^T
  __nv_bfloat16* pb_w = reinterpret_cast<__nv_bfloat16*>(a_w);
  __nv_bfloat16* ds_w = reinterpret_cast<__nv_bfloat16*>(b_w);
  const int ps = 2 * ss;

  tile_abt<D>(k_s + j0 * ks, q_s, np, a_w, ss);  // S^T = K Q^T
  tile_abt<D>(v_s + j0 * ks, o_s, np, b_w, ss);  // dP^T = V dO^T
  __syncwarp();

  for (int jj = 0; jj < 16; ++jj) {
    float p[kMaxKeyChunks], ds[kMaxKeyChunks];
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      const int i = lane + 32 * t;
      p[t] = 0.f;
      ds[t] = 0.f;
      if (i < N) {
        p[t] = expf(a_w[jj * ss + i] * scale - m_s[i]) / l_s[i];
        ds[t] = p[t] * (b_w[jj * ss + i] - d_s[i]) * scale;
      }
    }
    __syncwarp();  // row jj of both tiles is read before it is overwritten
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      const int i = lane + 32 * t;
      if (i < np) {
        pb_w[jj * ps + i] = __float2bfloat16_rn(p[t]);
        ds_w[jj * ps + i] = __float2bfloat16_rn(ds[t]);
      }
    }
  }
  __syncwarp();

  // dV = round(P)^T dO and dK = dS^T Q, each staged as f32 in a_w.
  tile_product_out<D>(pb_w, ps, o_s, np, a_w, ss, gbase, row0 + j0, N, C3,
                      2 * C + h * D);
  tile_product_out<D>(ds_w, ps, q_s, np, a_w, ss, gbase, row0 + j0, N, C3,
                      C + h * D);
}

template <int D>
int launch_bwd_mma(const void* qkv, const void* dout, void* dqkv, float* stats,
                   int B, int N, int C, int heads, cudaStream_t stream) {
  const size_t smem1 = mma_bwd_dq_smem_bytes(N, D);
  const size_t smem2 = mma_bwd_dkv_smem_bytes(N, D);
  cudaError_t err = cudaFuncSetAttribute(
      packed_attention_bwd_dq_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(packed_attention_bwd_dkv_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kMmaRows - 1) / kMmaRows, heads, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* o = static_cast<const __nv_bfloat16*>(dout);
  auto* g = static_cast<__nv_bfloat16*>(dqkv);
  packed_attention_bwd_dq_mma_kernel<D><<<grid, kMmaWarps * 32, smem1, stream>>>(
      q, o, g, stats, N, C, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  packed_attention_bwd_dkv_mma_kernel<D><<<grid, kMmaWarps * 32, smem2, stream>>>(
      q, o, g, stats, N, C, heads, scale);
  return cudaGetLastError();
}

// CUDA-core passes (f32, and bf16 shapes the tensor-core passes do not
// take). Four warps, each taking one row at a time, lanes splitting the N
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
                                   int N, int C, int H, int d, float scale) {
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
    k_s[j * ks + c] = row[C + h * d + c];
    v_s[j * d + c] = row[2 * C + h * d + c];
  }
  __syncthreads();

  float* st = stats + (static_cast<size_t>(b) * H + h) * N;
  const size_t plane = static_cast<size_t>(gridDim.z) * H * N;
  const int row0 = static_cast<int>(blockIdx.x) * kRowsPerBlock;
  const int row_end = min(row0 + kRowsPerBlock, N);
  for (int n = row0 + warp; n < row_end; n += kBwdWarps) {
    for (int c = lane; c < d; c += 32) {
      q_w[c] = to_float(base[n * C3 + h * d + c]);
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
      gbase[n * C3 + h * d + c] = from_float<T>(acc);
    }
    __syncwarp();
  }
}

// Pass 2: one key row per warp; Q_h rows (padded stride) and dO_h rows.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    packed_attention_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                                    T* __restrict__ dqkv, const float* __restrict__ stats,
                                    int N, int C, int H, int d, float scale) {
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
    q_s[j * ks + c] = base[j * C3 + h * d + c];
    o_s[j * d + c] = obase[j * C + h * d + c];
  }
  __syncthreads();

  const float* st = stats + (static_cast<size_t>(b) * H + h) * N;
  const size_t plane = static_cast<size_t>(gridDim.z) * H * N;
  const int row0 = static_cast<int>(blockIdx.x) * kRowsPerBlock;
  const int row_end = min(row0 + kRowsPerBlock, N);
  for (int j = row0 + warp; j < row_end; j += kBwdWarps) {
    for (int c = lane; c < d; c += 32) {
      k_w[c] = to_float(base[j * C3 + C + h * d + c]);
      v_w[c] = to_float(base[j * C3 + 2 * C + h * d + c]);
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
      gbase[j * C3 + C + h * d + c] = from_float<T>(dk);
      gbase[j * C3 + 2 * C + h * d + c] = from_float<T>(dv);
    }
    __syncwarp();
  }
}

template <typename T>
int launch_bwd(const void* qkv, const void* dout, void* dqkv, float* stats, int B,
               int N, int C, int heads, cudaStream_t stream) {
  const int d = C / heads;
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
      q, o, g, stats, N, C, heads, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  packed_attention_bwd_dkv_kernel<T><<<grid, kBwdThreads, smem, stream>>>(
      q, o, g, stats, N, C, heads, d, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes shared with ops/kernels/attention.py: 0 = float32, 1 = bfloat16.

// 1 when (N, d, dtype) runs on the tensor-core path, 0 on the CUDA-core path.
extern "C" int packed_attention_uses_mma(int N, int d, int dtype) {
  return mma_path(N, d, dtype) ? 1 : 0;
}

extern "C" long long packed_attention_smem_bytes(int N, int d, int dtype) {
  if (mma_path(N, d, dtype)) return static_cast<long long>(mma_smem_bytes(N, d));
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
  if (mma_path(N, d, dtype)) {
    if (d == 32) return launch_mma<32>(q, k, v, st, out, B, N, C, heads, s);
    if (d == 64) return launch_mma<64>(q, k, v, st, out, B, N, C, heads, s);
    return launch_mma<128>(q, k, v, st, out, B, N, C, heads, s);
  }
  if (dtype == 0) return launch<float>(q, k, v, st, out, B, N, C, heads, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, st, out, B, N, C, heads, s);
  return cudaErrorInvalidValue;
}

size_t element_size(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// K1: q, k and v are column slices of the packed (B, N, 3C) qkv.
extern "C" int packed_attention_fwd(const void* qkv, void* out, int B, int N,
                                    int C, int heads, int dtype, int device,
                                    void* stream) {
  const auto* base = static_cast<const unsigned char*>(qkv);
  const size_t row = 3 * static_cast<size_t>(C);
  const Strides st{N * row, row, static_cast<size_t>(C / heads)};
  const size_t col = static_cast<size_t>(C) * element_size(dtype);
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

// Backward: 1 when (N, d, dtype) runs its two passes on the tensor cores.
extern "C" int packed_attention_bwd_uses_mma(int N, int d, int dtype) {
  return mma_bwd_path(N, d, dtype) ? 1 : 0;
}

// Shared memory of the larger of the backward's two passes.
extern "C" long long packed_attention_bwd_smem_bytes(int N, int d, int dtype) {
  if (mma_bwd_path(N, d, dtype)) {
    const size_t a = mma_bwd_dq_smem_bytes(N, d);
    const size_t b = mma_bwd_dkv_smem_bytes(N, d);
    return static_cast<long long>(a > b ? a : b);
  }
  if (dtype == 0) return static_cast<long long>(bwd_smem_bytes<float>(N, d));
  if (dtype == 1) return static_cast<long long>(bwd_smem_bytes<__nv_bfloat16>(N, d));
  return -1;
}

// qkv (B, N, 3C) and dout (B, N, C) in -> dqkv (B, N, 3C) out, all of one
// dtype; stats is (3, B, heads, N) float32 scratch.
extern "C" int packed_attention_bwd(const void* qkv, const void* dout, void* dqkv,
                                    void* stats, int B, int N, int C, int heads,
                                    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  const int d = C / heads;
  if (mma_bwd_path(N, d, dtype)) {
    if (d == 32) return launch_bwd_mma<32>(qkv, dout, dqkv, st, B, N, C, heads, s);
    if (d == 64) return launch_bwd_mma<64>(qkv, dout, dqkv, st, B, N, C, heads, s);
    return launch_bwd_mma<128>(qkv, dout, dqkv, st, B, N, C, heads, s);
  }
  if (dtype == 0) return launch_bwd<float>(qkv, dout, dqkv, st, B, N, C, heads, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(qkv, dout, dqkv, st, B, N, C, heads, s);
  return cudaErrorInvalidValue;
}
