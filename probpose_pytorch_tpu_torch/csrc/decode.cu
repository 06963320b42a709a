// Kernel K3: fused expected-value decode of (B, K, H, W) float32 heatmaps.
//
// Replaces the TPU kernel `_decode_kernel` (probpose_pytorch_tpu/ops/pallas/
// decode_kernel.py, through `_decode_pallas`; public
// `expected_value_decode_pallas`). The JAX package keeps it for heatmaps
// larger than its default decode was tuned for; no JAX path calls it.
//
// What it computes, per (b, k) map, as ops/heatmap.py:expected_value_decode:
//   conv = row_op[k] . hm . col_op[k]^T   (separable reflect OKS convolution)
//   (yi, xi) = first-occurrence argmax of conv in row-major order
//   strictly inside the border: x = xi - dx / dxx, y = yi - dy / dyy from
//   central differences of conv (dxx or dyy of 0 replaced by 1e-6); on the
//   border the integer location
//   value = hm[yi, xi], the raw heatmap at the integer argmax
// and writes only (x, y) and value: the convolved map never reaches device
// memory.
//
// What bounds it on an H100: the two dense products, 2 H W (H + W) FLOP per
// map (~28 MFLOP at 192 x 192) against reading the map once (147 KB): ~190
// FLOP per byte in float32, above the CUDA cores' ~20 FLOP/byte ridge, so it
// is bound by operations. The products run in full float32 on the CUDA cores
// (fmaf), never TF32: the TPU kernel's default-precision products moved
// keypoints by 0.0229 px.
//
// Design: one block of 256 threads per map. Phase 1 forms t = hm . col_op^T
// into shared memory (147 KB at 192 x 192), in 64 x 64 output tiles of which
// each thread holds 4 x 4, with the operands staged 16 deep. Phase 2 forms
// conv = row_op . t in the same tiles, streaming row_op's rows from L2 (every
// map of keypoint k shares them), and keeps a running first-occurrence
// argmax; no tile of conv is stored. Phase 3 reduces the argmax over the
// block and recomputes conv at the winner and its four neighbours with the
// same fmaf order as phase 2, so those values carry the same bits.
//
// Plain-C interface, loaded with ctypes (ops/kernels/decode.py). Every entry
// point returns a cudaError_t as int (0 = success).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;        // output tile edge
constexpr int kDepth = 16;    // depth of one staged operand step
constexpr int kStage = kT + 4;  // row stride of the staged operands

__host__ __device__ inline int round64(int n) { return (n + kT - 1) / kT * kT; }

size_t smem_bytes(int H, int W) {
  return (static_cast<size_t>(round64(H)) * round64(W) + 2 * kDepth * kStage) * sizeof(float);
}

// One 4 x 4 block of a 64 x 64 output tile: acc[i][j] += sum over kDepth of
// a[kk][ty*4 + i] * b[kk][tx*4 + j], a and b staged with row stride sa, sb.
__device__ __forceinline__ void tile_step(float (&acc)[4][4], const float* a, int sa,
                                          const float* b, int sb, int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < kDepth; ++kk) {
    const float4 av = *reinterpret_cast<const float4*>(a + kk * sa + ty * 4);
    const float4 bv = *reinterpret_cast<const float4*>(b + kk * sb + tx * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// conv[h][w] = sum_g row[h][g] t[g][w], in phase 2's order.
__device__ __forceinline__ float conv_at(const float* row, const float* t_s, int Wp, int H,
                                         int h, int w) {
  float acc = 0.f;
  for (int g = 0; g < H; ++g) acc = fmaf(row[h * H + g], t_s[g * Wp + w], acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    decode_kernel(const float* __restrict__ hm, const float* __restrict__ row_op,
                  const float* __restrict__ col_op, float* __restrict__ locs,
                  float* __restrict__ vals, int K, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  const int Hp = round64(H);
  const int Wp = round64(W);
  float* t_s = smem;                   // (Hp, Wp): hm . col_op^T
  float* a_s = t_s + Hp * Wp;          // (kDepth, kStage)
  float* b_s = a_s + kDepth * kStage;  // (kDepth, kStage)
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ float nb[5];

  const int map = blockIdx.x;
  const int k = map % K;
  const float* x = hm + static_cast<size_t>(map) * H * W;
  const float* row = row_op + static_cast<size_t>(k) * H * H;
  const float* col = col_op + static_cast<size_t>(k) * W * W;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  // Phase 1: t[g][w] = sum_v x[g][v] col[w][v]; rows g >= H and columns
  // w >= W come out 0.
  for (int g0 = 0; g0 < Hp; g0 += kT) {
    for (int w0 = 0; w0 < Wp; w0 += kT) {
      float acc[4][4] = {};
      for (int v0 = 0; v0 < W; v0 += kDepth) {
        __syncthreads();
        for (int i = tid; i < kDepth * kT; i += kThreads) {
          const int r = i / kDepth;
          const int kk = i - r * kDepth;
          const int v = v0 + kk;
          a_s[kk * kStage + r] = (g0 + r < H && v < W) ? x[(g0 + r) * W + v] : 0.f;
          b_s[kk * kStage + r] = (w0 + r < W && v < W) ? col[(w0 + r) * W + v] : 0.f;
        }
        __syncthreads();
        tile_step(acc, a_s, kStage, b_s, kStage, ty, tx);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) t_s[(g0 + ty * 4 + i) * Wp + w0 + tx * 4 + j] = acc[i][j];
    }
  }
  __syncthreads();

  // Phase 2: conv = row . t tile by tile, with a running first-occurrence
  // argmax (the larger value, or the smaller row-major index on a tie).
  float best = -INFINITY;
  int best_idx = INT_MAX;
  for (int h0 = 0; h0 < H; h0 += kT) {
    for (int w0 = 0; w0 < W; w0 += kT) {
      float acc[4][4] = {};
      for (int g0 = 0; g0 < H; g0 += kDepth) {
        __syncthreads();
        for (int i = tid; i < kDepth * kT; i += kThreads) {
          const int r = i / kDepth;
          const int kk = i - r * kDepth;
          const int g = g0 + kk;
          a_s[kk * kStage + r] = (h0 + r < H && g < H) ? row[(h0 + r) * H + g] : 0.f;
        }
        __syncthreads();
        tile_step(acc, a_s, kStage, t_s + g0 * Wp + w0, Wp, ty, tx);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int h = h0 + ty * 4 + i;
          const int w = w0 + tx * 4 + j;
          if (h < H && w < W) {
            const int idx = h * W + w;
            const float v = acc[i][j];
            if (v > best || (v == best && idx < best_idx)) {
              best = v;
              best_idx = idx;
            }
          }
        }
      }
    }
  }

  // Phase 3: the block's argmax, then the sub-pixel step at the winner.
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, best, o);
    const int i = __shfl_xor_sync(0xffffffffu, best_idx, o);
    if (v > best || (v == best && i < best_idx)) {
      best = v;
      best_idx = i;
    }
  }
  if (tid % 32 == 0) {
    red_v[tid / 32] = best;
    red_i[tid / 32] = best_idx;
  }
  __syncthreads();
  if (tid >= 32) return;
  best = tid < kThreads / 32 ? red_v[tid] : -INFINITY;
  best_idx = tid < kThreads / 32 ? red_i[tid] : INT_MAX;
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, best, o);
    const int i = __shfl_xor_sync(0xffffffffu, best_idx, o);
    if (v > best || (v == best && i < best_idx)) {
      best = v;
      best_idx = i;
    }
  }
  if (best_idx == INT_MAX) best_idx = 0;  // no comparable value (all NaN)
  const int yi = best_idx / W;
  const int xi = best_idx - yi * W;
  const bool valid = xi > 0 && xi < W - 1 && yi > 0 && yi < H - 1;
  if (valid && tid < 5) {
    // c, right, left, down, up
    const int dy[5] = {0, 0, 0, 1, -1};
    const int dx[5] = {0, 1, -1, 0, 0};
    nb[tid] = conv_at(row, t_s, Wp, H, yi + dy[tid], xi + dx[tid]);
  }
  __syncwarp();
  if (tid != 0) return;
  float px = static_cast<float>(xi);
  float py = static_cast<float>(yi);
  if (valid) {
    const float c = nb[0], right = nb[1], left = nb[2], down = nb[3], up = nb[4];
    const float gx = (right - left) / 2.f;
    const float gy = (down - up) / 2.f;
    float gxx = right + left - 2.f * c;
    float gyy = down + up - 2.f * c;
    gxx = gxx != 0.f ? gxx : 1e-6f;
    gyy = gyy != 0.f ? gyy : 1e-6f;
    px = px - gx / gxx;
    py = py - gy / gyy;
  }
  locs[2 * static_cast<size_t>(map)] = px;
  locs[2 * static_cast<size_t>(map) + 1] = py;
  vals[map] = x[yi * W + xi];
}

}  // namespace

// Shared memory of one block at (H, W), the kernel's few static words
// included; the wrapper holds it to the card's opt-in limit.
extern "C" long long decode_smem_bytes(int H, int W) {
  return static_cast<long long>(smem_bytes(H, W)) + 128;
}

// heatmaps (B, K, H, W), row_op (K, H, H), col_op (K, W, W), float32 in;
// locs (B, K, 2) and vals (B, K), float32, out.
extern "C" int expected_value_decode_fwd(const void* heatmaps, const void* row_op,
                                         const void* col_op, void* locs, void* vals, int B,
                                         int K, int H, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(H, W);
  err = cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  decode_kernel<<<B * K, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(heatmaps), static_cast<const float*>(row_op),
      static_cast<const float*>(col_op), static_cast<float*>(locs), static_cast<float*>(vals),
      K, H, W);
  return cudaGetLastError();
}
