// Kernel K2: row sparsemax of (R, N) float32 logits.
//
// Replaces the TPU kernel `_sparsemax_kernel` (probpose_pytorch_tpu/ops/pallas/
// sparsemax_kernel.py, through `_sparsemax_pallas_2d`; public
// `sparsemax_pallas`).
//
// What it computes, per row z, as ops/kernels/sparsemax.py:sparsemax_reference:
//   zmax = max z; 30 bisection steps on [zmax - 1, zmax] of
//   f(mid) = sum max(z - mid, 0) - 1 (f > 0 raises the low end); the support
//   S = {z > tau_approx} at the last midpoint; tau = zmax + (sum_S (z - zmax)
//   - 1) / max(|S|, 1); out = max(z - tau, 0).
//
// What bounds it on an H100: one read and one write of each element, and a
// few operations a byte: device-memory bytes, when each row is read once.
//
// Design.
//   An exact candidate filter. lo0 = fl(zmax - 1) is the bracket's first low
//   end as rounded, and every later midpoint is >= lo0 (rounding is
//   monotone), so an element z <= lo0 adds exactly 0 to every f(mid) and is
//   never in the support. Each row's candidates z > lo0 are compacted once,
//   in row order (ballots and prefix counts, no atomics), and the 30 steps
//   and the support sums run over them alone; the output pass covers the
//   whole row. Only the order of the sums changes. A row whose candidates
//   overflow the buffer runs the steps over the whole row.
//   With at most kTree candidates one warp takes the steps five at a time:
//   lane j evaluates f at the midpoint of node j of the next five levels'
//   decision tree, with the same arithmetic as one step at a time, and a
//   ballot of the signs picks the path.
//   Rows of up to 3,072 pixels (the flagship's 64 x 48 maps): one warp a row,
//   four rows a block, the row held in registers (float4 loads where
//   aligned, a masked tail otherwise); every reduction is a shuffle.
//   Longer rows: one block of 512 threads a row. Where the row fits shared
//   memory (36,864 pixels, 147 KB, at 768 x 768 crops) it is staged once by
//   cp.async.bulk in kChunks chunks, each on its own mbarrier, so the max
//   starts on the first chunk, and the output is written from shared
//   memory: 8 bytes of device memory an element. Longer rows (65,536 pixels
//   from 1024 x 1024 crops) are read from device memory on each pass: the
//   max, the count, the compaction and the output.
//
// Plain-C interface, loaded with ctypes (ops/kernels/sparsemax.py). Every
// entry point returns a cudaError_t as int (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kIters = 30;
constexpr int kTree = 64;            // candidates up to which the tree runs
constexpr int kWarpRows = 4;         // rows (warps) of a short-row block
constexpr int kWarpCands = 1024;     // a short row's candidate buffer
constexpr int kBlockThreads = 512;
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kBlockCands = 4096;    // a long row's candidate buffer
constexpr int kChunks = 8;           // bulk copies of a staged row
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Five bisection steps of [lo, hi] over candidates c[0 .. n), in one round.
// Node 1 is the next step's midpoint; node j's children 2j (f <= 0: hi
// moves) and 2j + 1 (f > 0: lo moves). Each lane replays its node's path to
// its interval, so its midpoint carries the bits the step would compute.
__device__ __forceinline__ void bisect5(float& lo, float& hi, const float* c, int n, int lane) {
  const int node = lane == 0 ? 1 : lane;
  float l = lo, h = hi;
  for (int b = 30 - __clz(node); b >= 0; --b) {
    const float m = (l + h) * 0.5f;
    if ((node >> b) & 1) l = m;
    else h = m;
  }
  const float mid = (l + h) * 0.5f;
  float acc = 0.f;
  for (int i = 0; i < n; ++i) acc += fmaxf(c[i] - mid, 0.f);
  const unsigned right = __ballot_sync(kFull, acc - 1.0f > 0.f);
  int j = 1;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const float m = (lo + hi) * 0.5f;
    if ((right >> j) & 1u) {
      lo = m;
      j = 2 * j + 1;
    } else {
      hi = m;
      j = 2 * j;
    }
  }
}

// tau of a row from its candidates c[0 .. n) in shared memory, one warp.
__device__ float tau_from_candidates(const float* c, int n, float zmax, int lane) {
  float lo = zmax - 1.0f, hi = zmax;
  if (n <= kTree) {
    for (int r = 0; r < kIters / 5; ++r) bisect5(lo, hi, c, n, lane);
  } else {
    for (int it = 0; it < kIters; ++it) {
      const float mid = (lo + hi) * 0.5f;
      float acc = 0.f;
      for (int i = lane; i < n; i += 32) acc += fmaxf(c[i] - mid, 0.f);
      if (warp_sum(acc) - 1.0f > 0.f) lo = mid;
      else hi = mid;
    }
  }
  const float ta = (lo + hi) * 0.5f;
  float cnt = 0.f, sum = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float v = c[i];
    if (v > ta) {
      cnt += 1.f;
      sum += v - zmax;
    }
  }
  return zmax + (warp_sum(sum) - 1.0f) / fmaxf(warp_sum(cnt), 1.f);
}

// tau of a row held in one warp's registers (lanes past the row hold -inf).
template <int NPL>
__device__ float tau_from_registers(const float (&v)[NPL], float zmax) {
  float lo = zmax - 1.0f, hi = zmax;
  for (int it = 0; it < kIters; ++it) {
    const float mid = (lo + hi) * 0.5f;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) acc += fmaxf(v[i] - mid, 0.f);
    if (warp_sum(acc) - 1.0f > 0.f) lo = mid;
    else hi = mid;
  }
  const float ta = (lo + hi) * 0.5f;
  float cnt = 0.f, sum = 0.f;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    if (v[i] > ta) {
      cnt += 1.f;
      sum += v[i] - zmax;
    }
  }
  return zmax + (warp_sum(sum) - 1.0f) / fmaxf(warp_sum(cnt), 1.f);
}

// One warp a row of N <= 32 NPL pixels, the row in registers. VEC: N % 4 == 0
// and 16-byte aligned rows, lane l holding pixels 4 (32 j + l) + s at
// v[4 j + s]; else pixel 32 j + l at v[j].
template <int NPL, bool VEC>
__global__ void __launch_bounds__(kWarpRows * 32)
    sparsemax_warp_kernel(const float* __restrict__ z, float* __restrict__ out, int R, int N) {
  __shared__ float cands[kWarpRows][kWarpCands];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpRows + warp;
  if (row >= R) return;
  const float* zr = z + row * N;
  float* outr = out + row * N;

  float v[NPL];
  if (VEC) {
#pragma unroll
    for (int j = 0; j < NPL / 4; ++j) {
      const int e = 4 * (32 * j + lane);
      float4 q = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      if (e < N) q = *reinterpret_cast<const float4*>(zr + e);
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int e = 32 * j + lane;
      v[j] = e < N ? zr[e] : -INFINITY;
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < NPL; ++i) m = fmaxf(m, v[i]);
  const float zmax = warp_max(m);
  const float lo0 = zmax - 1.0f;

  // Compaction of the candidates, in row order.
  float* c = cands[warp];
  const unsigned lt = lanemask_lt();
  int n = 0;
  if (VEC) {
#pragma unroll
    for (int j = 0; j < NPL / 4; ++j) {
      bool p[4];
      unsigned b[4];
      int total = 0, pos = n;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        p[s] = v[4 * j + s] > lo0;
        b[s] = __ballot_sync(kFull, p[s]);
        total += __popc(b[s]);
        pos += __popc(b[s] & lt);
      }
      if (total == 0) continue;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (p[s]) {
          if (pos < kWarpCands) c[pos] = v[4 * j + s];
          ++pos;
        }
      }
      n += total;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const bool p = v[j] > lo0;
      const unsigned b = __ballot_sync(kFull, p);
      if (b == 0) continue;
      const int pos = n + __popc(b & lt);
      if (p && pos < kWarpCands) c[pos] = v[j];
      n += __popc(b);
    }
  }
  __syncwarp();
  const float tau =
      n <= kWarpCands ? tau_from_candidates(c, n, zmax, lane) : tau_from_registers(v, zmax);

  if (VEC) {
#pragma unroll
    for (int j = 0; j < NPL / 4; ++j) {
      const int e = 4 * (32 * j + lane);
      if (e < N)
        *reinterpret_cast<float4*>(outr + e) =
            make_float4(fmaxf(v[4 * j] - tau, 0.f), fmaxf(v[4 * j + 1] - tau, 0.f),
                        fmaxf(v[4 * j + 2] - tau, 0.f), fmaxf(v[4 * j + 3] - tau, 0.f));
    }
  } else {
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int e = 32 * j + lane;
      if (e < N) outr[e] = fmaxf(v[j] - tau, 0.f);
    }
  }
}

// Sum and max over the block; the result is the same in every thread.
__device__ __forceinline__ float block_sum(float v, float* red, int warp, int lane) {
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kBlockWarps; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ float block_max(float v, float* red, int warp, int lane) {
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = -INFINITY;
#pragma unroll
  for (int w = 0; w < kBlockWarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

// One block a row. STAGED: the row is copied into shared memory once (by
// bulk copies when VEC: N % 4 == 0 and 16-byte aligned rows); else every
// pass reads it from device memory.
template <bool STAGED, bool VEC>
__global__ void __launch_bounds__(kBlockThreads)
    sparsemax_block_kernel(const float* __restrict__ z, float* __restrict__ out, int N) {
  extern __shared__ __align__(16) float smem[];
  float* cand = smem;                  // kBlockCands
  float* row_s = smem + kBlockCands;   // N, when STAGED
  __shared__ __align__(8) uint64_t bars[kChunks];
  __shared__ float red[kBlockWarps];
  __shared__ int counts[kBlockWarps];
  __shared__ float tau_s;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float* zr = z + static_cast<long long>(blockIdx.x) * N;
  float* outr = out + static_cast<long long>(blockIdx.x) * N;
  const float* src = STAGED ? row_s : zr;

  // The max, over each chunk as it lands.
  float m = -INFINITY;
  if (STAGED && VEC) {
    const int len = ((N + kChunks - 1) / kChunks + 3) / 4 * 4;
    if (tid == 0) {
      for (int c = 0; c < kChunks; ++c) mbar_init(smem_u32(&bars[c]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      for (int c = 0; c < kChunks && c * len < N; ++c) {
        const int lo = c * len;
        const uint32_t bytes = static_cast<uint32_t>(min(N, lo + len) - lo) * 4u;
        mbar_expect_tx(smem_u32(&bars[c]), bytes);
        bulk_copy(smem_u32(row_s + lo), zr + lo, bytes, smem_u32(&bars[c]));
      }
    }
    for (int c = 0; c < kChunks && c * len < N; ++c) {
      const int lo = c * len;
      const int hi = min(N, lo + len);
      mbar_wait(smem_u32(&bars[c]), 0);
      for (int i = lo + 4 * tid; i < hi; i += 4 * kBlockThreads) {
        const float4 q = *reinterpret_cast<const float4*>(row_s + i);
        m = fmaxf(m, fmaxf(fmaxf(q.x, q.y), fmaxf(q.z, q.w)));
      }
    }
  } else if (STAGED) {
    for (int i = tid; i < N; i += kBlockThreads) {
      const float x = zr[i];
      row_s[i] = x;
      m = fmaxf(m, x);
    }
  } else if (VEC) {
    for (int i = 4 * tid; i < N; i += 4 * kBlockThreads) {
      const float4 q = *reinterpret_cast<const float4*>(zr + i);
      m = fmaxf(m, fmaxf(fmaxf(q.x, q.y), fmaxf(q.z, q.w)));
    }
  } else {
    for (int i = tid; i < N; i += kBlockThreads) m = fmaxf(m, zr[i]);
  }
  const float zmax = block_max(m, red, warp, lane);
  const float lo0 = zmax - 1.0f;

  // Candidates: each warp counts over its contiguous slice of the row, the
  // warps' counts give each its offset, then each writes its own in order.
  const int slice = ((N + kBlockWarps - 1) / kBlockWarps + 31) / 32 * 32;
  const int s0 = min(N, warp * slice);
  const int s1 = min(N, s0 + slice);
  const unsigned lt = lanemask_lt();
  int cnt = 0;
  for (int b = s0; b < s1; b += 32) {
    const int i = b + lane;
    cnt += __popc(__ballot_sync(kFull, i < s1 && src[i] > lo0));
  }
  if (lane == 0) counts[warp] = cnt;
  __syncthreads();
  int off = 0, n = 0;
#pragma unroll
  for (int w = 0; w < kBlockWarps; ++w) {
    off += w < warp ? counts[w] : 0;
    n += counts[w];
  }

  float tau;
  if (n <= kBlockCands) {
    for (int b = s0; b < s1; b += 32) {
      const int i = b + lane;
      const float x = i < s1 ? src[i] : -INFINITY;
      const unsigned bal = __ballot_sync(kFull, x > lo0);
      if (x > lo0) cand[off + __popc(bal & lt)] = x;
      off += __popc(bal);
    }
    __syncthreads();
    if (warp == 0) {
      const float t = tau_from_candidates(cand, n, zmax, lane);
      if (lane == 0) tau_s = t;
    }
    __syncthreads();
    tau = tau_s;
  } else {
    // Every element within 1 of the max, nearly: the steps over the row.
    float lo = lo0, hi = zmax;
    for (int it = 0; it < kIters; ++it) {
      const float mid = (lo + hi) * 0.5f;
      float acc = 0.f;
      for (int i = tid; i < N; i += kBlockThreads) acc += fmaxf(src[i] - mid, 0.f);
      if (block_sum(acc, red, warp, lane) - 1.0f > 0.f) lo = mid;
      else hi = mid;
    }
    const float ta = (lo + hi) * 0.5f;
    float c = 0.f, s = 0.f;
    for (int i = tid; i < N; i += kBlockThreads) {
      const float x = src[i];
      if (x > ta) {
        c += 1.f;
        s += x - zmax;
      }
    }
    const float sum = block_sum(s, red, warp, lane);
    tau = zmax + (sum - 1.0f) / fmaxf(block_sum(c, red, warp, lane), 1.f);
  }

  if (VEC) {
    for (int i = 4 * tid; i < N; i += 4 * kBlockThreads) {
      const float4 q = *reinterpret_cast<const float4*>(src + i);
      *reinterpret_cast<float4*>(outr + i) =
          make_float4(fmaxf(q.x - tau, 0.f), fmaxf(q.y - tau, 0.f), fmaxf(q.z - tau, 0.f),
                      fmaxf(q.w - tau, 0.f));
    }
  } else {
    for (int i = tid; i < N; i += kBlockThreads) outr[i] = fmaxf(src[i] - tau, 0.f);
  }
}

template <int NPL, bool VEC>
cudaError_t launch_warp(const float* z, float* out, int R, int N, cudaStream_t stream) {
  const int blocks = (R + kWarpRows - 1) / kWarpRows;
  sparsemax_warp_kernel<NPL, VEC><<<blocks, kWarpRows * 32, 0, stream>>>(z, out, R, N);
  return cudaGetLastError();
}

template <bool STAGED, bool VEC>
cudaError_t launch_block(const float* z, float* out, int R, int N, cudaStream_t stream) {
  const size_t smem = (kBlockCands + (STAGED ? static_cast<size_t>(N) : 0)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(sparsemax_block_kernel<STAGED, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sparsemax_block_kernel<STAGED, VEC><<<R, kBlockThreads, smem, stream>>>(z, out, N);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the long-row kernel for rows of N pixels, staged
// or not (ops/kernels/sparsemax.py mirrors it to pick the route).
extern "C" long long sparsemax_block_smem_bytes(int N, int staged) {
  return (kBlockCands + (staged ? static_cast<long long>(N) : 0)) * 4;
}

// z, out: (R, N) float32, contiguous. npl > 0: the short-row kernel with
// npl pixels a lane (8, 32 or 96); npl == 0: the long-row kernel, staged or
// not. vec: N % 4 == 0 and both pointers 16-byte aligned.
extern "C" int sparsemax_fwd(const void* z_, void* out_, int R, int N, int npl, int staged,
                             int vec, int device, void* stream_) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* z = static_cast<const float*>(z_);
  float* out = static_cast<float*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  switch (npl) {
    case 0:
      if (staged) return vec ? launch_block<true, true>(z, out, R, N, stream)
                             : launch_block<true, false>(z, out, R, N, stream);
      return vec ? launch_block<false, true>(z, out, R, N, stream)
                 : launch_block<false, false>(z, out, R, N, stream);
    case 8:
      return vec ? launch_warp<8, true>(z, out, R, N, stream)
                 : launch_warp<8, false>(z, out, R, N, stream);
    case 32:
      return vec ? launch_warp<32, true>(z, out, R, N, stream)
                 : launch_warp<32, false>(z, out, R, N, stream);
    case 96:
      return vec ? launch_warp<96, true>(z, out, R, N, stream)
                 : launch_warp<96, false>(z, out, R, N, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
