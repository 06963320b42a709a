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
// The OKS operators are band matrices: every nonzero of row_op[k] and
// col_op[k] lies within r_k of the diagonal (r_k <= ceil(3 * 3.0) = 9 for
// the shipped operators; ops/kernels/decode.py finds r_k from the operators,
// and a dense operator gives n - 1). Each output of the horizontal pass
// t = hm . col_op^T and of the vertical pass conv = row_op . t accumulates
// with fmaf in ascending index order from +0, over the band only: the terms
// the dense products add beyond it are exact zeros, so the values are those
// of the dense products (only the sign of a zero can differ). Full float32
// on the CUDA cores, never TF32: the TPU kernel's default-precision products
// moved keypoints by 0.0229 px.
//
// What bounds it on an H100: reading each map once (147 KB at 192 x 192)
// against 2 H W ((2r + 1) + (2r + 1)) FLOP, about 4 FLOP a byte at r = 9:
// device-memory bytes, if the passes keep up.
//
// Design: a block of 256 threads decodes a strip of S output rows of one map
// (S = H where two blocks of it fit an SM; 48-row strips at 192 x 192).
// It stages the map's rows [h0 - r - 1, h0 + S + r + 1) once (one
// cp.async.bulk where rows are 16-byte aligned), forms t on those rows into
// a second buffer, then conv on its S rows with a running first-occurrence
// argmax, and the Taylor step at its winner from the same t. The r + 1 rows
// of halo carry the Taylor step's neighbours. With more than one strip a map,
// each strip writes (value, index, x, y, raw value) and a second kernel picks
// the strip of the larger value, the lower index on a tie: the order in which
// strips run cannot change the result.
// Radii 0 .. kMaxR run unrolled passes: the horizontal pass gives a thread
// two adjacent columns, their band weights in registers (from a (K, 2 r_max
// + 1, W) band packed by the wrapper) and a float2 window of the row; the
// vertical pass gives a warp four rows at a time, their weights (staged in
// shared memory) in registers, one column a lane, and reads each t once for
// all four, with no branch in its inner loop. Larger radii run a loop per
// output in the same order. The passes are bound by latency and by shared-
// memory loads, so occupancy decides: where no radius exceeds kSmallR a
// kernel of fewer registers runs, three blocks an SM; else two.
//
// Plain-C interface, loaded with ctypes (ops/kernels/decode.py). Every entry
// point returns a cudaError_t as int (0 = success).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 9;   // radii with unrolled passes
constexpr int kSmallR = 4;  // the radius class whose kernel fits three blocks an SM
constexpr int kHC = 2;     // columns of a thread in the horizontal pass (Vec<kHC>)
constexpr int kTH = 4;     // rows of a vertical item
constexpr int kPad = 16;   // floats around the staged rows, for window reads past a row's end
constexpr long long kBudget = 110 * 1024;  // a block's shared memory, two blocks an SM

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// Rows of the map a strip of S output rows holds: R + 1 more on each side.
__host__ __device__ inline int strip_rows(int S, int R, int H) {
  return S + 2 * (R + 1) < H ? S + 2 * (R + 1) : H;
}

// Floats of the vertical pass's weights: row_op[h][h - r + d] for the
// strip's rows (rounded up to kTH) and d = 0 .. 2r, at the unrolled radii
// r <= min(R, kMaxR).
__host__ __device__ inline int weight_floats(int S, int R) {
  return round4(S) * (2 * (R < kMaxR ? R : kMaxR) + 1);
}

long long smem_bytes(int H, int W, int S, int R) {
  return (2LL * kPad + 2LL * strip_rows(S, R, H) * round4(W) + weight_floats(S, R)) * 4;
}

// The strip height: H if it fits the budget, else the most rows (a multiple
// of kTH) that do, evened out over the strips; H again where strips would
// each hold the whole map.
int strip_height(int H, int W, int R) {
  if (smem_bytes(H, W, H, R) <= kBudget) return H;
  int S = H / kTH * kTH;
  while (S > kTH && smem_bytes(H, W, S, R) > kBudget) S -= kTH;
  if (strip_rows(S, R, H) == H) return H;
  const int strips = (H + S - 1) / S;
  return round4((H + strips - 1) / strips);
}

__device__ __forceinline__ void take(float v, int idx, float& best, int& best_idx) {
  if (v > best || (v == best && idx < best_idx)) {
    best = v;
    best_idx = idx;
  }
}

// kHC floats as one load or store.
template <int C>
struct Vec;
template <>
struct Vec<2> {
  using T = float2;
  __device__ static float at(const float2& v, int s) { return s == 0 ? v.x : v.y; }
  __device__ static void store(float* p, const float (&a)[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
  }
};

// t[g][w] = sum over v of x[g][v] col[w][v], v ascending over the band, for
// the ng staged rows. band[d * Wp + w] = col[w][w - R + d]. A thread takes
// kHC adjacent columns, their weights in registers, for a run of rows.
template <int R>
__device__ __forceinline__ void horizontal(const float* xs, float* ts, const float* band, int W,
                                           int Wp, int ng, int tid) {
  constexpr int C = kHC;
  using V = typename Vec<C>::T;
  using F = Vec<C>;
  constexpr int A = (R + C - 1) / C;  // loads of the window on each side
  const int nq = Wp / C;
  const bool wide = nq > kThreads;
  const int P = wide ? 1 : kThreads / nq;  // threads on one column group
  const int p = wide ? 0 : tid / nq;
  if (p >= P) return;
  for (int q = wide ? tid : tid % nq; q < nq; q += wide ? kThreads : nq) {
    const int w0 = C * q;
    float wt[C][2 * R + 1];
#pragma unroll
    for (int d = 0; d <= 2 * R; ++d) {
      const V b = *reinterpret_cast<const V*>(band + d * Wp + w0);
#pragma unroll
      for (int c = 0; c < C; ++c) wt[c][d] = F::at(b, c);
    }
    const bool inner = w0 - R >= 0 && w0 + C - 1 + R < W;
    for (int g = p; g < ng; g += P) {
      // Window element i is x[g][w0 - C A + i]; it meets column c at band
      // index d = i - C A + R - c, so walking i ascending walks each
      // column's band ascending.
      const float* xr = xs + g * Wp + w0 - C * A;
      float acc[C] = {};
#pragma unroll
      for (int i0 = 0; i0 < 2 * A + 1; ++i0) {
        const V v = *reinterpret_cast<const V*>(xr + C * i0);
#pragma unroll
        for (int s = 0; s < C; ++s)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int d = C * i0 + s - C * A + R - c;
            if (d >= 0 && d <= 2 * R && (inner || (w0 + c - R + d >= 0 && w0 + c - R + d < W)))
              acc[c] = fmaf(F::at(v, s), wt[c][d], acc[c]);
          }
      }
      F::store(ts + g * Wp + w0, acc);
    }
  }
}

// The same for any radius r, one output a thread.
__device__ void horizontal_any(const float* xs, float* ts, const float* band, int r, int W,
                               int Wp, int ng, int tid) {
  for (int i = tid; i < ng * W; i += kThreads) {
    const int g = i / W;
    const int w = i - g * W;
    float acc = 0.f;
    const int v1 = min(W - 1, w + r);
    for (int v = max(0, w - r); v <= v1; ++v)
      acc = fmaf(xs[g * Wp + v], band[(v - w + r) * Wp + w], acc);
    ts[g * Wp + w] = acc;
  }
}

// wts[i * D + d] = row[h0 + i][h0 + i - R + d] (D = 2R + 1), zero for rows
// past the strip and columns outside the map.
template <int R>
__device__ __forceinline__ void stage_weights(float* wts, const float* row, int H, int h0, int h1,
                                              int tid) {
  constexpr int D = 2 * R + 1;
  for (int i = tid; i < round4(h1 - h0) * D; i += kThreads) {
    const int h = h0 + i / D;
    const int g = h - R + i % D;
    wts[i] = h < h1 && g >= 0 && g < H ? row[static_cast<size_t>(h) * H + g] : 0.f;
  }
}

// conv[h][w] = sum over g of row[h][g] t[g][w], g ascending over the band,
// for the strip's rows h0 .. h1 - 1, into a running first-occurrence argmax.
// t row g sits at ts[(g - ga) * Wp]. An item is kTH rows and 32 columns; a
// warp takes a contiguous run of items, row quad by row quad, and loads a
// quad's weights once. Terms outside the map (g < 0 or g >= H) have weight
// zero and read a clamped row of t: they add +0 and leave every sum as the
// band's (up to the sign of a zero).
template <int R>
__device__ __forceinline__ void vertical(const float* ts, const float* wts, int W, int Wp, int h0,
                                         int h1, int ga, int gb, int warp, int lane, float& best,
                                         int& best_idx) {
  constexpr int D = 2 * R + 1;
  constexpr int NT = 2 * R + kTH;
  const int chunks = (W + 31) / 32;
  const int items = (h1 - h0 + kTH - 1) / kTH * chunks;
  const int i1 = items * (warp + 1) / kWarps;
  int loaded = -1;
  float wt[kTH][D];
  for (int i = items * warp / kWarps; i < i1; ++i) {
    const int quad = i / chunks;
    const int w = (i - quad * chunks) * 32 + lane;
    const int h = h0 + kTH * quad;
    if (quad != loaded) {
#pragma unroll
      for (int j = 0; j < kTH; ++j)
#pragma unroll
        for (int d = 0; d < D; ++d) wt[j][d] = wts[(kTH * quad + j) * D + d];
      loaded = quad;
    }
    // t row g = h - R + o meets row h + j at band index d = o - j.
    const float* col = ts + min(w, W - 1);
    float acc[kTH] = {};
#pragma unroll
    for (int o = 0; o < NT; ++o) {
      const float t = col[(min(max(h - R + o, ga), gb - 1) - ga) * Wp];
#pragma unroll
      for (int j = 0; j < kTH; ++j)
        if (o - j >= 0 && o - j < D) acc[j] = fmaf(wt[j][o - j], t, acc[j]);
    }
    if (w < W) {
#pragma unroll
      for (int j = 0; j < kTH; ++j)
        if (h + j < h1) take(acc[j], (h + j) * W + w, best, best_idx);
    }
  }
}

// conv at (h, w), the band's terms in ascending order.
__device__ __forceinline__ float conv_at(const float* ts, const float* row, int r, int H, int Wp,
                                         int ga, int h, int w) {
  float acc = 0.f;
  const int g1 = min(H - 1, h + r);
  for (int g = max(0, h - r); g <= g1; ++g)
    acc = fmaf(row[static_cast<size_t>(h) * H + g], ts[(g - ga) * Wp + w], acc);
  return acc;
}

__device__ void vertical_any(const float* ts, const float* row, int r, int H, int W, int Wp,
                             int h0, int h1, int ga, int tid, float& best, int& best_idx) {
  for (int i = tid; i < (h1 - h0) * W; i += kThreads) {
    const int h = h0 + i / W;
    const int w = i % W;
    take(conv_at(ts, row, r, H, Wp, ga, h, w), h * W + w, best, best_idx);
  }
}

// The passes at radius r: unrolled for r = R .. RMAX, else the loops.
template <int RMAX, int R = 0>
__device__ __forceinline__ void passes(int r, const float* xs, float* ts, float* wts,
                                       const float* band, const float* row, int H, int W, int Wp,
                                       int ng, int h0, int h1, int ga, int gb, int tid, float& best,
                                       int& best_idx) {
  if constexpr (R > RMAX) {
    horizontal_any(xs, ts, band, r, W, Wp, ng, tid);
    __syncthreads();
    vertical_any(ts, row, r, H, W, Wp, h0, h1, ga, tid, best, best_idx);
  } else {
    if (r != R) {
      passes<RMAX, R + 1>(r, xs, ts, wts, band, row, H, W, Wp, ng, h0, h1, ga, gb, tid, best,
                          best_idx);
      return;
    }
    stage_weights<R>(wts, row, H, h0, h1, tid);
    horizontal<R>(xs, ts, band, W, Wp, ng, tid);
    __syncthreads();
    vertical<R>(ts, wts, W, Wp, h0, h1, ga, gb, tid / 32, tid % 32, best, best_idx);
  }
}

// RMAX: the largest radius with unrolled passes (kSmallR or kMaxR); its
// registers set how many blocks share an SM (85 or 128 registers a thread,
// no spills).
template <int RMAX>
__global__ void __launch_bounds__(kThreads, RMAX <= kSmallR ? 3 : 2)
    decode_kernel(const float* __restrict__ hm, const float* __restrict__ row_op,
                  const float* __restrict__ col_band, const int* __restrict__ radius, int D,
                  int K, int H, int W, int S, int ncap, int bulk, float* __restrict__ locs,
                  float* __restrict__ vals, float* __restrict__ rec, int* __restrict__ rec_idx) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float nb[5];

  const int Wp = round4(W);
  const int strips = (H + S - 1) / S;
  const int map = blockIdx.x / strips;
  const int strip = blockIdx.x - map * strips;
  const int k = map % K;
  const int r = radius[k];
  const int h0 = strip * S;
  const int h1 = min(H, h0 + S);
  const int ga = max(0, h0 - r - 1);
  const int gb = min(H, h1 + r + 1);
  const int ng = gb - ga;
  float* xs = smem + kPad;
  float* ts = xs + ncap * Wp + kPad;
  float* wts = ts + ncap * Wp;
  const float* x = hm + static_cast<size_t>(map) * H * W;
  const float* row = row_op + static_cast<size_t>(k) * H * H;
  const float* band = col_band + static_cast<size_t>(k) * D * Wp;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // Stage rows ga .. gb - 1 of the map; the vertical pass's weights are
  // staged beside them, before the wait.
  if (bulk) {
    const uint32_t b = smem_u32(&bar);
    if (tid == 0) {
      mbar_init(b, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      const uint32_t bytes = static_cast<uint32_t>(ng) * W * 4u;
      mbar_expect_tx(b, bytes);
      bulk_copy(smem_u32(xs), x + static_cast<size_t>(ga) * W, bytes, b);
    }
    mbar_wait(b, 0);
  } else {
    for (int i = tid; i < ng * W; i += kThreads) {
      const int g = i / W;
      xs[g * Wp + i - g * W] = x[static_cast<size_t>(ga) * W + i];
    }
  }
  __syncthreads();

  float best = -INFINITY;
  int best_idx = INT_MAX;
  passes<RMAX>(r, xs, ts, wts, band, row, H, W, Wp, ng, h0, h1, ga, gb, tid, best, best_idx);

  // The strip's argmax (the larger value, or the smaller row-major index on
  // a tie), then the sub-pixel step at it.
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, best, o);
    const int i = __shfl_xor_sync(0xffffffffu, best_idx, o);
    take(v, i, best, best_idx);
  }
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = best_idx;
  }
  __syncthreads();
  if (tid >= 32) return;
  best = tid < kWarps ? red_v[tid] : -INFINITY;
  best_idx = tid < kWarps ? red_i[tid] : INT_MAX;
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, best, o);
    const int i = __shfl_xor_sync(0xffffffffu, best_idx, o);
    take(v, i, best, best_idx);
  }
  const bool found = best_idx != INT_MAX;
  if (!found && strips > 1) {  // no comparable value in this strip (all NaN)
    if (tid == 0) rec_idx[blockIdx.x] = INT_MAX;
    return;
  }
  const int idx = found ? best_idx : 0;
  const int yi = idx / W;
  const int xi = idx - yi * W;
  const bool valid = xi > 0 && xi < W - 1 && yi > 0 && yi < H - 1;
  if (valid && tid < 5) {
    // c, right, left, down, up
    const int dy = tid == 3 ? 1 : tid == 4 ? -1 : 0;
    const int dx = tid == 1 ? 1 : tid == 2 ? -1 : 0;
    nb[tid] = conv_at(ts, row, r, H, Wp, ga, yi + dy, xi + dx);
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
  const float value = x[idx];
  if (strips == 1) {
    locs[2 * static_cast<size_t>(map)] = px;
    locs[2 * static_cast<size_t>(map) + 1] = py;
    vals[map] = value;
  } else {
    float* out = rec + 4 * static_cast<size_t>(blockIdx.x);
    out[0] = best;
    out[1] = px;
    out[2] = py;
    out[3] = value;
    rec_idx[blockIdx.x] = best_idx;
  }
}

// One thread a map: the strip of the larger value, the lower index on a tie
// (strips in ascending row order), or pixel 0 when no strip found a
// comparable value, as the one-strip kernel does.
__global__ void decode_pick_kernel(const float* __restrict__ hm, const float* __restrict__ rec,
                                   const int* __restrict__ rec_idx, int maps, int strips, int HW,
                                   float* __restrict__ locs, float* __restrict__ vals) {
  const int map = blockIdx.x * blockDim.x + threadIdx.x;
  if (map >= maps) return;
  float best = -INFINITY;
  int best_idx = INT_MAX, pick = -1;
  for (int s = 0; s < strips; ++s) {
    const size_t i = static_cast<size_t>(map) * strips + s;
    const int idx = rec_idx[i];
    const float v = rec[4 * i];
    if (idx != INT_MAX && (v > best || (v == best && idx < best_idx))) {
      best = v;
      best_idx = idx;
      pick = s;
    }
  }
  if (pick < 0) {
    locs[2 * static_cast<size_t>(map)] = 0.f;
    locs[2 * static_cast<size_t>(map) + 1] = 0.f;
    vals[map] = hm[static_cast<size_t>(map) * HW];
    return;
  }
  const float* r = rec + 4 * (static_cast<size_t>(map) * strips + pick);
  locs[2 * static_cast<size_t>(map)] = r[1];
  locs[2 * static_cast<size_t>(map) + 1] = r[2];
  vals[map] = r[3];
}

}  // namespace

// Strip height and strips a map for (H, W) maps whose operators have band
// radius at most R; the wrapper sizes the strips' records with them.
extern "C" int decode_strips(int H, int W, int R) {
  const int S = strip_height(H, W, R);
  return (H + S - 1) / S;
}

// Shared memory of one block at (H, W, R), the kernel's few static words
// included; the wrapper holds it to the card's opt-in limit.
extern "C" long long decode_smem_bytes(int H, int W, int R) {
  return smem_bytes(H, W, strip_height(H, W, R), R) + 128;
}

// heatmaps (B, K, H, W), row_op (K, H, H), float32; col_band (K, D, round4(W))
// float32 with D = 2 R + 1 and radius (K,) int32 <= R, as the wrapper packs
// them; rec (B K strips, 4) float32 and rec_idx (B K strips,) int32 scratch
// when decode_strips(H, W, R) > 1; locs (B, K, 2) and vals (B, K) out.
extern "C" int expected_value_decode_fwd(const void* heatmaps, const void* row_op,
                                         const void* col_band, const void* radius, void* rec,
                                         void* rec_idx, void* locs, void* vals, int B, int K,
                                         int H, int W, int R, int device, void* stream_) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int S = strip_height(H, W, R);
  const int strips = (H + S - 1) / S;
  const int maps = B * K;
  const size_t smem = static_cast<size_t>(smem_bytes(H, W, S, R));
  const bool bulk = W % 4 == 0 && reinterpret_cast<uintptr_t>(heatmaps) % 16 == 0;
  const auto kernel = R <= kSmallR ? decode_kernel<kSmallR> : decode_kernel<kMaxR>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<maps * strips, kThreads, smem, stream>>>(
      static_cast<const float*>(heatmaps), static_cast<const float*>(row_op),
      static_cast<const float*>(col_band), static_cast<const int*>(radius), 2 * R + 1, K, H, W,
      S, strip_rows(S, R, H), bulk, static_cast<float*>(locs), static_cast<float*>(vals),
      static_cast<float*>(rec), static_cast<int*>(rec_idx));
  err = cudaGetLastError();
  if (err != cudaSuccess || strips == 1) return err;
  decode_pick_kernel<<<(maps + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(heatmaps), static_cast<const float*>(rec),
      static_cast<const int*>(rec_idx), maps, strips, H * W, static_cast<float*>(locs),
      static_cast<float*>(vals));
  return cudaGetLastError();
}
