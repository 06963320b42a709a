// Multi-head attention in bf16 for Hopper (sm_90a), csrc/tiled_attention_sm90.cu
// has the design: the kernels and their launchers, templated on the padded
// head width Dp = 16 ceil(d / 16) with d itself a run-time value.
// csrc/tiled_attention_sm90.cu picks the width and holds the plain-C
// interface; tiled_attention_sm90_w*.cu instantiate the launchers, two
// widths a unit, which nvcc builds side by side.

#pragma once

#include <math.h>

#include "sm90.cuh"

namespace probpose_sm90 {

constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kStages = 2;     // depth of the TMA rings (the dQ kernel past Dp = 224: 1)
constexpr int kBlockRows = 128;
constexpr int kTileRows = 64;  // keys per dQ step, query rows per dK/dV step
constexpr float kLog2e = 1.4426950408889634f;
// Shared memory a block may opt into on an H100 (227 KB); the tiles of the
// widest heads are sized against it.
constexpr size_t kSmemLimit = 232448;

// X(Dp) for every padded width: the multiples of 16 from 16 to 256.
#define PROBPOSE_SM90_WIDTHS(X)                                                        \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176) X(192) X(208) \
  X(224) X(240) X(256)

// setmaxnreg's split of the block's 168 registers a thread: 232 a consumer
// thread and 40 a producer thread up to Dp = 128, 240 and 24 past it, where
// O (or dQ, dK, dV) of 64 rows is Dp / 2 registers a thread.
template <int Dp>
struct Regs {
  static constexpr int kConsumer = Dp <= 128 ? 232 : 240;
  static constexpr int kProducer = Dp <= 128 ? 40 : 24;
};

// Shared memory: tiles at 1024-byte boundaries (the swizzle's period), then
// the mbarriers, then f32 row statistics. The forward streams K and V in
// tiles of 128 keys up to Dp = 128 and of 64 past it (registers: S beside O).
template <int Dp>
struct Fwd {
  static constexpr int kKeys = Dp <= 128 ? 128 : 64;
  static constexpr uint32_t kQ = Tile<Dp>::bytes(kBlockRows);
  static constexpr uint32_t kKV = Tile<Dp>::bytes(kKeys);  // one K or V tile
  static constexpr uint32_t kBars = kQ + kStages * 2 * kKV;
  static constexpr size_t kSmem = 1024 + kBars + 8 * (1 + 2 * kStages);
};

template <int Dp>
struct Dq {
  static constexpr uint32_t kQ = Tile<Dp>::bytes(kBlockRows);  // Q, then dO
  static constexpr uint32_t kKV = Tile<Dp>::bytes(kTileRows);
  static constexpr size_t bytes(int stages) {
    return 1024 + 2 * kQ + stages * 2 * kKV + 8 * (1 + 2 * stages) + 2 * kBlockRows * 4;
  }
  static constexpr int kStages = bytes(2) <= kSmemLimit ? 2 : 1;
  static constexpr uint32_t kBars = 2 * kQ + kStages * 2 * kKV;
  static constexpr uint32_t kStats = kBars + 8 * (1 + 2 * kStages);
  static constexpr size_t kSmem = bytes(kStages);
};

// Past Dp = 128 a warpgroup cannot hold both dK and dV of its 64 keys
// (Dp registers a thread): the block owns 64 keys, warpgroup 0 their dV and
// warpgroup 1 their dK, each recomputing S^T.
template <int Dp>
struct Dkv {
  static constexpr bool kSplit = Dp > 128;
  static constexpr int kKeys = kSplit ? kTileRows : kBlockRows;
  static constexpr uint32_t kKV = Tile<Dp>::bytes(kKeys);     // K, then V
  static constexpr uint32_t kQ = Tile<Dp>::bytes(kTileRows);  // one Q or dO tile
  static constexpr uint32_t kBars = 2 * kKV + kStages * 2 * kQ;
  static constexpr uint32_t kStats = kBars + 8 * (1 + 2 * kStages);
  static constexpr size_t kSmem = 1024 + kStats + kStages * 2 * kTileRows * 4;
};

// Keys of a head padded to 64 * NT (N <= 256). One block owns 64 query rows
// of one (b, h) and is one warpgroup; its single TMA barrier brings its Q
// rows and the head's whole K and V.
template <int Dp, int NT>
struct Short {
  static constexpr int kKeys = 64 * NT;
  static constexpr uint32_t kQ = Tile<Dp>::bytes(64);
  static constexpr uint32_t kKV = Tile<Dp>::bytes(kKeys);
  static constexpr uint32_t kBar = kQ + 2 * kKV;
  static constexpr size_t kSmem = 1024 + kBar + 8;
};

// Every product that yields d columns (O, dQ, dK, dV) stores d of them:
// lane quad t of 8-column group jn writes columns 8 jn + 2 t, 8 jn + 2 t + 1,
// and d is a multiple of 8, so a group lies wholly inside or outside.
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Slots: a packed (B, N, 3C) qkv is 3 H slots of d columns, slot t * ts +
// h * hs for part t (q, k, v) of head h: ts = H, hs = 1 qkv-major, ts = 1,
// hs = 3 head-major (csrc/packed_attention.cu); the context and dO are H.

// ----------------------------------------------------------------- forward

template <int Dp>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap q_map,   // qkv, boxes of 128 rows
               const __grid_constant__ CUtensorMap kv_map,  // qkv, boxes of kKeys rows
               bf16* __restrict__ out, float* __restrict__ lse, int N, int C, int H, int d,
               int ts, int hs, float scale) {
  using L = Fwd<Dp>;
  constexpr int KT = L::kKeys;
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  const uint32_t q_s = base;
  const uint32_t kv_s = base + L::kQ;  // stage s: K, then V
  const uint32_t q_bar = base + L::kBars;
  const uint32_t full = q_bar + 8;  // full(s) = full + 8 s
  const uint32_t empty = full + 8 * kStages;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * kBlockRows;
  const int n_tiles = (N + KT - 1) / KT;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every copy
    setmaxnreg_dec<Regs<Dp>::kProducer>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_bar, L::kQ);
      tma_head<Dp>(q_s, &q_map, q_bar, h * hs, row0, b, kBlockRows);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty + 8 * s, ((j / kStages) - 1) & 1);
        const uint32_t k_s = kv_s + s * 2 * L::kKV;
        mbar_expect_tx(full + 8 * s, 2 * L::kKV);
        tma_head<Dp>(k_s, &kv_map, full + 8 * s, ts + h * hs, j * KT, b, KT);
        tma_head<Dp>(k_s + L::kKV, &kv_map, full + 8 * s, 2 * ts + h * hs, j * KT, b, KT);
      }
    }
  } else {  // consumers: 64 query rows each
    setmaxnreg_inc<Regs<Dp>::kConsumer>();
    const int tid = threadIdx.x % 128;
    const int g = (tid % 32) / 4;
    const int t = tid % 4;
    const float sl2 = scale * kLog2e;
    float o[Dp / 2];
#pragma unroll
    for (int i = 0; i < Dp / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running row max of the raw scores
    float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums
    mbar_wait(q_bar, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(full + 8 * s, (j / kStages) & 1);
      const uint32_t k_s = kv_s + s * 2 * L::kKV;
      const uint32_t v_s = k_s + L::kKV;

      float sc[KT / 2];  // S = Q K^T, 64 rows x KT keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Dp / 16; ++kk) {
        if constexpr (KT == 128)
          wgmma_ss_n128(sc, desc_k<Dp>(q_s, kBlockRows, wg * 64, kk),
                        desc_k<Dp>(k_s, KT, 0, kk), kk);
        else
          wgmma_ss_n64(sc, desc_k<Dp>(q_s, kBlockRows, wg * 64, kk),
                       desc_k<Dp>(k_s, KT, 0, kk), kk);
      }
      wgmma_commit_wait();
      reg_fence(sc);

      const int key0 = j * KT;
      if (key0 + KT > N) {
#pragma unroll
        for (int jn = 0; jn < KT / 8; ++jn)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (key0 + 8 * jn + 2 * t + c >= N) sc[4 * jn + c] = sc[4 * jn + 2 + c] = -INFINITY;
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int jn = 0; jn < KT / 8; ++jn) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * jn], sc[4 * jn + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * jn + 2], sc[4 * jn + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float c0 = exp2f((m0 - mx0) * sl2);  // 0 on the first tile
      const float c1 = exp2f((m1 - mx1) * sl2);
      m0 = mx0;
      m1 = mx1;
      const float b0 = mx0 * sl2, b1 = mx1 * sl2;
      float r0 = 0.f, r1 = 0.f;
      uint32_t pa[KT / 4];
#pragma unroll
      for (int jn = 0; jn < KT / 8; ++jn) {
        const float p00 = exp2f(fmaf(sc[4 * jn], sl2, -b0));
        const float p01 = exp2f(fmaf(sc[4 * jn + 1], sl2, -b0));
        const float p10 = exp2f(fmaf(sc[4 * jn + 2], sl2, -b1));
        const float p11 = exp2f(fmaf(sc[4 * jn + 3], sl2, -b1));
        r0 += p00 + p01;
        r1 += p10 + p11;
        pa[2 * jn] = pack_bf16(p00, p01);
        pa[2 * jn + 1] = pack_bf16(p10, p11);
      }
      l0 = l0 * c0 + r0;
      l1 = l1 * c1 + r1;
#pragma unroll
      for (int jn = 0; jn < Dp / 8; ++jn) {
        o[4 * jn] *= c0;
        o[4 * jn + 1] *= c0;
        o[4 * jn + 2] *= c1;
        o[4 * jn + 3] *= c1;
      }

      reg_fence(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        WgmmaRs<Dp>::mma(o, &pa[4 * kk], desc_mn<Dp>(v_s, KT, kk));
      wgmma_commit_wait();
      reg_fence(o);
      mbar_arrive(empty + 8 * s);
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const int ra = row0 + wg * 64 + (tid / 32) * 16 + g;
    const int rb = ra + 8;
    bf16* ob = out + static_cast<size_t>(b) * N * C + h * d + 2 * t;
#pragma unroll
    for (int jn = 0; jn < Dp / 8; ++jn) {
      if (8 * jn >= d) break;
      if (ra < N) store2(ob + static_cast<size_t>(ra) * C + 8 * jn, o[4 * jn] / l0, o[4 * jn + 1] / l0);
      if (rb < N)
        store2(ob + static_cast<size_t>(rb) * C + 8 * jn, o[4 * jn + 2] / l1, o[4 * jn + 3] / l1);
    }
    if (lse != nullptr && t == 0) {
      float* lp = lse + (static_cast<size_t>(b) * H + h) * N;
      if (ra < N) lp[ra] = m0 * scale + logf(l0);
      if (rb < N) lp[rb] = m1 * scale + logf(l1);
    }
  }
}

// ------------------------------------------------- short-sequence forward

// K1's forward for N <= 256 (packed_attention's "sm90 short" route), and
// K6's: the score row of every query stays in registers, so the softmax is
// exact and single-pass, and P is normalised and rounded to bf16 before
// P.V, the TPU kernel's order (plain twin: packed_attention_reference).
// Head h of q, k and v is slot q_slot + h * hs (k_slot, v_slot) of their
// maps (K1: one packed qkv, slots 0, ts, 2 ts; K6: three (B, N, heads, d)
// views, slot h of each). Writes the row log-sum-exp when lse is not null.
template <int Dp, int NT>
__global__ void __launch_bounds__(128)
    short_fwd_kernel(const __grid_constant__ CUtensorMap q_map,  // boxes of 64 rows
                     const __grid_constant__ CUtensorMap k_map,  // boxes of 64 NT rows
                     const __grid_constant__ CUtensorMap v_map,  // boxes of 64 NT rows
                     int q_slot, int k_slot, int v_slot, int hs, bf16* __restrict__ out,
                     float* __restrict__ lse, int N, int C, int H, int d, float scale) {
  using L = Short<Dp, NT>;
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  const uint32_t q_s = base;
  const uint32_t k_s = base + L::kQ;
  const uint32_t v_s = k_s + L::kKV;
  const uint32_t bar = base + L::kBar;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * 64;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, L::kQ + 2 * L::kKV);
    tma_head<Dp>(q_s, &q_map, bar, q_slot + h * hs, row0, b, 64);
    tma_head<Dp>(k_s, &k_map, bar, k_slot + h * hs, 0, b, L::kKeys);
    tma_head<Dp>(v_s, &v_map, bar, v_slot + h * hs, 0, b, L::kKeys);
  }
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const float sl2 = scale * kLog2e;
  mbar_wait(bar, 0);

  float sc[NT][32];  // S = Q K^T, 64 rows x 64 keys per tile
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int kk = 0; kk < Dp / 16; ++kk)
      wgmma_ss_n64(sc[j], desc_k<Dp>(q_s, 64, 0, kk), desc_k<Dp>(k_s, L::kKeys, 64 * j, kk),
                   kk);
  wgmma_commit_wait();
#pragma unroll
  for (int j = 0; j < NT; ++j) reg_fence(sc[j]);

  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (64 * j + 8 * jn + 2 * t + c >= N) sc[j][4 * jn + c] = sc[j][4 * jn + 2 + c] = -INFINITY;
        mx0 = fmaxf(mx0, sc[j][4 * jn + c]);
        mx1 = fmaxf(mx1, sc[j][4 * jn + 2 + c]);
      }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  const float b0 = mx0 * sl2, b1 = mx1 * sl2;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      sc[j][i] = exp2f(fmaf(sc[j][i], sl2, -b0));
      sc[j][i + 1] = exp2f(fmaf(sc[j][i + 1], sl2, -b0));
      sc[j][i + 2] = exp2f(fmaf(sc[j][i + 2], sl2, -b1));
      sc[j][i + 3] = exp2f(fmaf(sc[j][i + 3], sl2, -b1));
      l0 += sc[j][i] + sc[j][i + 1];
      l1 += sc[j][i + 2] + sc[j][i + 3];
    }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float r0 = 1.f / l0, r1 = 1.f / l1;
  uint32_t pa[NT][16];  // round(P), the register A operand of P.V
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      pa[j][2 * jn] = pack_bf16(sc[j][4 * jn] * r0, sc[j][4 * jn + 1] * r0);
      pa[j][2 * jn + 1] = pack_bf16(sc[j][4 * jn + 2] * r1, sc[j][4 * jn + 3] * r1);
    }

  float o[Dp / 2];
#pragma unroll
  for (int i = 0; i < Dp / 2; ++i) o[i] = 0.f;
  reg_fence(o);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRs<Dp>::mma(o, &pa[j][4 * kk], desc_mn<Dp>(v_s, L::kKeys, 4 * j + kk));
  wgmma_commit_wait();
  reg_fence(o);

  const int ra = row0 + (tid / 32) * 16 + g;
  const int rb = ra + 8;
  bf16* ob = out + static_cast<size_t>(b) * N * C + h * d + 2 * t;
#pragma unroll
  for (int jn = 0; jn < Dp / 8; ++jn) {
    if (8 * jn >= d) break;
    if (ra < N) store2(ob + static_cast<size_t>(ra) * C + 8 * jn, o[4 * jn], o[4 * jn + 1]);
    if (rb < N) store2(ob + static_cast<size_t>(rb) * C + 8 * jn, o[4 * jn + 2], o[4 * jn + 3]);
  }
  if (lse != nullptr && t == 0) {
    float* lp = lse + (static_cast<size_t>(b) * H + h) * N;
    if (ra < N) lp[ra] = mx0 * scale + logf(l0);
    if (rb < N) lp[rb] = mx1 * scale + logf(l1);
  }
}

// --------------------------------------------------------- backward: dQ

template <int Dp>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,   // qkv, boxes of 128 rows
                  const __grid_constant__ CUtensorMap kv_map,  // qkv, boxes of 64 rows
                  const __grid_constant__ CUtensorMap do_map,  // dout, boxes of 128 rows
                  const bf16* __restrict__ out, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ dsum,
                  bf16* __restrict__ dqkv, int N, int C, int H, int d, int ts, int hs,
                  float scale, int exact_d) {
  using L = Dq<Dp>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  const uint32_t q_s = base;
  const uint32_t do_s = base + L::kQ;
  const uint32_t kv_s = base + 2 * L::kQ;  // stage s: K, then V
  const uint32_t q_bar = base + L::kBars;
  const uint32_t full = q_bar + 8;
  const uint32_t empty = full + 8 * S;
  float* stat_l = reinterpret_cast<float*>(smem + (base - smem_u32(smem)) + L::kStats);
  float* stat_d = stat_l + kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.x) * kBlockRows;
  const int n_tiles = (N + kTileRows - 1) / kTileRows;
  const int wg = threadIdx.x / 128;
  const size_t C3 = 3 * static_cast<size_t>(C);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<Regs<Dp>::kProducer>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_bar, 2 * L::kQ);
      tma_head<Dp>(q_s, &q_map, q_bar, h * hs, row0, b, kBlockRows);
      tma_head<Dp>(do_s, &do_map, q_bar, h, row0, b, kBlockRows);
      // exact_d: every K/V tile twice, once for D and once for dQ
      const int n_loads = exact_d ? 2 * n_tiles : n_tiles;
      for (int j = 0; j < n_loads; ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(empty + 8 * s, ((j / S) - 1) & 1);
        const uint32_t k_s = kv_s + s * 2 * L::kKV;
        const int key0 = (j % n_tiles) * kTileRows;
        mbar_expect_tx(full + 8 * s, 2 * L::kKV);
        tma_head<Dp>(k_s, &kv_map, full + 8 * s, ts + h * hs, key0, b, kTileRows);
        tma_head<Dp>(k_s + L::kKV, &kv_map, full + 8 * s, 2 * ts + h * hs, key0, b, kTileRows);
      }
    }
  } else {
    setmaxnreg_inc<Regs<Dp>::kConsumer>();
    const int tid = threadIdx.x % 128;
    const int g = (tid % 32) / 4;
    const int t = tid % 4;
    const float sl2 = scale * kLog2e;

    // lse of this warpgroup's 64 rows and, unless exact_d, D = rowsum(dO * O),
    // two threads a row, each over half of the row's 8-column groups in order.
    {
      const int r = wg * 64 + tid / 2;
      const int n = row0 + r;
      const int half = tid % 2;
      float acc = 0.f;
      if (n < N && !exact_d) {
        const size_t off = (static_cast<size_t>(b) * N + n) * C + h * d;
        const int groups = d / 8, first = (groups + 1) / 2;
        for (int cg = half ? first : 0; cg < (half ? groups : first); ++cg) {
          const uint4 ov = *reinterpret_cast<const uint4*>(out + off + 8 * cg);
          const uint4 dv = *reinterpret_cast<const uint4*>(dout + off + 8 * cg);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]);
            const float2 df = __bfloat1622float2(d2[e]);
            acc = fmaf(of.x, df.x, acc);
            acc = fmaf(of.y, df.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) {
        const size_t at = (static_cast<size_t>(b) * H + h) * N + n;
        stat_d[r] = acc;
        stat_l[r] = n < N ? lse[at] * kLog2e : 0.f;
        if (n < N && !exact_d) dsum[at] = acc;
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
    const int ra = wg * 64 + (tid / 32) * 16 + g;
    const float la = stat_l[ra], lb = stat_l[ra + 8];
    float da = stat_d[ra], db = stat_d[ra + 8];
    mbar_wait(q_bar, 0);

    // exact_d: D = rowsum(dP * P) over the unrounded P, the TPU kernel's
    // order, in a first sweep over the key tiles (S and dP, no dQ).
    int j0 = 0;  // tiles taken from the ring so far
    if (exact_d) {
      float sa = 0.f, sb = 0.f;
      for (; j0 < n_tiles; ++j0) {
        const int s = j0 % S;
        mbar_wait(full + 8 * s, (j0 / S) & 1);
        const uint32_t k_s = kv_s + s * 2 * L::kKV;
        float sc[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < Dp / 16; ++kk)
          wgmma_ss_n64(sc, desc_k<Dp>(q_s, kBlockRows, wg * 64, kk),
                       desc_k<Dp>(k_s, kTileRows, 0, kk), kk);
#pragma unroll
        for (int kk = 0; kk < Dp / 16; ++kk)
          wgmma_ss_n64(dp, desc_k<Dp>(do_s, kBlockRows, wg * 64, kk),
                       desc_k<Dp>(k_s + L::kKV, kTileRows, 0, kk), kk);
        wgmma_commit_wait();
        reg_fence(sc);
        reg_fence(dp);
        mbar_arrive(empty + 8 * s);
        const int key0 = j0 * kTileRows;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (key0 + 8 * jn + 2 * t + c < N) {
              sa = fmaf(exp2f(fmaf(sc[4 * jn + c], sl2, -la)), dp[4 * jn + c], sa);
              sb = fmaf(exp2f(fmaf(sc[4 * jn + 2 + c], sl2, -lb)), dp[4 * jn + 2 + c], sb);
            }
      }
      // the four threads of a row pair hold its columns 2 t, 2 t + 1 (mod 8)
      sa += __shfl_xor_sync(0xffffffffu, sa, 1);
      sa += __shfl_xor_sync(0xffffffffu, sa, 2);
      sb += __shfl_xor_sync(0xffffffffu, sb, 1);
      sb += __shfl_xor_sync(0xffffffffu, sb, 2);
      da = sa;
      db = sb;
      const size_t at = (static_cast<size_t>(b) * H + h) * N + row0 + ra;
      if (t == 0 && row0 + ra < N) dsum[at] = da;
      if (t == 0 && row0 + ra + 8 < N) dsum[at + 8] = db;
    }

    float dq[Dp / 2];
#pragma unroll
    for (int i = 0; i < Dp / 2; ++i) dq[i] = 0.f;

    for (int j = 0; j < n_tiles; ++j) {
      const int s = (j0 + j) % S;
      mbar_wait(full + 8 * s, ((j0 + j) / S) & 1);
      const uint32_t k_s = kv_s + s * 2 * L::kKV;
      const uint32_t v_s = k_s + L::kKV;

      float sc[32], dp[32];  // S = Q K^T and dP = dO V^T, 64 rows x 64 keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Dp / 16; ++kk)
        wgmma_ss_n64(sc, desc_k<Dp>(q_s, kBlockRows, wg * 64, kk),
                     desc_k<Dp>(k_s, kTileRows, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < Dp / 16; ++kk)
        wgmma_ss_n64(dp, desc_k<Dp>(do_s, kBlockRows, wg * 64, kk),
                     desc_k<Dp>(v_s, kTileRows, 0, kk), kk);
      wgmma_commit_wait();
      reg_fence(sc);
      reg_fence(dp);

      const int key0 = j * kTileRows;
      uint32_t ds[16];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        float ga[2], gb[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool in = key0 + 8 * jn + 2 * t + c < N;
          const float pa = in ? exp2f(fmaf(sc[4 * jn + c], sl2, -la)) : 0.f;
          const float pb = in ? exp2f(fmaf(sc[4 * jn + 2 + c], sl2, -lb)) : 0.f;
          ga[c] = pa * (dp[4 * jn + c] - da) * scale;
          gb[c] = pb * (dp[4 * jn + 2 + c] - db) * scale;
        }
        ds[2 * jn] = pack_bf16(ga[0], ga[1]);
        ds[2 * jn + 1] = pack_bf16(gb[0], gb[1]);
      }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileRows / 16; ++kk)
        WgmmaRs<Dp>::mma(dq, &ds[4 * kk], desc_mn<Dp>(k_s, kTileRows, kk));
      wgmma_commit_wait();
      reg_fence(dq);
      mbar_arrive(empty + 8 * s);
    }

    const int na = row0 + ra, nb = na + 8;
    bf16* gq = dqkv + static_cast<size_t>(b) * N * C3 + static_cast<size_t>(h * hs) * d + 2 * t;
#pragma unroll
    for (int jn = 0; jn < Dp / 8; ++jn) {
      if (8 * jn >= d) break;
      if (na < N) store2(gq + na * C3 + 8 * jn, dq[4 * jn], dq[4 * jn + 1]);
      if (nb < N) store2(gq + nb * C3 + 8 * jn, dq[4 * jn + 2], dq[4 * jn + 3]);
    }
  }
}

// ------------------------------------------------------ backward: dK, dV

template <int Dp>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkv_kernel(const __grid_constant__ CUtensorMap kv_map,  // qkv, boxes of kKeys rows
                   const __grid_constant__ CUtensorMap q_map,   // qkv, boxes of 64 rows
                   const __grid_constant__ CUtensorMap do_map,  // dout, boxes of 64 rows
                   const float* __restrict__ lse, const float* __restrict__ dsum,
                   bf16* __restrict__ dqkv, int N, int C, int H, int d, int ts, int hs,
                   float scale) {
  using L = Dkv<Dp>;
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  const uint32_t k_s = base;
  const uint32_t v_s = base + L::kKV;
  const uint32_t qd_s = base + 2 * L::kKV;  // stage s: Q, then dO
  const uint32_t kv_bar = base + L::kBars;
  const uint32_t full = kv_bar + 8;
  const uint32_t empty = full + 8 * kStages;
  // stage s: lse * log2 e, then D, of its 64 query rows
  float* stats = reinterpret_cast<float*>(smem + (base - smem_u32(smem)) + L::kStats);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int key0 = static_cast<int>(blockIdx.x) * L::kKeys;
  const int n_tiles = (N + kTileRows - 1) / kTileRows;
  const int wg = threadIdx.x / 128;
  const size_t C3 = 3 * static_cast<size_t>(C);

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: one warp stages the statistics, its lane 0 the tiles
    setmaxnreg_dec<Regs<Dp>::kProducer>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(kv_bar, 2 * L::kKV);
        tma_head<Dp>(k_s, &kv_map, kv_bar, ts + h * hs, key0, b, L::kKeys);
        tma_head<Dp>(v_s, &kv_map, kv_bar, 2 * ts + h * hs, key0, b, L::kKeys);
      }
      const size_t row = (static_cast<size_t>(b) * H + h) * N;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty + 8 * s, ((j / kStages) - 1) & 1);
        float* st = stats + s * 2 * kTileRows;
        for (int i = lane; i < kTileRows; i += 32) {
          const int n = j * kTileRows + i;
          st[i] = n < N ? lse[row + n] * kLog2e : 0.f;
          st[kTileRows + i] = n < N ? dsum[row + n] : 0.f;
        }
        if (lane == 0) {
          const uint32_t q_s = qd_s + s * 2 * L::kQ;
          mbar_expect_tx(full + 8 * s, 2 * L::kQ);
          tma_head<Dp>(q_s, &q_map, full + 8 * s, h * hs, j * kTileRows, b, kTileRows);
          tma_head<Dp>(q_s + L::kQ, &do_map, full + 8 * s, h, j * kTileRows, b, kTileRows);
        } else {
          mbar_arrive(full + 8 * s);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<Regs<Dp>::kConsumer>();
  const int tid = threadIdx.x % 128;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const float sl2 = scale * kLog2e;
  bf16* gk = dqkv + static_cast<size_t>(b) * N * C3 + static_cast<size_t>(ts + h * hs) * d + 2 * t;
  bf16* gv = gk + static_cast<size_t>(ts) * d;
  mbar_wait(kv_bar, 0);

  if constexpr (!L::kSplit) {  // warpgroup wg: dK and dV of keys 64 wg ..
    float dk[Dp / 2], dv[Dp / 2];
#pragma unroll
    for (int i = 0; i < Dp / 2; ++i) dk[i] = dv[i] = 0.f;

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(full + 8 * s, (j / kStages) & 1);
      const uint32_t q_s = qd_s + s * 2 * L::kQ;
      const uint32_t do_s = q_s + L::kQ;
      const float* st = stats + s * 2 * kTileRows;

      float sc[32], dp[32];  // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Dp / 16; ++kk)
        wgmma_ss_n64(sc, desc_k<Dp>(k_s, L::kKeys, wg * 64, kk),
                     desc_k<Dp>(q_s, kTileRows, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < Dp / 16; ++kk)
        wgmma_ss_n64(dp, desc_k<Dp>(v_s, L::kKeys, wg * 64, kk),
                     desc_k<Dp>(do_s, kTileRows, 0, kk), kk);
      wgmma_commit_wait();
      reg_fence(sc);
      reg_fence(dp);

      const int q0 = j * kTileRows;
      uint32_t pt[16], dst[16];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        float pa[2], pb[2], ga[2], gb[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 8 * jn + 2 * t + c;
          const bool in = q0 + i < N;
          const float lq = st[i], dq = st[kTileRows + i];
          pa[c] = in ? exp2f(fmaf(sc[4 * jn + c], sl2, -lq)) : 0.f;
          pb[c] = in ? exp2f(fmaf(sc[4 * jn + 2 + c], sl2, -lq)) : 0.f;
          ga[c] = pa[c] * (dp[4 * jn + c] - dq) * scale;
          gb[c] = pb[c] * (dp[4 * jn + 2 + c] - dq) * scale;
        }
        pt[2 * jn] = pack_bf16(pa[0], pa[1]);
        pt[2 * jn + 1] = pack_bf16(pb[0], pb[1]);
        dst[2 * jn] = pack_bf16(ga[0], ga[1]);
        dst[2 * jn + 1] = pack_bf16(gb[0], gb[1]);
      }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileRows / 16; ++kk) {
        WgmmaRs<Dp>::mma(dv, &pt[4 * kk], desc_mn<Dp>(do_s, kTileRows, kk));
        WgmmaRs<Dp>::mma(dk, &dst[4 * kk], desc_mn<Dp>(q_s, kTileRows, kk));
      }
      wgmma_commit_wait();
      reg_fence(dk);
      reg_fence(dv);
      mbar_arrive(empty + 8 * s);
    }

    const int na = key0 + wg * 64 + (tid / 32) * 16 + g, nb = na + 8;
#pragma unroll
    for (int jn = 0; jn < Dp / 8; ++jn) {
      if (8 * jn >= d) break;
      if (na < N) {
        store2(gk + na * C3 + 8 * jn, dk[4 * jn], dk[4 * jn + 1]);
        store2(gv + na * C3 + 8 * jn, dv[4 * jn], dv[4 * jn + 1]);
      }
      if (nb < N) {
        store2(gk + nb * C3 + 8 * jn, dk[4 * jn + 2], dk[4 * jn + 3]);
        store2(gv + nb * C3 + 8 * jn, dv[4 * jn + 2], dv[4 * jn + 3]);
      }
    }
  } else {  // the block's 64 keys: warpgroup 0 their dV, warpgroup 1 their dK
    float acc[Dp / 2];
#pragma unroll
    for (int i = 0; i < Dp / 2; ++i) acc[i] = 0.f;

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(full + 8 * s, (j / kStages) & 1);
      const uint32_t q_s = qd_s + s * 2 * L::kQ;
      const uint32_t do_s = q_s + L::kQ;
      const float* st = stats + s * 2 * kTileRows;
      const int q0 = j * kTileRows;

      float sc[32];  // S^T = K Q^T, 64 keys x 64 rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Dp / 16; ++kk)
        wgmma_ss_n64(sc, desc_k<Dp>(k_s, L::kKeys, 0, kk), desc_k<Dp>(q_s, kTileRows, 0, kk),
                     kk);
      if (wg == 0) {  // dV += round(P^T) dO
        wgmma_commit_wait();
        reg_fence(sc);
        uint32_t pt[16];
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          float pa[2], pb[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = 8 * jn + 2 * t + c;
            const bool in = q0 + i < N;
            pa[c] = in ? exp2f(fmaf(sc[4 * jn + c], sl2, -st[i])) : 0.f;
            pb[c] = in ? exp2f(fmaf(sc[4 * jn + 2 + c], sl2, -st[i])) : 0.f;
          }
          pt[2 * jn] = pack_bf16(pa[0], pa[1]);
          pt[2 * jn + 1] = pack_bf16(pb[0], pb[1]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTileRows / 16; ++kk)
          WgmmaRs<Dp>::mma(acc, &pt[4 * kk], desc_mn<Dp>(do_s, kTileRows, kk));
      } else {  // dK += round(dS^T) Q, dS^T = P^T (dP^T - D) scale
        float dp[32];  // dP^T = V dO^T
#pragma unroll
        for (int kk = 0; kk < Dp / 16; ++kk)
          wgmma_ss_n64(dp, desc_k<Dp>(v_s, L::kKeys, 0, kk), desc_k<Dp>(do_s, kTileRows, 0, kk),
                       kk);
        wgmma_commit_wait();
        reg_fence(sc);
        reg_fence(dp);
        uint32_t dst[16];
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          float ga[2], gb[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = 8 * jn + 2 * t + c;
            const bool in = q0 + i < N;
            const float lq = st[i], dq = st[kTileRows + i];
            const float pa = in ? exp2f(fmaf(sc[4 * jn + c], sl2, -lq)) : 0.f;
            const float pb = in ? exp2f(fmaf(sc[4 * jn + 2 + c], sl2, -lq)) : 0.f;
            ga[c] = pa * (dp[4 * jn + c] - dq) * scale;
            gb[c] = pb * (dp[4 * jn + 2 + c] - dq) * scale;
          }
          dst[2 * jn] = pack_bf16(ga[0], ga[1]);
          dst[2 * jn + 1] = pack_bf16(gb[0], gb[1]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTileRows / 16; ++kk)
          WgmmaRs<Dp>::mma(acc, &dst[4 * kk], desc_mn<Dp>(q_s, kTileRows, kk));
      }
      wgmma_commit_wait();
      reg_fence(acc);
      mbar_arrive(empty + 8 * s);
    }

    const int na = key0 + (tid / 32) * 16 + g, nb = na + 8;
    bf16* gw = wg == 0 ? gv : gk;
#pragma unroll
    for (int jn = 0; jn < Dp / 8; ++jn) {
      if (8 * jn >= d) break;
      if (na < N) store2(gw + na * C3 + 8 * jn, acc[4 * jn], acc[4 * jn + 1]);
      if (nb < N) store2(gw + nb * C3 + 8 * jn, acc[4 * jn + 2], acc[4 * jn + 3]);
    }
  }
}

// ------------------------------------------------------------------ launch

// A map over the 3 H slots of a contiguous (B, N, 3C) qkv, or the H of a
// (B, N, C) tensor (`parts` 3 or 1), boxes of `rows` rows.
template <int Dp>
int head_map(CUtensorMap* map, const void* ptr, int parts, int B, int N, int C, int H,
             int rows) {
  const long long row = static_cast<long long>(parts) * C;
  return make_head_map<Dp>(map, ptr, C / H, parts * H, N, row, B, row * N, rows);
}

template <int Dp>
int launch_fwd(const void* qkv, void* out, float* lse, int B, int N, int C, int H,
               bool head_major, cudaStream_t stream) {
  CUtensorMap q_map, kv_map;
  int err = head_map<Dp>(&q_map, qkv, 3, B, N, C, H, kBlockRows);
  if (err == cudaSuccess) err = head_map<Dp>(&kv_map, qkv, 3, B, N, C, H, Fwd<Dp>::kKeys);
  if (err == cudaSuccess) err = allow_smem(fwd_kernel<Dp>, Fwd<Dp>::kSmem);
  if (err != cudaSuccess) return err;
  const int d = C / H;
  const dim3 grid((N + kBlockRows - 1) / kBlockRows, H, B);
  fwd_kernel<Dp><<<grid, kThreads, Fwd<Dp>::kSmem, stream>>>(
      q_map, kv_map, static_cast<bf16*>(out), lse, N, C, H, d, head_major ? 1 : H,
      head_major ? 3 : 1, 1.0f / sqrtf(static_cast<float>(d)));
  return cudaGetLastError();
}

// q, k and v: (B, N, slots, d) bf16 with element strides (batch, row), d
// between slots and unit stride along d; head h at slot *_slot + h *
// head_stride.
struct ShortArgs {
  const void *q, *k, *v;
  int q_slot, k_slot, v_slot, slots, head_stride, d;
  long long batch, row;
};

template <int Dp, int NT>
int launch_short_nt(const ShortArgs& a, void* out, float* lse, int B, int N, int C, int H,
                    cudaStream_t stream) {
  if constexpr (Short<Dp, NT>::kSmem > kSmemLimit) {
    return cudaErrorInvalidValue;  // the route sends such shapes to the tiled forward
  } else {
    CUtensorMap q_map, k_map, v_map;
    int err = make_head_map<Dp>(&q_map, a.q, a.d, a.slots, N, a.row, B, a.batch, 64);
    if (err == cudaSuccess)
      err = make_head_map<Dp>(&k_map, a.k, a.d, a.slots, N, a.row, B, a.batch, 64 * NT);
    if (err == cudaSuccess)
      err = make_head_map<Dp>(&v_map, a.v, a.d, a.slots, N, a.row, B, a.batch, 64 * NT);
    if (err == cudaSuccess) err = allow_smem(short_fwd_kernel<Dp, NT>, Short<Dp, NT>::kSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + 63) / 64, H, B);
    short_fwd_kernel<Dp, NT><<<grid, 128, Short<Dp, NT>::kSmem, stream>>>(
        q_map, k_map, v_map, a.q_slot, a.k_slot, a.v_slot, a.head_stride,
        static_cast<bf16*>(out), lse, N, C, H, a.d, 1.0f / sqrtf(static_cast<float>(a.d)));
    return cudaGetLastError();
  }
}

template <int Dp>
int launch_short(const ShortArgs& a, void* out, float* lse, int B, int N, int C, int H,
                 cudaStream_t stream) {
  switch ((N + 63) / 64) {
    case 1: return launch_short_nt<Dp, 1>(a, out, lse, B, N, C, H, stream);
    case 2: return launch_short_nt<Dp, 2>(a, out, lse, B, N, C, H, stream);
    case 3: return launch_short_nt<Dp, 3>(a, out, lse, B, N, C, H, stream);
    case 4: return launch_short_nt<Dp, 4>(a, out, lse, B, N, C, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int Dp>
int launch_bwd(const void* qkv, const void* out, const void* dout, const float* lse,
               float* dsum, void* dqkv, int B, int N, int C, int H, bool head_major,
               int exact_d, cudaStream_t stream) {
  CUtensorMap qkv128, qkv64, do128, do64;
  int err = head_map<Dp>(&qkv128, qkv, 3, B, N, C, H, kBlockRows);
  if (err == cudaSuccess) err = head_map<Dp>(&qkv64, qkv, 3, B, N, C, H, kTileRows);
  if (err == cudaSuccess) err = head_map<Dp>(&do128, dout, 1, B, N, C, H, kBlockRows);
  if (err == cudaSuccess) err = head_map<Dp>(&do64, dout, 1, B, N, C, H, kTileRows);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_kernel<Dp>, Dq<Dp>::kSmem);
  if (err == cudaSuccess) err = allow_smem(bwd_dkv_kernel<Dp>, Dkv<Dp>::kSmem);
  if (err != cudaSuccess) return err;
  const int d = C / H;
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  bf16* g = static_cast<bf16*>(dqkv);
  const int ts = head_major ? 1 : H, hs = head_major ? 3 : 1;
  const dim3 grid_q((N + kBlockRows - 1) / kBlockRows, H, B);
  bwd_dq_kernel<Dp><<<grid_q, kThreads, Dq<Dp>::kSmem, stream>>>(
      qkv128, qkv64, do128, static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse,
      dsum, g, N, C, H, d, ts, hs, scale, exact_d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((N + Dkv<Dp>::kKeys - 1) / Dkv<Dp>::kKeys, H, B);
  bwd_dkv_kernel<Dp><<<grid_kv, kThreads, Dkv<Dp>::kSmem, stream>>>(
      Dkv<Dp>::kSplit ? qkv64 : qkv128, qkv64, do64, lse, dsum, g, N, C, H, d, ts, hs, scale);
  return cudaGetLastError();
}

#define PROBPOSE_SM90_FWD_SIG(Dp)                                                        \
  int launch_fwd<Dp>(const void* qkv, void* out, float* lse, int B, int N, int C, int H, \
                     bool head_major, cudaStream_t stream)
#define PROBPOSE_SM90_SHORT_SIG(Dp)                                                      \
  int launch_short<Dp>(const ShortArgs& a, void* out, float* lse, int B, int N, int C,   \
                       int H, cudaStream_t stream)
#define PROBPOSE_SM90_BWD_SIG(Dp)                                                        \
  int launch_bwd<Dp>(const void* qkv, const void* out, const void* dout, const float* lse, \
                     float* dsum, void* dqkv, int B, int N, int C, int H, bool head_major, \
                     int exact_d, cudaStream_t stream)
#define PROBPOSE_SM90_EXTERN(Dp)               \
  extern template PROBPOSE_SM90_FWD_SIG(Dp);   \
  extern template PROBPOSE_SM90_SHORT_SIG(Dp); \
  extern template PROBPOSE_SM90_BWD_SIG(Dp);
#define PROBPOSE_SM90_INST(Dp)          \
  template PROBPOSE_SM90_FWD_SIG(Dp);   \
  template PROBPOSE_SM90_SHORT_SIG(Dp); \
  template PROBPOSE_SM90_BWD_SIG(Dp);

}  // namespace probpose_sm90
