// Kernel K4 on the CUDA cores: row-tiled multi-head attention for long
// sequences, its forward and its recompute backward, read straight from the
// packed qkv, in float32 at every head width and in bf16 at every head
// width that the wgmma kernels do not take (bf16 with d a multiple of 8 in
// [16, 256], the path every shipped model runs, is the wgmma + TMA design of
// csrc/tiled_attention_sm90.cu).
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
// warp per 16 rows, its Q rows staged once; where d's staged f32 tiles
// exceed the card's shared memory (the backward past d = 128, the forward
// past d = 225 on an H100) it owns 32, then 16 rows (`pick_warps`), which
// changes no row's arithmetic. The forward makes two sweeps over the key
// tiles:
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
// over d for the accumulating products: a lane owns columns lane + 32 t,
// t < NC, the kernels' one template parameter (d = 80: lanes 0-15 take a
// third column each), with d itself a run-time value: NC in {1, 2, 3, 4, 6,
// 8} (ceil(d / 32) rounded up to one of them) covers every width with six
// instantiations a kernel and dtype, the widths a preset has at their own
// NC. Past d = 160 the two accumulators of the dK/dV pass exceed the
// registers and spill: those widths are taken for coverage, not speed.
// Past d = 256 (`wide_*` kernels, templated on the dtype alone) a tile holds
// 128 columns of the head at a time: each score sums over the column
// chunks in registers, one pass over the d columns in order, and each
// product that yields d columns (O, dQ, dK, dV) sweeps the other side once
// a chunk of 128 of its columns with four columns a lane, recomputing the
// scores; no row's order differs from the kernels below d = 256, the
// scores cost ceil(d / 128) times as much, and four warps fit at every d.
// The JAX package runs such widths (its row-tiled kernel takes any d whose
// tiles fit its VMEM), so the port takes them too. The
// kernels live in csrc/tiled_attention.cuh and are instantiated in three
// units (forward; backward f32; backward bf16) that nvcc builds side by
// side.
//
// Plain-C interface, loaded with ctypes (ops/kernels/attention_tiled.py).
// Every entry point returns a cudaError_t as int (0 = success).

#include "tiled_attention.cuh"

namespace probpose_k4cc {

// The launchers are instantiated in tiled_attention_fwd.cu and
// tiled_attention_bwd_{f32,bf16}.cu.
PROBPOSE_K4CC_COLUMNS(PROBPOSE_K4CC_FWD_EXTERN, float)
PROBPOSE_K4CC_COLUMNS(PROBPOSE_K4CC_FWD_EXTERN, __nv_bfloat16)
PROBPOSE_K4CC_COLUMNS(PROBPOSE_K4CC_BWD_EXTERN, float)
PROBPOSE_K4CC_COLUMNS(PROBPOSE_K4CC_BWD_EXTERN, __nv_bfloat16)
extern template PROBPOSE_K4CC_WIDE_FWD_SIG(float);
extern template PROBPOSE_K4CC_WIDE_FWD_SIG(__nv_bfloat16);
extern template PROBPOSE_K4CC_WIDE_BWD_SIG(float);
extern template PROBPOSE_K4CC_WIDE_BWD_SIG(__nv_bfloat16);

namespace {

#define PROBPOSE_BY_COLUMNS(CALL)          \
  switch (columns(d)) {                    \
    case 1: return CALL(1);                \
    case 2: return CALL(2);                \
    case 3: return CALL(3);                \
    case 4: return CALL(4);                \
    case 6: return CALL(6);                \
    case 8: return CALL(8);                \
    default: return cudaErrorInvalidValue; \
  }

template <typename T>
int fwd_any(const void* qkv, void* out, int B, int N, int C, int heads, bool head_major,
            int warps, cudaStream_t s) {
  const int d = C / heads;
  if (d > kMaxD) return launch_wide_fwd<T>(qkv, out, B, N, C, heads, head_major, warps, s);
#define PROBPOSE_FWD(NC) launch_fwd<T, NC>(qkv, out, B, N, C, heads, head_major, warps, s)
  PROBPOSE_BY_COLUMNS(PROBPOSE_FWD)
#undef PROBPOSE_FWD
}

template <typename T>
int bwd_any(const void* qkv, const void* dout, void* dqkv, float* st, int B, int N, int C,
            int heads, bool head_major, int warps, cudaStream_t s) {
  const int d = C / heads;
  if (d > kMaxD)
    return launch_wide_bwd<T>(qkv, dout, dqkv, st, B, N, C, heads, head_major, warps, s);
#define PROBPOSE_BWD(NC) \
  launch_bwd<T, NC>(qkv, dout, dqkv, st, B, N, C, heads, head_major, warps, s)
  PROBPOSE_BY_COLUMNS(PROBPOSE_BWD)
#undef PROBPOSE_BWD
}

#undef PROBPOSE_BY_COLUMNS

}  // namespace
}  // namespace probpose_k4cc

using namespace probpose_k4cc;

// Every head width d >= 1 in float32 (dtype 0) and bf16 (dtype 1); bf16 at
// the wgmma widths runs csrc/tiled_attention_sm90.cu instead. Shared memory
// holds f32 in both, so the tile depends on d alone.

// Warps a block (16 query rows each: 4, 2 or 1) of the forward (backward =
// 0) or of the backward's passes (1) at head width d on a card whose opt-in
// shared memory per block is `limit` bytes; 0 where none fits.
extern "C" int tiled_attention_warps(int d, int backward, long long limit) {
  return pick_warps(d, backward != 0, limit);
}

// Shared memory of that launch at `warps` warps; -1 for a d it does not take.
extern "C" long long tiled_attention_smem_bytes(int d, int backward, int warps) {
  if (d < 1 || (warps != 1 && warps != 2 && warps != 4)) return -1;
  return static_cast<long long>(Geo{d, warps}.smem(backward != 0));
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
  const int warps = pick_warps(C / heads, false, device_smem_limit(device));
  if (warps == 0) return cudaErrorInvalidValue;
  if (dtype == 0) return fwd_any<float>(qkv, out, B, N, C, heads, head_major, warps, s);
  if (dtype == 1)
    return fwd_any<__nv_bfloat16>(qkv, out, B, N, C, heads, head_major, warps, s);
  return cudaErrorInvalidValue;
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
  const int warps = pick_warps(C / heads, true, device_smem_limit(device));
  if (warps == 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return bwd_any<float>(qkv, dout, dqkv, st, B, N, C, heads, head_major, warps, s);
  if (dtype == 1)
    return bwd_any<__nv_bfloat16>(qkv, dout, dqkv, st, B, N, C, heads, head_major, warps, s);
  return cudaErrorInvalidValue;
}
