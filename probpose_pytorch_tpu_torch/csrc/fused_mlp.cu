// Kernel K5 on the CUDA cores: the ViT block's second half fused per row,
//   out = x + fc2(gelu(fc1(LayerNorm(x)))),
// its forward and its recompute backward (FMA, no TF32), in float32 at
// every width and in bf16 at the widths the wgmma kernels of
// csrc/fused_mlp_sm90.cu do not take (a C or a hidden width that is no
// multiple of 8).
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel`
// (probpose_pytorch_tpu/ops/pallas/mlp_kernel.py, called from `_fwd` / `_bwd`
// under the custom_vjp `fused_ln_mlp`), which take any (R, C) and any hidden
// width. Per row, as `_tile_forward` does: f32 LayerNorm with the two-pass
// variance and eps 1e-6; u = y W1 + b1; GELU (tanh, or erf); o = h W2 + b2;
// o + x. The (rows, hidden) state never reaches device memory. In bf16 the
// values are rounded where the sm90 kernel rounds them: y and h before their
// products (the TPU kernel's points), dh and du before theirs, dy before the
// LayerNorm backward, dW1 and dW2 once after their f32 sums; sums and
// everything else stay f32 (plain twins: fused_ln_mlp_reference and
// fused_ln_mlp_bwd_kernel_order_reference).
//
// Weights arrive in nn.Linear's layout: w1t = W1^T (Hd, C), w2t = W2^T
// (C, Hd), both row-major; the gradients dW1^T and dW2^T come back in the
// same layout.
//
// What bounds it on an H100: at ViT-B widths each row costs 4 C Hd FLOPs
// forward against 8 C bytes in and out, far above the ridge of the CUDA
// cores' 67 TFLOP/s: the FMA rate bounds it. The design keeps row tiles of
// FR rows (16, or 8 past C = 1280, where two f32 (16, C) tiles would not fit
// shared memory), 256 hidden columns a chunk (one per thread), and stages
// weight slabs transposed in shared memory where a thread's reads would
// stride. Every load is scalar, so no width needs 16-byte rows; the tails of
// C (slabs of 32 columns) and of the hidden width (chunks of 256, blocks of
// 8) are predicated, zeros past the edge.
//
// The backward, per row (g = dO):
//   dh = g W2^T;  du = dh * gelu'(u);  dy = du W1^T
//   dx = g + rstd (dy*s - mean(dy*s) - xhat mean(dy*s*xhat))
//   dW1 = y^T du, dW2 = h^T g, db1 = sum du, db2 = sum g,
//   dscale = sum dy*xhat, dbias = sum dy
// in three launches, no atomics, so two runs give the same bits:
//   rows pass    one block per FR-row tile: recomputes u, dh, du chunk by
//                chunk, accumulates dy in registers, then the LayerNorm
//                backward writes dx; per-tile partial sums of dscale, dbias
//                and db2. It also leaves y and g in a zero-padded f32 scratch.
//   weights pass one block per (8 hidden columns, 1,024-row chunk):
//                recomputes u and dh of its columns tile by tile and
//                accumulates dW1^T and dW2^T of those columns in registers;
//                writes f32 partials per row chunk.
//   reduction    sums the partials of each gradient in chunk order.
//
// The kernels live in csrc/fused_mlp.cuh; this unit instantiates float32
// and csrc/fused_mlp_bf16.cu bf16, which nvcc builds side by side.
//
// Shapes: 1 <= C <= 2048 (eight output columns a thread), 1 <= Hd <= 8192.
// Plain-C interface, loaded with ctypes (ops/kernels/mlp.py); every entry
// point returns a cudaError_t as int (0 = success). dtype codes: 0 float32,
// 1 bfloat16.

#include "fused_mlp.cuh"

namespace probpose_k5cc {

// bf16 is instantiated in csrc/fused_mlp_bf16.cu.
extern template PROBPOSE_K5CC_FWD_SIG(__nv_bfloat16, 16);
extern template PROBPOSE_K5CC_FWD_SIG(__nv_bfloat16, 8);
extern template PROBPOSE_K5CC_BWD_SIG(__nv_bfloat16, 16);
extern template PROBPOSE_K5CC_BWD_SIG(__nv_bfloat16, 8);

}  // namespace probpose_k5cc

using namespace probpose_k5cc;

// Bytes of `work` the backward takes at (R, C, Hd); -1 for a shape it does
// not take.
extern "C" long long fused_mlp_cc_bwd_workspace_bytes(int R, int C, int Hd) {
  if (!supported(C, Hd) || R <= 0) return -1;
  return static_cast<long long>(workspace(R, C, Hd).bytes);
}

// x (R, C) -> out (R, C), in dtype (0 float32, 1 bfloat16) like w1t (Hd, C)
// and w2t (C, Hd); scale, bias, b1, b2 float32.
extern "C" int fused_mlp_cc_fwd(const void* x, const float* scale, const float* bias,
                                const void* w1t, const float* b1, const void* w2t,
                                const float* b2, void* out, int R, int C, int Hd, int exact,
                                int dtype, int device, void* stream) {
  if (!supported(C, Hd) || R <= 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = tile_rows(C) == 8;
  if (dtype == 0)
    return wide ? fwd<float, 8>(x, scale, bias, w1t, b1, w2t, b2, out, R, C, Hd, exact, s)
                : fwd<float, 16>(x, scale, bias, w1t, b1, w2t, b2, out, R, C, Hd, exact, s);
  return wide ? fwd<__nv_bfloat16, 8>(x, scale, bias, w1t, b1, w2t, b2, out, R, C, Hd, exact, s)
              : fwd<__nv_bfloat16, 16>(x, scale, bias, w1t, b1, w2t, b2, out, R, C, Hd, exact, s);
}

// Backward: dout (R, C) -> dx (R, C), dw1t (Hd, C), dw2t (C, Hd) in dtype,
// dscale, dbias, db2 (C,) and db1 (Hd,) float32. `work` holds
// fused_mlp_cc_bwd_workspace_bytes(R, C, Hd), which `work_bytes` must be.
extern "C" int fused_mlp_cc_bwd(const void* x, const float* scale, const float* bias,
                                const void* w1t, const float* b1, const void* w2t,
                                const void* dout, void* dx, float* dscale, float* dbias,
                                void* dw1t, float* db1, void* dw2t, float* db2, void* work,
                                long long work_bytes, int R, int C, int Hd, int exact, int dtype,
                                int device, void* stream) {
  if (!supported(C, Hd) || R <= 0 || (dtype != 0 && dtype != 1) ||
      work_bytes != static_cast<long long>(workspace(R, C, Hd).bytes))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = tile_rows(C) == 8;
#define PROBPOSE_BWD(T, FR)                                                                   \
  bwd<T, FR>(x, scale, bias, w1t, b1, w2t, dout, dx, dscale, dbias, dw1t, db1, dw2t, db2, work, \
             R, C, Hd, exact, s)
  if (dtype == 0) return wide ? PROBPOSE_BWD(float, 8) : PROBPOSE_BWD(float, 16);
  return wide ? PROBPOSE_BWD(__nv_bfloat16, 8) : PROBPOSE_BWD(__nv_bfloat16, 16);
#undef PROBPOSE_BWD
}
