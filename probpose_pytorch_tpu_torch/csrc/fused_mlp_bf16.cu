// Kernel K5 on the CUDA cores, the bf16 launchers at both row tiles
// (csrc/fused_mlp.cuh; the design and the plain-C interface are
// csrc/fused_mlp.cu's).

#include "fused_mlp.cuh"

namespace probpose_k5cc {

template PROBPOSE_K5CC_FWD_SIG(__nv_bfloat16, 16);
template PROBPOSE_K5CC_FWD_SIG(__nv_bfloat16, 8);
template PROBPOSE_K5CC_BWD_SIG(__nv_bfloat16, 16);
template PROBPOSE_K5CC_BWD_SIG(__nv_bfloat16, 8);

}  // namespace probpose_k5cc
