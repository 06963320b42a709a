// Kernel K4 on the CUDA cores, the launchers of the forward, both dtypes at every
// instantiated column count and past d = 256 (csrc/tiled_attention.cuh; the design and the
// plain-C interface are csrc/tiled_attention.cu's).

#include "tiled_attention.cuh"

namespace probpose_k4cc {

PROBPOSE_K4CC_COLUMNS(PROBPOSE_K4CC_FWD_INST, float)
PROBPOSE_K4CC_COLUMNS(PROBPOSE_K4CC_FWD_INST, __nv_bfloat16)
template PROBPOSE_K4CC_WIDE_FWD_SIG(float);
template PROBPOSE_K4CC_WIDE_FWD_SIG(__nv_bfloat16);

}  // namespace probpose_k4cc
