// Kernel K4 on the CUDA cores, the launchers of the forward, both dtypes at every
// instantiated column count (csrc/tiled_attention.cuh; the design and the
// plain-C interface are csrc/tiled_attention.cu's).

#include "tiled_attention.cuh"

namespace probpose_k4cc {

PROBPOSE_K4CC_COLUMNS(PROBPOSE_K4CC_FWD_INST, float)
PROBPOSE_K4CC_COLUMNS(PROBPOSE_K4CC_FWD_INST, __nv_bfloat16)

}  // namespace probpose_k4cc
