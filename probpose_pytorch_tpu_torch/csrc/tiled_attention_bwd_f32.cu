// Kernel K4 on the CUDA cores, the launchers of the backward (dQ and dK/dV passes), float32 at every
// instantiated column count and past d = 256 (csrc/tiled_attention.cuh; the design and the
// plain-C interface are csrc/tiled_attention.cu's).

#include "tiled_attention.cuh"

namespace probpose_k4cc {

PROBPOSE_K4CC_COLUMNS(PROBPOSE_K4CC_BWD_INST, float)
template PROBPOSE_K4CC_WIDE_BWD_SIG(float);

}  // namespace probpose_k4cc
