// bf16 attention for Hopper, the launchers at padded head widths 64 and 208
// (csrc/tiled_attention_sm90.cuh; the design and the plain-C interface are
// csrc/tiled_attention_sm90.cu's).

#include "tiled_attention_sm90.cuh"

namespace probpose_sm90 {

PROBPOSE_SM90_INST(64)
PROBPOSE_SM90_INST(208)

}  // namespace probpose_sm90
