"""Kernel K3: the fused expected-value decode, in CUDA C++ (csrc/decode.cu).

Replaces the TPU kernel `_decode_kernel` of
probpose_pytorch_tpu/ops/pallas/decode_kernel.py, whose public function is
`expected_value_decode_pallas`. It computes what
`ops.heatmap.expected_value_decode` computes -- the separable reflect OKS
convolution, the first-occurrence argmax, the sub-pixel Taylor step and the
raw value at the integer argmax -- in one launch that writes only the
(x, y) and value of each map. That plain function is its plain version.

As in the JAX package, no serving or training path calls it: the port's
decode stays the plain one, and this kernel is the fused alternative for
large heatmaps (192 x 192 from 768 x 768 crops). The wrapper takes the plain
version for a CPU tensor and launches the kernel, or raises, for a CUDA
tensor.
"""

from __future__ import annotations

import ctypes

import torch

from probpose_pytorch_tpu_torch.ops import kernels
from probpose_pytorch_tpu_torch.ops.heatmap import expected_value_decode

__all__ = ["expected_value_decode_fused"]


def _lib() -> ctypes.CDLL:
    from probpose_pytorch_tpu_torch.ops.kernels._build import library

    lib = library()
    if not getattr(lib, "_decode_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.expected_value_decode_fwd.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
        lib.expected_value_decode_fwd.restype = i32
        lib.decode_smem_bytes.argtypes = [i32, i32]
        lib.decode_smem_bytes.restype = ctypes.c_longlong
        lib._decode_bound = True
    return lib


def expected_value_decode_fused(heatmaps: torch.Tensor, row_op: torch.Tensor,
                                col_op: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, K, H, W) float32 heatmaps with their (K, H, H) and (K, W, W) OKS
    operators -> locs (B, K, 2) and vals (B, K), as `expected_value_decode`
    gives them: the counterpart of the JAX `expected_value_decode_pallas`."""
    if heatmaps.dim() != 4:
        raise ValueError(f"expected_value_decode_fused: heatmaps must be (B, K, H, W), "
                         f"got {tuple(heatmaps.shape)}")
    B, K, H, W = heatmaps.shape
    if tuple(row_op.shape) != (K, H, H) or tuple(col_op.shape) != (K, W, W):
        raise ValueError(f"expected_value_decode_fused: operators {tuple(row_op.shape)}, "
                         f"{tuple(col_op.shape)} do not fit heatmaps {tuple(heatmaps.shape)}")
    for t in (heatmaps, row_op, col_op):
        if t.dtype != torch.float32 or t.device != heatmaps.device:
            raise TypeError("expected_value_decode_fused: heatmaps and operators must be "
                            "float32 on one device")
    if kernels.use_plain(heatmaps, "expected_value_decode_fused"):
        return expected_value_decode(heatmaps, row_op, col_op)
    if 0 in heatmaps.shape:
        raise ValueError(f"expected_value_decode_fused: empty heatmaps {tuple(heatmaps.shape)}")
    from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import max_shared_memory

    heatmaps, row_op, col_op = (t.contiguous() for t in (heatmaps, row_op, col_op))
    device = heatmaps.device.index if heatmaps.device.index is not None \
        else torch.cuda.current_device()
    lib = _lib()
    need, limit = lib.decode_smem_bytes(H, W), max_shared_memory(device)
    if need > limit:
        raise ValueError(f"expected_value_decode_fused: {H} x {W} maps need {need} bytes of "
                         f"shared memory, the card allows {limit}")
    if B * K > 2**31 - 1:
        raise ValueError(f"expected_value_decode_fused: {B * K} maps exceed the grid")
    locs = torch.empty((B, K, 2), dtype=torch.float32, device=heatmaps.device)
    vals = torch.empty((B, K), dtype=torch.float32, device=heatmaps.device)
    err = lib.expected_value_decode_fwd(
        heatmaps.data_ptr(), row_op.data_ptr(), col_op.data_ptr(), locs.data_ptr(),
        vals.data_ptr(), B, K, H, W, device,
        torch.cuda.current_stream(heatmaps.device).cuda_stream)
    if err:
        raise RuntimeError(f"expected_value_decode_fused: kernel launch failed with cudaError "
                           f"{err} at heatmaps {tuple(heatmaps.shape)}")
    expected_value_decode_fused.launches += 1
    return locs, vals


expected_value_decode_fused.launches = 0
