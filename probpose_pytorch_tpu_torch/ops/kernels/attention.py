"""Kernel K1 forward: packed multi-head attention, and its plain version.

Replaces the TPU kernel `_packed_fwd_kernel` of
probpose_pytorch_tpu/ops/pallas/attention_kernel.py (`packed_attention`,
qkv-major layout). The CUDA source, with the note on what bounds it on the
card and how its design answers that, is csrc/packed_attention.cu: bf16
inputs with d in {32, 64, 128} and N <= 256 run on the tensor cores, all
other shapes on the CUDA cores (`kernel_path` says which).

`packed_attention(qkv, heads)` takes the (B, N, 3C) output of the qkv
projection as it is and returns the (B, N, C) context:
  * CPU tensor  -> `packed_attention_reference` (plain PyTorch);
  * CUDA tensor -> the CUDA kernel, or an error for anything it does not take.
Shapes the kernel cannot hold in shared memory raise; the long-sequence
kernel (K4) that would serve them is still to be ported.
"""

from __future__ import annotations

import ctypes

import torch

from probpose_pytorch_tpu_torch.ops import kernels

__all__ = ["packed_attention", "packed_attention_reference", "kernel_path"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def packed_attention_reference(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain version: `_einsum_packed_attention` (attention_kernel.py:335)
    with the f32 softmax. q.k and P.V accumulate in f32; P is rounded to
    qkv's dtype before P.V; the context comes back in qkv's dtype."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    d = C // heads
    q, k, v = qkv.reshape(B, N, 3, heads, d).unbind(2)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * (1.0 / d**0.5)
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float())
    return out.reshape(B, N, C).to(qkv.dtype)


def _lib() -> ctypes.CDLL:
    from probpose_pytorch_tpu_torch.ops.kernels._build import library

    lib = library()
    if not getattr(lib, "_attention_bound", False):
        lib.packed_attention_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.packed_attention_fwd.restype = ctypes.c_int
        lib.packed_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.packed_attention_smem_bytes.restype = ctypes.c_longlong
        lib.packed_attention_max_smem.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        lib.packed_attention_max_smem.restype = ctypes.c_int
        lib.packed_attention_uses_mma.argtypes = [ctypes.c_int] * 3
        lib.packed_attention_uses_mma.restype = ctypes.c_int
        lib._attention_bound = True
    return lib


def kernel_path(N: int, d: int, dtype: torch.dtype) -> str:
    """Which CUDA path serves (N, d, dtype): "tensor cores" or "CUDA cores"."""
    return ("tensor cores" if _lib().packed_attention_uses_mma(N, d, _DTYPES[dtype])
            else "CUDA cores")


def _check(qkv: torch.Tensor, heads: int) -> None:
    if qkv.dim() != 3:
        raise ValueError(f"packed_attention: qkv must be (B, N, 3C), got {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    if C3 % 3 or (C3 // 3) % heads:
        raise ValueError(
            f"packed_attention: last dim {C3} is not 3 * heads({heads}) * d"
        )
    if qkv.dtype not in _DTYPES:
        raise TypeError(
            f"packed_attention: dtype {qkv.dtype} not supported "
            "(float32 or bfloat16)"
        )
    if not qkv.is_contiguous():
        raise ValueError("packed_attention: qkv must be contiguous")
    if B == 0 or N == 0:
        raise ValueError(f"packed_attention: empty qkv {tuple(qkv.shape)}")
    if B > 65535:
        raise ValueError(f"packed_attention: batch {B} exceeds the grid's 65535")


def packed_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v per head from packed (B, N, 3C) qkv."""
    _check(qkv, heads)
    if qkv.device.type == "cpu" or (qkv.is_cuda and kernels.plain_enabled()):
        return packed_attention_reference(qkv, heads)
    if not qkv.is_cuda:
        raise ValueError(f"packed_attention: unsupported device {qkv.device}")
    B, N, C3 = qkv.shape
    C = C3 // 3
    d = C // heads
    code = _DTYPES[qkv.dtype]
    lib = _lib()
    device = qkv.device.index if qkv.device.index is not None else torch.cuda.current_device()
    limit = ctypes.c_int(0)
    err = lib.packed_attention_max_smem(device, ctypes.byref(limit))
    if err:
        raise RuntimeError(f"packed_attention: cudaDeviceGetAttribute failed ({err})")
    need = lib.packed_attention_smem_bytes(N, d, code)
    if need > limit.value:
        raise ValueError(
            f"packed_attention: N={N}, d={d} ({qkv.dtype}) needs {need} bytes "
            f"of shared memory, the card allows {limit.value}; the "
            "long-sequence kernel K4 is not ported yet"
        )
    if qkv.data_ptr() % 16:
        raise ValueError("packed_attention: qkv must be 16-byte aligned")
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    err = lib.packed_attention_fwd(
        qkv.data_ptr(), out.data_ptr(), B, N, C, heads, code, device,
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"packed_attention: kernel launch failed with cudaError {err} "
            f"at qkv {tuple(qkv.shape)} {qkv.dtype}"
        )
    packed_attention.launches += 1
    return out


packed_attention.launches = 0
