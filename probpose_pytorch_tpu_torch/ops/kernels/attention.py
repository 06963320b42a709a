"""Kernel K1: packed multi-head attention, forward and backward, and their
plain versions.

Replaces the TPU kernels `_packed_fwd_kernel` and `_packed_bwd_kernel` of
probpose_pytorch_tpu/ops/pallas/attention_kernel.py (`packed_attention`, a
`jax.custom_vjp` whose backward recomputes the scores, qkv-major layout).
The CUDA source, with the note on what bounds each pass on the card and how
its design answers that, is csrc/packed_attention.cu: bf16 inputs with d in
{32, 64, 128} and N <= 256 run on the tensor cores, all other shapes on the
CUDA cores (`kernel_path` says which).

`packed_attention(qkv, heads)` takes the (B, N, 3C) output of the qkv
projection as it is and returns the (B, N, C) context. It is a
`torch.autograd.Function` that saves qkv, as the JAX custom_vjp does (and,
on K4's bf16 route, the context and its log-sum-exp for K4's backward);
its backward is `packed_attention_backward`, which writes dqkv straight in
the packed layout. Both wrappers:
  * CPU tensor  -> the plain version (`packed_attention_reference`,
                   `packed_attention_bwd_reference`);
  * CUDA tensor -> the CUDA kernel, or an error for anything it does not take.
A shape whose K1 shared memory does not fit the card (N above ~789 in bf16
at d = 64, e.g. a ViT trunk on 768 x 768 inputs, N = 2304) goes to the
row-tiled kernel K4 (ops/kernels/attention_tiled.py) instead, as the JAX
`packed_attention` hands it to `tiled_attention`. Forward and backward are
routed each on its own (their shared memory differs), by the shape alone:
`attention_route` on K1's byte count and the card's opt-in limit.
`kernel_path` names the route: "K1 tensor cores", "K1 CUDA cores" or "K4".

Kernel K6, `fused_attention(q, k, v)`, replaces `_attn_kernel` of the same
file (`fused_attention`, the `attn_impl="pallas"` serving knob): the same
forward with q, k and v each (B, N, heads, d), read through their strides by
K1's forward body, so the views the qkv projection gives are not copied
(JAX transposes them to (B * heads, N, d) around its kernel). It returns
the context (B, N, heads, d). It is forward only, as in JAX: a gradient
through it raises. `fused_attention_reference` is its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from probpose_pytorch_tpu_torch.ops import kernels
from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
    DTYPES as _DTYPES,
    attention_route,
    max_shared_memory,
    tiled_attention_backward,
    tiled_forward,
)

__all__ = [
    "packed_attention",
    "packed_attention_reference",
    "packed_attention_backward",
    "packed_attention_bwd_reference",
    "kernel_path",
    "attention_route",
    "fused_attention",
    "fused_attention_reference",
]


def _unpack(qkv: torch.Tensor, heads: int):
    """(B, N, 3C) -> float32 q, k, v, each (B, N, heads, d), and 1/sqrt(d)."""
    B, N, C3 = qkv.shape
    d = C3 // 3 // heads
    q, k, v = qkv.float().reshape(B, N, 3, heads, d).unbind(2)
    return q, k, v, 1.0 / d**0.5


def packed_attention_reference(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain version: `_einsum_packed_attention` (attention_kernel.py:335)
    with the f32 softmax. q.k and P.V accumulate in f32; P is rounded to
    qkv's dtype before P.V; the context comes back in qkv's dtype."""
    B, N, C3 = qkv.shape
    q, k, v, scale = _unpack(qkv, heads)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", p.float(), v)
    return out.reshape(B, N, C3 // 3).to(qkv.dtype)


def packed_attention_bwd_reference(qkv: torch.Tensor, dout: torch.Tensor,
                                   heads: int) -> torch.Tensor:
    """Plain backward, line by line `_packed_bwd_kernel`
    (attention_kernel.py:146-191): f32 scores and softmax recomputed from
    qkv; dV = round(P)^T dO; dS = round(P * (dP - rowsum(dP * P)) * scale)
    with the row sum over the unrounded P; dQ = dS K, dK = dS^T Q, all sums
    in f32. round() is to qkv's dtype. Returns dqkv (B, N, 3C) packed in
    qkv's layout and dtype."""
    B, N, C3 = qkv.shape
    q, k, v, scale = _unpack(qkv, heads)
    do = dout.float().reshape(B, N, heads, -1)
    rnd = lambda t: t.to(qkv.dtype).float()
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale, dim=-1)
    dv = torch.einsum("bhnm,bnhd->bmhd", rnd(p), do)
    dp = torch.einsum("bnhd,bmhd->bhnm", do, v)
    dsum = (dp * p).sum(dim=-1, keepdim=True)
    ds = rnd(p * (dp - dsum) * scale)
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q)
    return torch.stack([dq, dk, dv], dim=2).reshape(B, N, C3).to(qkv.dtype)


def _lib() -> ctypes.CDLL:
    from probpose_pytorch_tpu_torch.ops.kernels._build import library

    lib = library()
    if not getattr(lib, "_attention_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.packed_attention_fwd.argtypes = [ptr, ptr] + [i32] * 6 + [ptr]
        lib.packed_attention_fwd.restype = i32
        lib.packed_attention_bwd.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        lib.packed_attention_bwd.restype = i32
        for name in ("packed_attention_smem_bytes", "packed_attention_bwd_smem_bytes"):
            getattr(lib, name).argtypes = [i32] * 3
            getattr(lib, name).restype = ctypes.c_longlong
        for name in ("packed_attention_uses_mma", "packed_attention_bwd_uses_mma"):
            getattr(lib, name).argtypes = [i32] * 3
            getattr(lib, name).restype = i32
        lib.flat_attention_fwd.argtypes = [ptr] * 4 + [i32] * 4 + [ctypes.c_longlong] * 3 \
            + [i32] * 2 + [ptr]
        lib.flat_attention_fwd.restype = i32
        lib._attention_bound = True
    return lib


def _route(N: int, d: int, dtype: torch.dtype, backward: bool, device: int) -> str:
    """"K1" or "K4" for (N, d, dtype) on the card `device`."""
    lib = _lib()
    need = lib.packed_attention_bwd_smem_bytes if backward else lib.packed_attention_smem_bytes
    return attention_route(need(N, d, _DTYPES[dtype]), max_shared_memory(device))


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def kernel_path(N: int, d: int, dtype: torch.dtype, backward: bool = False) -> str:
    """Which kernel serves (N, d, dtype) on the current card, forward or
    backward: "K1 tensor cores", "K1 CUDA cores" or "K4"."""
    if _route(N, d, dtype, backward, torch.cuda.current_device()) == "K4":
        return "K4"
    lib = _lib()
    fn = lib.packed_attention_bwd_uses_mma if backward else lib.packed_attention_uses_mma
    return "K1 tensor cores" if fn(N, d, _DTYPES[dtype]) else "K1 CUDA cores"


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


def _smem_check(t: torch.Tensor, N: int, d: int, smem_fn, what: str) -> int:
    """CUDA device index of t, after checking that the kernel's shared
    memory for (N, d) fits the card."""
    device = _device_index(t)
    limit = max_shared_memory(device)
    need = smem_fn(N, d, _DTYPES[t.dtype])
    if need > limit:
        raise ValueError(
            f"{what}: N={N}, d={d} ({t.dtype}) needs {need} bytes "
            f"of shared memory, the card allows {limit} (K6, fused_attention, "
            "takes the shapes K1 holds; packed_attention routes longer "
            "sequences to K4)"
        )
    return device


def _device_and_smem_check(qkv: torch.Tensor, heads: int, smem_fn, what: str) -> int:
    """CUDA device index of qkv, after checking that the kernel's shared
    memory fits the card and that qkv is 16-byte aligned."""
    B, N, C3 = qkv.shape
    device = _smem_check(qkv, N, C3 // 3 // heads, smem_fn, what)
    if qkv.data_ptr() % 16:
        raise ValueError(f"{what}: qkv must be 16-byte aligned")
    return device


def _forward(qkv: torch.Tensor, heads: int, with_lse: bool):
    """(context, lse): lse is K4's row log-sum-exp where `with_lse` asks for
    it and the shape routes to K4 in bf16 on the card, else None."""
    plain = kernels.use_plain(qkv, "packed_attention")
    if plain and not qkv.is_cuda:
        return packed_attention_reference(qkv, heads), None
    B, N, C3 = qkv.shape
    if _route(N, C3 // 3 // heads, qkv.dtype, False, _device_index(qkv)) == "K4":
        return tiled_forward(qkv, heads, with_lse)
    if plain:
        return packed_attention_reference(qkv, heads), None
    lib = _lib()
    device = _device_and_smem_check(qkv, heads, lib.packed_attention_smem_bytes,
                                    "packed_attention")
    B, N, C3 = qkv.shape
    out = torch.empty((B, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    err = lib.packed_attention_fwd(
        qkv.data_ptr(), out.data_ptr(), B, N, C3 // 3, heads, _DTYPES[qkv.dtype],
        device, torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"packed_attention: kernel launch failed with cudaError {err} "
            f"at qkv {tuple(qkv.shape)} {qkv.dtype}"
        )
    packed_attention.launches += 1
    return out, None


def packed_attention_backward(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
                              out: torch.Tensor | None = None,
                              lse: torch.Tensor | None = None) -> torch.Tensor:
    """dqkv (B, N, 3C) of `packed_attention` from qkv and the context's
    gradient dout (B, N, C), both of one dtype; dout is made contiguous.
    `out` and `lse`, the forward's context and K4's log-sum-exp, are read
    where the backward routes to K4 (which makes them when absent) and
    ignored by K1."""
    _check(qkv, heads)
    B, N, C3 = qkv.shape
    if tuple(dout.shape) != (B, N, C3 // 3):
        raise ValueError(
            f"packed_attention_backward: dout {tuple(dout.shape)} does not "
            f"match qkv {tuple(qkv.shape)}"
        )
    if dout.dtype != qkv.dtype or dout.device != qkv.device:
        raise TypeError(
            f"packed_attention_backward: dout is {dout.dtype} on {dout.device}, "
            f"qkv {qkv.dtype} on {qkv.device}"
        )
    plain = kernels.use_plain(qkv, "packed_attention_backward")
    if plain and not qkv.is_cuda:
        return packed_attention_bwd_reference(qkv, dout, heads)
    if _route(N, C3 // 3 // heads, qkv.dtype, True, _device_index(qkv)) == "K4":
        return tiled_attention_backward(qkv, dout, heads, out, lse)
    if plain:
        return packed_attention_bwd_reference(qkv, dout, heads)
    dout = dout.contiguous()
    lib = _lib()
    device = _device_and_smem_check(qkv, heads, lib.packed_attention_bwd_smem_bytes,
                                    "packed_attention_backward")
    if dout.data_ptr() % 16:
        raise ValueError("packed_attention_backward: dout must be 16-byte aligned")
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3, B, heads, N), dtype=torch.float32, device=qkv.device)
    err = lib.packed_attention_bwd(
        qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        B, N, C3 // 3, heads, _DTYPES[qkv.dtype], device,
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"packed_attention_backward: kernel launch failed with cudaError "
            f"{err} at qkv {tuple(qkv.shape)} {qkv.dtype}"
        )
    packed_attention_backward.launches += 1
    return dqkv


class _PackedAttention(torch.autograd.Function):
    """K1 or K4 forward, with K1 or K4 backward as its gradient, each routed
    by the shape; saves qkv, and on K4's bf16 route also the context and
    its lse, which K4's backward reads instead of rebuilding them."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int) -> torch.Tensor:
        ctx.heads = heads
        out, lse = _forward(qkv, heads, ctx.needs_input_grad[0])
        ctx.save_for_backward(*((qkv,) if lse is None else (qkv, out, lse)))
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        qkv, *residuals = ctx.saved_tensors
        return packed_attention_backward(qkv, grad, ctx.heads, *residuals), None


def packed_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v per head from packed (B, N, 3C) qkv;
    differentiable through K1's (or K4's) backward."""
    _check(qkv, heads)
    return _PackedAttention.apply(qkv, heads)


packed_attention.launches = 0
packed_attention_backward.launches = 0


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of K6, line by line `_attn_kernel` (attention_kernel.py:
    32-48): f32 scores, scale after the product, f32 softmax, P rounded to
    v's dtype before P.V, f32 sums; (B, N, heads, d) in q's dtype."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    return torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(q.dtype)


def _flat_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if kernels.use_plain(q, "fused_attention"):
        return fused_attention_reference(q, k, v)
    if q.dtype not in _DTYPES:
        raise TypeError(f"fused_attention: dtype {q.dtype} not supported (float32 or bfloat16)")
    B, N, H, d = q.shape
    if k.stride() != q.stride() or v.stride() != q.stride() or q.stride(3) != 1:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if B > 65535:
        raise ValueError(f"fused_attention: batch {B} exceeds the grid's 65535")
    device = _smem_check(q, N, d, _lib().packed_attention_smem_bytes, "fused_attention")
    align = 16 // q.element_size()
    if any(t.data_ptr() % 16 for t in (q, k, v)) or any(s % align for s in q.stride()[:3]):
        raise ValueError("fused_attention: q, k and v must be 16-byte aligned, row by row")
    out = torch.empty((B, N, H, d), dtype=q.dtype, device=q.device)
    err = _lib().flat_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, H, d,
        *q.stride()[:3], _DTYPES[q.dtype], device,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"fused_attention: kernel launch failed with cudaError {err} at "
                           f"q {tuple(q.shape)} {q.dtype}")
    fused_attention.launches += 1
    return out


class _FlatAttention(torch.autograd.Function):
    """K6 forward; like the JAX kernel it has no backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        return _flat_forward(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError(
            "fused_attention (kernel K6, attn_impl='pallas') is forward only, as in the JAX "
            "package; train with attn_impl='fused' or 'einsum' (kernel K1)")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v per head with q, k, v each (B, N, heads,
    d); returns (B, N, heads, d). Forward only."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused_attention: q, k, v must share one (B, N, heads, d) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device or v.device != q.device:
        raise TypeError("fused_attention: q, k and v must share dtype and device")
    if 0 in q.shape:
        raise ValueError(f"fused_attention: empty q {tuple(q.shape)}")
    return _FlatAttention.apply(q, k, v)


fused_attention.launches = 0
