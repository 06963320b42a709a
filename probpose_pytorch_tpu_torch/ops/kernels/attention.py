"""Kernel K1: packed multi-head attention, forward and backward, and their
plain versions.

Replaces the TPU kernels `_packed_fwd_kernel` and `_packed_bwd_kernel` of
probpose_pytorch_tpu/ops/pallas/attention_kernel.py (`packed_attention`, a
`jax.custom_vjp` whose backward recomputes the scores, qkv-major layout).

`packed_attention(qkv, heads)` takes the (B, N, 3C) output of the qkv
projection as it is and returns the (B, N, C) context. It is a
`torch.autograd.Function`; its backward is `packed_attention_backward`,
which writes dqkv straight in the packed layout. Which kernel serves a call
is decided by the shape alone, forward and backward each on its own
(`attention_route` in ops/kernels/attention_tiled.py, a pure function of N,
d, the dtype and the card's shared memory; `kernel_path` names it):
  * "sm90 short": bf16, d in {32, 64, 128}, N <= 256 (the ViT trunks'
    N = 192), forward: `short_forward`, csrc/tiled_attention_sm90.cu;
  * "sm90 tiled": the same dtype and widths at longer N, and their every
    backward: K4's wgmma kernels, which read the forward's saved context
    and log-sum-exp (`_PackedAttention` saves (qkv, out, lse) there);
  * "K1 CUDA cores": float32, and bf16 with another d, where K1's shared
    memory fits: csrc/packed_attention.cu (the f32 parity checks run here);
  * "K4 CUDA cores": past K1's shared memory, float32 with d in
    {32, 64, 80, 128} and bf16 with d = 80 (the vit-h preset at N >= 646):
    csrc/tiled_attention.cu, as the JAX package hands such shapes to its
    row-tiled kernel;
  * "no kernel (...)": any other shape past K1's shared memory (e.g. d = 48
    at N = 1024): NotImplementedError on the card.
Both wrappers:
  * CPU tensor  -> the plain version (`packed_attention_reference`,
                   `packed_attention_bwd_reference`) on every route;
  * CUDA tensor -> the routed kernel, or an error for anything it does not
                   take. `packed_attention.launches` and
                   `packed_attention_backward.launches` count K1's CUDA-core
                   kernels; the wgmma routes count on their own wrappers.

Kernel K6, `fused_attention(q, k, v)`, replaces `_attn_kernel` of the same
file (`fused_attention`, the `attn_impl="pallas"` serving knob): K1's
forward read from q, k and v each (B, N, heads, d) through their strides,
so the views the qkv projection gives are not copied (JAX transposes them
to (B * heads, N, d) around its kernel). bf16 with d in {32, 64, 128} and
N <= 256 runs the short wgmma forward, one tensor map per view, and gives
K1's bits; every other shape runs K1's CUDA-core body. It returns the
context (B, N, heads, d). It is forward only, as in JAX: a gradient through
it raises. `fused_attention_reference` is its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from probpose_pytorch_tpu_torch.ops import kernels
from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
    DTYPES as _DTYPES,
    HEAD_DIMS,
    K1_CUDA_CORES,
    NO_KERNEL,
    SHORT_MAX_N,
    SM90_SHORT,
    attention_route,
    max_shared_memory,
    short_forward,
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
        lib.flat_attention_fwd.argtypes = [ptr] * 4 + [i32] * 4 + [ctypes.c_longlong] * 3 \
            + [i32] * 2 + [ptr]
        lib.flat_attention_fwd.restype = i32
        lib.flat_short_attention_sm90_fwd.argtypes = [ptr] * 4 + [i32] * 4 \
            + [ctypes.c_longlong] * 2 + [i32, ptr]
        lib.flat_short_attention_sm90_fwd.restype = i32
        lib._attention_bound = True
    return lib


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _route(qkv: torch.Tensor, heads: int, backward: bool) -> str:
    """The route of a checked qkv on the card it lies on."""
    B, N, C3 = qkv.shape
    return attention_route(N, C3 // 3 // heads, qkv.dtype,
                           max_shared_memory(_device_index(qkv)), backward)


def kernel_path(N: int, d: int, dtype: torch.dtype, backward: bool = False) -> str:
    """Which kernel serves (N, d, dtype) on the current card, forward or
    backward: "sm90 short", "sm90 tiled", "K1 CUDA cores", "K4 CUDA cores"
    or "no kernel (d=.., N=..)" (see `attention_route`)."""
    return attention_route(N, d, dtype, max_shared_memory(torch.cuda.current_device()),
                           backward)


def _no_kernel(qkv: torch.Tensor, heads: int, route: str, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: qkv {tuple(qkv.shape)} {qkv.dtype} with {heads} heads: {route}; K1's "
        "shared memory does not fit, and K4 takes d in {32, 64, 128} in bf16 on wgmma, "
        "d in {32, 64, 80, 128} in f32 and d = 80 in bf16 on the CUDA cores (ROADMAP "
        "section 2, item 8)")


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
            "sequences to other kernels)"
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
    """(context, lse) on qkv's route; lse is the (B, heads, N) f32 row
    log-sum-exp where `with_lse` asks for it and a wgmma kernel runs, else
    None."""
    if kernels.use_plain(qkv, "packed_attention"):
        return packed_attention_reference(qkv, heads), None
    route = _route(qkv, heads, backward=False)
    if route.startswith(NO_KERNEL):
        raise _no_kernel(qkv, heads, route, "packed_attention")
    if route == SM90_SHORT:
        return short_forward(qkv, heads, with_lse)
    if route != K1_CUDA_CORES:
        return tiled_forward(qkv, heads, with_lse)
    return torch.ops.probpose.packed_attention_fwd(qkv, heads), None


@torch.library.custom_op("probpose::packed_attention_fwd", mutates_args=(),
                         schema="(Tensor qkv, int heads) -> Tensor")
def _packed_fwd_op(qkv, heads):
    """K1's CUDA-core forward launch as an op that torch.export records."""
    qkv = qkv.contiguous()  # at run time, as attention_tiled.py notes at _QKV_SCHEMA
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
    return out


@_packed_fwd_op.register_fake
def _(qkv, heads):
    B, N, C3 = qkv.shape
    return qkv.new_empty((B, N, C3 // 3))


def packed_attention_backward(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
                              out: torch.Tensor | None = None,
                              lse: torch.Tensor | None = None) -> torch.Tensor:
    """dqkv (B, N, 3C) of `packed_attention` from qkv and the context's
    gradient dout (B, N, C), both of one dtype; dout is made contiguous.
    `out` and `lse`, the forward's context and log-sum-exp, are read on the
    wgmma route (which makes them when absent) and ignored elsewhere."""
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
    if kernels.use_plain(qkv, "packed_attention_backward"):
        return packed_attention_bwd_reference(qkv, dout, heads)
    route = _route(qkv, heads, backward=True)
    if route.startswith(NO_KERNEL):
        raise _no_kernel(qkv, heads, route, "packed_attention_backward")
    if route != K1_CUDA_CORES:
        return tiled_attention_backward(qkv, dout, heads, out, lse)
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
    """The routed forward, with the routed backward as its gradient; saves
    qkv, and on the wgmma routes also the context and its lse, which K4's
    backward reads instead of rebuilding them."""

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
    differentiable through the routed backward."""
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
    if q.shape[0] > 65535:
        raise ValueError(f"fused_attention: batch {q.shape[0]} exceeds the grid's 65535")
    return torch.ops.probpose.flat_attention_fwd(q, k, v)


@torch.library.custom_op("probpose::flat_attention_fwd", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v) -> Tensor")
def _flat_fwd_op(q, k, v):
    """K6's launch as an op that torch.export records: q, k and v are read
    through their strides where they share them, else made contiguous."""
    B, N, H, d = q.shape
    # bf16 at the short forward's widths and lengths: its wgmma kernel, the
    # one that serves packed_attention there, so K6 and K1 give the same bits
    wgmma = q.dtype == torch.bfloat16 and d in HEAD_DIMS and N <= SHORT_MAX_N
    if k.stride() != q.stride() or v.stride() != q.stride() or q.stride(3) != 1 \
            or (wgmma and q.stride(2) != d):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if wgmma:
        device = _device_index(q)
    else:
        device = _smem_check(q, N, d, _lib().packed_attention_smem_bytes, "fused_attention")
    align = 16 // q.element_size()
    if any(t.data_ptr() % 16 for t in (q, k, v)) or any(s % align for s in q.stride()[:3]):
        raise ValueError("fused_attention: q, k and v must be 16-byte aligned, row by row")
    out = torch.empty((B, N, H, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if wgmma:
        err = _lib().flat_short_attention_sm90_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, H, d,
            q.stride(0), q.stride(1), device, stream)
    else:
        err = _lib().flat_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, H, d,
            *q.stride()[:3], _DTYPES[q.dtype], device, stream)
    if err:
        raise RuntimeError(f"fused_attention: kernel launch failed with cudaError {err} at "
                           f"q {tuple(q.shape)} {q.dtype}")
    fused_attention.launches += 1
    return out


@_flat_fwd_op.register_fake
def _(q, k, v):
    return q.new_empty(q.shape)


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
