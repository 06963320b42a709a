"""Kernel K5: fused LayerNorm -> fc1 -> GELU -> fc2 -> +residual, forward
and backward, and their plain versions.

Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
probpose_pytorch_tpu/ops/pallas/mlp_kernel.py (`fused_ln_mlp`, a
`jax.custom_vjp` whose backward recomputes each row tile). bf16 runs
csrc/fused_mlp_sm90.cu: wgmma products fed by TMA, with the LayerNorm, the
biases, GELU and the residual in the products' prologue passes and
epilogues, and y, h (and, backward, du and dy) in device memory in bf16, the
values the TPU kernel rounds before its products; the source's note says
what bounds it and why. float32 runs csrc/fused_mlp.cu on the CUDA cores.
Both take C in {384, 768, 1024, 1280} and a hidden width that is a multiple
of 256.

`fused_ln_mlp(x, scale, bias, w1, b1, w2, b2, exact_gelu)` takes the JAX
function's arguments in its layout: x (R, C) rows, w1 (C, Hd), w2 (Hd, C),
scale, bias, b1 and b2 float32. It is a `torch.autograd.Function` that saves
only its inputs, as the JAX custom_vjp does (mlp_kernel.py:181-184); its
backward is `fused_ln_mlp_backward`. Both wrappers:
  * CPU tensor  -> the plain version (`fused_ln_mlp_reference`,
                   `fused_ln_mlp_bwd_reference`);
  * CUDA tensor -> the CUDA kernel, or an error for anything it does not take.

Where the rounding happens, read off `jax.make_jaxpr` of the vjp of
`_tile_forward` with bf16 weights (the TPU kernel's in-kernel `jax.vjp`):
  forward   y and h are rounded to the weight type before their products;
            u, o, the biases and the residual stay f32; one cast at the end.
  backward  dh = g W2^T is summed in f32 and rounded to the weight type
            (the cotangent of the bf16 h); du = dh * gelu'(u) stays f32;
            dy = du W1^T is summed in f32 and rounded to the weight type
            (the cotangent of the bf16 y); the LayerNorm backward, db1, db2,
            dscale and dbias are f32; dW1 = y^T du and dW2 = h^T g are
            summed in f32 and come out of each row tile in the weight type,
            and their f32 sum over the tiles is cast to it again
            (mlp_kernel.py:83-94, 202-204).
The plain backward takes `chunk`: with a row count, each chunk's dW1 and
dW2 are rounded to the weight type before the f32 sum, as the TPU kernel's
row tiles are (max(tile // 4, 64) rows); with None, one f32 sum over all
rows. The bf16 kernel also rounds du to bf16 for the dy and dW1 products;
`fused_ln_mlp_bwd_kernel_order_reference` is the plain backward in that
order (du rounded, one f32 sum), the card's tighter yardstick.
`mlp_workspace_bytes` mirrors the bf16 backward's scratch layout.
"""

from __future__ import annotations

import ctypes

import torch

from probpose_pytorch_tpu_torch.ops import kernels

__all__ = [
    "fused_ln_mlp",
    "fused_ln_mlp_reference",
    "fused_ln_mlp_backward",
    "fused_ln_mlp_bwd_reference",
    "fused_ln_mlp_bwd_kernel_order_reference",
    "mlp_workspace_bytes",
    "SUPPORTED_WIDTHS",
]

_DTYPES = (torch.float32, torch.bfloat16)
SUPPORTED_WIDTHS = (384, 768, 1024, 1280)
LN_EPS = 1e-6
_SQRT_2_OVER_PI = 0.7978845608028654
_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def _gelu(u: torch.Tensor, exact: bool) -> torch.Tensor:
    """jax.nn.gelu in f32: tanh form, or the exact erfc form."""
    if exact:
        return 0.5 * u * torch.erfc(-u * _SQRT_HALF)
    return u * (0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (u + 0.044715 * (u * u * u)))))


def _gelu_grad(u: torch.Tensor, exact: bool) -> torch.Tensor:
    if exact:
        return 0.5 * torch.erfc(-u * _SQRT_HALF) + u * _INV_SQRT_2PI * torch.exp(-0.5 * u * u)
    t = torch.tanh(_SQRT_2_OVER_PI * (u + 0.044715 * (u * u * u)))
    return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * _SQRT_2_OVER_PI * (
        1.0 + 3.0 * 0.044715 * u * u)


def _rnd(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).float()


def _recompute(x, scale, bias, w1, b1):
    """f32 (xhat, rstd, y rounded to w1's dtype, u) of `_tile_forward`."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + LN_EPS)
    xhat = xc * rstd
    y = _rnd(xhat * scale.float() + bias.float(), w1.dtype)
    u = y @ w1.float() + b1.float()
    return xhat, rstd, y, u


def fused_ln_mlp_reference(x, scale, bias, w1, b1, w2, b2, exact_gelu: bool = False):
    """Plain version, line by line `_tile_forward` (mlp_kernel.py:29-46)."""
    _, _, _, u = _recompute(x, scale, bias, w1, b1)
    h = _rnd(_gelu(u, exact_gelu), w2.dtype)
    o = h @ w2.float() + b2.float()
    return (o + x.float()).to(x.dtype)


def _bwd_plain(x, scale, bias, w1, b1, w2, b2, dout, exact_gelu, chunk, round_du):
    xhat, rstd, y, u = _recompute(x, scale, bias, w1, b1)
    g = dout.float()
    h = _rnd(_gelu(u, exact_gelu), w2.dtype)
    dh = _rnd(g @ w2.float().t(), w2.dtype)
    du = dh * _gelu_grad(u, exact_gelu)
    du_mm = _rnd(du, w1.dtype) if round_du else du
    dy = _rnd(du_mm @ w1.float().t(), w1.dtype)
    dxhat = dy * scale.float()
    C = x.shape[-1]
    m1 = dxhat.sum(-1, keepdim=True) / C
    m2 = (dxhat * xhat).sum(-1, keepdim=True) / C
    dx = (g + rstd * (dxhat - m1 - xhat * m2)).to(x.dtype)
    R = x.shape[0]
    step = R if chunk is None else chunk
    dw1 = torch.zeros(w1.shape, dtype=torch.float32, device=x.device)
    dw2 = torch.zeros(w2.shape, dtype=torch.float32, device=x.device)
    for r0 in range(0, R, step):
        sl = slice(r0, r0 + step)
        p1, p2 = y[sl].t() @ du_mm[sl], h[sl].t() @ g[sl]
        dw1 += p1 if chunk is None else _rnd(p1, w1.dtype)
        dw2 += p2 if chunk is None else _rnd(p2, w2.dtype)
    return (dx, (dy * xhat).sum(0), dy.sum(0), dw1.to(w1.dtype), du.sum(0),
            dw2.to(w2.dtype), g.sum(0))


def fused_ln_mlp_bwd_reference(x, scale, bias, w1, b1, w2, b2, dout,
                               exact_gelu: bool = False, chunk: int | None = None):
    """Plain backward: (dx, dscale, dbias, dw1, db1, dw2, db2) with dx in x's
    dtype, dw1 and dw2 in the weights' dtypes and the rest float32; the
    rounding points are the module docstring's. `chunk` rows per rounded
    partial of dw1 and dw2 (the TPU kernel's row tile), or None."""
    return _bwd_plain(x, scale, bias, w1, b1, w2, b2, dout, exact_gelu, chunk, False)


def fused_ln_mlp_bwd_kernel_order_reference(x, scale, bias, w1, b1, w2, b2, dout,
                                            exact_gelu: bool = False):
    """The plain backward in the bf16 kernel's order: du rounded to the
    weights' dtype before the dy and dW1 products (db1 still sums the
    unrounded du), and one f32 sum over all rows for dW1 and dW2. In float32
    the rounding is the identity, so it equals `fused_ln_mlp_bwd_reference`.
    Used by the tests and chip_smoke.py only."""
    return _bwd_plain(x, scale, bias, w1, b1, w2, b2, dout, exact_gelu, None, True)


# The bf16 backward's scratch (csrc/fused_mlp_sm90.cu, `workspace`): its
# tiles and the weight gradients' split over the rows (`split_k`).
_BM, _BK, _LN_ROWS = 128, 64, 64
_WAVE_SMS, _EPILOGUE_STEPS, _MAX_SPLITS = 132, 8, 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _shape(C: int, Hd: int) -> tuple[int, int]:
    """(consumer warpgroups, tile width) of the GEMM blocks: 3 and 192 (tiles
    of 192 x 192) where 192 divides C and Hd, else 2 and 256 or 128."""
    if C % 192 == 0 and Hd % 192 == 0:
        return 3, 192
    return 2, 256 if C % 256 == 0 else 128


def _split_k(R: int, tiles: int) -> tuple[int, int]:
    """(splits, stages a chunk): the first S <= 16 minimising
    ceil(tiles S / 132) x (stages a chunk + 8)."""
    steps = _cdiv(R, _BK)
    best = None
    for s in range(1, _MAX_SPLITS + 1):
        per = _cdiv(steps, s)
        if _cdiv(steps, per) != s:
            continue
        cost = _cdiv(tiles * s, _WAVE_SMS) * (per + _EPILOGUE_STEPS)
        if best is None or cost < best[0]:
            best = (cost, s, per)
    return best[1], best[2]


def mlp_workspace_bytes(R: int, C: int, Hd: int) -> int:
    """Bytes of scratch the bf16 backward takes at R rows: y, h, du and dy in
    bf16, the row mean and rstd, the LayerNorm backward's partials
    (3, ceil(R / 64), C), db1's (ceil(R / 128), Hd) and the weight gradients'
    split partials (splits, 2 C Hd) in f32, each at a 256-byte boundary."""
    if C not in SUPPORTED_WIDTHS or Hd <= 0 or Hd % 256 or R <= 0:
        raise ValueError(f"mlp_workspace_bytes: R={R}, C={C}, hidden={Hd} not taken")
    w, bn = _shape(C, Hd)
    tiles = _cdiv(Hd, 64 * w) * (C // bn) + _cdiv(C, 64 * w) * (Hd // bn)
    splits, _ = _split_k(R, tiles)
    sizes = (R * C * 2, R * Hd * 2, R * Hd * 2, R * C * 2, R * 4, R * 4,
             3 * _cdiv(R, _LN_ROWS) * C * 4, _cdiv(R, _BM) * Hd * 4, splits * 2 * C * Hd * 4)
    return sum(_cdiv(n, 256) * 256 for n in sizes)


def _lib() -> ctypes.CDLL:
    from probpose_pytorch_tpu_torch.ops.kernels._build import library

    lib = library()
    if not getattr(lib, "_mlp_bound", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fused_mlp_f32_fwd.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        lib.fused_mlp_f32_bwd.argtypes = [ptr] * 15 + [i32] * 5 + [ptr]
        lib.fused_mlp_f32_bwd_workspace_bytes.argtypes = [i32] * 3
        lib.fused_mlp_f32_bwd_workspace_bytes.restype = i64
        lib.fused_mlp_sm90_fwd.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
        lib.fused_mlp_sm90_bwd.argtypes = [ptr] * 15 + [i64] + [i32] * 5 + [ptr]
        lib.fused_mlp_bwd_workspace_bytes.argtypes = [i32] * 3
        lib.fused_mlp_bwd_workspace_bytes.restype = i64
        for fn in (lib.fused_mlp_f32_fwd, lib.fused_mlp_f32_bwd, lib.fused_mlp_sm90_fwd,
                   lib.fused_mlp_sm90_bwd):
            fn.restype = i32
        lib._mlp_bound = True
    return lib


def _check(x, scale, bias, w1, b1, w2, b2) -> None:
    if x.dim() != 2:
        raise ValueError(f"fused_ln_mlp: x must be (R, C), got {tuple(x.shape)}")
    R, C = x.shape
    Hd = w1.shape[-1]
    shapes = dict(scale=(scale, (C,)), bias=(bias, (C,)), w1=(w1, (C, Hd)), b1=(b1, (Hd,)),
                  w2=(w2, (Hd, C)), b2=(b2, (C,)))
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"fused_ln_mlp: {name} is {tuple(t.shape)}, expected {want}")
    if R == 0:
        raise ValueError("fused_ln_mlp: empty x")


def _kernel_args(x, scale, bias, w1, b1, w2, b2):
    """Check what the CUDA kernel takes; the weights in nn.Linear's layout
    (free for the transposed views a Linear's weight gives) and the device."""
    R, C = x.shape
    Hd = w1.shape[1]
    if x.dtype not in _DTYPES or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(
            f"fused_ln_mlp: x {x.dtype}, w1 {w1.dtype}, w2 {w2.dtype}: the kernel takes "
            "one dtype for all three, float32 or bfloat16")
    for name, t in dict(scale=scale, bias=bias, b1=b1, b2=b2).items():
        if t.dtype != torch.float32:
            raise TypeError(f"fused_ln_mlp: {name} must be float32, got {t.dtype}")
    if C not in SUPPORTED_WIDTHS or Hd % 256:
        raise ValueError(
            f"fused_ln_mlp: C={C}, hidden={Hd} not taken by the kernel (C in "
            f"{SUPPORTED_WIDTHS}, hidden a multiple of 256)")
    tensors = [x, scale, bias, w1, b1, w2, b2]
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_ln_mlp: all arguments must be on one device")
    if not x.is_contiguous():
        raise ValueError("fused_ln_mlp: x must be contiguous")
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    vecs = [t.contiguous() for t in (scale, bias, b1, b2)]
    if any(t.data_ptr() % 32 for t in (x, w1t, w2t, *vecs)):
        raise ValueError("fused_ln_mlp: x, the weights and the vectors must be 32-byte aligned")
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return w1t, w2t, vecs, device


def _forward(x, scale, bias, w1, b1, w2, b2, exact_gelu):
    if kernels.use_plain(x, "fused_ln_mlp"):
        return fused_ln_mlp_reference(x, scale, bias, w1, b1, w2, b2, exact_gelu)
    return torch.ops.probpose.fused_ln_mlp_fwd(x, scale, bias, w1, b1, w2, b2, exact_gelu)


@torch.library.custom_op(
    "probpose::fused_ln_mlp_fwd", mutates_args=(),
    schema="(Tensor x, Tensor scale, Tensor bias, Tensor w1, Tensor b1, Tensor w2, Tensor b2, "
           "bool exact_gelu) -> Tensor")
def _fwd_op(x, scale, bias, w1, b1, w2, b2, exact_gelu):
    """K5's forward launch as an op that torch.export records (x made
    contiguous at run time, as attention_tiled's op bodies do)."""
    x = x.contiguous()
    w1t, w2t, (sc, bi, c1, c2), device = _kernel_args(x, scale, bias, w1, b1, w2, b2)
    R, C = x.shape
    Hd = w1.shape[1]
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), sc.data_ptr(), bi.data_ptr(), w1t.data_ptr(), c1.data_ptr(),
            w2t.data_ptr(), c2.data_ptr())
    if x.dtype == torch.bfloat16:  # y and h, the bf16 values the products read
        y = torch.empty_like(x)
        h = torch.empty((R, Hd), dtype=x.dtype, device=x.device)
        err = _lib().fused_mlp_sm90_fwd(*args, y.data_ptr(), h.data_ptr(), out.data_ptr(), R, C,
                                        Hd, int(exact_gelu), device, stream)
    else:
        err = _lib().fused_mlp_f32_fwd(*args, out.data_ptr(), R, C, Hd, int(exact_gelu), device,
                                       stream)
    if err:
        raise RuntimeError(f"fused_ln_mlp: kernel launch failed with cudaError {err} at x "
                           f"{tuple(x.shape)} {x.dtype}, hidden {Hd}")
    fused_ln_mlp.launches += 1
    return out


@_fwd_op.register_fake
def _(x, scale, bias, w1, b1, w2, b2, exact_gelu):
    return x.new_empty(x.shape)


def fused_ln_mlp_backward(x, scale, bias, w1, b1, w2, b2, dout, exact_gelu: bool = False):
    """(dx, dscale, dbias, dw1, db1, dw2, db2) of `fused_ln_mlp` from its
    inputs and the output's gradient dout (R, C), in the dtypes of
    `fused_ln_mlp_bwd_reference`; dout is made contiguous."""
    _check(x, scale, bias, w1, b1, w2, b2)
    if tuple(dout.shape) != tuple(x.shape) or dout.dtype != x.dtype or dout.device != x.device:
        raise ValueError(f"fused_ln_mlp_backward: dout {tuple(dout.shape)} {dout.dtype} on "
                         f"{dout.device} does not match x {tuple(x.shape)} {x.dtype}")
    if kernels.use_plain(x, "fused_ln_mlp_backward"):
        return fused_ln_mlp_bwd_reference(x, scale, bias, w1, b1, w2, b2, dout, exact_gelu)
    w1t, w2t, (sc, bi, c1, _), device = _kernel_args(x, scale, bias, w1, b1, w2, b2)
    dout = dout.contiguous()
    if dout.data_ptr() % 32:
        raise ValueError("fused_ln_mlp_backward: dout must be 32-byte aligned")
    R, C = x.shape
    Hd = w1.shape[1]
    lib = _lib()
    bf16 = x.dtype == torch.bfloat16
    nbytes = (mlp_workspace_bytes(R, C, Hd) if bf16
              else lib.fused_mlp_f32_bwd_workspace_bytes(R, C, Hd))
    work = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dw1t = torch.empty((Hd, C), dtype=w1.dtype, device=x.device)
    dw2t = torch.empty((C, Hd), dtype=w2.dtype, device=x.device)
    dscale, dbias, db2 = (torch.empty(C, **f32) for _ in range(3))
    db1 = torch.empty(Hd, **f32)
    ptrs = [t.data_ptr() for t in (x, sc, bi, w1t, c1, w2t, dout, dx, dscale, dbias, dw1t, db1,
                                   dw2t, db2, work)]
    tail = (R, C, Hd, int(exact_gelu), device, torch.cuda.current_stream(x.device).cuda_stream)
    if bf16:  # the library checks the scratch against its own count
        err = lib.fused_mlp_sm90_bwd(*ptrs, nbytes, *tail)
    else:
        err = lib.fused_mlp_f32_bwd(*ptrs, *tail)
    if err:
        raise RuntimeError(f"fused_ln_mlp_backward: kernel launch failed with cudaError {err} "
                           f"at x {tuple(x.shape)} {x.dtype}, hidden {Hd}")
    fused_ln_mlp_backward.launches += 1
    return dx, dscale, dbias, dw1t.t(), db1, dw2t.t(), db2


class _FusedLnMlp(torch.autograd.Function):
    """K5 forward, with K5 backward as its gradient; saves only the inputs."""

    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, b2, exact_gelu):
        ctx.exact_gelu = exact_gelu
        ctx.save_for_backward(x, scale, bias, w1, b1, w2, b2)
        return _forward(x, scale, bias, w1, b1, w2, b2, exact_gelu)

    @staticmethod
    def backward(ctx, grad):
        inputs = ctx.saved_tensors
        grads = fused_ln_mlp_backward(*inputs, grad, ctx.exact_gelu)
        return (*(g.to(t.dtype) for g, t in zip(grads, inputs)), None)


def fused_ln_mlp(x, scale, bias, w1, b1, w2, b2, exact_gelu: bool = False) -> torch.Tensor:
    """x + fc2(gelu(fc1(LayerNorm(x)))) per row of x (R, C); differentiable
    through K5's backward."""
    _check(x, scale, bias, w1, b1, w2, b2)
    return _FusedLnMlp.apply(x, scale, bias, w1, b1, w2, b2, bool(exact_gelu))


fused_ln_mlp.launches = 0
fused_ln_mlp_backward.launches = 0
