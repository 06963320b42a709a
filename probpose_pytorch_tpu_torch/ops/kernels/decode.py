"""Kernel K3: the fused expected-value decode, in CUDA C++ (csrc/decode.cu).

Replaces the TPU kernel `_decode_kernel` of
probpose_pytorch_tpu/ops/pallas/decode_kernel.py, whose public function is
`expected_value_decode_pallas`. It computes what
`ops.heatmap.expected_value_decode` computes -- the separable reflect OKS
convolution, the first-occurrence argmax, the sub-pixel Taylor step and the
raw value at the integer argmax -- in one launch that writes only the
(x, y) and value of each map. That plain function is its plain version.

The OKS operators are band matrices, so the kernel's products run over each
keypoint's band only. `band_radius` finds the band from the operators (the
largest |i - j| of a nonzero entry; n - 1 for a dense operator), and the
wrapper packs the column operator's band once per operator pair, so the
card is synced once and not on every call.
`expected_value_decode_banded_reference` is the banded design's plain twin.

As in the JAX package, no serving or training path calls it: the port's
decode stays the plain one, and this kernel is the fused alternative for
large heatmaps (192 x 192 from 768 x 768 crops). The wrapper takes the plain
version for a CPU tensor and launches the kernel, or raises, for a CUDA
tensor.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from probpose_pytorch_tpu_torch.ops import kernels
from probpose_pytorch_tpu_torch.ops.heatmap import decode_convolved, expected_value_decode

__all__ = [
    "expected_value_decode_fused",
    "expected_value_decode_banded_reference",
    "band_radius",
    "operator_bands",
]


def band_radius(op: torch.Tensor) -> torch.Tensor:
    """(K, n, n) operators -> (K,) int64: the largest |i - j| of a nonzero
    entry op[k, i, j] (0 for an all-zero operator)."""
    n = op.shape[-1]
    i = torch.arange(n, device=op.device)
    dist = (i[:, None] - i[None, :]).abs()
    return torch.where(op != 0, dist, 0).flatten(-2).amax(dim=-1)


def _shift(t: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """t moved by d along `dim` (out[i] = t[i + d]), zeros past the edge."""
    n = t.shape[dim]
    out = torch.zeros_like(t)
    if abs(d) < n:
        src = t.narrow(dim, max(d, 0), n - abs(d))
        out.narrow(dim, max(-d, 0), n - abs(d)).copy_(src)
    return out


def _diagonal(op: torch.Tensor, d: int) -> torch.Tensor:
    """(K, n) of op[k, i, i + d], zeros where i + d is outside [0, n)."""
    n = op.shape[-1]
    out = torch.zeros(op.shape[:-1], dtype=op.dtype, device=op.device)
    if abs(d) < n:
        out.narrow(-1, max(-d, 0), n - abs(d)).copy_(torch.diagonal(op, d, -2, -1))
    return out


def expected_value_decode_banded_reference(heatmaps: torch.Tensor, row_op: torch.Tensor,
                                           col_op: torch.Tensor):
    """The kernel's design in plain PyTorch: t = hm . col_op^T and conv =
    row_op . t as sums over each band, in ascending index order (mul then
    add where the kernel fuses them), then the decode of
    `expected_value_decode`. (B, K, H, W) float32 -> locs (B, K, 2), vals
    (B, K)."""
    r = int(torch.maximum(band_radius(row_op).max(), band_radius(col_op).max()))
    t = torch.zeros_like(heatmaps)
    for d in range(-r, r + 1):  # t[.., g, w] += hm[.., g, w + d] col[k, w, w + d]
        t = t + _shift(heatmaps, d, -1) * _diagonal(col_op, d)[None, :, None, :]
    conv = torch.zeros_like(heatmaps)
    for d in range(-r, r + 1):  # conv[.., h, w] += row[k, h, h + d] t[.., h + d, w]
        conv = conv + _diagonal(row_op, d)[None, :, :, None] * _shift(t, d, -2)
    return decode_convolved(heatmaps, conv)


_bands: dict = {}


def _version(t: torch.Tensor) -> int | None:
    """The tensor's in-place version; inference tensors (the codec builds its
    operators under torch.inference_mode) keep none."""
    return None if t.is_inference() else t._version


def operator_bands(row_op: torch.Tensor, col_op: torch.Tensor):
    """(radius (K,) int32, col_band (K, 2 R + 1, round4(W)) float32, R): each
    keypoint's band radius over both operators, the column operator's band
    packed as col_band[k, d, w] = col_op[k, w, w - radius[k] + d] (zero
    outside it), and R = the largest radius. Cached per operator pair (the
    same tensors, not changed in place since), so only the first call syncs
    the card."""
    key = (id(row_op), id(col_op))
    versions = (_version(row_op), _version(col_op))
    hit = _bands.get(key)
    if hit is not None:
        row_ref, col_ref, seen, value = hit
        if row_ref() is row_op and col_ref() is col_op and seen == versions:
            return value
    radius = torch.maximum(band_radius(row_op), band_radius(col_op))
    R = int(radius.max())
    K, W = col_op.shape[0], col_op.shape[-1]
    Wp = (W + 3) // 4 * 4
    w = torch.arange(Wp, device=col_op.device)
    d = torch.arange(2 * R + 1, device=col_op.device)
    v = w[None, None, :] - radius[:, None, None] + d[None, :, None]  # (K, D, Wp)
    inside = (v >= 0) & (v < W) & (w < W) & (d[None, :, None] <= 2 * radius[:, None, None])
    ks = torch.arange(K, device=col_op.device)[:, None, None]
    band = col_op[ks, w.clamp(max=W - 1)[None, None, :], v.clamp(0, W - 1)]
    value = (radius.to(torch.int32).contiguous(), torch.where(inside, band, 0.0).contiguous(), R)
    if len(_bands) >= 8:
        _bands.pop(next(iter(_bands)))
    _bands[key] = (weakref.ref(row_op), weakref.ref(col_op), versions, value)
    return value


def _lib() -> ctypes.CDLL:
    from probpose_pytorch_tpu_torch.ops.kernels._build import library

    lib = library()
    if not getattr(lib, "_decode_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.expected_value_decode_fwd.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
        lib.expected_value_decode_fwd.restype = i32
        lib.decode_smem_bytes.argtypes = [i32, i32, i32]
        lib.decode_smem_bytes.restype = ctypes.c_longlong
        lib.decode_strips.argtypes = [i32, i32, i32]
        lib.decode_strips.restype = i32
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

    row_op, col_op = row_op.contiguous(), col_op.contiguous()
    heatmaps = heatmaps.contiguous()
    device = heatmaps.device.index if heatmaps.device.index is not None \
        else torch.cuda.current_device()
    radius, band, R = operator_bands(row_op, col_op)
    lib = _lib()
    need, limit = lib.decode_smem_bytes(H, W, R), max_shared_memory(device)
    if need > limit:
        raise ValueError(f"expected_value_decode_fused: {H} x {W} maps with band radius {R} "
                         f"need {need} bytes of shared memory, the card allows {limit}")
    strips = lib.decode_strips(H, W, R)
    if B * K * strips > 2**31 - 1:
        raise ValueError(f"expected_value_decode_fused: {B * K} maps exceed the grid")
    locs = torch.empty((B, K, 2), dtype=torch.float32, device=heatmaps.device)
    vals = torch.empty((B, K), dtype=torch.float32, device=heatmaps.device)
    rec = rec_idx = None
    if strips > 1:
        rec = torch.empty((B * K * strips, 4), dtype=torch.float32, device=heatmaps.device)
        rec_idx = torch.empty(B * K * strips, dtype=torch.int32, device=heatmaps.device)
    err = lib.expected_value_decode_fwd(
        heatmaps.data_ptr(), row_op.data_ptr(), band.data_ptr(), radius.data_ptr(),
        rec.data_ptr() if rec is not None else None,
        rec_idx.data_ptr() if rec_idx is not None else None,
        locs.data_ptr(), vals.data_ptr(), B, K, H, W, R, device,
        torch.cuda.current_stream(heatmaps.device).cuda_stream)
    if err:
        raise RuntimeError(f"expected_value_decode_fused: kernel launch failed with cudaError "
                           f"{err} at heatmaps {tuple(heatmaps.shape)}")
    expected_value_decode_fused.launches += 1
    return locs, vals


expected_value_decode_fused.launches = 0
