"""Kernel K2: row-wise sparsemax in CUDA C++ (csrc/sparsemax.cu), and its plain versions.

Replaces the TPU kernel `_sparsemax_kernel` of
probpose_pytorch_tpu/ops/pallas/sparsemax_kernel.py (`sparsemax_pallas`).

What it computes, per row z of R rows: 30 bisection steps on the threshold
tau in [max(z) - 1, max(z)] (f(tau) = sum max(z - tau, 0) - 1), then the
support S = {z > tau_approx}, the exact tau = (sum_S z - 1) / max(|S|, 1),
and out = max(z - tau, 0). The versions here sum the support relative to
the row max, tau = max + (sum_S (z - max) - 1) / |S|: the same tau, but each
z - max is exact (Sterbenz: z lies within 1 of the max) and the sum rounds at
ulp(1) instead of ulp(|S| * max), so tau lands within half an ulp of the
exact value and kernel and plain version agree to one ulp of tau.

The kernel runs the bisection over the row's candidates only: with lo0 =
fl(max - 1), the bracket's first low end as rounded, every midpoint is >=
lo0, so an element z <= lo0 adds exactly 0 to every f and is never in the
support. `sparsemax_candidates_reference` is that design's plain twin
(compaction at lo0 in row order, the bisection over the candidates, the
whole row where they overflow the buffer).

What bounds it on an H100: one read and one write of each f32 element, ~4
operations a byte: device-memory bytes. Rows of up to 3,072 pixels (the
flagship's 64 x 48 heatmaps) run one warp a row with the row in registers;
longer rows one block a row, staged once into shared memory where they fit
(36,864 pixels from 768 x 768 crops), read from device memory on each of
four passes where they do not (65,536 from 1024 x 1024). `sparsemax_route`
picks the kernel from N and the card's shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from probpose_pytorch_tpu_torch.ops import kernels

__all__ = [
    "sparsemax_rows",
    "sparsemax_reference",
    "sparsemax_candidates_reference",
    "sparsemax_route",
    "block_smem_bytes",
    "BISECT_ITERS",
    "WARP_CANDIDATES",
    "BLOCK_CANDIDATES",
]

BISECT_ITERS = 30
# Candidate buffers of csrc/sparsemax.cu: a short row's (one warp) and a
# long row's (one block).
WARP_CANDIDATES = 1024
BLOCK_CANDIDATES = 4096
# Pixels a lane holds in the short-row kernel: rows of up to 32 times that.
_WARP_NPL = (8, 32, 96)


def _tau(src: torch.Tensor, zmax: torch.Tensor) -> torch.Tensor:
    """The threshold of each row: 30 bisection steps of sum max(src - mid, 0)
    - 1 on [zmax - 1, zmax], then the exact tau from the support, summed
    relative to zmax. -inf entries of `src` add nothing."""
    lo, hi = zmax - 1.0, zmax
    for _ in range(BISECT_ITERS):
        mid = (lo + hi) / 2.0
        f = torch.clamp_min(src - mid, 0.0).sum(dim=-1, keepdim=True) - 1.0
        lo = torch.where(f > 0, mid, lo)
        hi = torch.where(f > 0, hi, mid)
    tau_approx = (lo + hi) / 2.0
    support = src > tau_approx
    k = support.sum(dim=-1, keepdim=True).float().clamp_min(1.0)
    ssum = torch.where(support, src - zmax, 0.0).sum(dim=-1, keepdim=True)
    return zmax + (ssum - 1.0) / k


def sparsemax_reference(z: torch.Tensor) -> torch.Tensor:
    """Plain sparsemax along the last axis: a line-by-line counterpart of
    `_sparsemax_fwd_impl` (probpose_pytorch_tpu/ops/sparsemax.py:38-59),
    with the support summed relative to the row max (module docstring)."""
    z32 = z.float()
    zmax = z32.amax(dim=-1, keepdim=True)
    return torch.clamp_min(z32 - _tau(z32, zmax), 0.0).to(z.dtype)


def sparsemax_candidates_reference(z: torch.Tensor,
                                   capacity: int = BLOCK_CANDIDATES) -> torch.Tensor:
    """The kernel's design in plain PyTorch: each row's candidates z > lo0 =
    fl(max - 1) compacted in row order (padded with -inf), the bisection and
    the support sums over them; a row with more than `capacity` candidates
    runs them over the whole row. The output covers the whole row."""
    z32 = z.float()
    flat = z32.reshape(-1, z32.shape[-1])
    zmax = flat.amax(dim=-1, keepdim=True)
    cand = flat > zmax - 1.0
    n = cand.sum(dim=-1, keepdim=True)
    fits = n <= capacity
    width = max(1, int(torch.where(fits, n, 0).max()))
    # Candidates first, in row order: a stable sort of the non-candidate flags.
    order = torch.sort((~cand).to(torch.uint8), dim=-1, stable=True).indices[:, :width]
    packed = torch.gather(flat, -1, order)
    packed = torch.where(torch.arange(width, device=flat.device) < n, packed, float("-inf"))
    tau = torch.where(fits, _tau(packed, zmax), _tau(flat, zmax))
    return torch.clamp_min(flat - tau, 0.0).reshape(z32.shape).to(z.dtype)


def block_smem_bytes(N: int, staged: bool) -> int:
    """Shared memory of the long-row kernel at N pixels: the candidate
    buffer, the row if staged, and the kernel's static words (under 256
    bytes); mirrors csrc/sparsemax.cu's `sparsemax_block_smem_bytes` plus
    those words, which a card test checks."""
    return 4 * (BLOCK_CANDIDATES + (N if staged else 0)) + 256


def sparsemax_route(N: int, smem_limit: int) -> tuple[str, int]:
    """The kernel for rows of N pixels on a card whose blocks may use
    `smem_limit` bytes of shared memory: ("warp", pixels a lane) for rows
    of up to 3,072, else ("block staged", 0) where the row fits shared
    memory and ("block", 0) where it does not."""
    for npl in _WARP_NPL:
        if N <= 32 * npl:
            return "warp", npl
    if block_smem_bytes(N, True) <= smem_limit:
        return "block staged", 0
    return "block", 0


def _lib() -> ctypes.CDLL:
    from probpose_pytorch_tpu_torch.ops.kernels._build import library

    lib = library()
    if not getattr(lib, "_sparsemax_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sparsemax_fwd.argtypes = [ptr, ptr] + [i32] * 6 + [ptr]
        lib.sparsemax_fwd.restype = i32
        lib.sparsemax_block_smem_bytes.argtypes = [i32, i32]
        lib.sparsemax_block_smem_bytes.restype = ctypes.c_longlong
        lib._sparsemax_bound = True
    return lib


def sparsemax_rows(z: torch.Tensor) -> torch.Tensor:
    """Sparsemax of each row of a contiguous (R, N) float32 tensor."""
    if z.dim() != 2:
        raise ValueError(f"sparsemax_rows: expected (R, N), got {tuple(z.shape)}")
    if z.dtype != torch.float32:
        raise TypeError(f"sparsemax_rows: dtype {z.dtype} not supported (float32)")
    if not z.is_contiguous():
        raise ValueError("sparsemax_rows: input must be contiguous")
    R, N = z.shape
    if kernels.use_plain(z, "sparsemax_rows"):
        return sparsemax_reference(z)
    if R == 0 or N == 0:
        raise ValueError(f"sparsemax_rows: empty input {tuple(z.shape)}")
    if R > 2**31 - 1:
        raise ValueError(f"sparsemax_rows: {tuple(z.shape)} exceeds the grid")
    from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import max_shared_memory

    device = z.device.index if z.device.index is not None else torch.cuda.current_device()
    route, npl = sparsemax_route(N, max_shared_memory(device))
    out = torch.empty_like(z)
    vec = N % 4 == 0 and z.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    err = _lib().sparsemax_fwd(z.data_ptr(), out.data_ptr(), R, N, npl,
                               int(route == "block staged"), int(vec), device,
                               torch.cuda.current_stream(z.device).cuda_stream)
    if err:
        raise RuntimeError(f"sparsemax_rows: kernel launch failed with cudaError {err} at "
                           f"{tuple(z.shape)} ({route})")
    sparsemax_rows.launches += 1
    return out


sparsemax_rows.launches = 0
