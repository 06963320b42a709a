"""Kernel K2: row-wise sparsemax in Triton, and its plain version.

Replaces the TPU kernel `_sparsemax_kernel` of
probpose_pytorch_tpu/ops/pallas/sparsemax_kernel.py (`sparsemax_pallas`).

What it computes, per row z of R rows: 30 bisection steps on the threshold
tau in [max(z) - 1, max(z)] (f(tau) = sum max(z - tau, 0) - 1), then the
support S = {z > tau_approx}, the exact tau = (sum_S z - 1) / max(|S|, 1),
and out = max(z - tau, 0). Both versions here sum the support relative to
the row max, tau = max + (sum_S (z - max) - 1) / |S|: the same tau, but each
z - max is exact (Sterbenz: z lies within 1 of the max) and the sum rounds at
ulp(1) instead of ulp(|S| * max), so tau lands within half an ulp of the
exact value and kernel and plain version agree to one ulp of tau.

What bounds it on an H100: one read and one write of each f32 element
(R x 3072 x 8 bytes, ~36 MB at a serving batch of 256 crops x 17 keypoints)
against ~32 reductions over the row, i.e. ~4 FLOP per byte: memory- and
latency-bound, no matrix product. Design: one program per row with the whole
row (3,072 pixels, 12 KB) held in registers as one BLOCK = 4096 vector, so
the 30 bisection reductions never touch memory again; lanes past the row end
load -inf and drop out of every sum and of the support. The ragged tail of R
needs no mask because the grid is exactly R programs.

Rows longer than one register block (16,384 pixels; a 768 x 768 crop's
192 x 192 heatmap gives 36,864) run a second kernel with the same
arithmetic: one program per row loops over the row in chunks of 4,096 on
every sweep (the max, 30 bisection sums, the support and the output), each
lane keeping its own partial sum. The row (147 KB of f32 at 36,864) is
re-read on each of the 33 sweeps; the sweeps of the rows in flight stay
largely in the 50 MB L2. Triton serves here as well as CUDA would: the
work is a chain of row reductions with no matrix product, which Triton's
block reductions express directly, and the kernel stays beside the short
one with the same lines of arithmetic. A CUDA block that staged the row
once in shared memory would read it from there instead of L2; that is a
speed-up for a later version, not a change of result.
"""

from __future__ import annotations

import torch

from probpose_pytorch_tpu_torch.ops import kernels

__all__ = ["sparsemax_rows", "sparsemax_reference", "BISECT_ITERS"]

BISECT_ITERS = 30
_MAX_BLOCK = 16384
_CHUNK = 4096  # the long-row kernel's chunk


def sparsemax_reference(z: torch.Tensor) -> torch.Tensor:
    """Plain sparsemax along the last axis: a line-by-line counterpart of
    `_sparsemax_fwd_impl` (probpose_pytorch_tpu/ops/sparsemax.py:38-59),
    with the support summed relative to the row max (module docstring)."""
    z32 = z.float()
    zmax = z32.amax(dim=-1, keepdim=True)
    lo, hi = zmax - 1.0, zmax
    for _ in range(BISECT_ITERS):
        mid = (lo + hi) / 2.0
        f = torch.clamp_min(z32 - mid, 0.0).sum(dim=-1, keepdim=True) - 1.0
        lo = torch.where(f > 0, mid, lo)
        hi = torch.where(f > 0, hi, mid)
    tau_approx = (lo + hi) / 2.0
    support = z32 > tau_approx
    k = support.sum(dim=-1, keepdim=True).float().clamp_min(1.0)
    ssum = torch.where(support, z32 - zmax, 0.0).sum(dim=-1, keepdim=True)
    tau = zmax + (ssum - 1.0) / k
    return torch.clamp_min(z32 - tau, 0.0).to(z.dtype)


_kernel = None
tl = None  # triton.language, bound by _triton_kernel()


def _triton_kernel():
    """Compile-on-first-use: triton is imported here, never at module import,
    so the package loads where triton is absent. `tl` is bound as a module
    global because triton resolves the kernel's names in its globals."""
    global _kernel, tl
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl

    @triton.jit
    def sparsemax_kernel(z_ptr, out_ptr, N, stride, BLOCK: tl.constexpr,
                         ITERS: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        offs = tl.arange(0, BLOCK)
        mask = offs < N
        z = tl.load(z_ptr + row * stride + offs, mask=mask,
                    other=-float("inf"))
        zmax = tl.max(z, axis=0)
        lo = zmax - 1.0
        hi = zmax
        for _ in range(ITERS):
            mid = (lo + hi) * 0.5
            f = tl.sum(tl.maximum(z - mid, 0.0), axis=0) - 1.0
            lo = tl.where(f > 0, mid, lo)
            hi = tl.where(f > 0, hi, mid)
        tau_approx = (lo + hi) * 0.5
        support = z > tau_approx
        k = tl.maximum(tl.sum(support.to(tl.float32), axis=0), 1.0)
        ssum = tl.sum(tl.where(support, z - zmax, 0.0), axis=0)
        tau = zmax + (ssum - 1.0) / k
        tl.store(out_ptr + row * stride + offs, tl.maximum(z - tau, 0.0),
                 mask=mask)

    @triton.jit
    def sparsemax_long_kernel(z_ptr, out_ptr, N, stride, CHUNK: tl.constexpr,
                              ITERS: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        z_row = z_ptr + row * stride
        offs = tl.arange(0, CHUNK)
        mx = tl.full([CHUNK], -float("inf"), tl.float32)
        for start in range(0, N, CHUNK):
            z = tl.load(z_row + start + offs, mask=start + offs < N, other=-float("inf"))
            mx = tl.maximum(mx, z)
        zmax = tl.max(mx, axis=0)
        lo = zmax - 1.0
        hi = zmax
        for _ in range(ITERS):
            mid = (lo + hi) * 0.5
            acc = tl.zeros([CHUNK], tl.float32)
            for start in range(0, N, CHUNK):
                z = tl.load(z_row + start + offs, mask=start + offs < N,
                            other=-float("inf"))
                acc += tl.maximum(z - mid, 0.0)
            f = tl.sum(acc, axis=0) - 1.0
            lo = tl.where(f > 0, mid, lo)
            hi = tl.where(f > 0, hi, mid)
        tau_approx = (lo + hi) * 0.5
        cnt = tl.zeros([CHUNK], tl.float32)
        ssum = tl.zeros([CHUNK], tl.float32)
        for start in range(0, N, CHUNK):
            z = tl.load(z_row + start + offs, mask=start + offs < N, other=-float("inf"))
            support = z > tau_approx
            cnt += support.to(tl.float32)
            ssum += tl.where(support, z - zmax, 0.0)
        k = tl.maximum(tl.sum(cnt, axis=0), 1.0)
        tau = zmax + (tl.sum(ssum, axis=0) - 1.0) / k
        for start in range(0, N, CHUNK):
            mask = start + offs < N
            z = tl.load(z_row + start + offs, mask=mask, other=-float("inf"))
            tl.store(out_ptr + row * stride + start + offs, tl.maximum(z - tau, 0.0),
                     mask=mask)

    _kernel = (triton, sparsemax_kernel, sparsemax_long_kernel)
    return _kernel


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
    triton, kernel, long_kernel = _triton_kernel()
    block = triton.next_power_of_2(N)
    out = torch.empty_like(z)
    with torch.cuda.device(z.device):
        if block <= _MAX_BLOCK:
            kernel[(R,)](z, out, N, z.stride(0), BLOCK=block,
                         ITERS=BISECT_ITERS, num_warps=8)
        else:
            long_kernel[(R,)](z, out, N, z.stride(0), CHUNK=_CHUNK,
                              ITERS=BISECT_ITERS, num_warps=8)
    sparsemax_rows.launches += 1
    return out


sparsemax_rows.launches = 0
