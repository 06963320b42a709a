"""Kernel K4: row-tiled attention for long sequences, forward and backward,
and their plain versions.

Replaces the TPU kernels `_tiled_fwd_kernel` and `_tiled_bwd_kernel` of
probpose_pytorch_tpu/ops/pallas/attention_tiled.py (`tiled_attention`, a
`jax.custom_vjp` whose backward recomputes the scores). Two CUDA sources,
each with its design and what bounds it on the card; no shape bounded by N:
  * bf16 with d in {32, 64, 128}, csrc/tiled_attention_sm90.cu: a one-sweep
    forward (online softmax, wgmma fed by a TMA ring of K/V tiles) that can
    also write the row log-sum-exp `lse`, and a backward of two kernels (dQ,
    then dK/dV) that takes the forward's output and `lse` instead of
    rebuilding the softmax statistics; no atomics.
  * float32 with d in {32, 64, 80, 128}, and bf16 at d = 80 (the vit-h
    preset), csrc/tiled_attention.cu: CUDA cores, two sweeps (exact softmax)
    and a two-pass recompute backward in the TPU kernels' order; it carries
    the f32 parity checks.

The same bf16 source holds K1's redesigned forward for N <= 256,
`short_forward` (one warpgroup per 64 query rows, every key of the head in
registers, an exact single-pass softmax, P normalised and rounded before
P.V as the TPU kernel does; its plain version is K1's own
`packed_attention_reference`, and `short_attention_reference` adds the
lse); K6 (`attention.fused_attention`) runs it on its q, k, v views. K1's
bf16 backward with d in {32, 64, 128} is K4's, at every N.

`tiled_attention(qkv, heads)` has K1's contract (ops/kernels/attention.py):
the (B, N, 3C) qkv-major projection in, the h-major (B, N, C) context out;
it is a `torch.autograd.Function` whose backward is
`tiled_attention_backward`. In bf16 on the card, where qkv needs a
gradient, it saves (qkv, out, lse); otherwise only qkv, and serving (no
gradient) writes no lse. `packed_attention` picks its kernel by the shape
alone (`attention_route`, a pure function of N, d, the dtype and the card's
shared memory), forward and backward each on its own. Every wrapper takes
the plain version for a CPU tensor and launches the kernel, or raises, for
a CUDA tensor.

Two pairs of plain versions, both chunked over query rows so that no
(B, heads, N, N) score tensor is ever built (at (64, 2304, 1152) it would
hold 8 GB):
  * `tiled_attention_reference` / `tiled_attention_bwd_reference` follow
    the TPU kernels line by line; the wrappers' CPU path and every gate use
    them.
  * `tiled_attention_online_reference` / `tiled_attention_online_bwd_reference`
    follow the bf16 kernels' arithmetic order (online softmax over 128-key
    tiles, P rounded relative to the running max; P = exp(S * scale - lse)
    in the backward, and D = rowsum(dO * O) past EXACT_D_MAX_N tokens).
    Only tests and chip_smoke.py use them, to show how far the kernels'
    order moves from the TPU's.
"""

from __future__ import annotations

import ctypes

import torch

from probpose_pytorch_tpu_torch.ops import kernels

__all__ = [
    "tiled_attention",
    "tiled_attention_reference",
    "tiled_attention_backward",
    "tiled_attention_bwd_reference",
    "tiled_attention_online_reference",
    "tiled_attention_online_bwd_reference",
    "short_forward",
    "short_attention_reference",
    "attention_route",
    "k1_smem_bytes",
    "max_shared_memory",
]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
# Query rows per chunk of the plain versions: (B, heads, 256, N) f32 scores,
# 0.9 GB at (64, 2304, 1152).
PLAIN_CHUNK = 256
# Keys per tile of the bf16 forward kernel (its online softmax's step).
KEY_TILE = 128
LOG2E = 1.4426950408889634
# Longest sequence of the short forward: every key of a head in registers.
SHORT_MAX_N = 256
# Longest sequence whose bf16 backward takes D = rowsum(dP * P) over the
# unrounded P, the TPU kernel's order, in a second sweep over the keys;
# longer ones take D = rowsum(dO * O) from the saved context, where that
# sweep would cost the dQ kernel two of its three products again. At
# N = 192, D from O put K1's backward 2 bf16 ulps from the TPU-order plain
# version on one of eight draws at (256, 192, 1152), past K1's bound.
EXACT_D_MAX_N = SHORT_MAX_N

# Head widths of K4's CUDA-core kernels (csrc/tiled_attention.cu), per
# dtype: bf16 only where the wgmma kernels (HEAD_DIMS) do not reach.
CUDA_CORE_DIMS = {torch.float32: (32, 64, 80, 128), torch.bfloat16: (80,)}

# packed_attention's routes (`attention_route`, `attention.kernel_path`).
SM90_SHORT = "sm90 short"  # short_forward, csrc/tiled_attention_sm90.cu
SM90_TILED = "sm90 tiled"  # K4 bf16, csrc/tiled_attention_sm90.cu
K1_CUDA_CORES = "K1 CUDA cores"  # csrc/packed_attention.cu
K4_CUDA_CORES = "K4 CUDA cores"  # csrc/tiled_attention.cu
NO_KERNEL = "no kernel"  # raises on the card; the plain version on the CPU


def k1_smem_bytes(N: int, d: int, dtype: torch.dtype) -> int:
    """Shared memory per block of K1's CUDA-core kernels at (N, d, dtype),
    forward and backward alike (csrc/packed_attention.cu: smem_bytes and
    bwd_smem_bytes): K rows padded by one 32-bit word, V rows, and per
    warp (eight forward, four backward with two rows each) d + N f32."""
    size = 4 if dtype == torch.float32 else 2
    return N * (2 * d + 4 // size) * size + 32 * (d + N)


def attention_route(N: int, d: int, dtype: torch.dtype, limit: int,
                    backward: bool = False) -> str:
    """The kernel that serves attention of N tokens with head width d in
    `dtype`, forward or backward, on a card whose opt-in shared memory per
    block is `limit` bytes. The shape decides alone:
      * bf16, d in {32, 64, 128}: the wgmma kernels, "sm90 short" (forward,
        N <= 256) or "sm90 tiled" (K4: longer forwards, every backward);
      * else "K1 CUDA cores" where K1's shared memory fits the card;
      * else "K4 CUDA cores" at K4's CUDA-core widths (`CUDA_CORE_DIMS`: f32
        d in {32, 64, 80, 128}, bf16 d = 80), as the JAX package's
        packed_attention hands such shapes to its row-tiled kernel;
      * else "no kernel (d=.., N=..)": the card raises
        NotImplementedError, the CPU computes the plain version."""
    if dtype == torch.bfloat16 and d in HEAD_DIMS:
        return SM90_SHORT if N <= SHORT_MAX_N and not backward else SM90_TILED
    if k1_smem_bytes(N, d, dtype) <= limit:
        return K1_CUDA_CORES
    if d in CUDA_CORE_DIMS[dtype]:
        return K4_CUDA_CORES
    return f"{NO_KERNEL} (d={d}, N={N})"


def _head_dims(dtype: torch.dtype) -> tuple[int, ...]:
    """The head widths K4's kernels take in `dtype`, wgmma and CUDA cores."""
    wgmma = HEAD_DIMS if dtype == torch.bfloat16 else ()
    return tuple(sorted(wgmma + CUDA_CORE_DIMS[dtype]))


def _wgmma(qkv: torch.Tensor, heads: int) -> bool:
    """Whether K4 runs qkv on its wgmma kernels (else on the CUDA cores)."""
    return qkv.dtype == torch.bfloat16 and qkv.shape[2] // 3 // heads in HEAD_DIMS


def short_attention_reference(qkv: torch.Tensor, heads: int):
    """Plain version of `short_forward`, in the TPU kernel's order: the
    context of `attention.packed_attention_reference` (f32 softmax, P
    rounded to qkv's dtype before P.V) and the row log-sum-exp of the
    scaled scores, (B, heads, N) f32. Returns (out, lse)."""
    B, N, C3 = qkv.shape
    q, k, v, d, scale = _heads_split(qkv, heads)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k) * scale
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", p.float(), v)
    return out.reshape(B, N, C3 // 3).to(qkv.dtype), torch.logsumexp(s, dim=-1)


def _heads_split(qkv: torch.Tensor, heads: int):
    B, N, C3 = qkv.shape
    d = C3 // 3 // heads
    q, k, v = qkv.reshape(B, N, 3, heads, d).unbind(2)
    return q, k.float(), v.float(), d, 1.0 / d**0.5


def tiled_attention_reference(qkv: torch.Tensor, heads: int,
                              chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain forward, line by line `_tiled_fwd_kernel` (attention_tiled.py:
    119-144), over chunks of `chunk` query rows: s = q.k * scale in f32,
    s - rowmax, exp, divided by its row sum, P rounded to qkv's dtype before
    P.V in f32; the context (B, N, C) in qkv's dtype."""
    B, N, C3 = qkv.shape
    q, k, v, d, scale = _heads_split(qkv, heads)
    out = torch.empty((B, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    for n0 in range(0, N, chunk):
        s = torch.einsum("bnhd,bmhd->bhnm", q[:, n0:n0 + chunk].float(), k) * scale
        s = s - s.amax(dim=-1, keepdim=True)
        p = torch.exp(s)
        p = p / p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhnm,bmhd->bnhd", p.to(qkv.dtype).float(), v)
        out[:, n0:n0 + chunk] = o.reshape(B, -1, C3 // 3).to(qkv.dtype)
    return out


def tiled_attention_bwd_reference(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
                                  chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain backward, line by line `_tiled_bwd_kernel` (attention_tiled.py:
    147-192), over chunks of query rows: the f32 softmax recomputed from qkv;
    dP = dO V^T; dsum = rowsum(dP * P) over the unrounded P;
    dS = round(P * (dP - dsum) * scale); dQ = dS K per chunk, dK += dS^T Q
    and dV += round(P)^T dO summed in f32 over the chunks. round() is to
    qkv's dtype. Returns dqkv (B, N, 3C) packed like qkv, in its dtype."""
    B, N, C3 = qkv.shape
    q, k, v, d, scale = _heads_split(qkv, heads)
    do = dout.reshape(B, N, heads, d)
    rnd = lambda t: t.to(qkv.dtype).float()
    dq = torch.empty((B, N, heads, d), dtype=torch.float32, device=qkv.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for n0 in range(0, N, chunk):
        qc = q[:, n0:n0 + chunk].float()
        doc = do[:, n0:n0 + chunk].float()
        s = torch.einsum("bnhd,bmhd->bhnm", qc, k) * scale
        s = s - s.amax(dim=-1, keepdim=True)
        p = torch.exp(s)
        p = p / p.sum(dim=-1, keepdim=True)
        dp = torch.einsum("bnhd,bmhd->bhnm", doc, v)
        dsum = (dp * p).sum(dim=-1, keepdim=True)
        ds = rnd(p * (dp - dsum) * scale)
        dq[:, n0:n0 + chunk] = torch.einsum("bhnm,bmhd->bnhd", ds, k)
        dk += torch.einsum("bhnm,bnhd->bmhd", ds, qc)
        dv += torch.einsum("bhnm,bnhd->bmhd", rnd(p), doc)
    dq, dk, dv = (t.to(qkv.dtype) for t in (dq, dk, dv))
    return torch.stack([dq, dk, dv], dim=2).reshape(B, N, C3)


def _heads_d(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, C) -> f32 (B, N, heads, d)."""
    B, N, C = t.shape
    return t.float().reshape(B, N, heads, C // heads)


def tiled_attention_online_reference(qkv: torch.Tensor, heads: int, chunk: int = PLAIN_CHUNK,
                                     key_tile: int = KEY_TILE):
    """Plain forward in the bf16 kernel's order: per chunk of query rows,
    one sweep over tiles of `key_tile` keys with the running max m (raw
    scores) and sum l; p = 2^(s * scale * log2 e - m * scale * log2 e),
    rounded to qkv's dtype before P.V, o and l rescaled by
    2^((m_old - m) * scale * log2 e) when m grows; out = round(o / l) and
    lse = m * scale + log l. Returns (out (B, N, C) in qkv's dtype, lse
    (B, heads, N) f32)."""
    B, N, C3 = qkv.shape
    q, k, v, d, scale = _heads_split(qkv, heads)
    sl2 = scale * LOG2E
    out = torch.empty((B, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, heads, N), dtype=torch.float32, device=qkv.device)
    for n0 in range(0, N, chunk):
        qc = q[:, n0:n0 + chunk].float()
        n = qc.shape[1]
        m = torch.full((B, heads, n, 1), -torch.inf, device=qkv.device)
        l = torch.zeros((B, heads, n, 1), device=qkv.device)
        o = torch.zeros((B, heads, n, d), device=qkv.device)
        for k0 in range(0, N, key_tile):
            s = torch.einsum("bnhd,bmhd->bhnm", qc, k[:, k0:k0 + key_tile])
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            corr = torch.exp2((m - m_new) * sl2)
            p = torch.exp2(s * sl2 - m_new * sl2)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            o = o * corr + torch.einsum("bhnm,bmhd->bhnd", p.to(qkv.dtype).float(),
                                        v[:, k0:k0 + key_tile])
            m = m_new
        out[:, n0:n0 + chunk] = (o / l).permute(0, 2, 1, 3).reshape(B, n, -1).to(qkv.dtype)
        lse[:, :, n0:n0 + chunk] = (m * scale + torch.log(l))[..., 0]
    return out, lse


def tiled_attention_online_bwd_reference(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
                                         out: torch.Tensor | None = None,
                                         lse: torch.Tensor | None = None,
                                         chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain backward in the bf16 kernels' order, from the forward's `out`
    and `lse` (made by `tiled_attention_online_reference` when either is
    None): per chunk of query rows P = 2^(S * scale * log2 e - lse * log2 e),
    dP = dO V^T, D = rowsum(dP * P) up to EXACT_D_MAX_N tokens and
    rowsum(dO * O) over the rounded O past them, dS = round(P * (dP - D) *
    scale); dQ = dS K, dK += dS^T Q and dV += round(P)^T dO in f32. Returns
    dqkv (B, N, 3C) in qkv's dtype."""
    if out is None or lse is None:
        out, lse = tiled_attention_online_reference(qkv, heads, chunk)
    B, N, C3 = qkv.shape
    q, k, v, d, scale = _heads_split(qkv, heads)
    sl2 = scale * LOG2E
    do = _heads_d(dout, heads)
    exact = N <= EXACT_D_MAX_N
    if not exact:  # (B, H, N, 1)
        dsum = (do * _heads_d(out, heads)).sum(dim=-1).permute(0, 2, 1)[..., None]
    rnd = lambda t: t.to(qkv.dtype).float()
    dq = torch.empty((B, N, heads, d), dtype=torch.float32, device=qkv.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for n0 in range(0, N, chunk):
        qc = q[:, n0:n0 + chunk].float()
        doc = do[:, n0:n0 + chunk]
        s = torch.einsum("bnhd,bmhd->bhnm", qc, k)
        p = torch.exp2(s * sl2 - lse[:, :, n0:n0 + chunk, None] * LOG2E)
        dp = torch.einsum("bnhd,bmhd->bhnm", doc, v)
        d_c = (dp * p).sum(dim=-1, keepdim=True) if exact else dsum[:, :, n0:n0 + chunk]
        ds = rnd(p * (dp - d_c) * scale)
        dq[:, n0:n0 + chunk] = torch.einsum("bhnm,bmhd->bnhd", ds, k)
        dk += torch.einsum("bhnm,bnhd->bmhd", ds, qc)
        dv += torch.einsum("bhnm,bnhd->bmhd", rnd(p), doc)
    dq, dk, dv = (t.to(qkv.dtype) for t in (dq, dk, dv))
    return torch.stack([dq, dk, dv], dim=2).reshape(B, N, C3)


def _lib() -> ctypes.CDLL:
    from probpose_pytorch_tpu_torch.ops.kernels._build import library

    lib = library()
    if not getattr(lib, "_tiled_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.tiled_attention_fwd.argtypes = [ptr, ptr] + [i32] * 6 + [ptr]
        lib.tiled_attention_bwd.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        lib.tiled_attention_sm90_fwd.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
        lib.tiled_attention_sm90_bwd.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        lib.short_attention_sm90_fwd.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
        for name in ("tiled_attention_fwd", "tiled_attention_bwd", "tiled_attention_sm90_fwd",
                     "tiled_attention_sm90_bwd", "short_attention_sm90_fwd"):
            getattr(lib, name).restype = i32
        lib.short_attention_sm90_smem_bytes.argtypes = [i32] * 2
        lib.short_attention_sm90_smem_bytes.restype = ctypes.c_longlong
        for name in ("tiled_attention_smem_bytes", "tiled_attention_sm90_smem_bytes"):
            getattr(lib, name).argtypes = [i32] * 2
            getattr(lib, name).restype = ctypes.c_longlong
        lib.packed_attention_max_smem.argtypes = [i32, ctypes.POINTER(i32)]
        lib.packed_attention_max_smem.restype = i32
        lib._tiled_bound = True
    return lib


def max_shared_memory(device: int) -> int:
    """The card's opt-in shared memory per block, in bytes."""
    limit = ctypes.c_int(0)
    err = _lib().packed_attention_max_smem(device, ctypes.byref(limit))
    if err:
        raise RuntimeError(f"cudaDeviceGetAttribute failed ({err})")
    return limit.value


def _check(qkv: torch.Tensor, heads: int, layout: str, what: str) -> None:
    if layout == "head_major":
        raise NotImplementedError(
            f"{what}: layout='head_major' is the tensor-parallel packing, not ported "
            "to PyTorch yet (ROADMAP item 13)")
    if layout != "qkv_major":
        raise ValueError(f"{what}: unknown layout {layout!r}")
    if qkv.dim() != 3:
        raise ValueError(f"{what}: qkv must be (B, N, 3C), got {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    if C3 % 3 or (C3 // 3) % heads:
        raise ValueError(f"{what}: last dim {C3} is not 3 * heads({heads}) * d")
    if qkv.dtype not in DTYPES:
        raise TypeError(f"{what}: dtype {qkv.dtype} not supported (float32 or bfloat16)")
    if not qkv.is_contiguous():
        raise ValueError(f"{what}: qkv must be contiguous")
    if B == 0 or N == 0:
        raise ValueError(f"{what}: empty qkv {tuple(qkv.shape)}")


def _smem_need(d: int, dtype: torch.dtype, backward: bool) -> int:
    """Shared memory per block of K4's largest kernel for (d, dtype)."""
    lib = _lib()
    if dtype == torch.float32 or d not in HEAD_DIMS:
        return lib.tiled_attention_smem_bytes(d, int(backward))
    passes = (0, 1, 2) if backward else (0,)  # the backward may run the forward
    return max(lib.tiled_attention_sm90_smem_bytes(d, p) for p in passes)


def _device(qkv: torch.Tensor, heads: int, backward: bool, what: str) -> int:
    """CUDA device index of qkv, after checking that K4 takes its head
    width, that its shared memory fits the card and that qkv is 16-byte
    aligned."""
    B, N, C3 = qkv.shape
    d = C3 // 3 // heads
    if d not in _head_dims(qkv.dtype):
        raise ValueError(f"{what}: head width d={d} not supported in {qkv.dtype} "
                         f"(one of {_head_dims(qkv.dtype)})")
    if B > 65535:
        raise ValueError(f"{what}: batch {B} exceeds the grid's 65535")
    device = qkv.device.index if qkv.device.index is not None else torch.cuda.current_device()
    need = _smem_need(d, qkv.dtype, backward)
    limit = max_shared_memory(device)
    if need > limit:
        raise ValueError(f"{what}: d={d} ({qkv.dtype}) needs {need} bytes of shared "
                         f"memory, the card allows {limit}")
    if qkv.data_ptr() % 16:
        raise ValueError(f"{what}: qkv must be 16-byte aligned")
    return device


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(qkv: torch.Tensor, heads: int, device: int, with_lse: bool):
    """One forward launch: (out, lse), lse None unless asked for (bf16)."""
    B, N, C3 = qkv.shape
    out = torch.empty((B, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = None
    if _wgmma(qkv, heads):
        if with_lse:
            lse = torch.empty((B, heads, N), dtype=torch.float32, device=qkv.device)
        err = _lib().tiled_attention_sm90_fwd(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None,
            B, N, C3 // 3, heads, device, _stream(qkv))
    else:
        err = _lib().tiled_attention_fwd(qkv.data_ptr(), out.data_ptr(), B, N, C3 // 3, heads,
                                         DTYPES[qkv.dtype], device, _stream(qkv))
    if err:
        raise RuntimeError(f"tiled_attention: kernel launch failed with cudaError {err} "
                           f"at qkv {tuple(qkv.shape)} {qkv.dtype}")
    return out, lse


# The forward ops' schema: the context and the lse (empty where none is made).
_QKV_SCHEMA = "(Tensor qkv, int heads, bool with_lse) -> (Tensor, Tensor)"
# An op's body makes its inputs contiguous before it reads their pointers:
# the wrappers check contiguity when a program is traced, on fake tensors,
# and a loaded program's real tensors can differ from them in layout (a
# convolution's output at batch 1 is channels-last on cuDNN where its fake
# was not), so a body must not trust the check it was traced with. A
# contiguous tensor passes through uncopied.


def tiled_forward(qkv: torch.Tensor, heads: int, with_lse: bool = False):
    """K4 forward on a checked qkv: (out, lse). The plain version for a CPU
    tensor (or under `plain_versions()`), else one kernel launch through the
    `probpose::tiled_attention_fwd` op; lse, the (B, heads, N) f32 row
    log-sum-exp, only on the wgmma route (bf16, d in {32, 64, 128}) on the
    card with `with_lse`, else None."""
    if kernels.use_plain(qkv, "tiled_attention"):
        return tiled_attention_reference(qkv, heads), None
    out, lse = torch.ops.probpose.tiled_attention_fwd(qkv, heads, with_lse)
    return out, (lse if with_lse and _wgmma(qkv, heads) else None)


@torch.library.custom_op("probpose::tiled_attention_fwd", mutates_args=(), schema=_QKV_SCHEMA)
def _tiled_fwd_op(qkv, heads, with_lse):
    """K4's forward launch as an op that torch.export records; the lse is
    an empty tensor where none is made."""
    qkv = qkv.contiguous()  # at run time: the note at _QKV_SCHEMA
    device = _device(qkv, heads, False, "tiled_attention")
    out, lse = _launch_fwd(qkv, heads, device, with_lse)
    tiled_attention.launches += 1
    return out, _no_lse(qkv) if lse is None else lse


@_tiled_fwd_op.register_fake
def _(qkv, heads, with_lse):
    B, N, C3 = qkv.shape
    lse_shape = (B, heads, N) if with_lse and _wgmma(qkv, heads) else (0,)
    return qkv.new_empty((B, N, C3 // 3)), qkv.new_empty(lse_shape, dtype=torch.float32)


def _no_lse(qkv: torch.Tensor) -> torch.Tensor:
    """The empty tensor an op returns in place of an lse it did not make."""
    return torch.empty((0,), dtype=torch.float32, device=qkv.device)


def short_forward(qkv: torch.Tensor, heads: int, with_lse: bool = False):
    """K1's bf16 forward for N <= 256 on a checked qkv: (out, lse). The plain
    version for a CPU tensor (or under `plain_versions()`), else one launch
    of the short kernel of csrc/tiled_attention_sm90.cu through the
    `probpose::short_attention_fwd` op; lse, the (B, heads, N) f32 row
    log-sum-exp, only with `with_lse`, else None."""
    if kernels.use_plain(qkv, "short_forward"):
        out, lse = short_attention_reference(qkv, heads)
        return out, lse if with_lse else None
    B, N, C3 = qkv.shape
    d = C3 // 3 // heads
    if qkv.dtype != torch.bfloat16 or d not in HEAD_DIMS or N > SHORT_MAX_N:
        raise ValueError(f"short_forward: takes bf16 with d in {HEAD_DIMS} and N <= "
                         f"{SHORT_MAX_N}, got N={N}, d={d} ({qkv.dtype})")
    out, lse = torch.ops.probpose.short_attention_fwd(qkv, heads, with_lse)
    return out, lse if with_lse else None


@torch.library.custom_op("probpose::short_attention_fwd", mutates_args=(), schema=_QKV_SCHEMA)
def _short_fwd_op(qkv, heads, with_lse):
    """The short kernel's launch as an op that torch.export records; the
    lse is an empty tensor without `with_lse`."""
    qkv = qkv.contiguous()  # at run time: the note at _QKV_SCHEMA
    B, N, C3 = qkv.shape
    d = C3 // 3 // heads
    device = _device(qkv, heads, False, "short_forward")
    need = _lib().short_attention_sm90_smem_bytes(d, N)
    if need > max_shared_memory(device):
        raise ValueError(f"short_forward: N={N}, d={d} needs {need} bytes of shared memory")
    out = torch.empty((B, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, heads, N), dtype=torch.float32, device=qkv.device) if with_lse else None
    err = _lib().short_attention_sm90_fwd(qkv.data_ptr(), out.data_ptr(),
                                          lse.data_ptr() if with_lse else None,
                                          B, N, C3 // 3, heads, device, _stream(qkv))
    if err:
        raise RuntimeError(f"short_forward: kernel launch failed with cudaError {err} "
                           f"at qkv {tuple(qkv.shape)} {qkv.dtype}")
    short_forward.launches += 1
    return out, _no_lse(qkv) if lse is None else lse


@_short_fwd_op.register_fake
def _(qkv, heads, with_lse):
    B, N, C3 = qkv.shape
    return (qkv.new_empty((B, N, C3 // 3)),
            qkv.new_empty((B, heads, N) if with_lse else (0,), dtype=torch.float32))


def tiled_attention_backward(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
                             out: torch.Tensor | None = None,
                             lse: torch.Tensor | None = None) -> torch.Tensor:
    """dqkv (B, N, 3C) of `tiled_attention` from qkv and the context's
    gradient dout (B, N, C), both of one dtype; dout is made contiguous. In
    bf16 on the card the backward reads the forward's context `out` and
    `lse`; where either is None, it runs the forward kernel first to make
    them, counted in `tiled_attention_backward.recomputes` and not as a
    forward launch. The CPU path and the CUDA-core kernels ignore them."""
    _check(qkv, heads, "qkv_major", "tiled_attention_backward")
    B, N, C3 = qkv.shape
    if tuple(dout.shape) != (B, N, C3 // 3):
        raise ValueError(f"tiled_attention_backward: dout {tuple(dout.shape)} does not "
                         f"match qkv {tuple(qkv.shape)}")
    if dout.dtype != qkv.dtype or dout.device != qkv.device:
        raise TypeError(f"tiled_attention_backward: dout is {dout.dtype} on {dout.device}, "
                        f"qkv {qkv.dtype} on {qkv.device}")
    if kernels.use_plain(qkv, "tiled_attention_backward"):
        return tiled_attention_bwd_reference(qkv, dout, heads)
    device = _device(qkv, heads, True, "tiled_attention_backward")
    dout = dout.contiguous()
    if dout.data_ptr() % 16:
        raise ValueError("tiled_attention_backward: dout must be 16-byte aligned")
    dqkv = torch.empty_like(qkv)
    if _wgmma(qkv, heads):
        if out is None or lse is None:
            out, lse = _launch_fwd(qkv, heads, device, with_lse=True)
            tiled_attention_backward.recomputes += 1
        if out.shape != dout.shape or out.dtype != qkv.dtype or not out.is_contiguous() \
                or lse.shape != (B, heads, N) or lse.dtype != torch.float32 \
                or not lse.is_contiguous():
            raise ValueError("tiled_attention_backward: out must be the forward's contiguous "
                             f"(B, N, C) context and lse its ({B}, {heads}, {N}) f32 lse")
        dsum = torch.empty((B, heads, N), dtype=torch.float32, device=qkv.device)
        err = _lib().tiled_attention_sm90_bwd(
            qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
            dqkv.data_ptr(), B, N, C3 // 3, heads, int(N <= EXACT_D_MAX_N), device,
            _stream(qkv))
    else:
        stats = torch.empty((3, B, heads, N), dtype=torch.float32, device=qkv.device)
        err = _lib().tiled_attention_bwd(
            qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            B, N, C3 // 3, heads, DTYPES[qkv.dtype], device, _stream(qkv))
    if err:
        raise RuntimeError(f"tiled_attention_backward: kernel launch failed with cudaError "
                           f"{err} at qkv {tuple(qkv.shape)} {qkv.dtype}")
    tiled_attention_backward.launches += 1
    return dqkv


class _TiledAttention(torch.autograd.Function):
    """K4 forward, with K4 backward as its gradient; saves (qkv, out, lse)
    where the forward made lse (the wgmma route on the card), else only
    qkv."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int) -> torch.Tensor:
        ctx.heads = heads
        out, lse = tiled_forward(qkv, heads, with_lse=ctx.needs_input_grad[0])
        ctx.save_for_backward(*((qkv,) if lse is None else (qkv, out, lse)))
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        qkv, *residuals = ctx.saved_tensors
        return tiled_attention_backward(qkv, grad, ctx.heads, *residuals), None


def tiled_attention(qkv: torch.Tensor, heads: int, layout: str = "qkv_major") -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v per head from packed (B, N, 3C) qkv, by K4
    at any N; differentiable through K4's backward."""
    _check(qkv, heads, layout, "tiled_attention")
    return _TiledAttention.apply(qkv, heads)


short_forward.launches = 0
tiled_attention.launches = 0
tiled_attention_backward.launches = 0
tiled_attention_backward.recomputes = 0
