"""packed_attention's route and the plain versions of the kernels it picks,
against the JAX package, on the CPU.

`attention_route` is a pure function of (N, d, dtype, the card's shared
memory): bf16 at every head width that is a multiple of 8 from 16 to 256
(the vit-h preset's d = 80 and ViT-g's d = 88 among them) goes to the wgmma
kernels of csrc/tiled_attention_sm90.cu where their tiles fit, float32 and
other widths stay on K1's CUDA cores, and past K1's shared memory every
other d, past 256 too, goes to K4's CUDA-core kernels, as JAX's
`packed_attention` hands such shapes to its row-tiled kernel (fault 13:
the port once had no kernel past d = 256). The plain versions of the wgmma design (the short forward
in the TPU kernel's order, the tiled forward's online order, and the
backward from the saved (out, lse)) and of K4's CUDA-core kernels (the TPU
order) are held against JAX's `packed_attention` in interpret mode; inputs
come from numpy generators, tolerances stand beside each check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.ops.pallas import packed_attention as jax_packed_attention
from probpose_pytorch_tpu.ops.pallas.attention_tiled import tiled_feasible_bq
from probpose_pytorch_tpu_torch.ops.kernels.attention import (
    packed_attention,
    packed_attention_reference,
)
from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
    MAX_GRID_Z,
    SHORT_MAX_N,
    attention_route,
    batch_chunks,
    cuda_core_smem_bytes,
    cuda_core_warps,
    k1_smem_bytes,
    short_attention_reference,
    short_smem_bytes,
    short_forward,
    tiled_attention,
    tiled_attention_bwd_reference,
    tiled_attention_online_bwd_reference,
    tiled_attention_online_reference,
    tiled_attention_reference,
)

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

BF16, F32 = torch.bfloat16, torch.float32
H100_SMEM = 232448  # an H100's opt-in shared memory per block, bytes


def k1_bound(ref: np.ndarray) -> float:
    """K1's bf16 bound (chip_smoke.py:k1_bound): two bf16 ulps of
    max(1, max|ref|) -- an f32 sum in another order can move a bf16 output
    across one rounding boundary."""
    return 2 * 2**-8 * max(1.0, float(np.abs(ref).max()))


# --------------------------------------------------------------------------
# the route, a pure function of the shape


@pytest.mark.parametrize("name,N,d,dtype,fwd,bwd", [
    ("flagship", 192, 64, BF16, "sm90 short", "sm90 tiled"),
    ("vitb", 192, 64, BF16, "sm90 short", "sm90 tiled"),  # 12 heads; d decides
    ("fieldsynth", 576, 32, BF16, "sm90 tiled", "sm90 tiled"),
    ("768sq", 2304, 64, BF16, "sm90 tiled", "sm90 tiled"),
    ("d128", 192, 128, BF16, "sm90 short", "sm90 tiled"),
    ("flagship_f32", 192, 64, F32, "K1 CUDA cores", "K1 CUDA cores"),
    ("fieldsynth_f32", 576, 32, F32, "K1 CUDA cores", "K1 CUDA cores"),
    ("768sq_f32", 2304, 64, F32, "K4 CUDA cores", "K4 CUDA cores"),
    ("d48", 96, 48, BF16, "sm90 short", "sm90 tiled"),  # every multiple of 8 on wgmma
    # vit-h (d = 80) in bf16: the wgmma kernels at every N
    ("vith_645", 645, 80, BF16, "sm90 tiled", "sm90 tiled"),
    ("vith_646", 646, 80, BF16, "sm90 tiled", "sm90 tiled"),
    ("vith_672", 672, 80, BF16, "sm90 tiled", "sm90 tiled"),
    ("vith_192", 192, 80, BF16, "sm90 short", "sm90 tiled"),
    ("vith_f32_340", 340, 80, F32, "K1 CUDA cores", "K1 CUDA cores"),
    ("vith_f32_341", 341, 80, F32, "K4 CUDA cores", "K4 CUDA cores"),
    # a width no preset has, past K1's shared memory: K4's CUDA cores in
    # f32, the wgmma kernels in bf16
    ("d48_1024", 1024, 48, BF16, "sm90 tiled", "sm90 tiled"),
    ("d48_f32_1024", 1024, 48, F32, "K4 CUDA cores", "K4 CUDA cores"),
    # past 256 and K1's shared memory: K4's CUDA cores (fault 13)
    ("d272_1024", 1024, 272, BF16, "K4 CUDA cores", "K4 CUDA cores"),
    # ViT-g/14 (16 heads of 88) at 256 x 192 and 768 x 768
    ("vitg_192", 192, 88, BF16, "sm90 short", "sm90 tiled"),
    ("vitg_2304", 2304, 88, BF16, "sm90 tiled", "sm90 tiled"),
])
def test_route_of_shipped_shapes(name, N, d, dtype, fwd, bwd):
    assert attention_route(N, d, dtype, H100_SMEM) == fwd
    assert attention_route(N, d, dtype, H100_SMEM, backward=True) == bwd


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("N", [192, 1024, 2304, 4096])
def test_every_head_width_up_to_256_has_a_kernel(N, dtype):
    """No head width d <= 256 routes to "no kernel" on an H100, forward or
    backward, as JAX's packed_attention takes every d; K4's CUDA-core tile
    shrinks (64 -> 32 -> 16 query rows) where d's f32 tiles need it. The
    vit-h rows (bf16, d = 80) take the wgmma kernels."""
    for d in range(1, 257):
        for backward in (False, True):
            route = attention_route(N, d, dtype, H100_SMEM, backward)
            assert not route.startswith("no kernel"), (d, backward, route)
            if route == "K4 CUDA cores":
                w = cuda_core_warps(d, backward, H100_SMEM)
                assert cuda_core_smem_bytes(d, w, backward) <= H100_SMEM
    if dtype == BF16:
        assert attention_route(N, 80, BF16, H100_SMEM) == ("sm90 short" if N <= 256
                                                            else "sm90 tiled")
        assert attention_route(N, 80, BF16, H100_SMEM, True) == "sm90 tiled"


def test_cuda_core_tile_at_the_widest_heads():
    """K4's CUDA-core bytes (csrc/tiled_attention.cu: Geo; the card test
    holds them to the library's): 249,600 for the backward at d = 160 with
    four warps and 397,056 at d = 256, past an H100's 232,448, so those
    take two and one; the forward takes four warps up to d = 225. Past
    256 (fault 13) the tiles hold 128 of the head's columns at a time, and
    four warps fit both ways."""
    assert cuda_core_smem_bytes(160, 4, True) == 249600
    assert cuda_core_smem_bytes(256, 4, True) == 397056
    assert cuda_core_smem_bytes(256, 4, False) == 263936
    assert [cuda_core_warps(d, True, H100_SMEM) for d in (128, 160, 256)] == [4, 2, 1]
    assert [cuda_core_warps(d, False, H100_SMEM) for d in (225, 226, 256)] == [4, 2, 2]
    assert cuda_core_warps(257, False, H100_SMEM) == 4
    assert cuda_core_smem_bytes(1024, 4, True) == cuda_core_smem_bytes(128, 4, True) == 200448


@pytest.mark.parametrize("B,want", [
    (1, [(0, 1)]),
    (MAX_GRID_Z, [(0, MAX_GRID_Z)]),
    (MAX_GRID_Z + 1, [(0, MAX_GRID_Z), (MAX_GRID_Z, 1)]),
    (70000, [(0, 65535), (65535, 4465)]),
    (3 * MAX_GRID_Z, [(0, MAX_GRID_Z), (MAX_GRID_Z, MAX_GRID_Z), (2 * MAX_GRID_Z, MAX_GRID_Z)]),
])
def test_batch_chunks_cover_the_batch(B, want):
    """The launches of a batch past the grid's 65,535: whole chunks of the
    limit, then the rest, in order, covering every item once."""
    assert batch_chunks(B) == want
    assert sum(n for _, n in want) == B and all(n <= MAX_GRID_Z for _, n in want)
    assert batch_chunks(7, limit=3) == [(0, 3), (3, 3), (6, 1)]


def test_k1_bytes_at_d80():
    """K1's CUDA-core bytes at d = 80: 356 N + 2,560 in bf16 and 676 N +
    2,560 in f32 (the card test holds them to the library's count)."""
    for N in (1, 192, 645, 646, 2304):
        assert k1_smem_bytes(N, 80, BF16) == 356 * N + 2560
        assert k1_smem_bytes(N, 80, F32) == 676 * N + 2560


# --------------------------------------------------------------------------
# the plain versions of the wgmma design against JAX


def _inputs(shape, seed):
    """bf16-representable qkv and dout, and the same values for JAX."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(BF16)
    dout = torch.from_numpy(rng.normal(size=(*shape[:2], shape[2] // 3)).astype(np.float32))
    dout = dout.to(BF16)
    return qkv, dout, jnp.asarray(qkv.float().numpy(), jnp.bfloat16), \
        jnp.asarray(dout.float().numpy(), jnp.bfloat16)


def _design_forward(qkv, heads):
    """(out, lse) as the card computes them: the short forward's TPU order
    up to SHORT_MAX_N tokens, the tiled forward's online order past it."""
    if qkv.shape[1] <= SHORT_MAX_N:
        return short_attention_reference(qkv, heads)
    return tiled_attention_online_reference(qkv, heads)


DESIGN_CASES = [((2, 192, 3 * 6 * 64), 6), ((2, 576, 3 * 12 * 32), 12), ((3, 77, 3 * 4 * 32), 4)]


@pytest.mark.parametrize("shape,heads", DESIGN_CASES, ids=["flagship", "fieldsynth", "n77"])
def test_design_forward_matches_jax(shape, heads):
    qkv, _, jq, _ = _inputs(shape, 20)
    ref = np.asarray(jax_packed_attention(jq, heads, interpret=True).astype(jnp.float32))
    out, lse = _design_forward(qkv, heads)
    assert lse.shape == (shape[0], heads, shape[1]) and lse.dtype == F32
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=k1_bound(ref))


@pytest.mark.parametrize("shape,heads", DESIGN_CASES, ids=["flagship", "fieldsynth", "n77"])
def test_design_backward_from_saved_residuals_matches_jax(shape, heads):
    """K4's backward order (P = exp(S * scale - lse); D = rowsum(dP * P) up
    to 256 tokens, rowsum(dO * O) past them), fed the forward's (out, lse),
    against jax.vjp of packed_attention."""
    qkv, dout, jq, jo = _inputs(shape, 21)
    _, vjp = jax.vjp(lambda x: jax_packed_attention(x, heads, interpret=True), jq)
    ref = np.asarray(vjp(jo)[0].astype(jnp.float32))
    out, lse = _design_forward(qkv, heads)
    got = tiled_attention_online_bwd_reference(qkv, dout, heads, out, lse)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=k1_bound(ref))


def test_short_reference_is_k1s_plain_version():
    """The short forward's plain version gives K1's plain context bit for
    bit, and lse = logsumexp of the scaled scores; on a CPU tensor the
    wrapper is that plain version."""
    qkv, _, _, _ = _inputs((2, 100, 3 * 2 * 32), 22)
    out, lse = short_attention_reference(qkv, 2)
    torch.testing.assert_close(out, packed_attention_reference(qkv, 2), rtol=0, atol=0)
    q, k, _ = qkv.float().reshape(2, 100, 3, 2, 32).unbind(2)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) / 32**0.5
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6, atol=1e-6)
    got, got_lse = short_forward(qkv, 2, with_lse=True)
    assert torch.equal(got, out) and torch.equal(got_lse, lse)
    assert short_forward(qkv, 2)[1] is None


# --------------------------------------------------------------------------
# fault 5: d = 80 past K1's shared memory, on K4's CUDA-core kernels


def _d80_case(qkv, dout, heads, jq, jo, fn):
    """`fn` (packed_attention or tiled_attention) forward and autograd
    backward on the CPU, which are the plain versions of the route's
    kernels, against JAX's packed_attention within K1's bound."""
    x = qkv.clone().requires_grad_(True)
    out = fn(x, heads)
    (grad,) = torch.autograd.grad(out, x, dout)
    ref = np.asarray(jax_packed_attention(jq, heads, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(out.detach().float().numpy(), ref, rtol=0, atol=k1_bound(ref))
    _, vjp = jax.vjp(lambda y: jax_packed_attention(y, heads, interpret=True), jq)
    gref = np.asarray(vjp(jo)[0].astype(jnp.float32))
    np.testing.assert_allclose(grad.float().numpy(), gref, rtol=0, atol=k1_bound(gref))


def test_vith_at_672_matches_jax():
    """The vit-h preset (16 heads, d = 80) on 448 x 384 crops, N = 672, in
    bf16: K4's d = 80 wgmma kernels, as JAX's packed_attention runs its
    row-tiled kernel there; packed_attention and the K4 wrapper (each its
    plain version on the CPU) meet K1's bound against JAX's
    packed_attention."""
    assert attention_route(672, 80, BF16, H100_SMEM) == "sm90 tiled"
    qkv, dout, jq, jo = _inputs((1, 672, 3 * 16 * 80), 23)
    _d80_case(qkv, dout, 16, jq, jo, packed_attention)
    _d80_case(qkv, dout, 16, jq, jo, tiled_attention)


def test_d80_k4_route_at_small_n():
    """K4 at d = 80 and N = 40 with eight heads (JAX's tiled kernel groups
    d = 80 heads by eight), on a card whose shared memory K1 exceeds there:
    bf16 routes to the short wgmma forward and K4's wgmma backward whatever
    the card's K1 bytes (f32 takes K1 there, whose tiles are smaller than
    K4's CUDA-core ones); the K4 wrapper's plain version against JAX."""
    assert attention_route(40, 80, F32, H100_SMEM) == "K1 CUDA cores"
    limit = k1_smem_bytes(40, 80, BF16) - 1
    assert attention_route(40, 80, BF16, limit) == "sm90 short"
    assert attention_route(40, 80, BF16, limit, backward=True) == "sm90 tiled"
    qkv, dout, jq, jo = _inputs((2, 40, 3 * 8 * 80), 24)
    _d80_case(qkv, dout, 8, jq, jo, tiled_attention)


def test_no_kernel_shape_is_plain_on_the_cpu():
    """A width that once had no kernel past K1's shared memory (d = 272,
    N = 1024; fault 13) routes to K4's CUDA cores, which the card runs
    (tests/test_torch_cuda.py); on the CPU the wrapper is the plain
    version, as on every route."""
    assert attention_route(1024, 272, BF16, H100_SMEM) == "K4 CUDA cores"
    qkv, _, _, _ = _inputs((1, 1024, 3 * 2 * 272), 25)
    assert torch.equal(packed_attention(qkv, 2), packed_attention_reference(qkv, 2))


# --------------------------------------------------------------------------
# fault 9: every head width, and d = 80 on the wgmma design, against JAX


def _jax_case(qkv, dout, heads, jq, jo):
    """JAX's packed_attention and its vjp on (jq, jo), as f32 numpy."""
    ref = np.asarray(jax_packed_attention(jq, heads, interpret=True).astype(jnp.float32))
    _, vjp = jax.vjp(lambda y: jax_packed_attention(y, heads, interpret=True), jq)
    return ref, np.asarray(vjp(jo)[0].astype(jnp.float32))


def _f32_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=shape).astype(np.float32)
    dout = rng.normal(size=(*shape[:2], shape[2] // 3)).astype(np.float32)
    return torch.from_numpy(qkv), torch.from_numpy(dout), jnp.asarray(qkv), jnp.asarray(dout)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("d", [16, 48, 96, 160])
def test_k4_cuda_core_order_matches_jax(d, dtype):
    """K4's CUDA-core kernels follow the TPU kernels' order
    (`tiled_attention_reference` and `_bwd_reference`, their plain twins):
    at widths only they take past K1's shared memory, forward and backward
    against jax.vjp of packed_attention within K1's bound (bf16) or 1e-5
    of max(1, |ref|) (f32)."""
    shape, heads = (1, 40, 3 * 2 * d), 2
    qkv, dout, jq, jo = (_inputs if dtype == "bf16" else _f32_inputs)(shape, 30 + d)
    ref, gref = _jax_case(qkv, dout, heads, jq, jo)
    out = tiled_attention_reference(qkv, heads)
    got = tiled_attention_bwd_reference(qkv, dout, heads)
    for o, r in ((out, ref), (got, gref)):
        tol = k1_bound(r) if dtype == "bf16" else 1e-5 * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(o.float().numpy(), r, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("B,N,heads", [(1, 192, 16), (1, 300, 8)], ids=["n192", "n300"])
def test_d80_wgmma_design_matches_jax(B, N, heads, dtype):
    """vit-h's width on the wgmma design: the short forward's plain version
    (N <= 256) or the tiled forward's online order (N = 300), and the
    backward from the saved (out, lse), against JAX's packed_attention and
    its vjp: K1's bound in bf16, 1e-5 of max(1, |ref|) in f32."""
    shape = (B, N, 3 * heads * 80)
    qkv, dout, jq, jo = (_inputs if dtype == "bf16" else _f32_inputs)(shape, 40 + N)
    ref, gref = _jax_case(qkv, dout, heads, jq, jo)
    out, lse = _design_forward(qkv, heads)
    got = tiled_attention_online_bwd_reference(qkv, dout, heads, out, lse)
    for o, r in ((out, ref), (got, gref)):
        tol = k1_bound(r) if dtype == "bf16" else 1e-5 * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(o.float().numpy(), r, rtol=0, atol=tol)


# --------------------------------------------------------------------------
# fault 13 and the wgmma kernels at every multiple of 8


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("N", [64, 192, 1024, 2304])
def test_route_at_every_width_to_1024(N, dtype):
    """Every head width d = 1 .. 1024 has a kernel both ways on an H100;
    bf16 takes the wgmma kernels exactly at the multiples of 8 in
    [16, 256] (the short forward up to N = 256 where its K and V fit, the
    tiled forward and backward else, whose tiles fit an H100 at every
    width), every other shape a CUDA-core kernel whose shared memory
    fits."""
    for d in range(1, 1025):
        wgmma = dtype == BF16 and d % 8 == 0 and 16 <= d <= 256
        for backward in (False, True):
            route = attention_route(N, d, dtype, H100_SMEM, backward)
            if wgmma:
                short = not backward and N <= 256 and short_smem_bytes(d, N) <= H100_SMEM
                assert route == ("sm90 short" if short else "sm90 tiled"), (d, route)
            elif route == "K1 CUDA cores":
                assert k1_smem_bytes(N, d, dtype) <= H100_SMEM
            else:
                assert route == "K4 CUDA cores", (d, backward, route)
                w = cuda_core_warps(d, backward, H100_SMEM)
                assert w and cuda_core_smem_bytes(d, w, backward) <= H100_SMEM


def test_wgmma_shared_memory_borders():
    """The short wgmma forward's bytes (csrc/tiled_attention_sm90.cuh; the
    card test holds them to the library's, and the tiled kernels' to the
    card's limit at every width): the short forward holds the head's whole
    K and V, which fits at N = 192 up to d = 256 and at N = 256 up to
    d = 192, so d >= 200 at N > 192 takes the tiled forward."""
    assert short_smem_bytes(256, 192) == 230408 <= H100_SMEM
    assert short_smem_bytes(192, 256) == 222216 <= H100_SMEM < short_smem_bytes(200, 256)
    assert attention_route(192, 256, BF16, H100_SMEM) == "sm90 short"
    assert attention_route(193, 256, BF16, H100_SMEM) == "sm90 tiled"
    assert attention_route(256, 192, BF16, H100_SMEM) == "sm90 short"
    assert attention_route(256, 200, BF16, H100_SMEM) == "sm90 tiled"
    # the padded width sets the bytes: d = 88 takes Dp = 96's tiles
    assert short_smem_bytes(88, 192) == short_smem_bytes(96, 192)


@pytest.mark.parametrize("N,d", [(192, 320), (192, 512), (1024, 320), (1024, 512),
                                 (2304, 320), (2304, 512)])
def test_fault13_route_where_jax_runs_a_kernel(N, d):
    """Fault 13: where JAX's packed_attention runs its row-tiled Pallas
    kernel (tiled_feasible_bq > 0 for the single-head qkv) at d > 256, the
    port routes to a kernel too, forward and backward, in both dtypes."""
    for bwd in (False, True):
        if tiled_feasible_bq((1, N, 3 * d), 1, bwd=bwd) == 0:
            continue
        for dtype in (BF16, F32):
            route = attention_route(N, d, dtype, H100_SMEM, bwd)
            assert route in ("K1 CUDA cores", "K4 CUDA cores"), (N, d, bwd, route)
    assert tiled_feasible_bq((1, 192, 3 * 512), 1, bwd=True) == 512
    assert tiled_feasible_bq((1, 1024, 3 * 512), 1, bwd=False) == 512
    assert attention_route(1024, 512, BF16, H100_SMEM) == "K4 CUDA cores"


@pytest.mark.parametrize("d", [24, 88, 104, 320])
def test_plain_versions_match_jax_at_new_widths(d):
    """The plain versions the new kernels are held to, at widths that
    reach them (d = 24, 88, 104: the wgmma kernels; 320: K4's CUDA cores),
    against JAX's packed_attention and its vjp in interpret mode, bf16:
    the TPU order (tiled_attention_reference and its backward), the short
    forward's order at N <= 256 and the tiled forward's online order past
    it with the backward from the saved (out, lse), within K1's bound."""
    heads = 2
    for N in (40, 300):
        qkv, dout, jq, jo = _inputs((1, N, 3 * heads * d), 60 + d + N)
        ref, gref = _jax_case(qkv, dout, heads, jq, jo)
        out, lse = _design_forward(qkv, heads)
        pairs = ((tiled_attention_reference(qkv, heads), ref), (out, ref),
                 (tiled_attention_bwd_reference(qkv, dout, heads), gref),
                 (tiled_attention_online_bwd_reference(qkv, dout, heads, out, lse), gref))
        for got, want in pairs:
            np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=k1_bound(want))
