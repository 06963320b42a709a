"""packed_attention's route and the plain versions of the kernels it picks,
against the JAX package, on the CPU.

`attention_route` is a pure function of (N, d, dtype, the card's shared
memory): the trunks' bf16 shapes go to the wgmma kernels of
csrc/tiled_attention_sm90.cu, float32 stays on K1's CUDA cores, and past
K1's shared memory float32 and the vit-h preset's bf16 (d = 80, N >= 646)
go to K4's CUDA-core kernels, as JAX's `packed_attention` hands them to its
row-tiled kernel. The plain versions of the wgmma design (the short forward
in the TPU kernel's order, the tiled forward's online order, and the
backward from the saved (out, lse)) are held against JAX's
`packed_attention` in interpret mode; inputs come from numpy generators,
tolerances stand beside each check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.ops.pallas import packed_attention as jax_packed_attention
from probpose_pytorch_tpu_torch.ops.kernels.attention import (
    packed_attention,
    packed_attention_reference,
)
from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
    SHORT_MAX_N,
    attention_route,
    k1_smem_bytes,
    short_attention_reference,
    short_forward,
    tiled_attention,
    tiled_attention_online_bwd_reference,
    tiled_attention_online_reference,
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
    ("d48", 96, 48, BF16, "K1 CUDA cores", "K1 CUDA cores"),
    ("vith_645", 645, 80, BF16, "K1 CUDA cores", "K1 CUDA cores"),
    ("vith_646", 646, 80, BF16, "K4 CUDA cores", "K4 CUDA cores"),
    ("vith_672", 672, 80, BF16, "K4 CUDA cores", "K4 CUDA cores"),
    ("vith_f32_340", 340, 80, F32, "K1 CUDA cores", "K1 CUDA cores"),
    ("vith_f32_341", 341, 80, F32, "K4 CUDA cores", "K4 CUDA cores"),
    # a width no preset has, past K1's shared memory: no kernel takes it
    ("d48_1024", 1024, 48, BF16, "no kernel (d=48, N=1024)", "no kernel (d=48, N=1024)"),
    ("d48_f32_1024", 1024, 48, F32, "no kernel (d=48, N=1024)", "no kernel (d=48, N=1024)"),
])
def test_route_of_shipped_shapes(name, N, d, dtype, fwd, bwd):
    assert attention_route(N, d, dtype, H100_SMEM) == fwd
    assert attention_route(N, d, dtype, H100_SMEM, backward=True) == bwd


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
    bf16: past K1's shared memory on an H100, so it routes to K4's CUDA-core
    kernels, as JAX's packed_attention runs its row-tiled kernel there;
    packed_attention and the K4 wrapper (each its plain version on the CPU)
    meet K1's bound against JAX's packed_attention."""
    assert attention_route(672, 80, BF16, H100_SMEM) == "K4 CUDA cores"
    qkv, dout, jq, jo = _inputs((1, 672, 3 * 16 * 80), 23)
    _d80_case(qkv, dout, 16, jq, jo, packed_attention)
    _d80_case(qkv, dout, 16, jq, jo, tiled_attention)


def test_d80_k4_route_at_small_n():
    """K4's d = 80 route at N = 40 with eight heads (JAX's tiled kernel
    groups d = 80 heads by eight), on a card whose shared memory K1
    exceeds there: the K4 wrapper's plain version against JAX."""
    assert attention_route(40, 80, BF16, k1_smem_bytes(40, 80, BF16) - 1) == "K4 CUDA cores"
    qkv, dout, jq, jo = _inputs((2, 40, 3 * 8 * 80), 24)
    _d80_case(qkv, dout, 8, jq, jo, tiled_attention)


def test_no_kernel_shape_is_plain_on_the_cpu():
    """A width no kernel takes past K1's shared memory (d = 48, N = 1024)
    raises on the card (tests/test_torch_cuda.py); on the CPU the wrapper
    is the plain version, as on every route."""
    qkv, _, _, _ = _inputs((1, 1024, 3 * 2 * 48), 25)
    assert torch.equal(packed_attention(qkv, 2), packed_attention_reference(qkv, 2))
