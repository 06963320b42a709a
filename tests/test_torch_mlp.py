"""Kernels K5 (fused LayerNorm + MLP + residual) and K6 (flat attention),
the ViT paths that run them, per-block recompute and the entry points'
device default, against the JAX package on the CPU.

The JAX Pallas kernels run in interpret mode, as the JAX package's own tests
run them (tests/test_pallas.py). JAX's ViT takes its fused-MLP branch only
when `jax.default_backend() == "tpu"` (models/vit.py:271); the tests that
need that branch patch, inside the test, the `jax` module that models/vit.py
sees and the `fused_ln_mlp` it imports (interpret mode, tile 16). Nothing in
the JAX package changes. Inputs are drawn with numpy from a seed; each
tolerance is stated beside its assertion.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probpose_pytorch_tpu.ops.pallas as jax_pallas
from probpose_pytorch_tpu.models import model as jax_model
from probpose_pytorch_tpu.models import vit as jax_vit
from probpose_pytorch_tpu.ops.pallas import fused_attention as jax_fused_attention
from probpose_pytorch_tpu.ops.pallas import fused_ln_mlp as jax_fused_ln_mlp
from probpose_pytorch_tpu.ops.sparsemax import force_xla_sparsemax
from probpose_pytorch_tpu_torch.compat.from_jax import load_jax_variables
from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model
from probpose_pytorch_tpu_torch.ops.kernels.attention import (
    fused_attention,
    fused_attention_reference,
)
from probpose_pytorch_tpu_torch.ops.kernels.mlp import (
    SUPPORTED_WIDTHS,
    _shape,
    _split_k,
    fused_ln_mlp,
    fused_ln_mlp_bwd_kernel_order_reference,
    fused_ln_mlp_bwd_reference,
    fused_ln_mlp_reference,
    MAX_C,
    MAX_HIDDEN,
    mlp_route,
    mlp_workspace_bytes,
    wgmma_mlp_width,
)
from probpose_pytorch_tpu_torch.models import vit as port_vit
from probpose_pytorch_tpu_torch.train.config import TrainConfig
from probpose_pytorch_tpu_torch.train.loop import Trainer
from test_torch_models import TINY_CFG, _images, init_pair
from test_torch_train import (
    RAW,
    STEPS_PER_EPOCH,
    _batch,
    _by_name,
    _check_grads,
    _jax_grads,
    _port,
    build_jax_side,
)

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

C, HID = 32, 64
JAX_TILE = 16  # the JAX forward's row tile; its backward's is max(16 // 4, 64) = 64
JAX_BWD_TILE = 64
FUSED_CFG = dict(TINY_CFG, mlp_impl="fused", attn_impl="einsum")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _args(seed, R, dtype, width=C, hidden=HID):
    """(x, scale, bias, w1, b1, w2, b2) as numpy f32, with x and the weights
    already rounded to `dtype` when it is bfloat16; the weights at 0.3 at
    the default (C, HID), at fan-in scale at another width."""
    rng = np.random.default_rng(seed)
    s1, s2 = (0.3, 0.3) if (width, hidden) == (C, HID) else (width**-0.5, hidden**-0.5)
    args = [rng.normal(size=(R, width)), rng.normal(1, 0.1, width), rng.normal(0, 0.1, width),
            rng.normal(0, s1, (width, hidden)), rng.normal(0, 0.1, hidden),
            rng.normal(0, s2, (hidden, width)), rng.normal(0, 0.1, width)]
    args = [a.astype(np.float32) for a in args]
    if dtype == "bfloat16":
        for i in (0, 3, 5):
            args[i] = np.asarray(jnp.asarray(args[i], jnp.bfloat16).astype(jnp.float32))
    return args


def _jax_args(args, dtype):
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return [jnp.asarray(a, dt) if i in (0, 3, 5) else jnp.asarray(a)
            for i, a in enumerate(args)]


def _torch_args(args, dtype):
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return [_t(a).to(dt) if i in (0, 3, 5) else _t(a) for i, a in enumerate(args)]


def _ulp(ref: np.ndarray) -> float:
    """One bf16 ulp at the largest magnitude of `ref`."""
    m = float(np.abs(ref).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def _close(out, ref, dtype, f32_tol):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=f32_tol, atol=f32_tol)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=_ulp(ref))


class _TpuJax:
    """The jax module with default_backend() reporting "tpu"."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.fixture
def jax_fused_branch(monkeypatch):
    """JAX's ViT takes its fused-MLP branch, the kernel in interpret mode;
    yields the list of its calls (one per traced block)."""
    monkeypatch.setattr(jax_vit, "jax", _TpuJax())
    orig, calls = jax_pallas.fused_ln_mlp, []

    def interpreted(*args):
        calls.append(args[0].shape)
        return orig(*args, JAX_TILE, True)

    monkeypatch.setattr(jax_pallas, "fused_ln_mlp", interpreted)
    with force_xla_sparsemax():
        yield calls


# --------------------------------------------------------------------------
# K5 plain version against the Pallas kernel


@pytest.mark.parametrize("R", [48, 37])  # 37: not a multiple of the 16-row tile
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_mlp_plain_matches_pallas(dtype, exact, R):
    args = _args(0, R, dtype)
    ref = jax_fused_ln_mlp(*_jax_args(args, dtype), exact, JAX_TILE, True)
    out = fused_ln_mlp(*_torch_args(args, dtype), exact)
    assert out.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    # f32: 1e-5, the bound tests/test_pallas.py holds the Pallas kernel to;
    # bf16: one bf16 ulp of the output's magnitude (the final cast may land
    # on either side where the f32 sums differ in order).
    _close(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), dtype, 1e-5)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_mlp_bwd_plain_matches_pallas(dtype, exact):
    R = 100  # two backward row tiles of the JAX kernel, the second ragged
    args = _args(1, R, dtype)
    g = np.random.default_rng(2).normal(size=(R, C)).astype(np.float32)
    jargs = _jax_args(args, dtype)
    jg = jnp.asarray(g, jargs[0].dtype)
    _, vjp = jax.vjp(lambda *a: jax_fused_ln_mlp(*a, exact, JAX_TILE, True), *jargs)
    refs = vjp(jg)
    targs = _torch_args(args, dtype)
    outs = fused_ln_mlp_bwd_reference(*targs, _t(g).to(targs[0].dtype), exact,
                                      chunk=JAX_BWD_TILE)
    names = ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2")
    for name, out, ref, arg in zip(names, outs, refs, targs):
        assert out.dtype == arg.dtype and tuple(out.shape) == tuple(ref.shape), name
        # f32: 1e-4, tests/test_pallas.py's bound on the Pallas gradients;
        # bf16: one bf16 ulp of each cotangent's magnitude.
        _close(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), dtype, 1e-4)


@pytest.mark.parametrize("R", [100, 37])  # two JAX backward tiles, the second ragged; one
@pytest.mark.parametrize("exact", [False, True])
def test_kernel_order_bwd_twin_matches_pallas(exact, R):
    """The bf16 kernel's plain twin (du rounded before the dy and dW1
    products, one f32 sum for dW1 and dW2) against the Pallas backward."""
    args = _args(6, R, "bfloat16")
    g = np.random.default_rng(7).normal(size=(R, C)).astype(np.float32)
    jargs = _jax_args(args, "bfloat16")
    _, vjp = jax.vjp(lambda *a: jax_fused_ln_mlp(*a, exact, JAX_TILE, True), *jargs)
    refs = vjp(jnp.asarray(g, jnp.bfloat16))
    targs = _torch_args(args, "bfloat16")
    outs = fused_ln_mlp_bwd_kernel_order_reference(*targs, _t(g).to(torch.bfloat16), exact)
    names = ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2")
    for name, out, ref, arg in zip(names, outs, refs, targs):
        assert out.dtype == arg.dtype and tuple(out.shape) == tuple(ref.shape), name
        ref = np.asarray(ref.astype(jnp.float32))
        # four bf16 ulps (4 * 2**-8) of each cotangent's magnitude, the card's
        # bound on K5 backward against the plain version: the twin rounds du
        # where the TPU kernel keeps it f32, and sums dW once, not per tile
        err = np.abs(out.float().numpy() - ref).max()
        assert err <= 4 * 2**-8 * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("exact", [False, True])
def test_kernel_order_bwd_twin_is_the_plain_backward_in_f32(exact):
    """In float32 rounding du is the identity: the twin is the plain backward."""
    args = _torch_args(_args(8, 45, "float32"), "float32")
    g = torch.from_numpy(np.random.default_rng(9).normal(size=(45, C)).astype(np.float32))
    for got, want in zip(fused_ln_mlp_bwd_kernel_order_reference(*args, g, exact),
                         fused_ln_mlp_bwd_reference(*args, g, exact)):
        assert torch.equal(got, want)


def test_mlp_workspace_bytes_at_vitb_step():
    """ViT-B's step (R = 12,288 rows, C = 768, Hd = 3072): the weight
    gradients' 128 tiles of 192 x 192 fit one wave of 132 SMs, so the rows
    are not split (one chunk of 192 stages), and the scratch is the sum of
    its buffers."""
    R, C_, Hd = 12288, 768, 3072
    assert _shape(C_, Hd) == (3, 192) and _split_k(R, 128) == (1, 192)
    want = (2 * R * C_ * 2 + 2 * R * Hd * 2 + 2 * R * 4 + 3 * (R // 64) * C_ * 4
            + (R // 128) * Hd * 4 + 1 * 2 * C_ * Hd * 4)
    assert mlp_workspace_bytes(R, C_, Hd) == want == 210_665_472


@pytest.mark.parametrize("R", [1, 97, 3 * 192 + 7, 12288 + 5])
@pytest.mark.parametrize("C_", SUPPORTED_WIDTHS)
def test_mlp_workspace_bytes_cover_every_buffer(C_, R):
    """At each width and at ragged R: 256-byte aligned, at least every
    buffer's bytes, and a split whose chunks cover the rows, none empty,
    with no cheaper split by the wave model."""
    Hd = 4 * C_
    w, bn = _shape(C_, Hd)
    tiles = -(-Hd // (64 * w)) * (C_ // bn) + -(-C_ // (64 * w)) * (Hd // bn)
    splits, chunk = _split_k(R, tiles)
    steps = -(-R // 64)
    assert (splits - 1) * chunk < steps <= splits * chunk
    cost = lambda s, per: -(-tiles * s // 132) * (per + 8)
    assert all(cost(s, -(-steps // s)) >= cost(splits, chunk) for s in range(1, 17)
               if -(-steps // -(-steps // s)) == s)
    n = mlp_workspace_bytes(R, C_, Hd)
    raw = (2 * R * C_ * 2 + 2 * R * Hd * 2 + 2 * R * 4 + 3 * (-(-R // 64)) * C_ * 4
           + (-(-R // 128)) * Hd * 4 + splits * 2 * C_ * Hd * 4)
    assert n % 256 == 0 and raw <= n < raw + 9 * 256


def test_mlp_workspace_bytes_refuses_other_shapes():
    """Past the CUDA-core kernels' limits (C = 2048, hidden 8,192) and at no
    rows no kernel takes the shape; the widths the wgmma kernels do not take
    below them are the CUDA cores' (test_cuda_core_workspace_bytes)."""
    for R, C_, Hd in ((8, 2056, 256), (8, 768, 8200), (0, 768, 3072)):
        with pytest.raises(ValueError):
            mlp_workspace_bytes(R, C_, Hd)


# The ids are those of the rows' first expected routes: four bf16 rows moved
# from the CUDA cores to the wgmma kernels when every multiple of 8 was opened.
@pytest.mark.parametrize("C_,Hd,dtype,route", [
    pytest.param(768, 3072, torch.bfloat16, "sm90", id="768-3072-dtype0-sm90"),
    pytest.param(384, 1280, torch.bfloat16, "sm90", id="384-1280-dtype1-sm90"),
    pytest.param(768, 3072, torch.float32, "CUDA cores", id="768-3072-dtype2-CUDA cores"),
    # vit-nano
    pytest.param(64, 128, torch.bfloat16, "sm90", id="64-128-dtype3-CUDA cores"),
    pytest.param(200, 600, torch.bfloat16, "sm90", id="200-600-dtype4-CUDA cores"),
    # hidden no multiple of 256
    pytest.param(768, 3000, torch.bfloat16, "sm90", id="768-3000-dtype5-CUDA cores"),
    pytest.param(512, 2048, torch.bfloat16, "sm90", id="512-2048-dtype6-CUDA cores"),
    pytest.param(2048, 8192, torch.float32, "CUDA cores", id="2048-8192-dtype7-CUDA cores"),
    pytest.param(2056, 256, torch.bfloat16, "no kernel (C=2056, hidden=256)",
                 id="2056-256-dtype8-no kernel (C=2056, hidden=256)"),
    pytest.param(768, 8200, torch.float32, "no kernel (C=768, hidden=8200)",
                 id="768-8200-dtype9-no kernel (C=768, hidden=8200)"),
])
def test_mlp_route(C_, Hd, dtype, route):
    """K5's kernel is a pure function of the shape: the wgmma kernels at
    every bf16 C and hidden width that are multiples of 8 (up to C = 2048
    and hidden 8,192), the CUDA cores at every other shape up to those
    limits (and in f32), as JAX's fused_ln_mlp takes any (R, C) and hidden
    width."""
    assert mlp_route(C_, Hd, dtype) == route


def test_mlp_route_at_every_width():
    """mlp_route at every C from 1 to 2,056 against a spread of hidden
    widths (multiples of 8 and not, past 8,192 too), in both dtypes: "sm90"
    exactly where bf16 C and Hd are multiples of 8 within the limits, "CUDA
    cores" at the other shapes within them, else no kernel."""
    hiddens = (1, 7, 8, 12, 128, 200, 584, 600, 1000, 3000, 3072, 6144, 6148, 8184, 8192,
               8196, 8200)
    for dtype in (torch.bfloat16, torch.float32):
        for C_ in range(1, 2057):
            for Hd in hiddens:
                within = C_ <= MAX_C and Hd <= MAX_HIDDEN
                wgmma = dtype == torch.bfloat16 and within and C_ % 8 == 0 and Hd % 8 == 0
                want = ("sm90" if wgmma else "CUDA cores" if within
                        else f"no kernel (C={C_}, hidden={Hd})")
                assert wgmma_mlp_width(C_, Hd, dtype) == wgmma, (C_, Hd, dtype)
                assert mlp_route(C_, Hd, dtype) == want, (C_, Hd, dtype)


def test_shape_keeps_the_preset_tiles():
    """The tile rule (least padded work) gives the tiles the four preset
    widths had before every multiple of 8 was opened, at every hidden width
    that is a multiple of 256: 192 x 192 where 192 divides C and Hd, else
    128 x 256 where 256 divides C, else 128 x 128; ViT-g's 1408 (11 x 128)
    takes 128 x 128, 1536 192 x 192."""
    for C_ in SUPPORTED_WIDTHS:
        for Hd in range(256, MAX_HIDDEN + 1, 256):
            before = (3, 192) if C_ % 192 == 0 and Hd % 192 == 0 else (
                2, 256 if C_ % 256 == 0 else 128)
            assert _shape(C_, Hd) == before, (C_, Hd)
    assert _shape(1408, 6144) == (2, 128) and _shape(1536, 6144) == (3, 192)
    assert _shape(2048, 8192) == (2, 256) and _shape(64, 128) == (2, 128)


@pytest.mark.parametrize("R", [1, 97, 393, 6144 + 5, 12288 + 5])
@pytest.mark.parametrize("C_,Hd", [(1408, 6144), (1536, 6144), (72, 200), (2048, 8192),
                                   (8, 8), (136, 584)])
def test_mlp_workspace_bytes_at_new_widths(C_, Hd, R):
    """At widths the wgmma kernels took when every multiple of 8 was opened,
    at ragged R: 256-byte aligned, at least every buffer's bytes (y, h, du,
    dy, mean, rstd, the LayerNorm partials (3, ceil(R / 64), C), db1's
    (ceil(R / 128), Hd), the split partials (splits, 2 C Hd)), tiles that
    cover the ragged columns, and a split whose chunks cover the rows."""
    w, bn = _shape(C_, Hd)
    bm = 64 * w
    tiles = -(-Hd // bm) * -(-C_ // bn) + -(-C_ // bm) * -(-Hd // bn)
    assert (-(-Hd // bm) * bm >= Hd and -(-C_ // bn) * bn >= C_ and -(-C_ // bm) * bm >= C_
            and -(-Hd // bn) * bn >= Hd)
    splits, chunk = _split_k(R, tiles)
    steps = -(-R // 64)
    assert (splits - 1) * chunk < steps <= splits * chunk
    n = mlp_workspace_bytes(R, C_, Hd)
    raw = (2 * R * C_ * 2 + 2 * R * Hd * 2 + 2 * R * 4 + 3 * (-(-R // 64)) * C_ * 4
           + (-(-R // 128)) * Hd * 4 + splits * 2 * C_ * Hd * 4)
    assert n % 256 == 0 and raw <= n < raw + 9 * 256


@pytest.mark.parametrize("R", [1, 15, 17, 1023, 1025])
def test_cuda_core_workspace_bytes(R):
    """The CUDA-core backward's scratch (csrc/fused_mlp.cu, `workspace`; the
    card test holds it to the library's): y and g padded to the row tile
    (16 rows, 8 past C = 1280), the tiles' (3, C) partials and the
    1,024-row chunks' dW1, dW2 and db1 partials, each 256-byte aligned; in
    f32, and in bf16 at the neighbouring widths that are not multiples of 8
    (the bf16 multiples of 8 are the wgmma kernels')."""
    al = lambda n: -(-n // 256) * 256
    for C_, Hd, fr in ((64, 128, 16), (200, 600, 16), (1536, 6144, 8)):
        for dtype, c, hd in ((torch.float32, C_, Hd), (torch.bfloat16, C_ + 4, Hd + 4)):
            rpad = -(-R // fr) * fr
            chunks = -(-rpad // 1024)
            want = (2 * al(rpad * c * 4) + al(3 * (rpad // fr) * c * 4)
                    + 2 * al(chunks * hd * c * 4) + al(chunks * hd * 4))
            assert mlp_route(c, hd, dtype) == "CUDA cores"
            assert mlp_workspace_bytes(R, c, hd, dtype) == want, (c, R)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,width,hidden", [(130, 64, 128), (77, 200, 600), (77, 72, 200),
                                            (77, 136, 584)])
def test_other_widths_match_pallas(R, width, hidden, dtype):
    """At widths other than the presets (vit-nano's 64 / 128; 200 / 600,
    whose tails are ragged on every tile: the wgmma kernels' in bf16, the
    CUDA cores' in f32), JAX's fused_ln_mlp in interpret mode against the
    port's plain forward and plain backward (f32 1e-5 and 1e-4, bf16 one
    ulp, as above) and the kernel-order twin (four bf16 ulps, the twin's
    bound above; equal to the plain backward in f32)."""
    assert mlp_route(width, hidden, getattr(torch, dtype)) == (
        "sm90" if dtype == "bfloat16" else "CUDA cores")
    args = _args(10, R, dtype, width, hidden)
    jargs = _jax_args(args, dtype)
    targs = _torch_args(args, dtype)
    ref = jax_fused_ln_mlp(*jargs, False, JAX_TILE, True)
    _close(fused_ln_mlp(*targs).float().numpy(), np.asarray(ref.astype(jnp.float32)), dtype,
           1e-5)
    g = np.random.default_rng(11).normal(size=(R, width)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_fused_ln_mlp(*a, False, JAX_TILE, True), *jargs)
    refs = [np.asarray(r.astype(jnp.float32)) for r in vjp(jnp.asarray(g, jargs[0].dtype))]
    tg = _t(g).to(targs[0].dtype)
    plain = fused_ln_mlp_bwd_reference(*targs, tg, chunk=JAX_BWD_TILE)
    twin = fused_ln_mlp_bwd_kernel_order_reference(*targs, tg)
    names = ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2")
    for name, p, t, r in zip(names, plain, twin, refs):
        _close(p.float().numpy(), r, dtype, 1e-4)
        err = np.abs(t.float().numpy() - r).max()
        tol = 4 * 2**-8 * np.abs(r).max() if dtype == "bfloat16" else 1e-4 * max(
            1.0, np.abs(r).max())
        assert err <= tol, (name, err)


def test_fused_ln_mlp_autograd_on_cpu_is_the_plain_backward():
    args = _torch_args(_args(3, 40, "float32"), "float32")
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(40, C)).astype(np.float32))
    leaves = [a.clone().requires_grad_(True) for a in args]
    grads = torch.autograd.grad((fused_ln_mlp(*leaves, False) * g).sum(), leaves)
    for got, want in zip(grads, fused_ln_mlp_bwd_reference(*args, g, False)):
        assert torch.equal(got, want)
    # and the same as JAX's gradient of sum(out * g), within 1e-4
    jg = jnp.asarray(g.numpy())
    ref = jax.grad(lambda *a: jnp.sum(jax_fused_ln_mlp(*a, False, JAX_TILE, True) * jg),
                   argnums=tuple(range(7)))(*_jax_args(_args(3, 40, "float32"), "float32"))
    for got, want in zip(grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_fused_ln_mlp_checks_inputs():
    x, scale, bias, w1, b1, w2, b2 = _torch_args(_args(0, 8, "float32"), "float32")
    with pytest.raises(ValueError, match="w2"):
        fused_ln_mlp(x, scale, bias, w1, b1, w2.t(), b2)
    with pytest.raises(ValueError, match=r"\(R, C\)"):
        fused_ln_mlp(x[None], scale, bias, w1, b1, w2, b2)


# --------------------------------------------------------------------------
# K6 plain version against the Pallas kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_plain_matches_pallas(dtype):
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(3, 24, 2, 16)).astype(np.float32) for _ in range(3))
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = jax_fused_attention(*(jnp.asarray(a, jd) for a in (q, k, v)), group=2, interpret=True)
    out = fused_attention(*(_t(a).to(td) for a in (q, k, v)))
    assert out.shape == (3, 24, 2, 16) and out.dtype == td
    # f32 scores and softmax on both sides, sums in another order: 1e-5;
    # bf16 P rounded before P.V on both: one bf16 ulp of the magnitude.
    _close(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), dtype, 1e-5)
    assert torch.equal(out, fused_attention_reference(*(_t(a).to(td) for a in (q, k, v))))


def test_fused_attention_gradient_raises():
    q, k, v = (torch.randn(1, 8, 2, 4, requires_grad=True) for _ in range(3))
    out = fused_attention(q, k, v)
    with pytest.raises(RuntimeError, match="forward only"):
        out.sum().backward()


def test_trunk_with_flat_attention_matches_jax():
    """attn_impl="pallas": JAX runs `fused_attention` (interpret mode off the
    TPU, no gate), the port runs K6's plain version."""
    jm, variables, pm = init_pair(dict(TINY_CFG, attn_impl="pallas"), seed=2)
    x = _images(6)
    ref = jm.backbone.apply({"params": variables["params"]["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        out = pm.backbone(torch.from_numpy(x)).numpy()
    # f32 through two blocks, sums in another order (test_torch_models.py's bar)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# the fused-MLP ViT against JAX's fused branch


def test_fused_trunk_matches_jax_fused_branch(jax_fused_branch):
    jm, variables, pm = init_pair(FUSED_CFG, seed=3)
    assert pm.backbone.blocks[0].mlp_impl == "fused"
    x = _images(7)
    jax_fused_branch.clear()  # init_pair's init traced the branch too
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    assert len(jax_fused_branch) == 2  # JAX ran its fused branch in both blocks
    for o, r in zip(out, ref):
        # f32 through two fused blocks and the head (test_torch_models.py's bar)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


def test_fused_param_tree_loads_through_from_jax(jax_fused_branch):
    """The JAX fused branch declares the dense tree (tests/test_pallas.py:
    345-364), so its params load strictly into the port's fused model."""
    cfg = jax_model.ModelConfig(**FUSED_CFG)
    x = jnp.zeros((1, *FUSED_CFG["img_size"], 3), jnp.float32)
    fused = jax.eval_shape(lambda: jax_model.build_model(cfg).init(
        jax.random.PRNGKey(0), x, train=False))
    dense = jax.eval_shape(lambda: jax_model.build_model(
        dataclasses.replace(cfg, mlp_impl="dense")).init(jax.random.PRNGKey(0), x, train=False))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), t)
    assert shapes(fused) == shapes(dense)
    variables = jax.tree_util.tree_map(
        lambda s: np.random.default_rng(0).normal(size=s.shape).astype(np.float32), fused)
    pm = build_model(ModelConfig(**FUSED_CFG), device="cpu")
    load_jax_variables(pm, variables["params"], variables["batch_stats"])
    w = variables["params"]["backbone"]["block1"]["mlp"]["fc2"]["kernel"]
    assert np.array_equal(pm.backbone.blocks[1].mlp.fc2.weight.detach().numpy(), w.T)


@pytest.mark.parametrize("remat", [False, True])
def test_fused_train_step_matches_jax(jax_fused_branch, remat):
    """One f32 train step of the fused-MLP ViT (per-block recompute or not)
    against JAX `make_train_step` taking its fused branch, from the same
    state and batch."""
    raw = dict(RAW, model=dict(FUSED_CFG, remat=remat))
    js = build_jax_side(raw)
    trainer = _port(js, raw)
    assert trainer.model.backbone.remat == remat
    batch = _batch(7)
    captured = []
    apply = trainer.state.apply_gradients
    trainer.state.apply_gradients = lambda g, tx, ema_decay=None: (
        captured.append([t.clone() for t in g]), apply(g, tx, ema_decay))[1]
    rlosses, rgrads, _ = _jax_grads(js, {k: jnp.asarray(v) for k, v in batch.items()})
    _, jm = js["step"](js["state"], {k: jnp.asarray(v) for k, v in batch.items()})
    assert jax_fused_branch  # JAX traced its fused branch
    _, metrics = trainer.train_step(trainer.state, trainer.device_batch(batch))
    for k, v in rlosses.items():
        # each loss term within 1e-5 relative (test_torch_train.py's bar)
        np.testing.assert_allclose(float(metrics[f"loss/{k}"]), float(v), rtol=1e-5,
                                   atol=1e-8, err_msg=k)
    # per leaf within 1e-4 of its largest JAX entry; the pre-clip norm 1e-4
    _check_grads(trainer.state.names, captured[0],
                 _by_name(rgrads, js["state"].batch_stats, trainer.state.names))
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)


# --------------------------------------------------------------------------
# per-block recompute


@pytest.mark.parametrize("mlp_impl", ["dense", "fused"])
def test_remat_step_equals_plain_step_bitwise(mlp_impl):
    """remat recomputes each block's forward in the backward with the same
    operations, so two steps agree bit for bit on the CPU."""
    trainers = []
    for remat in (False, True):
        raw = dict(RAW, model=dict(TINY_CFG, mlp_impl=mlp_impl, remat=remat))
        trainers.append(Trainer.create(TrainConfig.from_dict(raw), STEPS_PER_EPOCH, device="cpu"))
    # both drawn from cfg.seed
    for a, b in zip(trainers[0].state.params, trainers[1].state.params):
        assert torch.equal(a, b)
    batch = _batch(8)
    metrics = [t.train_step(t.state, t.device_batch(batch))[1] for t in trainers]
    for k in metrics[0]:
        assert torch.equal(metrics[0][k], metrics[1][k]), k
    for a, b in zip(trainers[0].state.params, trainers[1].state.params):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the entry points' device


@pytest.mark.parametrize("entry", ["build_model", "Trainer.create"])
def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch, entry):
    """With no card (decided here: CUDA reported absent) the default device
    raises instead of falling back to the CPU; device="cpu" still works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrainConfig.from_dict(RAW)
    call = {"build_model": lambda **kw: build_model(cfg.model, **kw),
            "Trainer.create": lambda **kw: Trainer.create(cfg, STEPS_PER_EPOCH, **kw)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert call(device="cpu") is not None


def test_lora_with_fused_mlp_is_refused_like_jax():
    with pytest.raises(ValueError, match="mlp_impl='fused'"):
        build_model(ModelConfig(**FUSED_CFG, lora_rank=4), device="cpu")


# --------------------------------------------------------------------------
# models at the widths the port once refused on the card


def test_vit_nano_fused_mlp_matches_jax():
    """vit-nano (C = 64, hidden 128) with mlp_impl="fused": on the card K5's
    wgmma kernels take it in bf16 (the CUDA cores in f32); on the CPU the
    port's plain version against JAX's model, whose CPU path is its dense
    block, the same function (test_torch_models.py's bar)."""
    cfg = dict(TINY_CFG, backbone="vit-nano", mlp_impl="fused")
    assert mlp_route(64, 128, torch.bfloat16) == "sm90"
    assert mlp_route(64, 128, torch.float32) == "CUDA cores"
    jm, variables, pm = init_pair(cfg, seed=4)
    assert pm.backbone.blocks[0].mlp_impl == "fused"
    x = _images(8)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


def test_d80_vit_through_from_jax_matches_jax(monkeypatch):
    """A ViT with vit-h's head width d = 80 at a small width (embed_dim 160,
    2 heads, depth 2), a preset added to both packages' tables inside the
    test: JAX's weights loaded by compat/from_jax.py, the port's forward
    (K1's plain version on the CPU; the d = 80 wgmma kernels on the card)
    against JAX's within test_torch_models.py's bar."""
    geo = dict(embed_dim=160, depth=2, num_heads=2, mlp_ratio=2.0)
    monkeypatch.setitem(jax_vit.ViTConfig.PRESETS, "vit-d80-test", geo)
    monkeypatch.setitem(port_vit.ViTConfig.PRESETS, "vit-d80-test", geo)
    jm, variables, pm = init_pair(dict(TINY_CFG, backbone="vit-d80-test"), seed=5)
    assert pm.backbone.blocks[0].attn.num_heads == 2
    x = _images(9)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)
