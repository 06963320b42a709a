"""The long-sequence slice of the port against the JAX package, on the CPU.

K4 (row-tiled attention, forward and backward), K3 (fused decode) and K2 at
192 x 192-pixel rows: each plain version against the JAX kernel it stands
for, in interpret mode; the routing between K1 and K4 given byte counts; and
the slice itself, the vit-nano preset on 768 x 768 inputs (N = 2304, 192 x
192 heatmaps), forward, decode and one float32 train step against JAX.
Inputs come from numpy generators; tolerances are stated beside each check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.codec import Codec as JaxCodec
from probpose_pytorch_tpu.codec import ProbMap as JaxProbMap
from probpose_pytorch_tpu.data.coco import COCO_SIGMAS
from probpose_pytorch_tpu.ops.heatmap import build_oks_conv_operators as jax_operators
from probpose_pytorch_tpu.ops.pallas import expected_value_decode_pallas, tiled_attention as jax_tiled
from probpose_pytorch_tpu.ops.sparsemax import sparsemax as jax_sparsemax
from probpose_pytorch_tpu_torch.codec import Codec, ProbMap
from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
from probpose_pytorch_tpu_torch.ops.kernels.attention import packed_attention
from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
    attention_route,
    k1_smem_bytes,
    tiled_attention,
    tiled_attention_backward,
    tiled_attention_bwd_reference,
    tiled_attention_online_bwd_reference,
    tiled_attention_online_reference,
    tiled_attention_reference,
)
from probpose_pytorch_tpu_torch.ops.heatmap import (
    build_oks_conv_operators,
    expected_value_decode,
)
from probpose_pytorch_tpu_torch.ops.kernels.decode import (
    band_radius,
    expected_value_decode_banded_reference,
    expected_value_decode_fused,
    operator_bands,
)
from probpose_pytorch_tpu_torch.ops.kernels.sparsemax import sparsemax_reference, sparsemax_rows
from test_torch_ops import _maps
from test_torch_train import RAW, _port, build_jax_side

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

H100_SMEM = 232448  # opt-in shared memory per block, bytes


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def k1_bound(ref: np.ndarray, dtype) -> float:
    """K1's bound (chip_smoke.py:k1_bound): two bf16 ulps of max(1, max|ref|)
    in bf16 -- an f32 sum in another order can move a bf16 output across one
    rounding boundary; 1e-5 of the same scale in f32."""
    rel = 2 * 2**-8 if dtype == torch.bfloat16 else 1e-5
    return rel * max(1.0, float(np.abs(ref).max()))


# --------------------------------------------------------------------------
# K4: row-tiled attention


TILED_CASES = [
    ((2, 200, 384), 2, 64),   # d 64, N padded to 256 by the row tile
    ((1, 300, 384), 4, 128),  # d 32
]
# and d 80 (the vit-h width, on K4's CUDA cores in both dtypes); JAX's
# tiled kernel groups d = 80 heads by eight
PLAIN_CASES = TILED_CASES + [((1, 130, 3 * 8 * 80), 8, 64)]


def _qkv(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=shape).astype(np.float32)
    dout = rng.normal(size=(*shape[:2], shape[2] // 3)).astype(np.float32)
    if dtype == torch.bfloat16:  # the same bf16 values on both sides
        qkv = _t(qkv).to(dtype).float().numpy()
        dout = _t(dout).to(dtype).float().numpy()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return qkv, dout, jdt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,heads,bq", PLAIN_CASES, ids=["d64", "d32", "d80"])
def test_tiled_plain_forward_matches_jax(shape, heads, bq, dtype):
    qkv, _, jdt = _qkv(shape, 0, dtype)
    ref = np.asarray(jax_tiled(jnp.asarray(qkv, jdt), heads, bq=bq, interpret=True)
                     .astype(jnp.float32))
    out = tiled_attention_reference(_t(qkv).to(dtype), heads, chunk=bq).float().numpy()
    # f32: f32 softmax on both sides, sums in another order; bf16: K1's bound.
    tol = 1e-5 if dtype == torch.float32 else k1_bound(ref, dtype)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,heads,bq", PLAIN_CASES, ids=["d64", "d32", "d80"])
def test_tiled_plain_backward_matches_jax(shape, heads, bq, dtype):
    qkv, dout, jdt = _qkv(shape, 1, dtype)
    _, vjp = jax.vjp(lambda x: jax_tiled(x, heads, bq, True), jnp.asarray(qkv, jdt))
    (ref,) = vjp(jnp.asarray(dout, jdt))
    ref = np.asarray(ref.astype(jnp.float32))
    out = tiled_attention_bwd_reference(_t(qkv).to(dtype), _t(dout).to(dtype), heads,
                                        chunk=bq).float().numpy()
    tol = 1e-5 if dtype == torch.float32 else k1_bound(ref, dtype)  # as above
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,heads,bq", TILED_CASES, ids=["d64", "d32"])
def test_tiled_online_forward_matches_jax(shape, heads, bq, dtype):
    """The bf16 kernels' arithmetic order (one sweep, online softmax over
    128-key tiles, P rounded against the running max) against the TPU
    kernel: it must meet the same bound as the TPU-order plain version."""
    qkv, _, jdt = _qkv(shape, 0, dtype)
    ref = np.asarray(jax_tiled(jnp.asarray(qkv, jdt), heads, bq=bq, interpret=True)
                     .astype(jnp.float32))
    out, lse = tiled_attention_online_reference(_t(qkv).to(dtype), heads)
    assert lse.shape == (shape[0], heads, shape[1]) and lse.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else k1_bound(ref, dtype)  # as above
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,heads,bq", TILED_CASES, ids=["d64", "d32"])
def test_tiled_online_backward_matches_jax(shape, heads, bq, dtype):
    """The backward in the kernels' order, from the forward's (out, lse)
    (D = rowsum(dP * P) at N = 200, rowsum(dO * O) at N = 300), against
    jax.vjp of the TPU kernel."""
    qkv, dout, jdt = _qkv(shape, 1, dtype)
    _, vjp = jax.vjp(lambda x: jax_tiled(x, heads, bq, True), jnp.asarray(qkv, jdt))
    (ref,) = vjp(jnp.asarray(dout, jdt))
    ref = np.asarray(ref.astype(jnp.float32))
    x, g = _t(qkv).to(dtype), _t(dout).to(dtype)
    out, lse = tiled_attention_online_reference(x, heads)
    got = tiled_attention_online_bwd_reference(x, g, heads, out, lse)
    tol = 1e-5 if dtype == torch.float32 else k1_bound(ref, dtype)  # as above
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


def test_tiled_online_backward_recomputes_its_residuals():
    """Without (out, lse) the kernel-order backward makes them itself and
    gives the same bits as with them passed."""
    qkv, dout, _ = _qkv((2, 200, 384), 3, torch.bfloat16)
    x, g = _t(qkv).to(torch.bfloat16), _t(dout).to(torch.bfloat16)
    out, lse = tiled_attention_online_reference(x, 2)
    passed = tiled_attention_online_bwd_reference(x, g, 2, out, lse)
    torch.testing.assert_close(tiled_attention_online_bwd_reference(x, g, 2), passed,
                               rtol=0, atol=0)


SLICE_TOL = 2 * 2**-8  # chip_smoke.py:ONLINE_REL_TOL


def _slice_rel(got: torch.Tensor, ref: torch.Tensor) -> list[float]:
    """||got - ref|| / ||ref|| per dq, dk, dv slice of a packed dqkv, as
    chip_smoke.py:rel_gate takes it."""
    return [((a - b).norm() / b.norm()).item()
            for a, b in zip(got.float().chunk(3, -1), ref.float().chunk(3, -1))]


@pytest.mark.parametrize("wrong_d", ["none", "zero", "next_row", "next_head"])
def test_k4_slice_gate_separates_a_wrong_d_from_another_order(wrong_d):
    """The card's per-slice gate of K4's backward against the kernel-order
    plain version, at the 768 x 768 path's N = 2304, d = 64, bf16: the
    TPU-order plain version (another summation order, D from the unrounded
    P) stays under a quarter of the bound; a D = rowsum(dO * O) dropped or
    read from the next row or head moves the dQ slice past 8x the bound.
    D enters only through O, so a wrong O stands for a wrong D."""
    g = torch.Generator().manual_seed(5)
    qkv = torch.randn(1, 2304, 1152, generator=g).to(torch.bfloat16)
    dout = torch.randn(1, 2304, 384, generator=g).to(torch.bfloat16)
    out, lse = tiled_attention_online_reference(qkv, 6)
    ref = tiled_attention_online_bwd_reference(qkv, dout, 6, out, lse)
    if wrong_d == "none":
        rel = _slice_rel(tiled_attention_bwd_reference(qkv, dout, 6), ref)
        assert max(rel) <= SLICE_TOL / 4, rel
        return
    bad_out = {"zero": torch.zeros_like(out), "next_row": out.roll(1, dims=1),
               "next_head": out.roll(64, dims=2)}[wrong_d]
    rel = _slice_rel(tiled_attention_online_bwd_reference(qkv, dout, 6, bad_out, lse), ref)
    assert rel[0] > 8 * SLICE_TOL and rel[1] > SLICE_TOL, rel  # dQ, dK; dV has no D


def test_tiled_attention_cpu_wrapper_is_plain_and_differentiable():
    """On a CPU tensor the wrapper is the plain version; autograd through it
    gives the plain backward; the chunk size does not change the result."""
    rng = np.random.default_rng(2)
    qkv = _t(rng.normal(size=(2, 150, 192)).astype(np.float32))
    w = _t(rng.normal(size=(2, 150, 64)).astype(np.float32))
    out = tiled_attention(qkv, 2)
    torch.testing.assert_close(out, tiled_attention_reference(qkv, 2), rtol=0, atol=0)
    torch.testing.assert_close(out, tiled_attention_reference(qkv, 2, chunk=64),
                               rtol=0, atol=1e-6)  # chunked sums of the same terms
    x = qkv.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad((tiled_attention(x, 2) * w).sum(), x)
    torch.testing.assert_close(grad, tiled_attention_bwd_reference(qkv, w, 2), rtol=0, atol=0)
    torch.testing.assert_close(grad, tiled_attention_backward(qkv, w, 2), rtol=0, atol=0)
    # packed_attention on the CPU computes the same function (K1's plain form)
    torch.testing.assert_close(packed_attention(qkv, 2), out, rtol=0, atol=1e-5)


def test_tiled_attention_refuses_head_major_and_bad_shapes():
    # the head-major layout runs since item 13a (tests/test_torch_parallel.py
    # holds it to JAX); an unknown layout is refused
    assert tiled_attention(torch.zeros(1, 8, 96), 2, layout="head_major").shape == (1, 8, 32)
    with pytest.raises(ValueError, match="unknown layout"):
        tiled_attention(torch.zeros(1, 8, 96), 2, layout="other")
    with pytest.raises(ValueError, match="3 \\* heads"):
        tiled_attention(torch.zeros(1, 8, 30), 3)
    with pytest.raises(TypeError):
        tiled_attention(torch.zeros(1, 8, 96, dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="does not match"):
        tiled_attention_backward(torch.zeros(1, 8, 96), torch.zeros(1, 8, 30), 2)


@pytest.mark.parametrize("N,d,limit,route", [
    pytest.param(192, 64, H100_SMEM, "K1 CUDA cores", id="114688-K1"),  # the flagship
    # exactly K1's byte count still fits; one byte less does not
    pytest.param(300, 64, k1_smem_bytes(300, 64, torch.float32), "K1 CUDA cores",
                 id="232448-K1"),
    pytest.param(300, 64, k1_smem_bytes(300, 64, torch.float32) - 1, "K4 CUDA cores", id="232449-K4"),
    pytest.param(2304, 64, H100_SMEM, "K4 CUDA cores", id="672768-K4"),  # ViT-S at 768 x 768
])
def test_attention_route_given_bytes(N, d, limit, route):
    """f32 runs K1's CUDA cores where K1's shared memory fits the card's
    limit, else K4's CUDA-core kernels."""
    assert attention_route(N, d, torch.float32, limit) == route
    assert attention_route(N, d, torch.float32, limit, backward=True) == route


# --------------------------------------------------------------------------
# K3: fused decode


def _peaked(seed, B, K, H, W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    c = rng.uniform([3, 3], [W - 4, H - 4], (B, K, 2))
    maps = np.exp(-((xx - c[..., :1, None]) ** 2 + (yy - c[..., 1:, None]) ** 2) / 50.0)
    return (maps + 0.03 * rng.random(maps.shape)).astype(np.float32)


@pytest.mark.parametrize("case", ["64x48", "192x192"])
def test_decode_plain_matches_jax_fused_decode(case):
    if case == "64x48":  # test_pallas.py's maps
        maps, sigmas = _maps(0)
    else:
        maps, sigmas = _peaked(3, 2, 3, 192, 192), np.full(3, 0.05, np.float32)
    K, H, W = maps.shape[1:]
    ops = jax_operators(sigmas, H, W)
    locs_ref, vals_ref = expected_value_decode_pallas(jnp.asarray(maps), ops, interpret=True)
    locs, vals = expected_value_decode_fused(_t(maps), _t(ops.row_op), _t(ops.col_op))
    assert locs.shape == (maps.shape[0], K, 2) and vals.shape == maps.shape[:2]
    # test_pallas.py's bar for the fused decode: 1e-4 px; raw values 1e-6.
    np.testing.assert_allclose(locs.numpy(), np.asarray(locs_ref), rtol=0, atol=1e-4)
    np.testing.assert_allclose(vals.numpy(), np.asarray(vals_ref), rtol=0, atol=1e-6)


# Band radii of the COCO operators, keypoint by keypoint, by heatmap size.
COCO_RADII = {(64, 48): [2, 2, 2, 2, 2, 7, 7, 6, 6, 5, 5, 9, 9, 9, 9, 9, 9],
              (192, 192): [3, 3, 3, 5, 5, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9]}


@pytest.mark.parametrize("H,W", list(COCO_RADII))
def test_band_radius_of_coco_operators(H, W):
    """K3's band radius: ceil(3 s) of each keypoint's OKS kernel, the same
    for row and column operators, every nonzero inside it; a dense operator
    gives n - 1."""
    ops = build_oks_conv_operators(COCO_SIGMAS, H, W)
    for op in (ops.row_op, ops.col_op):
        radius = band_radius(_t(op))
        assert radius.tolist() == COCO_RADII[(H, W)]
        n = op.shape[-1]
        dist = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
        assert not (op != 0)[dist[None] > radius.numpy()[:, None, None]].any()
    dense = np.random.default_rng(0).random((2, 9, 9)).astype(np.float32) + 0.1
    assert band_radius(_t(dense)).tolist() == [8, 8]


def test_operator_bands_pack_the_column_band_and_cache_it():
    """col_band[k, d, w] = col_op[k, w, w - r_k + d] inside the band, zero
    outside and in the padding to a multiple of 4 columns; the same tensors
    give the cached pack, an in-place change a new one."""
    ops = build_oks_conv_operators(COCO_SIGMAS, 64, 46)
    row_op, col_op = _t(ops.row_op), _t(ops.col_op)
    radius, band, R = operator_bands(row_op, col_op)
    assert R == 9 and band.shape == (17, 19, 48) and radius.dtype == torch.int32
    for k in range(17):
        r = int(radius[k])
        for w in range(48):
            for d in range(19):
                v = w - r + d
                inside = w < 46 and 0 <= v < 46 and d <= 2 * r
                assert band[k, d, w] == (col_op[k, w, v] if inside else 0.0)
    assert operator_bands(row_op, col_op)[1] is band
    col_op.mul_(2.0)
    assert torch.equal(operator_bands(row_op, col_op)[1], 2.0 * band)
    with torch.inference_mode():  # as the codec builds them while serving
        row_op, col_op = row_op.clone(), col_op.clone()
    assert torch.equal(operator_bands(row_op, col_op)[1], 2.0 * band)
    assert operator_bands(row_op, col_op)[1] is operator_bands(row_op, col_op)[1]


@pytest.mark.parametrize("B,H,W", [(2, 64, 48), (1, 192, 192)])
def test_banded_decode_twin_matches_jax_fused_decode(B, H, W):
    """K3's design (products over each band, ascending index order) at the
    COCO operators against the Pallas fused decode and the port's plain
    decode: the repo's decode bar of 1e-3 px, raw values 1e-6."""
    maps = _peaked(5, B, 17, H, W)
    ops = jax_operators(COCO_SIGMAS, H, W)
    locs, vals = expected_value_decode_banded_reference(_t(maps), _t(ops.row_op),
                                                        _t(ops.col_op))
    for ref_locs, ref_vals in (
            expected_value_decode_pallas(jnp.asarray(maps), ops, interpret=True),
            expected_value_decode(_t(maps), _t(ops.row_op), _t(ops.col_op))):
        np.testing.assert_allclose(locs.numpy(), np.asarray(ref_locs), rtol=0, atol=1e-3)
        np.testing.assert_allclose(vals.numpy(), np.asarray(ref_vals), rtol=0, atol=1e-6)


def test_decode_fused_checks_inputs():
    with pytest.raises(ValueError, match="operators"):
        expected_value_decode_fused(torch.zeros(1, 2, 8, 6), torch.zeros(2, 8, 8),
                                    torch.zeros(2, 8, 8))
    with pytest.raises(TypeError):
        expected_value_decode_fused(torch.zeros(1, 2, 8, 6, dtype=torch.float64),
                                    torch.zeros(2, 8, 8), torch.zeros(2, 6, 6))


# --------------------------------------------------------------------------
# K2 at 192 x 192-pixel rows


def test_sparsemax_long_rows_plain_matches_jax():
    rng = np.random.default_rng(4)
    z = (rng.normal(size=(4, 192 * 192)) / 0.5).astype(np.float32)
    out = sparsemax_rows(_t(z))
    torch.testing.assert_close(out, sparsemax_reference(_t(z)), rtol=0, atol=0)
    # exact tau from the same support; f32 sums in another order
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_sparsemax(jnp.asarray(z))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-5)  # on the simplex


# --------------------------------------------------------------------------
# the slice at tiny width: vit-nano on 768 x 768 inputs


RAW_768 = dict(RAW, train_batch_size=2, val_batch_size=2, model=dict(
    RAW["model"], img_size=(768, 768), backbone="vit-nano",
    pool_sizes=((4, 3), (2, 2), (2, 2))))


@pytest.fixture(scope="module")
def side_768():
    js = build_jax_side(RAW_768)
    return js, _port(js, RAW_768)


def test_slice_768_forward_and_decode_match_jax(side_768):
    js, trainer = side_768
    x = np.random.default_rng(5).random((2, 768, 768, 3), dtype=np.float32)
    ref = js["model"].apply(js["variables"], jnp.asarray(x), train=False)
    model = trainer.model.eval()
    with torch.no_grad():
        out = model(_t(x))
    assert out[0].shape == (2, 5, 192, 192)
    assert (out[0] > 0).float().mean() < 0.5  # peaked, sparse maps
    for o, r in zip(out, ref):
        # f32 on both sides; sums in another order (tests/test_torch_models.py)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)
    kw = dict(input_size=(768, 768), heatmap_size=(192, 192),
              sigmas=np.full(5, 0.05, np.float32), sigma=2.0)
    (k_ref, _), *_ = JaxCodec(JaxProbMap(**kw)).decode(ref)
    (k, _), *_ = Codec(ProbMap(**kw)).decode(out)
    # the repo's decode bar, 1e-3 px, at 192 x 192 maps
    np.testing.assert_allclose(k.numpy(), np.asarray(k_ref), rtol=0, atol=1e-3)


def test_slice_768_train_step_matches_jax(side_768):
    js, trainer = side_768
    ds = SyntheticPoseDataset(2, (768, 768), 5, seed=0)
    batch = next(iter(batch_iterator(ds, 2, num_workers=1)))
    _, jm = js["step"](js["state"], {k: jnp.asarray(v) for k, v in batch.items()})
    trainer.model.train()
    _, metrics = trainer.train_step(trainer.state, trainer.device_batch(batch))
    for k, v in jm.items():
        if k.startswith("loss"):
            # each loss term within 1e-5 relative, as tests/test_torch_train.py
            np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, atol=1e-8,
                                       err_msg=k)
    # pre-clip global norm, 1e-4 relative
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
