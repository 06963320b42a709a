"""The port's training numerics against the JAX package, on the CPU at small
sizes: target encoding, the argmax + UDP decode, OKS targets, every loss
term and metric, and the plain K1 backward.

Inputs come from numpy generators and cross between the frameworks as numpy
arrays. Everything is float32 unless a test says otherwise; each tolerance
is stated beside its assertion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu import losses as jl
from probpose_pytorch_tpu.codec import ArgMaxProbMap as JaxArgMax
from probpose_pytorch_tpu.codec import Codec as JaxCodec
from probpose_pytorch_tpu.codec import ProbMap as JaxProbMap
from probpose_pytorch_tpu.ops import heatmap as jhm
from probpose_pytorch_tpu.ops import oks as joks
from probpose_pytorch_tpu.ops import probmaps as jpm
from probpose_pytorch_tpu.ops import udp as judp
from probpose_pytorch_tpu.ops.pallas import packed_attention as jax_packed_attention
from probpose_pytorch_tpu_torch import losses as tl
from probpose_pytorch_tpu_torch.codec import ArgMaxProbMap, Codec, ProbMap
from probpose_pytorch_tpu_torch.ops import heatmap as thm
from probpose_pytorch_tpu_torch.ops import oks as toks
from probpose_pytorch_tpu_torch.ops import probmaps as tpm
from probpose_pytorch_tpu_torch.ops import udp as tudp
from probpose_pytorch_tpu_torch.ops.kernels.attention import (
    packed_attention,
    packed_attention_bwd_reference,
)

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

IMG_WH = (48, 64)
HM_WH = (12, 16)
K = 5
SIGMAS = np.full(K, 0.05, np.float32)
# Elementwise float32 arithmetic in the same order on both sides.
RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _n(t):
    return t.detach().numpy()


def _keypoints(seed, B=4):
    """Input-space keypoints, some outside the crop, and visibilities with
    unlabeled keypoints (vis 0) among them."""
    rng = np.random.default_rng(seed)
    kpts = rng.uniform([-5, -5], [IMG_WH[0] + 5, IMG_WH[1] + 5], (B, K, 2)).astype(np.float32)
    vis = (rng.random((B, K)) > 0.25).astype(np.float32)
    visibility = np.where(vis > 0, (rng.random((B, K)) > 0.3), 0).astype(np.float32)
    return kpts, vis, visibility


def _peaked_heatmaps(seed, B=4, empty=True):
    """Sparse heatmaps with one smooth bump each (and one all-zero map when
    `empty`, whose -1 argmax reads the padded corner in the UDP step)."""
    rng = np.random.default_rng(seed)
    W, H = HM_WH
    ys, xs = np.mgrid[0:H, 0:W]
    cx = rng.uniform(1, W - 2, (B, K, 1, 1))
    cy = rng.uniform(1, H - 2, (B, K, 1, 1))
    hm = np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * rng.uniform(0.6, 2.0, (B, K, 1, 1))))
    hm = np.where(hm > 0.05, hm, 0.0).astype(np.float32)
    if empty:
        hm[0, 0] = 0.0
    return hm


# --------------------------------------------------------------------------
# encode


@pytest.mark.parametrize("sigma", [2.0, -1.0, 0.55])
def test_generate_probmaps_matches_jax(sigma):
    kpts, vis, _ = _keypoints(0)
    hm_kpts = kpts / 4.0
    ref, ref_w = jpm.generate_probmaps(HM_WH, hm_kpts, vis, SIGMAS, sigma)
    out, w = tpm.generate_probmaps(HM_WH, _t(hm_kpts), _t(vis), SIGMAS, sigma)
    np.testing.assert_allclose(_n(out), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(_n(w), np.asarray(ref_w))
    np.testing.assert_array_equal(
        _n(tpm.oks_spread(SIGMAS, HM_WH, sigma)), np.asarray(jpm.oks_spread(SIGMAS, HM_WH, sigma)))


@pytest.mark.parametrize("codec_cls,jax_cls,sigma", [
    (ProbMap, JaxProbMap, 2.0),
    (ArgMaxProbMap, JaxArgMax, -1.0),
])
def test_encode_matches_jax(codec_cls, jax_cls, sigma):
    kpts, vis, visibility = _keypoints(1)
    ours = Codec(codec_cls(IMG_WH, HM_WH, sigmas=SIGMAS, sigma=sigma)).encode(
        _t(kpts), _t(vis), keypoints_visibility=_t(visibility))
    ref = JaxCodec(jax_cls(IMG_WH, HM_WH, sigmas=SIGMAS, sigma=sigma)).encode(
        kpts, vis, keypoints_visibility=visibility)
    assert sorted(ours) == sorted(ref)
    for key, r in ref.items():
        o = ours[key]
        if key == "identification_similarity":
            assert o == r
        elif key in ("annotated", "in_image"):
            np.testing.assert_array_equal(_n(o), np.asarray(r), err_msg=key)
        else:
            np.testing.assert_allclose(_n(o), np.asarray(r), rtol=RTOL, atol=ATOL, err_msg=key)
    # single-instance (K, 2) input
    one = Codec(codec_cls(IMG_WH, HM_WH, sigmas=SIGMAS, sigma=sigma)).encode(kpts[0])
    assert one["heatmaps"].shape == (1, K, HM_WH[1], HM_WH[0])


# --------------------------------------------------------------------------
# argmax + UDP decode


def test_blur_operators_and_modulation_match_jax():
    ops = tudp.build_gaussian_blur_operators(11, HM_WH[1], HM_WH[0])
    ref = judp.build_gaussian_blur_operators(11, HM_WH[1], HM_WH[0])
    np.testing.assert_array_equal(ops.row_op, ref.row_op)
    np.testing.assert_array_equal(ops.col_op, ref.col_op)
    hm = _peaked_heatmaps(2)
    out = tudp.gaussian_blur_modulate(_t(hm), _t(ops.row_op), _t(ops.col_op))
    # f32 band products summed in another order (JAX at HIGHEST precision).
    np.testing.assert_allclose(_n(out), np.asarray(judp.gaussian_blur_modulate(hm, ref)),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="odd"):
        tudp.build_gaussian_blur_operators(10, 4, 4)


def test_sym2x2_pinv_matches_jax():
    rng = np.random.default_rng(3)
    a, b, c = (rng.normal(size=64).astype(np.float32) for _ in range(3))
    # degenerate cases: diagonal (b = 0, both orders of a and c), singular,
    # and zero.
    a[:4], b[:4], c[:4] = [2.0, 0.5, 1.0, 0.0], [0.0, 0.0, 1.0, 0.0], [0.5, 2.0, 1.0, 0.0]
    ours = tudp._sym2x2_pinv(_t(a), _t(b), _t(c))
    ref = judp._sym2x2_pinv(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    for o, r in zip(ours, ref):
        # entries reach 1/|lambda_min|; 1e-5 relative to their scale.
        np.testing.assert_allclose(_n(o), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("max_step", [None, 1.0])
def test_argmax_udp_decode_matches_jax(max_step):
    hm = _peaked_heatmaps(4)
    ours = ArgMaxProbMap(IMG_WH, HM_WH, sigmas=SIGMAS, udp_max_step=max_step)
    ref = JaxArgMax(IMG_WH, HM_WH, sigmas=SIGMAS, udp_max_step=max_step)
    kpts, vals = ours.decode(_t(hm))
    rk, rv = ref.decode(hm)
    assert np.isfinite(_n(kpts)).all()
    # input-space pixels (x4 the heatmap grid); the Newton step is f32.
    np.testing.assert_allclose(_n(kpts), np.asarray(rk), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(_n(vals), np.asarray(rv))
    one, _ = ours.decode(_t(hm[1]))  # (K, H, W)
    np.testing.assert_allclose(_n(one), np.asarray(rk)[1:2], rtol=0, atol=1e-4)


# --------------------------------------------------------------------------
# OKS targets


def test_oks_targets_match_jax():
    rng = np.random.default_rng(5)
    gt = rng.uniform(0, 48, (4, K, 2)).astype(np.float32)
    dt = (gt + rng.normal(scale=2.0, size=gt.shape)).astype(np.float32)
    w = (rng.random((4, K)) > 0.3).astype(np.float32)
    w[2] = 0.0  # a sample with no valid keypoint
    oks, sw = toks.oks_targets_from_coords(_t(gt), _t(dt), _t(w), SIGMAS, HM_WH)
    roks, rsw = joks.oks_targets_from_coords(gt, dt, w, SIGMAS, HM_WH)
    np.testing.assert_allclose(_n(oks), np.asarray(roks), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(_n(sw), np.asarray(rsw))
    assert (_n(oks)[2] == 0).all()
    p = toks.per_keypoint_oks(_t(gt), _t(dt), _t(w), SIGMAS, 100.0)
    np.testing.assert_allclose(_n(p), np.asarray(joks.per_keypoint_oks(gt, dt, w, SIGMAS, 100.0)),
                               rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# loss terms


def _maps(seed, B=3):
    rng = np.random.default_rng(seed)
    out = rng.random((B, K, 8, 6)).astype(np.float32)
    tgt = np.where(rng.random((B, K, 8, 6)) > 0.4, rng.random((B, K, 8, 6)), 0).astype(np.float32)
    tgt[0, 1] = 0.0  # an empty channel
    w = rng.random((B, K)).astype(np.float32)
    mask = (rng.random((B, K, 8, 6)) > 0.2).astype(np.float32)
    return out, tgt, w, mask


@pytest.mark.parametrize("kw", [
    dict(oks_type="minus", per_pixel=True),
    dict(oks_type="plus", per_keypoint=True, gaussian_weight=0.1),
    dict(oks_type="both", skip_empty_channel=True, loss_weight=2.0),
    dict(oks_type="minus", use_mask=True, smoothing_weight=0.05),
])
def test_oks_heatmap_loss_matches_jax(kw):
    kw = dict(kw)
    out, tgt, w, mask = _maps(6)
    m = mask if kw.pop("use_mask", False) else None
    ref_fn = lambda o: jl.oks_heatmap_loss(o, tgt, w, None if m is None else m, **kw)
    ours = tl.oks_heatmap_loss(o := _t(out).requires_grad_(True), _t(tgt), _t(w),
                               None if m is None else _t(m), **kw)
    np.testing.assert_allclose(_n(ours), np.asarray(ref_fn(out)), rtol=RTOL, atol=ATOL)
    # Gradients, through the Sobel term and the max over pixels.
    (g,) = torch.autograd.grad(ours.sum(), o)
    rg = jax.grad(lambda x: jnp.sum(ref_fn(x)))(out)
    np.testing.assert_allclose(_n(g), np.asarray(rg), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(from_probs=True),
    dict(from_probs=True, reduction="sum", weighted=True),
    dict(from_probs=False, reduction="none", weighted=True, loss_weight=0.5),
])
def test_binary_cross_entropy_matches_jax(kw):
    kw = dict(kw)
    rng = np.random.default_rng(7)
    x = rng.random((4, K)).astype(np.float32) if kw["from_probs"] else \
        rng.normal(scale=3.0, size=(4, K)).astype(np.float32)
    y = (rng.random((4, K)) > 0.5).astype(np.float32)
    w = rng.random(4).astype(np.float32) if kw.pop("weighted", False) else None
    ours = tl.binary_cross_entropy(xt := _t(x).requires_grad_(True), _t(y),
                                   None if w is None else _t(w), **kw)
    ref_fn = lambda v: jl.binary_cross_entropy(v, y, w, **kw)
    np.testing.assert_allclose(_n(ours), np.asarray(ref_fn(x)), rtol=RTOL, atol=ATOL)
    (g,) = torch.autograd.grad(ours.sum(), xt)
    np.testing.assert_allclose(_n(g), np.asarray(jax.grad(lambda v: jnp.sum(ref_fn(v)))(x)),
                               rtol=RTOL, atol=ATOL)


def test_binary_cross_entropy_at_exact_zero_and_one():
    """Saturated probabilities: finite loss, and zero gradient outside the
    clip [1.1754944e-38, 1 - 6e-8], both as in JAX. F.binary_cross_entropy
    would give log(0) clamped to -100 and a non-zero gradient."""
    p = np.array([0.0, 1.0, 0.0, 1.0, 0.5, 1e-39], np.float32)
    y = np.array([0.0, 1.0, 1.0, 0.0, 1.0, 0.0], np.float32)
    pt = _t(p).requires_grad_(True)
    ours = tl.binary_cross_entropy(pt, _t(y), from_probs=True, reduction="none")
    ref = jl.binary_cross_entropy(p, y, from_probs=True, reduction="none")
    assert np.isfinite(_n(ours)).all()
    np.testing.assert_allclose(_n(ours), np.asarray(ref), rtol=RTOL, atol=ATOL)
    (g,) = torch.autograd.grad(ours.sum(), pt)
    rg = jax.grad(lambda v: jnp.sum(jl.binary_cross_entropy(v, y, from_probs=True,
                                                            reduction="none")))(p)
    np.testing.assert_array_equal(_n(g)[[0, 1, 2, 3, 5]], 0.0)
    np.testing.assert_allclose(_n(g), np.asarray(rg), rtol=RTOL, atol=ATOL)


def test_mse_and_l1_log_losses_match_jax():
    rng = np.random.default_rng(8)
    o, t = rng.random((2, 4, K)).astype(np.float32) * 3
    w = (rng.random((4, K)) > 0.3).astype(np.float32)
    for fn, jfn in ((tl.mse_loss, jl.mse_loss), (tl.l1_log_loss, jl.l1_log_loss)):
        for weight in (None, w):
            ot = _t(o).requires_grad_(True)
            ours = fn(ot, _t(t), None if weight is None else _t(weight), loss_weight=1.5)
            ref_fn = lambda v: jfn(v, t, weight, loss_weight=1.5)
            np.testing.assert_allclose(_n(ours), np.asarray(ref_fn(o)), rtol=RTOL, atol=ATOL)
            (g,) = torch.autograd.grad(ours, ot)
            np.testing.assert_allclose(_n(g), np.asarray(jax.grad(ref_fn)(o)), rtol=RTOL, atol=1e-7)


# --------------------------------------------------------------------------
# metrics


def test_distances_and_accuracy_match_jax():
    rng = np.random.default_rng(9)
    pred = rng.uniform(0, 10, (4, K, 2)).astype(np.float32)
    gt = rng.uniform(0, 10, (4, K, 2)).astype(np.float32)
    mask = rng.random((4, K)) > 0.3
    norm = rng.uniform(1, 5, (4, 2)).astype(np.float32)
    norm[1, 0] = 0.0  # masked instance
    norm[2, 1] = -1.0  # replaced by 1e6
    d = thm.calc_distances(_t(pred), _t(gt), _t(mask), _t(norm))
    rd = jhm.calc_distances(pred, gt, mask, norm)
    np.testing.assert_allclose(_n(d), np.asarray(rd), rtol=RTOL, atol=ATOL)
    acc = thm.distance_acc(d, 0.5)
    racc = jax.vmap(lambda r: jhm.distance_acc(r, 0.5))(rd)
    np.testing.assert_allclose(_n(acc), np.asarray(racc), rtol=RTOL, atol=ATOL)
    assert float(thm.distance_acc(torch.full((3,), -1.0))) == -1.0


@pytest.mark.parametrize("method", ["argmax", "expected"])
def test_pose_pck_accuracy_matches_jax(method):
    out, tgt = _peaked_heatmaps(10, empty=False), _peaked_heatmaps(11)
    mask = np.random.default_rng(12).random((4, K)) > 0.2
    conv = None
    if method == "expected":
        conv = ProbMap(IMG_WH, HM_WH, SIGMAS).conv_operators(torch.device("cpu"))
    ours = tl.pose_pck_accuracy(_t(out), _t(tgt), _t(mask), method=method, conv_ops=conv)
    rconv = jhm.build_oks_conv_operators(SIGMAS, HM_WH[1], HM_WH[0]) if conv else None
    ref = jl.pose_pck_accuracy(out, tgt, mask, method=method, conv_ops=rconv)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(_n(o), np.asarray(r), rtol=RTOL, atol=ATOL)


def test_binary_accuracy_and_mae_match_jax():
    rng = np.random.default_rng(13)
    dt = rng.random((4, K)).astype(np.float32)
    gt = (rng.random((4, K)) > 0.5).astype(np.float32)
    mask = rng.random((4, K)) > 0.2
    for m in (mask, np.zeros_like(mask)):
        ours = tl.balanced_binary_accuracy(_t(dt), _t(gt), _t(m))
        ref = jl.balanced_binary_accuracy(dt, gt, m)
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(_n(o), np.asarray(r), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(_n(tl.masked_mae(_t(dt), _t(gt), _t(m))),
                                   np.asarray(jl.masked_mae(dt, gt, m)), rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# the composite loss


def _pred_and_gt(seed):
    """A head-shaped prediction and the encoded gt of a batch."""
    rng = np.random.default_rng(seed)
    B = 4
    kpts, vis, visibility = _keypoints(seed, B)
    enc = JaxCodec(JaxProbMap(IMG_WH, HM_WH, sigmas=SIGMAS, sigma=2.0)).encode(
        kpts, vis, keypoints_visibility=visibility)
    gt = dict(heatmaps=np.asarray(enc["heatmaps"]), in_image=np.asarray(enc["in_image"]),
              keypoints_visible=vis, keypoints_visibility=visibility)
    scal = lambda: rng.random((B, K, 1, 1)).astype(np.float32)
    pred = (_peaked_heatmaps(seed + 100, B, empty=False), scal(), scal(), scal(),
            3 * scal())
    pred[1][0, 0] = 1.0  # a saturated probability
    return gt, pred


@pytest.mark.parametrize("freeze_oks,freeze_error,from_zeros", [
    (False, True, False),   # the flagship
    (False, False, True),
    (True, True, False),
])
def test_probpose_loss_matches_jax(freeze_oks, freeze_error, from_zeros):
    gt, pred = _pred_and_gt(14)
    codec = Codec(ArgMaxProbMap(IMG_WH, HM_WH, sigmas=SIGMAS))
    jcodec = JaxCodec(JaxArgMax(IMG_WH, HM_WH, sigmas=SIGMAS))
    ours_fn = tl.ProbPoseLoss(codec, freeze_error=freeze_error, freeze_oks=freeze_oks)
    ref_fn = jl.ProbPoseLoss(jcodec, freeze_error=freeze_error, freeze_oks=freeze_oks)
    pt = tuple(_t(p).requires_grad_(True) for p in pred)
    losses, acc = ours_fn({k: _t(v) for k, v in gt.items()}, pt,
                          learn_heatmaps_from_zeros=from_zeros, compute_acc=True)
    rlosses, racc = ref_fn(gt, pred, learn_heatmaps_from_zeros=from_zeros, compute_acc=True)
    for k in rlosses:
        # each term within 1e-5 relative of the JAX value
        np.testing.assert_allclose(_n(losses[k]), np.asarray(rlosses[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for k in racc:
        # 1e-4 relative: acc/error is a mean of decoded distances, and the
        # UDP step's eigenvector is ill-conditioned where dxx ~ dyy and
        # dxy ~ 0 (a round encoded peak), so 1e-7 rounding in the blur sums
        # moves such a coordinate by up to ~5e-3 px on both sides alike.
        np.testing.assert_allclose(_n(acc[k]), np.asarray(racc[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    total = sum(losses.values())
    grads = torch.autograd.grad(total, pt)
    rgrads = jax.grad(lambda p: sum(ref_fn(gt, p, learn_heatmaps_from_zeros=from_zeros)
                                    .values()))(tuple(jnp.asarray(p) for p in pred))
    for g, r in zip(grads, rgrads):
        # per-input gradient within 1e-4 of its largest JAX entry
        np.testing.assert_allclose(_n(g), np.asarray(r), rtol=0,
                                   atol=1e-4 * float(np.abs(np.asarray(r)).max()) + 1e-9)


# --------------------------------------------------------------------------
# plain K1 backward


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_backward_plain_matches_jax_vjp(dtype):
    """packed_attention_bwd_reference against jax.vjp of the Pallas kernel in
    interpret mode, on the same (bf16-representable) inputs."""
    rng = np.random.default_rng(15)
    B, N, heads, d = 2, 16, 2, 16
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * heads * d)).astype(np.float32)).to(dtype)
    dout = torch.from_numpy(rng.normal(size=(B, N, heads * d)).astype(np.float32)).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq = jnp.asarray(qkv.float().numpy(), jdt)
    jo = jnp.asarray(dout.float().numpy(), jdt)
    _, vjp = jax.vjp(lambda x: jax_packed_attention(x, heads, group=1, interpret=True), jq)
    (ref,) = vjp(jo)
    ref = np.asarray(ref.astype(jnp.float32))
    ours = packed_attention_bwd_reference(qkv, dout, heads)
    assert ours.dtype == dtype and ours.shape == qkv.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        # Same two bf16 roundings (P, dS); f32 sums in another order can
        # move an output by one bf16 ulp: 2 ulps (2 * 2^-8) of max|ref|.
        bound = 2 * 2**-8 * max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(ours.float().numpy() - ref).max()) <= bound


def test_k1_autograd_defines_qkv_grad_on_cpu():
    """packed_attention is differentiable: qkv.grad is defined after
    backward and equals the plain backward of the same cotangent."""
    rng = np.random.default_rng(16)
    qkv = _t(rng.normal(size=(2, 12, 3 * 32)).astype(np.float32)).requires_grad_(True)
    w = _t(rng.normal(size=(2, 12, 32)).astype(np.float32))
    (packed_attention(qkv, 2) * w).sum().backward()
    assert qkv.grad is not None
    np.testing.assert_allclose(
        qkv.grad.numpy(), packed_attention_bwd_reference(qkv.detach(), w, 2).numpy(),
        rtol=1e-6, atol=1e-7)
