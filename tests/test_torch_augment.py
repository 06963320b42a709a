"""The port's augmentation (ops/augment.py) and the augmented train step
against the JAX package, on the CPU.

torch cannot replay `jax.random`, so every transform here takes the values
that `jax.random` drew on the JAX side (`jax_draws`, the draws of the JAX
train step's key domains); the port's own sampler, `draw_augment`, is held
to its ranges and rates. Inputs are numpy arrays made from a seed; each
tolerance is stated beside its assertion.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.ops import augment as jax_aug
from probpose_pytorch_tpu.train import loop as jax_loop
from probpose_pytorch_tpu.train import state as jax_state
from probpose_pytorch_tpu_torch.compat.from_jax import state_dict_from_jax
from probpose_pytorch_tpu_torch.ops import augment
from probpose_pytorch_tpu_torch.ops.augment import AugmentDraws
from probpose_pytorch_tpu_torch.train import loop
from probpose_pytorch_tpu_torch.train.config import AugmentConfig
from test_torch_train import (
    RAW,
    STEPS_PER_EPOCH,
    _by_name,
    _check_grads,
    _close_params,
    _n,
    _port,
    build_jax_side,
)

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

K = 17


def jax_draws(aug, seed: int, step: int, B: int) -> AugmentDraws:
    """The values the JAX train step draws at `step` (its fold_in domains:
    2 step for flip, rotation and colour, 2 step + 1 for the box jitter,
    the half-body root key), as the port's AugmentDraws."""
    u = jax.random.uniform
    base = jax.random.PRNGKey(seed)
    key = jax.random.fold_in(base, step * 2)
    k_flip, k_rot, k_color = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_color)
    kb1, kb2 = jax.random.split(jax.random.fold_in(base, step * 2 + 1))
    hb_root = jax.random.fold_in(jax.random.PRNGKey(seed), 2**31 - 1)
    kh1, kh2 = jax.random.split(jax.random.fold_in(hb_root, step))
    vals = dict(
        flip=jax.random.bernoulli(k_flip, aug.flip_prob, (B,)),
        scale=1.0 + aug.scale_jitter * u(kb1, (B, 1), minval=-1.0, maxval=1.0),
        shift=aug.shift_jitter * u(kb2, (B, 2), minval=-1.0, maxval=1.0),
        half_coin=jax.random.bernoulli(kh1, 0.5, (B,)),
        half_u=u(kh2, (B,)),
        theta=u(k_rot, (B,), minval=-1.0, maxval=1.0) * jnp.deg2rad(aug.rotation_deg),
        brightness=aug.brightness * u(k1, (B, 1, 1, 1), minval=-1, maxval=1),
        contrast=1.0 + aug.contrast * u(k2, (B, 1, 1, 1), minval=-1, maxval=1),
    )
    return AugmentDraws(**{k: torch.from_numpy(np.array(v)) for k, v in vals.items()})


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# the transforms, one by one


def test_flip_matches_jax_exactly():
    rng = np.random.default_rng(0)
    B, H, W = 8, 16, 12
    crops = rng.random((B, H, W, 3), dtype=np.float32)
    kpts = rng.uniform(0, 12, (B, K, 2)).astype(np.float32)
    vis = (rng.random((B, K)) > 0.3).astype(np.float32)
    visibility = (rng.random((B, K)) > 0.5).astype(np.float32)
    cfg = jax_aug.AugmentConfig()
    key = jax.random.PRNGKey(3)
    ref = jax_aug.flip_crops_and_keypoints(key, *map(jnp.asarray, (crops, kpts, vis, visibility)),
                                           cfg)
    flip = _t(jax.random.bernoulli(key, cfg.flip_prob, (B,)))
    assert 0 < int(flip.sum()) < B
    out = augment.flip_crops_and_keypoints(flip, *map(_t, (crops, kpts, vis, visibility)),
                                           AugmentConfig())
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(_n(o), np.asarray(r))  # a permutation: exact


def test_augment_boxes_matches_jax():
    rng = np.random.default_rng(1)
    boxes = rng.uniform([0, 0, 20, 30], [50, 60, 90, 120], (16, 4)).astype(np.float32)
    cfg = jax_aug.AugmentConfig()
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jax_aug.augment_boxes(key, jnp.asarray(boxes), cfg))
    d = jax_draws(cfg, 0, 0, 16)  # shapes only; the values come from `key`
    k1, k2 = jax.random.split(key)
    scale = _t(1.0 + cfg.scale_jitter * jax.random.uniform(k1, (16, 1), minval=-1.0, maxval=1.0))
    shift = _t(cfg.shift_jitter * jax.random.uniform(k2, (16, 2), minval=-1.0, maxval=1.0))
    assert scale.shape == d.scale.shape and shift.shape == d.shift.shape
    out = augment.augment_boxes(_t(boxes), scale, shift)
    np.testing.assert_allclose(_n(out), ref, rtol=1e-6)  # f32 products, FMA or not


def _grid_kpts():
    """The JAX tests' 17 keypoints: upper (0-10) in y [0, 50], lower
    (11-16) in y [100, 160]."""
    k = np.zeros((17, 2), np.float32)
    for i in range(11):
        k[i] = [10 + 8 * i, 5 * i]
    for j, i in enumerate(range(11, 17)):
        k[i] = [20 + 12 * j, 100 + 10 * j]
    return k


def _half_body_case(name):
    """(boxes, keypoints, labeled, cfg kwargs, aspect, key) of the JAX
    test_augment.py half-body cases, and a random one."""
    k = _grid_kpts()
    if name == "forced":
        return ([[0.0, 0.0, 200.0, 200.0]], k[None], np.ones((1, 17)),
                dict(half_body_prob=1.0, upper_body_ids=()), None, 0)
    if name == "upper_or_lower":
        return (np.tile([[0.0, 0.0, 200.0, 200.0]], (64, 1)), np.tile(k[None], (64, 1, 1)),
                np.ones((64, 17)), dict(half_body_prob=1.0), None, 1)
    if name == "insufficient":
        lab = np.zeros((2, 17), np.float32)
        lab[0, :5], lab[1] = 1, 1
        return ([[1.0, 2.0, 50.0, 60.0]] * 2, np.tile(k[None], (2, 1, 1)), lab,
                dict(half_body_prob=1.0), None, 2)
    if name == "aspect":
        return ([[0.0, 0.0, 200.0, 200.0]], k[None], np.ones((1, 17)),
                dict(half_body_prob=1.0, upper_body_ids=()), 192 / 256, 0)
    if name == "zero_prob":
        return ([[3.0, 4.0, 90.0, 170.0]], k[None], np.ones((1, 17)),
                dict(half_body_prob=0.0), 0.75, 0)
    rng = np.random.default_rng(5)  # "random": partial labels, collinear halves
    kp = rng.uniform(0, 300, (32, 17, 2)).astype(np.float32)
    kp[:4, :, 1] = 40.0
    return (rng.uniform([0, 0, 50, 50], [40, 40, 200, 300], (32, 4)), kp,
            (rng.random((32, 17)) > 0.25).astype(np.float32), dict(half_body_prob=0.6),
            192 / 256, 7)


@pytest.mark.parametrize("name", ["forced", "upper_or_lower", "insufficient", "aspect",
                                  "zero_prob", "random"])
def test_half_body_boxes_match_jax(name):
    boxes, kpts, lab, kw, aspect, seed = _half_body_case(name)
    boxes = np.asarray(boxes, np.float32)
    kpts = np.asarray(kpts, np.float32)
    lab = np.asarray(lab, np.float32)
    B = len(boxes)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax_aug.half_body_boxes(key, jnp.asarray(boxes), jnp.asarray(kpts),
                                             jnp.asarray(lab), jax_aug.AugmentConfig(**kw),
                                             aspect=aspect))
    k1, k2 = jax.random.split(key)
    coin = _t(jax.random.bernoulli(k1, 0.5, (B,)))
    u = _t(jax.random.uniform(k2, (B,)))
    out = augment.half_body_boxes(_t(boxes), _t(kpts), _t(lab), coin, u, AugmentConfig(**kw),
                                  aspect=aspect)
    # 1e-5 px: the same f32 min/max, halving and padding
    np.testing.assert_allclose(_n(out), ref, rtol=0, atol=1e-5)
    if name == "upper_or_lower":
        assert not np.isclose(ref, boxes).all(axis=1).any()  # every sample re-boxed


def test_rotate_crops_by_zero_and_90_degrees():
    rng = np.random.default_rng(6)
    img = rng.random((3, 10, 10, 3), dtype=np.float32)
    kpts = rng.uniform(0, 9, (3, K, 2)).astype(np.float32)
    out, k = augment.rotate_crops(_t(img), _t(kpts), torch.zeros(3))
    np.testing.assert_array_equal(_n(out), img)  # 0 degrees: every tap weight 0 or 1
    np.testing.assert_allclose(_n(k), kpts, rtol=0, atol=1e-6)  # (k - c) + c rounds
    out, k = augment.rotate_crops(_t(img), _t(kpts), torch.full((3,), np.pi / 2))
    # 90 degrees: out[y, x] = img[W - 1 - x, y]; cos(f32(pi/2)) = -4.4e-8, so taps
    # sit 4e-7 px off the pixel grid at most
    np.testing.assert_allclose(_n(out), np.rot90(img, k=-1, axes=(1, 2)), rtol=0, atol=1e-5)
    c = 4.5  # the center of a 10 x 10 crop
    np.testing.assert_allclose(_n(k), np.stack([c - (kpts[..., 1] - c), c + (kpts[..., 0] - c)],
                                               -1), rtol=0, atol=1e-5)


def test_rotate_crops_matches_jax():
    rng = np.random.default_rng(7)
    img = rng.random((6, 16, 12, 3), dtype=np.float32)
    kpts = rng.uniform(-2, 14, (6, K, 2)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, 6).astype(np.float32)
    ref_img, ref_k = jax_aug.rotate_crops(jnp.asarray(img), jnp.asarray(kpts), jnp.asarray(theta))
    out, k = augment.rotate_crops(_t(img), _t(kpts), _t(theta))
    # 1e-5: cos/sin of another library and XLA's fused multiply-adds move the
    # sample positions by ulps; the four taps are summed in the JAX order
    np.testing.assert_allclose(_n(out), np.asarray(ref_img), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_n(k), np.asarray(ref_k), rtol=0, atol=1e-5)


def test_color_jitter_matches_jax():
    rng = np.random.default_rng(8)
    crops = rng.random((8, 16, 12, 3), dtype=np.float32)
    cfg = jax_aug.AugmentConfig(brightness=0.4, contrast=0.5)
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jax_aug.color_jitter(key, jnp.asarray(crops), cfg))
    k1, k2 = jax.random.split(key)
    b = _t(cfg.brightness * jax.random.uniform(k1, (8, 1, 1, 1), minval=-1, maxval=1))
    c = _t(1.0 + cfg.contrast * jax.random.uniform(k2, (8, 1, 1, 1), minval=-1, maxval=1))
    out = augment.color_jitter(_t(crops), b, c)
    np.testing.assert_allclose(_n(out), ref, rtol=0, atol=1e-6)  # the mean summed in another order
    assert (ref == 0).any() and (ref == 1).any()  # both clips were reached


def test_draw_augment_ranges_and_rates():
    cfg = AugmentConfig(flip_prob=0.3, rotation_deg=40.0, brightness=0.25, contrast=0.1)
    n = 10_000
    d = augment.draw_augment(0, 5, n, cfg, "cpu")
    # rates within 4 standard deviations of a Bernoulli mean over 10^4 draws
    for mask, p in ((d.flip, 0.3), (d.half_coin, 0.5)):
        assert mask.dtype == torch.bool
        assert abs(float(mask.float().mean()) - p) < 4 * np.sqrt(p * (1 - p) / n)
    assert abs(float((d.half_u < 0.2).float().mean()) - 0.2) < 4 * np.sqrt(0.16 / n)
    for t, lo, hi in ((d.scale, 1 - cfg.scale_jitter, 1 + cfg.scale_jitter),
                      (d.shift, -cfg.shift_jitter, cfg.shift_jitter),
                      (d.theta, -np.radians(40.0), np.radians(40.0)),
                      (d.brightness, -0.25, 0.25), (d.contrast, 0.9, 1.1), (d.half_u, 0.0, 1.0)):
        assert t.dtype == torch.float32
        assert float(t.min()) >= lo - 1e-7 and float(t.max()) <= hi + 1e-7
        # uniform: each tenth of the range holds 1/10 of the draws, within 4 sd
        counts = np.histogram(_n(t).ravel(), bins=10, range=(lo, hi))[0] / t.numel()
        assert np.abs(counts - 0.1).max() < 4 * np.sqrt(0.09 / t.numel())
    assert d.scale.shape == (n, 1) and d.shift.shape == (n, 2)
    assert d.brightness.shape == d.contrast.shape == (n, 1, 1, 1)
    # Streams: seeded by (seed, domain, step) alone; steps and seeds differ.
    again = augment.draw_augment(0, 5, n, cfg, "cpu")
    assert all(torch.equal(getattr(d, f.name), getattr(again, f.name))
               for f in dataclasses.fields(d))
    assert not torch.equal(augment.draw_augment(0, 6, n, cfg, "cpu").theta, d.theta)
    assert not torch.equal(augment.draw_augment(1, 5, n, cfg, "cpu").theta, d.theta)
    # the three streams are independent: flip and box draws do not correlate
    assert abs(np.corrcoef(_n(d.theta), _n(d.scale[:, 0]))[0, 1]) < 4 / np.sqrt(n)


# --------------------------------------------------------------------------
# the augmented preamble and the augmented step


AUG = dict(flip_prob=0.5, scale_jitter=0.15, shift_jitter=0.05, rotation_deg=30.0,
           brightness=0.2, contrast=0.2, flip_pairs=((1, 2), (3, 4)), half_body_prob=0.7,
           half_body_min_total=2, half_body_min_half=1, upper_body_ids=(0, 1, 2))
B = 4


def _frame_batch(seed=11, n=B):
    rng = np.random.default_rng(seed)
    return dict(frame=rng.integers(0, 256, (n, 96, 80, 3), dtype=np.uint8),
                box=rng.uniform([0, 0, 40, 50], [20, 20, 60, 70], (n, 4)).astype(np.float32),
                keypoints=rng.uniform(5, 70, (n, 5, 2)).astype(np.float32),
                keypoints_visible=np.ones((n, 5), np.float32),
                keypoints_visibility=(rng.random((n, 5)) > 0.2).astype(np.float32))


def _crop_batch(seed=12, n=B):
    from test_torch_train import _batch

    return _batch(seed, n)


@pytest.fixture(scope="module")
def aug_sides():
    raw = dict(RAW, augment=AUG)
    return raw, build_jax_side(raw)


@pytest.mark.parametrize("mode", ["crop", "frame"])
def test_augment_encode_matches_jax(aug_sides, mode):
    raw, js = aug_sides
    batch = _crop_batch() if mode == "crop" else _frame_batch()
    cfg = js["cfg"]
    base = jax.random.PRNGKey(cfg.seed)
    hb = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 2**31 - 1)
    step = 3
    rimages, rgt = jax_loop._augment_encode(cfg, js["enc"], base, hb, jnp.int32(step),
                                            {k: jnp.asarray(v) for k, v in batch.items()})
    trainer = _port(js, raw)
    draws = jax_draws(cfg.augment, cfg.seed, step, B)
    if mode == "frame":
        assert bool((draws.half_u < AUG["half_body_prob"]).any())  # half-body applied
    images, gt = loop._augment_encode(trainer.cfg, trainer.encode_codec,
                                      trainer.device_batch(batch), draws)
    # crop mode: 1e-5 (rotation's tap positions); frame mode: the crops'
    # bf16 products (test_torch_ops.py's bar) through rotation and contrast
    tol = 1e-5 if mode == "crop" else 2.0**-7
    np.testing.assert_allclose(_n(images), np.asarray(rimages), rtol=0, atol=tol)
    assert float(np.abs(_n(images) - np.asarray(rimages)).mean()) < 1e-5
    assert sorted(gt) == sorted(rgt)
    for k in rgt:
        # keypoint-derived targets, 1e-5 (heatmaps of keypoints within 1e-5 px)
        np.testing.assert_allclose(_n(gt[k]).astype(np.float32),
                                   np.asarray(rgt[k]).astype(np.float32), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def _jax_grads_on(js, images, gt):
    """(losses, grads) of the JAX step's compute_loss at its initial state on
    the given preamble output."""
    cfg, state = js["cfg"], js["state"]

    def compute_loss(params):
        pred, _ = js["model"].apply({"params": params, "batch_stats": state.batch_stats},
                                    images, train=True, mutable=["batch_stats"])
        losses = js["loss_fn"](gt, pred)
        return sum(losses[k] * w for k, w in cfg.loss_weights.as_dict().items()), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(compute_loss, has_aux=True))(state.params)
    return losses, grads


@pytest.mark.parametrize("mode", ["crop", "frame"])
def test_augmented_train_step_matches_jax(aug_sides, mode, monkeypatch):
    """One whole augmented f32 step of the port against JAX make_train_step,
    held to the bounds of test_torch_train.py's whole-step test.

    The port's draws are patched to the JAX step's, and the JAX step is
    given the port's preamble output (images and encoded targets) in place
    of its own: the two preambles are held to each other above
    (test_augment_encode_matches_jax), and their rounding-level
    differences, which this step's bounds cannot absorb, stay out of it.
    Rotation positions carry ulps through XLA's fused multiply-adds (its
    own jitted and eager rotate_crops differ by 4.4e-6 on random crops),
    frame mode's crop weights cross bf16 rounding boundaries at other
    pixels than JAX's, and the head's max-pool routing turns either into
    another gradient."""
    raw, js = aug_sides
    cfg = js["cfg"]
    trainer = _port(js, raw)
    batch = _crop_batch(13) if mode == "crop" else _frame_batch(14)
    monkeypatch.setattr(loop, "draw_augment", lambda seed, step, n, aug, device: jax_draws(
        aug, seed, step, n).to(device))
    preambles, captured = [], []
    encode = loop._augment_encode

    def recording_encode(*args):
        out = encode(*args)
        preambles.append(jax.tree_util.tree_map(lambda t: jnp.asarray(_n(t)), out))
        return out

    monkeypatch.setattr(loop, "_augment_encode", recording_encode)
    apply = trainer.state.apply_gradients
    trainer.state.apply_gradients = lambda g, tx, ema_decay=None: (
        captured.append([t.clone() for t in g]), apply(g, tx, ema_decay))[1]
    _, metrics = trainer.train_step(trainer.state, trainer.device_batch(batch))
    if mode == "frame":  # half-body re-boxed some samples
        assert bool((jax_draws(cfg.augment, cfg.seed, 0, B).half_u < AUG["half_body_prob"]).any())

    images, gt = preambles[0]
    monkeypatch.setattr(jax_loop, "_augment_encode", lambda *args: (images, gt))
    jstep = jax.jit(jax_loop.make_train_step(js["model"], js["enc"], js["loss_fn"], js["tx"], cfg))
    jstate, jm = jstep(js["state"], {k: jnp.asarray(v) for k, v in batch.items()})
    rlosses, rgrads = _jax_grads_on(js, images, gt)
    for k, v in rlosses.items():
        # each loss term within 1e-5 relative
        np.testing.assert_allclose(float(metrics[f"loss/{k}"]), float(v), rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    grads_ref = _by_name(rgrads, jstate.batch_stats, trainer.state.names)
    _check_grads(trainer.state.names, captured[0], grads_ref)
    # pre-clip global norm and the total, 1e-4 and 1e-5 relative
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-5)
    _close_params(trainer, jstate.params, jstate.batch_stats, grads_ref,
                  [float(jax_state.onecycle_schedule(cfg.optim, STEPS_PER_EPOCH)(0))])
    sd = trainer.model.state_dict()
    for k, v in state_dict_from_jax(jstate.params, jstate.batch_stats).items():
        if k.endswith(("running_mean", "running_var")):
            # batch statistics within 1e-5
            np.testing.assert_allclose(_n(sd[k]), v, rtol=1e-5, atol=1e-5, err_msg=k)
    assert trainer.state.host_step == int(trainer.state.step) == int(jstate.step) == 1
