"""The port's SimCC head family against the JAX package, on the CPU at the
tiny geometry of test_torch_models.py (64 x 48 crops, a 4 x 3 feature
grid, 96 x 128 bins): the codec's labels and decode with their edge cases,
the head with weights carried by compat/from_jax.py, the loss and its
accuracies, the flip-test average, a whole f32 train step, a distillation
step and the eval step, the predictor, predict_frame, and the eval CLI on
a checkpoint of the train CLI. Each tolerance is stated beside its
assertion.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu import codec_simcc as jax_codec
from probpose_pytorch_tpu.inference import TopDownPredictor as JaxPredictor
from probpose_pytorch_tpu.losses_simcc import SimCCLoss as JaxSimCCLoss
from probpose_pytorch_tpu.models import model as jax_model
from probpose_pytorch_tpu.ops import augment as jax_augment
from probpose_pytorch_tpu.ops.preprocess import crop_resize as jax_crop_resize
from probpose_pytorch_tpu.train import loop as jax_loop
from probpose_pytorch_tpu.train import state as jax_state
from probpose_pytorch_tpu.train.config import TrainConfig as JaxTrainConfig
from probpose_pytorch_tpu_torch import codec_simcc
from probpose_pytorch_tpu_torch.compat.from_jax import load_jax_variables, state_dict_from_jax
from probpose_pytorch_tpu_torch.inference import TopDownPredictor
from probpose_pytorch_tpu_torch.losses_simcc import SimCCLoss
from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model
from probpose_pytorch_tpu_torch.models.simcc import SimCCHead
from probpose_pytorch_tpu_torch.ops import augment
from probpose_pytorch_tpu_torch.train.config import TrainConfig
from probpose_pytorch_tpu_torch.train.loop import Trainer, make_train_step
from test_torch_lora import _close_params
from test_torch_models import TINY_CFG, peaked_variables
from test_torch_train import RAW, STEPS_PER_EPOCH, _batch, _by_name, _check_grads

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

SIMCC_CFG = dict(TINY_CFG, head_type="simcc", simcc_split_ratio=2.0, simcc_sigma=6.0)
K = SIMCC_CFG["num_keypoints"]
IMG_WH = (48, 64)  # (in_w, in_h)
SIGMAS = (0.05,) * K
RAW_SIMCC = dict(RAW, model=SIMCC_CFG)
# Coordinates and scores from the same logits: 1e-6 px (float32 softmax
# summed in another order moves the parabola by a few ulps).
COORD_TOL = 1e-6


def _n(t):
    return t.detach().cpu().numpy()


def _labels(split=2.0, sigma=6.0):
    return (jax_codec.SimCCLabel(IMG_WH, split_ratio=split, sigma=sigma, sigmas=SIGMAS),
            codec_simcc.SimCCLabel(IMG_WH, split_ratio=split, sigma=sigma, sigmas=SIGMAS))


def _logits(kind, rng, shape=(3, K, 96)):
    """Decoder inputs: random logits and the edge cases of the parabola."""
    x = rng.normal(size=shape).astype(np.float32)
    N = shape[-1]
    if kind == "ties":  # two equal maxima: the first wins in both packages
        x[..., 10] = x[..., 50] = 9.0
    elif kind == "edges":  # maxima at bin 0 and bin N - 1: no parabola
        x[:, ::2, 0] = 9.0
        x[:, 1::2, N - 1] = 9.0
    elif kind == "flat":  # a constant row: a zero denominator
        x[:] = 0.25
    elif kind == "plateau":  # three equal maxima: the first, pulled half a bin right
        x[..., 20:23] = 9.0
    elif kind == "zero_labels":  # log(0 + 1e-12) of an off-grid label row
        x[:] = np.log(np.float32(1e-12))
    return x


@pytest.mark.parametrize("coords", ["inside", "edges", "off_grid"])
@pytest.mark.parametrize("n_bins,sigma", [(96, 6.0), (40, 2.5)])
def test_axis_labels_match_jax(coords, n_bins, sigma):
    rng = np.random.default_rng(n_bins)
    c = {"inside": rng.uniform(2, n_bins - 3, (3, K)),
         "edges": np.tile([0.0, n_bins - 1.0, -0.4, n_bins - 0.6, 0.5], (3, 1)),
         "off_grid": rng.uniform(-400, -300, (3, K))}[coords].astype(np.float32)
    ref = np.asarray(jax_codec._axis_labels(jnp.asarray(c), n_bins, sigma))
    ours = _n(codec_simcc._axis_labels(torch.from_numpy(c), n_bins, sigma))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)  # values <= 1
    if coords == "off_grid":
        assert not ours.any()  # every bin underflows: an all-zero row in both


@pytest.mark.parametrize("kind", ["random", "ties", "edges", "flat", "plateau", "zero_labels"])
def test_axis_decode_matches_jax(kind):
    x = _logits(kind, np.random.default_rng(1))
    rc, rs = jax_codec._axis_decode(jnp.asarray(x))
    oc, os_ = codec_simcc._axis_decode(torch.from_numpy(x))
    np.testing.assert_allclose(_n(oc), np.asarray(rc), rtol=0, atol=COORD_TOL)
    np.testing.assert_allclose(_n(os_), np.asarray(rs), rtol=0, atol=1e-6)
    if kind == "ties":
        assert (np.abs(_n(oc) - 10) <= 0.5).all()
    elif kind == "plateau":  # delta = 0.5 (left - right) / (left - center) = 0.5
        assert (_n(oc) == 20.5).all()
    elif kind in ("edges", "flat", "zero_labels"):  # no parabola at the end bins
        assert set(np.unique(_n(oc))) <= {0.0, 95.0}


@pytest.mark.parametrize("split", [1.0, 2.0, 3.0])
def test_encode_matches_jax(split):
    jl, pl = _labels(split)
    rng = np.random.default_rng(2)
    kpts = rng.uniform((-5, -5), (52, 68), (4, K, 2)).astype(np.float32)
    vis = (rng.random((4, K)) > 0.2).astype(np.float32)
    visibility = (rng.random((4, K)) > 0.5).astype(np.float32)
    ref = jl.encode(jnp.asarray(kpts), jnp.asarray(vis), keypoints_visibility=jnp.asarray(visibility))
    ours = pl.encode(torch.from_numpy(kpts), torch.from_numpy(vis),
                     keypoints_visibility=torch.from_numpy(visibility))
    assert sorted(ours) == sorted(ref) and pl.bins == jl.bins
    for k in ref:
        if k == "identification_similarity":
            assert ours[k] == ref[k]
            continue
        np.testing.assert_allclose(_n(ours[k]).astype(np.float32),
                                   np.asarray(ref[k]).astype(np.float32),
                                   rtol=0, atol=1e-6, err_msg=k)  # labels <= 1, exact flags


def test_codec_decode_matches_jax():
    jl, pl = _labels()
    rng = np.random.default_rng(3)
    x, y = _logits("random", rng), _logits("random", rng, (3, K, 128))
    scalars = [rng.random((3, K, 1, 1)).astype(np.float32) for _ in range(4)]
    ref = jax_codec.SimCCCodec(jl).decode(((jnp.asarray(x), jnp.asarray(y)),
                                           *map(jnp.asarray, scalars)))
    ours = codec_simcc.SimCCCodec(pl).decode(((torch.from_numpy(x), torch.from_numpy(y)),
                                              *map(torch.from_numpy, scalars)))
    (rk, rs), *rest = ref
    (ok, os_), *ours_rest = ours
    np.testing.assert_allclose(_n(ok), np.asarray(rk), rtol=0, atol=COORD_TOL)  # input px
    np.testing.assert_allclose(_n(os_), np.asarray(rs), rtol=0, atol=1e-6)
    for o, r in zip(ours_rest, rest):
        assert tuple(o.shape) == r.shape == (3, 1, K)
        np.testing.assert_allclose(_n(o), np.asarray(r), rtol=1e-6, atol=0)


# --------------------------------------------------------------------------
# the head


def simcc_pair(cfg_kw=SIMCC_CFG, seed=0):
    """(JAX model, numpy variables, port model) sharing weights: the JAX
    init with the head's conv kernels redrawn at fan-in scale (the 1x1
    `final` too) and BN statistics randomised; the Dense kernels as drawn,
    all distinct."""
    jm = jax_model.build_model(jax_model.ModelConfig(**cfg_kw))
    x = jnp.zeros((1, *cfg_kw["img_size"], 3), jnp.float32)
    variables = peaked_variables(jm.init(jax.random.PRNGKey(seed), x, train=False), seed)
    pm = build_model(ModelConfig(**cfg_kw), device="cpu")
    load_jax_variables(pm, variables["params"], variables["batch_stats"])
    return jm, variables, pm


@pytest.fixture(scope="module")
def pair():
    return simcc_pair()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_matches_jax(pair, dtype):
    """The head alone on random features of the non-square 4 x 3 grid with
    distinct weights, so a column-major flatten would fail: f32 logits and
    scalars within 1e-5 (sums in another order); bf16 within 2 bf16 ulps
    of the largest logit (2 * 2^-8 relative): both round input, kernel and
    product to bf16 at the same points."""
    jm, variables, _ = pair
    kw = dict(SIMCC_CFG, compute_dtype=dtype)
    jm = jax_model.build_model(jax_model.ModelConfig(**kw))
    pm = build_model(ModelConfig(**kw), device="cpu")
    load_jax_variables(pm, variables["params"], variables["batch_stats"])
    assert isinstance(pm.head, SimCCHead) and pm.head.bins == (96, 128)
    feats = np.random.default_rng(4).normal(size=(2, 4, 3, 32)).astype(np.float32)
    ref = jm.head.apply({"params": variables["params"]["head"],
                         "batch_stats": variables["batch_stats"]["head"]},
                        jnp.asarray(feats), train=False)
    with torch.no_grad():
        out = pm.head(torch.from_numpy(feats))
    for o, r in zip((*out[0], *out[1:]), (*ref[0], *ref[1:])):
        assert o.dtype == torch.float32 and tuple(o.shape) == r.shape
        r = np.asarray(r, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(_n(o), r, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(_n(o), r, rtol=0, atol=2 * 2**-8 * np.abs(r).max())


def test_model_matches_jax(pair):
    """The whole model in f32: logits and scalars within 1e-4 relative and
    1e-5 absolute (test_torch_models.py's bar), and the decoded keypoints
    within 1e-3 px."""
    jm, variables, pm = pair
    x = np.random.default_rng(5).random((3, 64, 48, 3), dtype=np.float32)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    for o, r in zip((*out[0], *out[1:]), (*ref[0], *ref[1:])):
        np.testing.assert_allclose(_n(o), np.asarray(r), rtol=1e-4, atol=1e-5)
    jl, pl = _labels()
    (rk, _), *_ = jax_codec.SimCCCodec(jl).decode(ref)
    (ok, _), *_ = codec_simcc.SimCCCodec(pl).decode(out)
    np.testing.assert_allclose(_n(ok), np.asarray(rk), rtol=0, atol=1e-3)


def test_head_weight_layouts_match_jax(pair):
    """The carried Dense kernels are the JAX kernels transposed, and the
    conv's 1x1 kernel (kh, kw, I, O) is the Conv2d's (O, I, 1, 1)."""
    _, variables, pm = pair
    head = variables["params"]["head"]
    sd = pm.state_dict()
    for name in ("mlp_x", "mlp_y"):
        np.testing.assert_array_equal(_n(sd[f"head.{name}.weight"]), head[name]["kernel"].T)
        np.testing.assert_array_equal(_n(sd[f"head.{name}.bias"]), head[name]["bias"])
    np.testing.assert_array_equal(_n(sd["head.final.weight"])[:, :, 0, 0],
                                  head["final"]["kernel"][0, 0].T)


# --------------------------------------------------------------------------
# the loss


def _loss_inputs(seed=6):
    rng = np.random.default_rng(seed)
    jl, pl = _labels()
    kpts = rng.uniform((-6, -6), (54, 70), (4, K, 2)).astype(np.float32)
    vis = (rng.random((4, K)) > 0.2).astype(np.float32)
    visibility = (rng.random((4, K)) > 0.5).astype(np.float32)
    enc = pl.encode(torch.from_numpy(kpts), torch.from_numpy(vis),
                    keypoints_visibility=torch.from_numpy(visibility))
    gt = dict(in_image=enc["in_image"], keypoints_visible=torch.from_numpy(vis),
              keypoints_visibility=torch.from_numpy(visibility),
              keypoint_weights=enc["keypoint_weights"], x_labels=enc["x_labels"],
              y_labels=enc["y_labels"])
    # logits near the labels, so the decoded errors and OKS are not flat
    x = (np.log(_n(enc["x_labels"]) + 1e-3) + 0.3 * rng.normal(size=(4, K, 96))).astype(np.float32)
    y = (np.log(_n(enc["y_labels"]) + 1e-3) + 0.3 * rng.normal(size=(4, K, 128))).astype(np.float32)
    scalars = [rng.uniform(0.05, 0.95, (4, K, 1, 1)).astype(np.float32) for _ in range(3)]
    scalars.append(rng.uniform(0.0, 3.0, (4, K, 1, 1)).astype(np.float32))
    return jl, pl, gt, (x, y), scalars


@pytest.mark.parametrize("from_zeros", [False, True])
@pytest.mark.parametrize("freeze", [(True, False), (False, True)], ids=["oks", "error"])
def test_loss_matches_jax(from_zeros, freeze):
    """Every term and accuracy within 1e-5 relative (f32 sums in another
    order), learn_heatmaps_from_zeros on and off, with the OKS target (or
    the error target) derived from decoded labels and logits."""
    jl, pl, gt, (x, y), scalars = _loss_inputs()
    freeze_error, freeze_oks = freeze
    jloss = JaxSimCCLoss(jax_codec.SimCCCodec(jl), freeze_error=freeze_error,
                         freeze_oks=freeze_oks)
    ploss = SimCCLoss(codec_simcc.SimCCCodec(pl), freeze_error=freeze_error,
                      freeze_oks=freeze_oks)
    jgt = {k: jnp.asarray(_n(v)) for k, v in gt.items()}
    rl, ra = jloss(jgt, ((jnp.asarray(x), jnp.asarray(y)), *map(jnp.asarray, scalars)),
                   learn_heatmaps_from_zeros=from_zeros, compute_acc=True)
    ol, oa = ploss(gt, ((torch.from_numpy(x), torch.from_numpy(y)),
                        *map(torch.from_numpy, scalars)),
                   learn_heatmaps_from_zeros=from_zeros, compute_acc=True)
    assert sorted(ol) == sorted(rl) and sorted(oa) == sorted(ra)
    for k in rl:
        np.testing.assert_allclose(float(ol[k]), float(rl[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    for k in ra:
        np.testing.assert_allclose(float(oa[k]), float(ra[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(rl["oks" if not freeze_oks else "error"]) > 0
    assert ploss(gt, ((torch.from_numpy(x), torch.from_numpy(y)),
                      *map(torch.from_numpy, scalars))).keys() == rl.keys()


def test_loss_gradients_match_jax():
    """d(total)/d(logits, scalars) within 1e-5 of the largest entry: the
    decoded targets are constants on both sides."""
    jl, pl, gt, (x, y), scalars = _loss_inputs(7)
    jloss = JaxSimCCLoss(jax_codec.SimCCCodec(jl), freeze_error=False)
    ploss = SimCCLoss(codec_simcc.SimCCCodec(pl), freeze_error=False)
    jgt = {k: jnp.asarray(_n(v)) for k, v in gt.items()}

    def total(x, y, *s):
        return sum(jloss(jgt, ((x, y), *s)).values())

    ref = jax.grad(total, argnums=tuple(range(6)))(jnp.asarray(x), jnp.asarray(y),
                                                   *map(jnp.asarray, scalars))
    ins = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (x, y, *scalars)]
    ours = torch.autograd.grad(sum(ploss(gt, ((ins[0], ins[1]), *ins[2:])).values()), ins)
    for o, r in zip(ours, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(_n(o), r, rtol=0, atol=1e-5 * np.abs(r).max())


# --------------------------------------------------------------------------
# flip test


@pytest.mark.parametrize("split", [1.0, 2.0, 3.0, 1.6])
def test_mirror_x_bins_matches_jax(split):
    p = np.random.default_rng(8).random((2, K, int(48 * split))).astype(np.float32)
    ref = np.asarray(jax_augment._mirror_x_bins(jnp.asarray(p), split))
    np.testing.assert_array_equal(_n(augment._mirror_x_bins(torch.from_numpy(p), split)), ref)


@pytest.mark.parametrize("split", [1.0, 2.0, 3.0])
def test_average_flip_pred_simcc_matches_jax(split):
    """log of the averaged distributions within 1e-5 (log of values near
    1e-12 included), scalars exact after the same pair swap."""
    rng = np.random.default_rng(9)
    Wb, Hb = int(48 * split), int(64 * split)

    def pred():
        return ((rng.normal(size=(2, K, Wb)).astype(np.float32),
                 rng.normal(size=(2, K, Hb)).astype(np.float32)),
                *[rng.random((2, K, 1, 1)).astype(np.float32) for _ in range(4)])

    a, b = pred(), pred()
    pairs = ((1, 2), (3, 4))
    jt = lambda p: ((jnp.asarray(p[0][0]), jnp.asarray(p[0][1])), *map(jnp.asarray, p[1:]))
    tt = lambda p: ((torch.from_numpy(p[0][0]), torch.from_numpy(p[0][1])),
                    *map(torch.from_numpy, p[1:]))
    ref = jax_augment.average_flip_pred_simcc(jt(a), jt(b), pairs, split)
    ours = augment.average_flip_pred_simcc(tt(a), tt(b), pairs, split)
    for o, r in zip(ours[0], ref[0]):
        np.testing.assert_allclose(_n(o), np.asarray(r), rtol=1e-5, atol=1e-5)
    for o, r in zip(ours[1:], ref[1:]):
        np.testing.assert_array_equal(_n(o), np.asarray(r))


# --------------------------------------------------------------------------
# training


def build_simcc_side(raw=RAW_SIMCC, seed=0):
    """The JAX SimCC model, optimizer, codec, loss, jitted steps and initial
    state of the config `raw`, from `simcc_pair`'s weights."""
    cfg = JaxTrainConfig.from_dict(raw)
    jm, variables, _ = simcc_pair(dict(raw["model"]), seed)
    tx = jax_state.make_optimizer(cfg.optim, STEPS_PER_EPOCH * cfg.epochs)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), ema_params=jax.tree_util.tree_map(jnp.copy, params))
    enc, fast = jax_loop.build_codecs(cfg)
    loss_fn = JaxSimCCLoss(fast, freeze_error=cfg.freeze_error, freeze_oks=cfg.freeze_oks)
    return dict(cfg=cfg, model=jm, variables=variables, tx=tx, state=state, enc=enc,
                fast=fast, loss_fn=loss_fn,
                step=jax.jit(jax_loop.make_train_step(jm, enc, loss_fn, tx, cfg)),
                eval_step=jax.jit(jax_loop.make_eval_step(jm, enc, loss_fn, cfg)))


@pytest.fixture(scope="module")
def simcc_side():
    return build_simcc_side()


def _port(js, raw=RAW_SIMCC) -> Trainer:
    from probpose_pytorch_tpu_torch.compat.from_jax import load_jax_train_state

    trainer = Trainer.create(TrainConfig.from_dict(raw), STEPS_PER_EPOCH, device="cpu")
    load_jax_train_state(trainer.state, jax.device_get(js["state"]))
    return trainer


def _jax_grads(js, batch, teacher=None):
    """The JAX step's loss gradients at its initial state (with the
    distillation terms when a teacher (model, variables) is given)."""
    cfg, state = js["cfg"], js["state"]
    key = jax.random.PRNGKey(cfg.seed)
    images, gt = jax_loop._augment_encode(cfg, js["enc"], key, key, state.step, batch)
    mse = lambda a, b: jnp.mean((a.astype(jnp.float32) - b.astype(jnp.float32)) ** 2)
    tpred = None if teacher is None else teacher[0].apply(teacher[1], images, train=False)

    def compute_loss(params):
        pred, _ = js["model"].apply({"params": params, "batch_stats": state.batch_stats},
                                    images, train=True, mutable=["batch_stats"])
        losses = js["loss_fn"](gt, pred)
        total = sum(losses[k] * w for k, w in cfg.loss_weights.as_dict().items())
        if tpred is not None:
            d = cfg.distill
            d_hm = (mse(pred[0][0], tpred[0][0]) + mse(pred[0][1], tpred[0][1])) / 2
            d_sc = (mse(pred[1], tpred[1]) + mse(pred[2], tpred[2]) + mse(pred[3], tpred[3])) / 3
            total = total + d.weight * (d.heatmap_weight * d_hm + d.scalar_weight * d_sc)
        return total

    return jax.jit(jax.grad(compute_loss))(state.params)


def test_train_step_matches_jax(simcc_side):
    """Two f32 steps against JAX's make_train_step: each loss term within
    1e-5 relative, gradients per leaf within 1e-4 of the leaf's largest
    (test_torch_train.py's bar), grad_norm 1e-4 and the total 1e-5
    relative, params after two steps within 1e-5 (Adam's 2 lr where the
    gradient is under the grad tolerance), batch statistics and EMA."""
    js = simcc_side
    trainer = _port(js)
    batch = _batch()
    captured = []
    apply = trainer.state.apply_gradients
    trainer.state.apply_gradients = lambda g, tx, ema_decay=None: (
        captured.append([t.clone() for t in g]), apply(g, tx, ema_decay))[1]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rgrads = _jax_grads(js, jbatch)
    jstate, lrs = js["state"], []
    for i in range(2):
        lrs.append(float(jax_state.onecycle_schedule(js["cfg"].optim, STEPS_PER_EPOCH)(i)))
        jstate, jm = js["step"](jstate, jbatch)
        _, metrics = trainer.train_step(trainer.state, trainer.device_batch(batch))
        for k in [k for k in jm if k.startswith("loss")]:
            np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-5, atol=1e-8,
                                       err_msg=f"step {i}: {k}")
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
        if i == 0:
            _check_grads(trainer.state.names, captured[0],
                         _by_name(rgrads, js["state"].batch_stats, trainer.state.names))
    grads_ref = _by_name(rgrads, jstate.batch_stats, trainer.state.names)
    _close_params(trainer, jstate.params, jstate.batch_stats, grads_ref, lrs)
    ref_bs = state_dict_from_jax(jstate.params, jstate.batch_stats)
    sd = trainer.model.state_dict()
    for k, v in ref_bs.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(_n(sd[k]), v, rtol=1e-5, atol=1e-5, err_msg=k)
    ema = _by_name(jstate.ema_params, jstate.batch_stats, trainer.state.names)
    for n, e in zip(trainer.state.names, trainer.state.ema_params):
        np.testing.assert_allclose(_n(e), ema[n], rtol=0, atol=1e-5, err_msg=n)


def test_eval_step_matches_jax(simcc_side):
    """Losses, accuracies, max_heatmap (the x logits' max) and mean_prob
    within 1e-4 relative (accuracies read decoded coordinates)."""
    js = simcc_side
    trainer = _port(js)
    batch = _batch(2)
    ref = js["eval_step"](js["state"], {k: jnp.asarray(v) for k, v in batch.items()})
    ours = trainer.eval_step(trainer.state, trainer.device_batch(batch))
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(float(ours[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)


def test_distill_step_matches_jax():
    """Two f32 steps with a SimCC teacher of another seed: the two
    distillation terms (the heatmap term the mean of the two axes' MSEs),
    the total and grad_norm within 1e-5 relative, and the params as in
    test_train_step_matches_jax."""
    raw = dict(RAW_SIMCC, distill=dict(teacher_checkpoint="", ema_teacher=True, weight=0.5,
                                       heatmap_weight=1.0, scalar_weight=0.1))
    js = build_simcc_side(raw)
    tjm, tvars, teacher = simcc_pair(SIMCC_CFG, seed=3)
    teacher = teacher.eval().requires_grad_(False)
    jstep = jax.jit(jax_loop.make_train_step(
        js["model"], js["enc"], js["loss_fn"], js["tx"], js["cfg"],
        teacher=(tjm, jax.tree_util.tree_map(jnp.asarray, tvars))))
    trainer = _port(js, raw)
    step = make_train_step(trainer.model, trainer.encode_codec, trainer.loss_fn, trainer.tx,
                           trainer.cfg, teacher)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rgrads = _jax_grads(js, jbatch, (tjm, tvars))
    jstate, lrs = js["state"], []
    for i in range(2):
        lrs.append(float(jax_state.onecycle_schedule(js["cfg"].optim, STEPS_PER_EPOCH)(i)))
        jstate, jmetrics = jstep(jstate, jbatch)
        _, metrics = step(trainer.state, trainer.device_batch(batch))
        for k in ("loss/distill_heatmap", "loss/distill_scalar", "loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5,
                                       err_msg=f"step {i}: {k}")
    grads_ref = _by_name(rgrads, jstate.batch_stats, trainer.state.names)
    _close_params(trainer, jstate.params, jstate.batch_stats, grads_ref, lrs)


# --------------------------------------------------------------------------
# serving


def _request(seed, B):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(B, 80, 64, 3), dtype=np.uint8)
    boxes = rng.uniform([0, 0, 30, 45], [15, 15, 50, 70], (B, 4)).astype(np.float32)
    return frames, boxes


def _margin(logits):
    """Gap between the two largest probabilities of each row: where it is
    tiny the argmax, and so the keypoint, is not well defined."""
    p = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    top2 = np.sort(p, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("mode", ["plain", "flip", "heatmaps"])
def test_predictor_matches_jax(pair, mode):
    """The predictor with the SimCC codec: plain, with flip test
    (average_flip_pred_simcc at split 2) and with return_heatmaps (the
    outer product of the two softmaxes, (B, K, Hb, Wb)). Scalars within
    test_torch_serving.py's 2e-4 (crops one bf16 ulp from XLA's at a few
    values), heatmaps within 2e-4 relative and 1e-6 absolute, keypoints
    within 1e-3 px where both axes' top-2 probability gap exceeds 1e-4."""
    jm, variables, pm = pair
    jl, pl = _labels()
    kw = dict(flip_test=mode == "flip", return_heatmaps=mode == "heatmaps",
              flip_pairs=((1, 2), (3, 4)))
    jp = JaxPredictor(model=jm, variables=variables, codec=jax_codec.SimCCCodec(jl),
                      input_size=SIMCC_CFG["img_size"], **kw)
    tp = TopDownPredictor(model=pm, codec=codec_simcc.SimCCCodec(pl),
                          input_size=SIMCC_CFG["img_size"], **kw)
    frames, boxes = _request(10, 4)
    ref, out = jp(frames, boxes), tp(frames, boxes)
    assert sorted(out) == sorted(ref)
    for k in ("probabilities", "visibilities", "oks", "errors", "scores"):
        np.testing.assert_allclose(out[k], ref[k], rtol=2e-4, atol=2e-4, err_msg=k)
    if mode == "heatmaps":
        assert out["heatmaps"].shape == ref["heatmaps"].shape == (4, K, 128, 96)
        np.testing.assert_allclose(out["heatmaps"], ref["heatmaps"], rtol=2e-4, atol=1e-6)
    crops = np.asarray(jax_crop_resize(jnp.asarray(frames), jnp.asarray(boxes),
                                       SIMCC_CFG["img_size"], "bilinear_matmul"))
    (lx, ly), *_ = jm.apply(variables, jnp.asarray(crops), train=False)
    ok = (_margin(lx) > 1e-4) & (_margin(ly) > 1e-4)
    assert ok.mean() > 0.8
    np.testing.assert_allclose(out["keypoints"][ok], ref["keypoints"][ok], rtol=0, atol=1e-3)


def test_predict_frame_matches_jax(pair):
    """predict_frame with buckets (2, 4) and 3 boxes on one frame, then 5
    (two dispatches), with OKS-NMS: JAX's keys and shapes, fields within
    the predictor's bars."""
    jm, variables, pm = pair
    jl, pl = _labels()
    jp = JaxPredictor(model=jm, variables=variables, codec=jax_codec.SimCCCodec(jl),
                      input_size=SIMCC_CFG["img_size"])
    tp = TopDownPredictor(model=pm, codec=codec_simcc.SimCCCodec(pl),
                          input_size=SIMCC_CFG["img_size"])
    rng = np.random.default_rng(11)
    frame = rng.integers(0, 256, (100, 90, 3), dtype=np.uint8)
    for n, nms in ((3, None), (5, "oks")):
        boxes = rng.uniform([0, 0, 30, 45], [30, 30, 55, 70], (n, 4)).astype(np.float32)
        ref = jp.predict_frame(frame, boxes, buckets=(2, 4), nms=nms)
        out = tp.predict_frame(frame, boxes, buckets=(2, 4), nms=nms)
        assert sorted(out) == sorted(ref)
        for k in ref:
            assert out[k].shape == ref[k].shape, k
        for k in ("probabilities", "scores", "oks"):
            np.testing.assert_allclose(out[k], ref[k], rtol=2e-4, atol=2e-4, err_msg=k)


def test_eval_cli_on_a_train_cli_checkpoint(tmp_path):
    """The train CLI writes a SimCC checkpoint of the tiny config (17
    keypoints) on a synthetic COCO-format set (--device cpu, 2 steps) and
    the eval CLI scores it with flip test: JAX's keys, AP in [0, 1]. Then
    the same run's latest checkpoint holds the JAX weights, and the eval
    CLI's dumped keypoints are held to JAX's evaluate_topdown with flip
    test: AP and AR keys within 1/n for each of the n instances with a
    keypoint more than 1e-3 px from JAX's (test_torch_eval.py's bound)."""
    from probpose_pytorch_tpu.data.coco import COCOPoseDataset as JaxCOCOPoseDataset
    from probpose_pytorch_tpu.eval.pipeline import evaluate_topdown as jax_evaluate_topdown
    from probpose_pytorch_tpu_torch.data import generate_coco_synth
    from probpose_pytorch_tpu_torch.eval import run as eval_run
    from probpose_pytorch_tpu_torch.train import cli
    from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
    from test_torch_eval import AP_KEYS, LINE_KEYS, SYNTH

    root = generate_coco_synth(tmp_path / "coco", **SYNTH)
    cfg17 = dict(SIMCC_CFG, num_keypoints=17)
    raw = dict(RAW_SIMCC, model=cfg17, train_batch_size=2, val_batch_size=2, val_every=100,
               num_workers=1)
    cfg_path = tmp_path / "cfg.json"
    TrainConfig.from_dict(raw).save(cfg_path)
    run = tmp_path / "run"
    cli.main([str(run), "--config", str(cfg_path), "--data-root", str(root),
              "--dataset-format", "coco", "--max-steps", "2", "--device", "cpu"])
    assert (run / "checkpoints" / "2").is_file()
    ann, images = root / "annotations/person_keypoints_val2017.json", root / "val2017"
    base = ["--checkpoint", str(run / "checkpoints"), "--annotations", str(ann),
            "--images", str(images), "--batch-size", "4", "--flip-test", "--device", "cpu"]
    line = eval_run.main(base)
    assert set(line) == set(LINE_KEYS)
    assert all(0.0 <= line[k] <= 1.0 for k in AP_KEYS)

    jm, variables, _ = simcc_pair(cfg17)
    trainer = Trainer.create(TrainConfig.load(run / "config.json"), 1, device="cpu")
    load_jax_variables(trainer.model, variables["params"], variables["batch_stats"])
    CheckpointManager(run / "checkpoints").save(3, trainer.state)
    dumped = tmp_path / "preds.json"
    ours = eval_run.main(base + ["--dump-predictions", str(dumped)])
    label = jax_codec.SimCCLabel(IMG_WH, split_ratio=2.0, sigma=6.0, sigmas=(0.05,) * 17)
    jp = JaxPredictor(model=jm, variables=variables, codec=jax_codec.SimCCCodec(label),
                      input_size=cfg17["img_size"], flip_test=True)
    ref = jax_evaluate_topdown(jp, JaxCOCOPoseDataset(ann, images, cfg17["img_size"]),
                               batch_size=4, collect_predictions=True, num_workers=1)
    got = json.loads(dumped.read_text())
    n = len(got)
    assert n == len(ref["predictions"]) >= 6
    assert [r["image_id"] for r in got] == [r["image_id"] for r in ref["predictions"]]
    kp = lambda r: np.asarray(r["keypoints"], np.float64).reshape(17, 3)[:, :2]
    apart = sum(int((np.abs(kp(a) - kp(b)) > 1e-3).any())
                for a, b in zip(got, ref["predictions"]))
    assert apart < n  # most instances agree to 1e-3 px
    for key in AP_KEYS:
        # the line is rounded to 4 places
        assert abs(ours[key] - ref[key]) <= apart / n + 1e-4, key
