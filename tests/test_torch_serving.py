"""The port's TopDownPredictor against the JAX predictor, on the CPU.

Same tiny float32 model (weights carried across by compat/from_jax.py, head
kernels redrawn so the heatmaps are peaked), same uint8 frames and boxes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.codec import Codec as JaxCodec
from probpose_pytorch_tpu.codec import ProbMap as JaxProbMap
from probpose_pytorch_tpu.inference import TopDownPredictor as JaxPredictor
from probpose_pytorch_tpu.ops.heatmap import build_oks_conv_operators, oks_conv
from probpose_pytorch_tpu_torch.codec import Codec, ProbMap
from probpose_pytorch_tpu_torch.inference import TopDownPredictor

from test_torch_models import TINY_CFG, init_pair

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

K = TINY_CFG["num_keypoints"]
CODEC_KW = dict(input_size=(48, 64), heatmap_size=(12, 16),
                sigmas=np.full(K, 0.05, np.float32), sigma=2.0)


def _request(seed, B):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(B, 80, 64, 3), dtype=np.uint8)
    boxes = rng.uniform([0, 0, 30, 45], [15, 15, 50, 70], (B, 4)).astype(np.float32)
    return frames, boxes


def _top2_margin(heatmaps):
    """Gap between the two largest values of each convolved map: where it
    is tiny the argmax, and so the keypoint, is not well defined."""
    B, Kk, H, W = heatmaps.shape
    ops = build_oks_conv_operators(CODEC_KW["sigmas"], H, W)
    conv = np.asarray(oks_conv(jnp.asarray(heatmaps), ops)).reshape(B, Kk, -1)
    top2 = np.sort(conv, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.fixture(scope="module")
def predictors():
    jm, variables, pm = init_pair()
    jax_pred = JaxPredictor(model=jm, variables=variables,
                            codec=JaxCodec(JaxProbMap(**CODEC_KW)),
                            input_size=TINY_CFG["img_size"], return_heatmaps=True)
    port_pred = TopDownPredictor(model=pm, codec=Codec(ProbMap(**CODEC_KW)),
                                 input_size=TINY_CFG["img_size"], return_heatmaps=True)
    return jax_pred, port_pred


@pytest.mark.parametrize("B,indexed", [(3, False), (4, True)])
def test_predictor_matches_jax(predictors, B, indexed):
    jax_pred, port_pred = predictors
    frames, boxes = _request(B, B)
    ids = None
    if indexed:
        ids = np.array([1, 0, 1, 1], np.int32)
        frames = frames[:2]
    ref = jax_pred(frames, boxes, ids)
    out = port_pred(frames, boxes, ids)
    assert sorted(out) == sorted(ref)
    for k in out:
        assert out[k].shape == ref[k].shape, k
        assert np.isfinite(out[k]).all(), k
    # Heatmaps and scalar heads: the model bar (rtol 1e-4, atol 1e-5) of
    # test_torch_models.py, after crops that agree to bf16 rounding.
    for k in ("heatmaps", "probabilities", "visibilities", "oks", "errors"):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-5, err_msg=k)
    # Keypoints: the repo's 1e-3 px decode bar, on every keypoint whose
    # convolved map has a top-2 margin above 1e-4 (near-ties excepted).
    ok = _top2_margin(ref["heatmaps"]) > 1e-4
    assert ok.mean() > 0.8
    np.testing.assert_allclose(out["keypoints"][ok], ref["keypoints"][ok], atol=1e-3)
    np.testing.assert_allclose(out["scores"], ref["scores"], rtol=1e-4, atol=1e-5)


def test_predictor_refuses_unported_options(predictors):
    _, port_pred = predictors
    for kw in (dict(flip_test=True), dict(scale_test=(0.9, 1.1)),
               dict(calibration={"presence": 1.2}), dict(quantize="int8")):
        with pytest.raises(NotImplementedError, match="item 8"):
            TopDownPredictor(model=port_pred.model, codec=port_pred.codec,
                             input_size=(64, 48), **kw)
    with pytest.raises(NotImplementedError, match="item 8"):
        port_pred.predict_stream([])
