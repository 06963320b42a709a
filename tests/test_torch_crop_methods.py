"""The port's scale-and-translate crop methods ("linear", "cubic",
"lanczos3") against the JAX package's crop_resize, which runs
jax.image.scale_and_translate per box, on the CPU; the default method
(JAX's "linear"); the predictor and the training step's frame-mode crop
with each method.

The weights are computed in the float32 operations XLA compiles JAX's
jitted crop_resize into, so the crops agree to float32 rounding and the
order of the two products' sums: within 1e-5 absolute on the [0, 1]
scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.codec import Codec as JaxCodec
from probpose_pytorch_tpu.codec import ProbMap as JaxProbMap
from probpose_pytorch_tpu.inference import TopDownPredictor as JaxPredictor
from probpose_pytorch_tpu.ops.preprocess import crop_resize as jax_crop_resize
from probpose_pytorch_tpu_torch.codec import Codec, ProbMap
from probpose_pytorch_tpu_torch.inference import TopDownPredictor
from probpose_pytorch_tpu_torch.ops.preprocess import METHODS, crop_resize
from probpose_pytorch_tpu_torch.train.config import TrainConfig
from probpose_pytorch_tpu_torch.train.loop import augment_batch

from test_torch_models import TINY_CFG, init_pair

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

TOL = 1e-5  # absolute, on crops in [0, 1]
SCALED = ("linear", "cubic", "lanczos3")
# (frame (H, W), boxes xywh, crop (H, W)): the box shrunk onto the crop
# (antialiased: the kernel widens by 1/scale), the box blown up, boxes
# partly and wholly off the frame, and a non-square crop of a thin box
CASES = {
    "downsample": ((128, 112), [[3.5, 7.25, 100.0, 110.0], [20.0, 10.0, 64.0, 96.0]], (32, 24)),
    "upsample": ((64, 48), [[10.0, 5.0, 20.0, 30.0], [30.5, 40.25, 12.0, 16.0]], (64, 48)),
    "off_frame": ((96, 128), [[-40.0, -20.0, 90.0, 120.0], [100.0, 70.0, 60.0, 50.0],
                              [200.0, 150.0, 30.0, 40.0]], (48, 36)),
    "thin": ((80, 96), [[5.0, 2.0, 8.0, 70.0], [0.0, 30.0, 96.0, 6.0]], (40, 24)),
}


def _inputs(case, dtype, seed=0):
    (H, W), boxes, out_hw = CASES[case]
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (len(boxes), H, W, 3), dtype=np.uint8)
    if dtype == "float32":
        frames = rng.random((len(boxes), H, W, 3), dtype=np.float32)
    return frames, np.asarray(boxes, np.float32), out_hw


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method", SCALED)
def test_scale_translate_crops_match_jax(method, case, dtype):
    frames, boxes, out_hw = _inputs(case, dtype)
    ref = np.asarray(jax_crop_resize(jnp.asarray(frames), jnp.asarray(boxes), out_hw, method))
    out = crop_resize(torch.from_numpy(frames), torch.from_numpy(boxes), out_hw, method)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL)
    if case == "off_frame":  # black where the box leaves the frame
        assert float(np.abs(out.numpy()[2]).max()) == float(np.abs(ref[2]).max()) == 0.0


def test_default_method_is_jax_default():
    """A call without a method: JAX's default "linear" on both sides
    (the port's default was "bilinear_matmul" before; a default call then
    returned other crops)."""
    frames, boxes, out_hw = _inputs("off_frame", "uint8", seed=3)
    ref = np.asarray(jax_crop_resize(jnp.asarray(frames), jnp.asarray(boxes), out_hw))
    out = crop_resize(torch.from_numpy(frames), torch.from_numpy(boxes), out_hw).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    lin = crop_resize(torch.from_numpy(frames), torch.from_numpy(boxes), out_hw, "linear")
    assert np.array_equal(out, lin.numpy())
    assert METHODS == ("linear", "lanczos3", "cubic", "bilinear_gather", "bilinear_matmul")


@pytest.mark.parametrize("method", SCALED)
def test_predictor_takes_each_method(method):
    """TopDownPredictor(preprocess_method=...) against JAX's on the same
    float32 weights: the head outputs within test_torch_serving.py's model
    bar (rtol 1e-4, atol 1e-5) after crops within 1e-5."""
    jm, variables, pm = init_pair()
    kw = dict(input_size=TINY_CFG["img_size"], return_heatmaps=True, preprocess_method=method)
    codec = dict(input_size=(48, 64), heatmap_size=(12, 16),
                 sigmas=np.full(TINY_CFG["num_keypoints"], 0.05, np.float32), sigma=2.0)
    jax_pred = JaxPredictor(model=jm, variables=variables, codec=JaxCodec(JaxProbMap(**codec)),
                            **kw)
    port_pred = TopDownPredictor(model=pm, codec=Codec(ProbMap(**codec)), **kw)
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (3, 80, 64, 3), dtype=np.uint8)
    boxes = rng.uniform([-10, -10, 30, 45], [15, 15, 70, 90], (3, 4)).astype(np.float32)
    ref, out = jax_pred(frames, boxes), port_pred(frames, boxes)
    for k in ("heatmaps", "probabilities", "visibilities", "oks", "errors"):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("method", SCALED)
def test_training_frame_crop_takes_each_method(method):
    """The training step's frame-mode preamble (train/loop.py:augment_batch,
    no augmentation) crops with the config's preprocess_method: JAX's
    crop_resize within 1e-5."""
    frames, boxes, out_hw = _inputs("downsample", "uint8", seed=7)
    cfg = TrainConfig.from_dict(dict(model=dict(TINY_CFG, img_size=out_hw),
                                     preprocess_method=method))
    kpts = np.random.default_rng(8).uniform(10, 90, (len(boxes), 5, 2)).astype(np.float32)
    batch = dict(frame=torch.from_numpy(frames), box=torch.from_numpy(boxes),
                 keypoints=torch.from_numpy(kpts))
    images, out = augment_batch(cfg, batch)
    ref = np.asarray(jax_crop_resize(jnp.asarray(frames), jnp.asarray(boxes), out_hw, method))
    np.testing.assert_allclose(images.numpy(), ref, rtol=0, atol=TOL)
    assert out["keypoints"].shape == (len(boxes), 5, 2)
