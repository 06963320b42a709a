"""ViT-g/14's trunk shape against the JAX package, on the CPU.

ViT-g/14 (Zhai et al., "Scaling Vision Transformers", 2022) is 1408 wide,
40 deep, with 16 heads of d = 88 and an MLP of 6,144 (ratio 48/11). Neither
package has a preset for it: both compose it as
ProbPoseModel(ViTBackbone(...), ProbMapHead(...)), as JAX's build_model
does (models/model.py). Here a narrow trunk of the same head width (176
wide, 2 heads of 88, depth 2, the same MLP ratio, attn_impl="fused") gets
JAX's weights through compat/from_jax.py; the port's forward (K1's plain
version on the CPU; the d = 88 wgmma kernels on the card) is held to
JAX's at tests/test_torch_models.py's bar. The same trunk with
mlp_impl="fused" (hidden 768: the bf16 wgmma K5 on the card, its plain
version here) is held to JAX's fused branch (tests/test_torch_mlp.py's
`jax_fused_branch`: the Pallas kernel in interpret mode), forward and one
f32 train step. Images come from numpy.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.models.head import ProbMapHead as JaxProbMapHead
from probpose_pytorch_tpu.models.model import ProbPoseModel as JaxProbPoseModel
from probpose_pytorch_tpu.models.vit import ViTBackbone as JaxViTBackbone
from probpose_pytorch_tpu_torch.compat.from_jax import load_jax_variables
from probpose_pytorch_tpu_torch.models.head import ProbMapHead
from probpose_pytorch_tpu_torch.models.model import ProbPoseModel
from probpose_pytorch_tpu_torch.models.vit import ViTBackbone
from probpose_pytorch_tpu.models import vit as jax_vit
from probpose_pytorch_tpu_torch.models import vit as port_vit
from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import attention_route
from probpose_pytorch_tpu_torch.ops.kernels.mlp import mlp_route
from test_torch_mlp import jax_fused_branch  # noqa: F401 (a fixture)
from test_torch_models import ATOL, RTOL, TINY_CFG, _images, peaked_variables
from test_torch_train import RAW, _batch, _by_name, _jax_grads, _n, _noise_leaves, _port, \
    build_jax_side

torch.set_num_threads(2)

IMG = (64, 48)
GEO = dict(embed_dim=176, depth=2, num_heads=2, mlp_ratio=48 / 11)
HEAD = dict(out_channels=5, pool_sizes=((2, 2), (2, 2)), deconv_out_channels=(16, 16),
            deconv_kernel_sizes=(4, 4), normalize=1.0)


@pytest.fixture(scope="module")
def vitg_pair():
    """(JAX model, numpy variables, port model): the narrow ViT-g trunk
    under the ProbMap head in f32, sharing JAX's weights."""
    jm = JaxProbPoseModel(
        backbone=JaxViTBackbone(img_size=IMG, dtype=jnp.float32, attn_impl="fused", **GEO),
        head=JaxProbMapHead(dtype=jnp.float32, **HEAD))
    x = jnp.zeros((1, *IMG, 3), jnp.float32)
    variables = peaked_variables(jm.init(jax.random.PRNGKey(8), x, train=False), 8)
    pm = ProbPoseModel(ViTBackbone(img_size=IMG, dtype=torch.float32, attn_impl="fused", **GEO),
                       ProbMapHead(in_channels=GEO["embed_dim"], dtype=torch.float32, **HEAD))
    load_jax_variables(pm, variables["params"], variables["batch_stats"])
    return jm, variables, pm.eval()


def test_vitg_trunk_geometry(vitg_pair):
    """The port's trunk has ViT-g's head width and MLP width ratio, and its
    bf16 attention at 256 x 192 and 768 x 768 routes to the wgmma kernels."""
    _, _, pm = vitg_pair
    block = pm.backbone.blocks[0]
    assert block.attn.num_heads == 2 and GEO["embed_dim"] // 2 == 88
    assert int(1408 * GEO["mlp_ratio"]) == 6144 and int(176 * GEO["mlp_ratio"]) == 768
    assert attention_route(192, 88, torch.bfloat16, 232448) == "sm90 short"
    assert attention_route(2304, 88, torch.bfloat16, 232448, backward=True) == "sm90 tiled"


def test_vitg_trunk_matches_jax(vitg_pair):
    """The trunk's features (B, H/16, W/16, 176) against JAX's backbone."""
    jm, variables, pm = vitg_pair
    x = _images(11)
    ref = jm.backbone.apply({"params": variables["params"]["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        out = pm.backbone(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_vitg_model_matches_jax(vitg_pair):
    """The whole model's five outputs against JAX's."""
    jm, variables, pm = vitg_pair
    x = _images(12)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


def _vitg_pair(mlp_impl: str):
    """(JAX model, numpy variables, port model) of the narrow ViT-g trunk
    under the ProbMap head in f32 with `mlp_impl`, sharing JAX's weights."""
    jm = JaxProbPoseModel(
        backbone=JaxViTBackbone(img_size=IMG, dtype=jnp.float32, attn_impl="fused",
                                mlp_impl=mlp_impl, **GEO),
        head=JaxProbMapHead(dtype=jnp.float32, **HEAD))
    x = jnp.zeros((1, *IMG, 3), jnp.float32)
    variables = peaked_variables(jm.init(jax.random.PRNGKey(9), x, train=False), 9)
    pm = ProbPoseModel(ViTBackbone(img_size=IMG, dtype=torch.float32, attn_impl="fused",
                                   mlp_impl=mlp_impl, **GEO),
                       ProbMapHead(in_channels=GEO["embed_dim"], dtype=torch.float32, **HEAD))
    load_jax_variables(pm, variables["params"], variables["batch_stats"])
    return jm, variables, pm.eval()


def test_vitg_fused_mlp_matches_jax_fused_branch(jax_fused_branch):
    """The narrow ViT-g trunk with mlp_impl="fused" (176 wide, hidden 768,
    both multiples of 8: bf16 runs K5's wgmma kernels on the card) through
    compat/from_jax.py: the whole model's five outputs against JAX's, whose
    blocks ran its fused branch."""
    assert mlp_route(176, 768, torch.bfloat16) == "sm90"
    assert mlp_route(1408, 6144, torch.bfloat16) == "sm90"
    jm, variables, pm = _vitg_pair("fused")
    assert all(b.mlp_impl == "fused" for b in pm.backbone.blocks)
    x = _images(13)
    jax_fused_branch.clear()  # the init traced the branch too
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    assert len(jax_fused_branch) == GEO["depth"]
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


def test_vitg_fused_mlp_train_step_matches_jax(jax_fused_branch, monkeypatch):
    """One f32 train step of the narrow ViT-g trunk with mlp_impl="fused"
    (a preset added to both packages' tables inside the test) against JAX
    make_train_step taking its fused branch, from the same state (carried by
    load_jax_train_state) and batch: each loss term within 1e-5 relative,
    each gradient leaf within 1e-4 of its largest JAX entry, the pre-clip
    norm within 1e-4 (tests/test_torch_train.py's bars), and `_check_grads`'
    noise leaves within 1e-6 of the largest gradient anywhere. The head's
    conv biases that a train-mode BatchNorm follows have a zero gradient in
    exact arithmetic (the batch mean takes them out): both frameworks give
    f32 cancellation noise there (here ~1.2e-6 of the largest gradient, one
    noise against the other), so each side is held to zero within 1e-5 of
    the largest gradient."""
    geo = dict(GEO)
    monkeypatch.setitem(jax_vit.ViTConfig.PRESETS, "vit-g-narrow-test", geo)
    monkeypatch.setitem(port_vit.ViTConfig.PRESETS, "vit-g-narrow-test", geo)
    raw = dict(RAW, model=dict(TINY_CFG, backbone="vit-g-narrow-test", mlp_impl="fused"))
    js = build_jax_side(raw)
    trainer = _port(js, raw)
    assert trainer.model.backbone.blocks[0].attn.num_heads == 2
    assert trainer.model.backbone.blocks[0].mlp.fc1.out_features == 768
    batch = _batch(12)
    captured = []
    apply = trainer.state.apply_gradients
    trainer.state.apply_gradients = lambda g, tx, ema_decay=None: (
        captured.append([t.clone() for t in g]), apply(g, tx, ema_decay))[1]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rlosses, rgrads, _ = _jax_grads(js, jbatch)
    _, jm = js["step"](js["state"], jbatch)
    assert jax_fused_branch  # JAX traced its fused branch
    _, metrics = trainer.train_step(trainer.state, trainer.device_batch(batch))
    for k, v in rlosses.items():
        np.testing.assert_allclose(float(metrics[f"loss/{k}"]), float(v), rtol=1e-5,
                                   atol=1e-8, err_msg=k)
    ref = _by_name(rgrads, js["state"].batch_stats, trainer.state.names)
    noise, gmax = _noise_leaves(ref)
    for n, g in zip(trainer.state.names, captured[0]):
        if re.fullmatch(r"head\..*\.convs\.\d+\.bias", n):
            assert max(np.abs(_n(g)).max(), np.abs(ref[n]).max()) <= 1e-5 * gmax, n
            continue
        tol = 1e-6 * gmax if n in noise else 1e-4 * float(np.abs(ref[n]).max())
        np.testing.assert_allclose(_n(g), ref[n], rtol=0, atol=tol, err_msg=n)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
