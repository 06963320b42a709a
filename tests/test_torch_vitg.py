"""ViT-g/14's trunk shape against the JAX package, on the CPU.

ViT-g/14 (Zhai et al., "Scaling Vision Transformers", 2022) is 1408 wide,
40 deep, with 16 heads of d = 88 and an MLP of 6,144 (ratio 48/11). Neither
package has a preset for it: both compose it as
ProbPoseModel(ViTBackbone(...), ProbMapHead(...)), as JAX's build_model
does (models/model.py). Here a narrow trunk of the same head width (176
wide, 2 heads of 88, depth 2, the same MLP ratio, attn_impl="fused") gets
JAX's weights through compat/from_jax.py; the port's forward (K1's plain
version on the CPU; the d = 88 wgmma kernels on the card) is held to
JAX's at tests/test_torch_models.py's bar. Images come from numpy.
"""

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
from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import attention_route
from test_torch_models import ATOL, RTOL, _images, peaked_variables

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
