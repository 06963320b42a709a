"""The port's model against the JAX package on the CPU, at a tiny geometry.

Weights come from the JAX `model.init` (head kernels redrawn at fan-in
scale and BN statistics randomised, so the sparsemax sees peaked maps and
BN folding is exercised) and are carried over by compat/from_jax.py.
Everything runs in float32; tolerances are stated beside each assertion.
"""

import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.compat.torch_export import (
    export_head_params,
    export_timm_vit_params,
)
from probpose_pytorch_tpu.models import model as jax_model
from probpose_pytorch_tpu.models.vit import Block as JaxBlock
from probpose_pytorch_tpu.models.vit import ViTConfig as JaxViTConfig
from probpose_pytorch_tpu_torch.compat.from_jax import (
    load_jax_variables,
    state_dict_from_jax,
)
from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model
from probpose_pytorch_tpu_torch.models.vit import Block, ViTConfig

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0)
JaxViTConfig.PRESETS.setdefault("vit-tiny-port", TINY)
ViTConfig.PRESETS.setdefault("vit-tiny-port", TINY)

TINY_CFG = dict(
    img_size=(64, 48),
    num_keypoints=5,
    backbone="vit-tiny-port",
    compute_dtype="float32",
    deconv_out_channels=(16, 16),
    deconv_kernel_sizes=(4, 4),
    pool_sizes=((2, 2), (2, 2)),
    normalize=1.0,
    attn_impl="fused",
)

# Head outputs: the bar of tests/test_torch_export.py's torch oracle.
RTOL, ATOL = 1e-4, 1e-5


def peaked_variables(variables, seed=0):
    """numpy copy of `variables` with the head's conv kernels redrawn at
    fan-in scale and randomised BN statistics."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(lambda v: np.array(v, np.float32), variables)

    def redraw(node):
        for k, v in node.items():
            if isinstance(v, dict):
                redraw(v)
            elif k == "kernel" and v.ndim == 4:
                fan_in = v.shape[0] * v.shape[1] * v.shape[2]
                node[k] = (rng.normal(size=v.shape) / np.sqrt(fan_in)).astype(np.float32)

    def stats(node):
        for k, v in node.items():
            if isinstance(v, dict):
                stats(v)
            elif k == "mean":
                node[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
            elif k == "var":
                node[k] = (1 + 0.1 * rng.normal(size=v.shape) ** 2).astype(np.float32)

    redraw(tree["params"]["head"])
    stats(tree["batch_stats"])
    return tree


def init_pair(cfg_kw=TINY_CFG, seed=0):
    """(JAX model, numpy variables, port model) sharing weights."""
    jm = jax_model.build_model(jax_model.ModelConfig(**cfg_kw))
    x = jnp.zeros((1, *cfg_kw["img_size"], 3), jnp.float32)
    variables = peaked_variables(jm.init(jax.random.PRNGKey(seed), x, train=False), seed)
    pm = build_model(ModelConfig(**cfg_kw), device="cpu")
    load_jax_variables(pm, variables["params"], variables["batch_stats"])
    return jm, variables, pm


@pytest.fixture(scope="module")
def pair():
    return init_pair()


def _images(seed, B=2, H=64, W=48):
    return np.random.default_rng(seed).random((B, H, W, 3), dtype=np.float32)


def test_block_matches_jax(pair):
    _, variables, _ = pair
    x = np.random.default_rng(1).normal(size=(2, 12, 32)).astype(np.float32)
    ref = JaxBlock(2, 2.0, dtype=jnp.float32, attn_impl="fused").apply(
        {"params": variables["params"]["backbone"]["block0"]}, jnp.asarray(x))
    block = Block(32, 2, 2.0, torch.float32)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    prefix = "backbone.blocks.0."
    block.load_state_dict(
        {k[len(prefix):]: torch.from_numpy(v.copy()) for k, v in sd.items()
         if k.startswith(prefix)}, strict=True)
    with torch.no_grad():
        out = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_backbone_matches_jax(pair):
    jm, variables, pm = pair
    x = _images(2)
    ref = jm.backbone.apply({"params": variables["params"]["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        out = pm.backbone(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 4, 3, 32)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_head_matches_jax(pair):
    jm, variables, pm = pair
    feats = np.random.default_rng(3).normal(size=(2, 4, 3, 32)).astype(np.float32)
    ref = jm.head.apply(
        {"params": variables["params"]["head"],
         "batch_stats": variables["batch_stats"]["head"]},
        jnp.asarray(feats), train=False)
    with torch.no_grad():
        out = pm.head(torch.from_numpy(feats))
    assert len(out) == 5
    assert out[0].shape == (2, 5, 16, 12)
    assert (out[0] > 0).float().mean() < 0.5  # peaked, sparse maps
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


def test_model_matches_jax(pair):
    jm, variables, pm = pair
    x = _images(4)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("over", [
    dict(scalar_impl="fused", deconv_impl="fastvjp"),
    dict(attn_impl="einsum", num_prefix_tokens=2, adapter_hidden=(24, 16),
         frozen_backbone=True, exact_gelu=True, conv_out_channels=(8,),
         conv_kernel_sizes=(3,)),
    dict(head_type="simcc"),
    dict(head_type="simcc", simcc_split_ratio=3.0, adapter_hidden=(24,),
         pool_sizes=((4, 3), (2, 2))),
    dict(backbone="conv-t"),
    dict(backbone="conv-t", head_type="simcc", frozen_backbone=True),
])
def test_model_options_match_jax(over):
    """The accepted-but-equal XLA knobs, the small trunk/head options the
    flagship leaves off, the SimCC head (its (x, y) logits pair first) and
    the conv-t trunk (models/convnet.py)."""
    kw = {**TINY_CFG, **over}
    jm, variables, pm = init_pair(kw, seed=1)
    x = _images(5)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    flat = lambda pred: [t for p in pred for t in (p if isinstance(p, tuple) else (p,))]
    assert len(flat(out)) == len(flat(ref)) == (6 if kw.get("head_type") == "simcc" else 5)
    for o, r in zip(flat(out), flat(ref)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


def _export_key(port_key: str) -> str:
    """The compat/torch_export.py name of a port state-dict key."""
    k = port_key
    if k.startswith("backbone."):
        k = k[len("backbone."):]
        return re.sub(r"^patch_embed\.", "patch_embed.proj.", k)
    k = k[len("head."):]
    k = re.sub(r"^deconvs\.(\d+)", lambda m: f"deconv_layers.{3 * int(m[1])}", k)
    k = re.sub(r"^deconv_bns\.(\d+)", lambda m: f"deconv_layers.{3 * int(m[1]) + 1}", k)
    k = re.sub(r"^convs\.(\d+)", lambda m: f"conv_layers.{3 * int(m[1])}", k)
    k = re.sub(r"^conv_bns\.(\d+)", lambda m: f"conv_layers.{3 * int(m[1]) + 1}", k)
    k = re.sub(r"^final\.", "final_layer.", k)
    k = re.sub(r"^branches\.(\w+)\.convs\.(\d+)", lambda m: f"{m[1]}_layers.{4 * int(m[2])}", k)
    k = re.sub(r"^branches\.(\w+)\.bns\.(\d+)", lambda m: f"{m[1]}_layers.{4 * int(m[2]) + 1}", k)
    return re.sub(r"^branches\.(\w+)\.final", lambda m: f"{m[1]}_layers.8", k)


def test_from_jax_equals_torch_export(pair):
    """from_jax.py gives exactly the arrays the JAX package's exporter
    gives for the same tree (two pool stages: branch final is index 8)."""
    _, variables, _ = pair
    params, stats = variables["params"], variables["batch_stats"]
    ours = state_dict_from_jax(params, stats)
    theirs = {**export_timm_vit_params(params["backbone"], prefix=""),
              **export_head_params(params["head"], stats["head"])}
    mapped = {_export_key(k): v for k, v in ours.items()}
    assert sorted(mapped) == sorted(theirs)
    for k, v in mapped.items():
        assert v.dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(v, theirs[k], err_msg=k)


def test_flagship_geometry_loads_strictly():
    """Every array of the flagship JAX model has a place of the same shape in
    the port's flagship model, and nothing is left over."""
    block = json.loads((REPO / "configs/flagship_coco_vits.json").read_text())["model"]
    cfg = ModelConfig(**block)
    assert cfg.attn_impl == "fused" and cfg.heatmap_size == (48, 64)
    jcfg = jax_model.ModelConfig(**{**cfg.__dict__})
    shapes = jax.eval_shape(
        lambda: jax_model.build_model(jcfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 256, 192, 3)), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    pm = build_model(cfg, device="cpu")
    load_jax_variables(pm, zeros["params"], zeros["batch_stats"])
    n_jax = sum(v.size for v in jax.tree_util.tree_leaves(zeros))
    n_port = sum(t.numel() for k, t in pm.state_dict().items()
                 if not k.endswith("num_batches_tracked"))
    assert n_port == n_jax


@pytest.mark.parametrize("over,item", [
    (dict(pp_stages=2), "item 13"),
    (dict(attn_impl="fused_tp"), "item 13"),
    (dict(deconv_kernel_sizes=(2, 4)), "item 4"),
    (dict(deconv_kernel_sizes=(4, 3)), "item 4"),
    (dict(attn_impl="einsum", softmax_dtype="bfloat16"), "item 4"),
])
def test_model_config_names_roadmap_item_for_unported(over, item):
    """Such a config loads (training configs carry it) and the model build
    refuses it, naming the ROADMAP item."""
    cfg = ModelConfig(**over)
    with pytest.raises(NotImplementedError, match=item):
        build_model(cfg, device="cpu")
