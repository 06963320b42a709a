"""The port's model against the JAX package on the CPU, at a tiny geometry.

Weights come from the JAX `model.init` (head kernels redrawn at fan-in
scale and BN statistics randomised, so the sparsemax sees peaked maps and
BN folding is exercised) and are carried over by compat/from_jax.py.
Everything runs in float32; tolerances are stated beside each assertion.
"""

import json
import pathlib
import re
from types import SimpleNamespace

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


@pytest.mark.parametrize("over,bound", [
    pytest.param(dict(pp_stages=2), None, id="over0-item 13"),
    pytest.param(dict(attn_impl="fused_tp", pp_stages=2), None, id="over1-item 13"),
    pytest.param(dict(deconv_kernel_sizes=(2, 4), pp_stages=2), None, id="over2-item 13"),
    pytest.param(dict(deconv_kernel_sizes=(4, 3), pp_stages=2), None, id="over3-item 13"),
    pytest.param(dict(attn_impl="einsum", softmax_dtype="bfloat16", pp_stages=2), 2 * 2.0**-8,
                 id="over4-item 13"),
])
def test_model_config_names_roadmap_item_for_unported(over, bound):
    """The configs that named ROADMAP item 13b (a pipeline: `pp_stages`
    with the head-major layout and the head and attention options) build:
    the trunk stacked in JAX's leaves, JAX's stacked variables loaded
    through compat/from_jax.py, and the forward (one device: the blocks in
    turn, JAX's sequential fallback) equal to JAX's build_model of the same
    config: the model bar (rtol 1e-4, atol 1e-5); the bf16-softmax trunk
    within test_einsum_bf16_softmax_trunk_matches_jax's bound, 2 * 2^-8 *
    max(1, max|ref|), on every output."""
    jm, variables, pm = init_pair({**TINY_CFG, **over}, seed=5)
    assert "blocks" in variables["params"]["backbone"]
    assert pm.backbone.stacked
    x = _images(9)
    ref = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    for a, b in zip(out, ref):
        b = np.asarray(b)
        if bound is None:
            np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=bound * max(1.0, float(np.abs(b).max())))


def test_build_model_and_trainer_create_bind_like_jax():
    """JAX's build_model(cfg, mesh=None) and Trainer.create(cfg,
    steps_per_epoch, mesh=None): `mesh` in its place, `device` and `seed`
    keyword-only after it; a mesh binds by position or by keyword (a
    world-free 1 x 1 mesh here; on one with a pipe axis of 2, stage 0 of a
    stand-in, Trainer.create stages the trunk as JAX's does: pp_stages 2,
    this stage half of each stacked leaf's depth; the pipelines themselves
    run in tests/test_torch_pipeline.py's world)."""
    import inspect

    from probpose_pytorch_tpu.train.loop import Trainer as JaxTrainer
    from probpose_pytorch_tpu_torch.train import TrainConfig, Trainer

    pairs = ((build_model, jax_model.build_model), (Trainer.create, JaxTrainer.create))
    for ours, theirs in pairs:
        ours = inspect.signature(ours).parameters
        theirs = inspect.signature(theirs).parameters
        n = len(theirs)
        assert list(ours)[:n] == list(theirs)
        assert all(ours[k].default == theirs[k].default for k in theirs)
        assert all(p.kind is p.KEYWORD_ONLY for p in list(ours.values())[n:])
    cfg = TrainConfig.from_dict(dict(model=dict(TINY_CFG)))
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), mesh=torch.zeros(1, 1))
    assert build_model(cfg.model, mesh, device="cpu").mesh is mesh
    assert build_model(cfg.model, mesh=mesh, device="cpu").mesh is mesh
    pipe = SimpleNamespace(mesh_dim_names=("data", "model", "pipe"), mesh=torch.zeros(1, 1, 2),
                           get_group=lambda name: None, get_coordinate=lambda: [0, 0, 0])
    depth = ViTConfig.PRESETS[cfg.model.backbone]["depth"]
    for call in (lambda: Trainer.create(cfg, 1, pipe, device="cpu"),
                 lambda: Trainer.create(cfg, 1, mesh=pipe, device="cpu")):
        trainer = call()
        assert trainer.mesh is pipe and trainer.model.mesh is pipe
        assert trainer.cfg.model.pp_stages == 2
        assert trainer.model.backbone.blocks.qkv_kernel.shape[0] == depth // 2
    with pytest.raises(TypeError):
        build_model(cfg.model, None, "cpu")  # device is no longer positional


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kernels", [(2, 3), (3, 2), (3, 4)])
def test_deconv_kernel_sizes_match_jax(kernels, train):
    """flax ConvTranspose(k, strides=2, padding="SAME") at k = 2 and 3, with
    weights from compat/from_jax.py: eval mode against JAX's apply, train
    mode (batch statistics and their running update) against JAX's
    train=True apply; the model bar (rtol 1e-4, atol 1e-5)."""
    kw = {**TINY_CFG, "deconv_kernel_sizes": kernels}
    jm, variables, pm = init_pair(kw, seed=3)
    x = _images(6)
    pm.train(train)
    if train:
        ref, upd = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, jnp.asarray(x), train=False)
    out = pm(torch.from_numpy(x))
    assert out[0].shape == (2, 5, 16, 12)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
    if train:
        head = pm.head
        for i in range(2):
            stats = upd["batch_stats"]["head"][f"deconv_bn{i}"]
            np.testing.assert_allclose(head.deconv_bns[i].running_mean.numpy(),
                                       np.asarray(stats["mean"]), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(head.deconv_bns[i].running_var.numpy(),
                                       np.asarray(stats["var"]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_einsum_bf16_softmax_trunk_matches_jax(compute):
    """attn_impl="einsum" with softmax_dtype="bfloat16": the scores scaled
    in float32, the softmax in bf16, then the compute dtype, in plain
    PyTorch. Against JAX's trunk within bf16 bounds: the probabilities
    round to bf16 (and XLA's bf16 softmax keeps excess precision where
    PyTorch rounds once), so 2 * 2^-8 * max(1, max|ref|) with float32
    compute, twice that with bf16 compute. The path is the einsum, not
    kernel K1: the float32-softmax trunk on the same weights differs."""
    kw = {**TINY_CFG, "attn_impl": "einsum", "softmax_dtype": "bfloat16",
          "compute_dtype": compute}
    jm, variables, pm = init_pair(kw, seed=4)
    x = _images(7)
    ref = np.asarray(jm.backbone.apply({"params": variables["params"]["backbone"]},
                                       jnp.asarray(x)), np.float32)
    with torch.no_grad():
        out = pm.backbone(torch.from_numpy(x)).float().numpy()
    bound = (2 if compute == "float32" else 4) * 2.0**-8 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=0, atol=bound)
    f32 = build_model(ModelConfig(**{**kw, "softmax_dtype": "float32"}), device="cpu")
    f32.load_state_dict(pm.state_dict())
    with torch.no_grad():
        assert not np.array_equal(f32.backbone(torch.from_numpy(x)).float().numpy(), out)


def test_einsum_bf16_softmax_trains_with_remat():
    """The bf16-softmax einsum attention under remat (each block under
    torch.utils.checkpoint) gives the gradients of the same model without
    remat, exactly."""
    kw = {**TINY_CFG, "attn_impl": "einsum", "softmax_dtype": "bfloat16"}
    grads = []
    for remat in (False, True):
        pm = build_model(ModelConfig(**kw, remat=remat), device="cpu", seed=5).train()
        out = pm(torch.from_numpy(_images(8)))
        sum(o.float().square().mean() for o in out).backward()
        grads.append([p.grad.clone() for p in pm.backbone.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert any(g.abs().sum() > 0 for g in grads[1])
