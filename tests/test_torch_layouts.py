"""The port's sharding decisions, layouts and head-major attention against
the JAX package's, on the CPU with no world (the 8-device virtual CPU
mesh of tests/conftest.py gives JAX's side; the port reads a mesh's shape
from a stand-in): param_shardings name by name, head_batch_spec, ZeRO-1's
axis per leaf, batch_iterator's process slices, compat/layouts.py's
conversions (exact), the head-major plain attention and its gradient, one
tensor-parallel rank's attention, the fused_tp model's forward on
converted weights, and what ROADMAP item 13b refused, which builds since
(the pipelines' runs are tests/test_torch_pipeline.py's). The scale-out
runs themselves are tests/test_torch_parallel.py's."""

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.compat import layouts as jax_layouts
from probpose_pytorch_tpu.data import SyntheticPoseDataset as JaxSynthetic
from probpose_pytorch_tpu.data import batch_iterator as jax_batch_iterator
from probpose_pytorch_tpu.models import model as jax_model
from probpose_pytorch_tpu.models.vit import ViTConfig as JaxViTConfig
from probpose_pytorch_tpu.ops.pallas.attention_kernel import _einsum_packed_attention
from probpose_pytorch_tpu.parallel import head_batch_spec as jax_head_batch_spec
from probpose_pytorch_tpu.parallel import make_mesh as jax_make_mesh
from probpose_pytorch_tpu.parallel import opt_state_shardings as jax_opt_state_shardings
from probpose_pytorch_tpu.parallel import param_shardings as jax_param_shardings
from probpose_pytorch_tpu.train import Trainer as JaxTrainer
from probpose_pytorch_tpu_torch.compat import layouts
from probpose_pytorch_tpu_torch.compat.from_jax import (
    _leaves_in_order,
    _port_leaf_index,
    state_dict_from_jax,
)
from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model
from probpose_pytorch_tpu_torch.ops.kernels.attention import (
    packed_attention,
    packed_attention_reference,
)
from probpose_pytorch_tpu_torch.parallel import (
    head_batch_spec,
    opt_state_shardings,
    param_shardings,
)
from probpose_pytorch_tpu_torch.train import TrainConfig, Trainer
from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
from probpose_pytorch_tpu_torch.train.loop import layout_metadata, restore_state_with_layout
from probpose_pytorch_tpu_torch.train.state import JAX_AXES, param_layouts
from test_torch_parallel import MODEL, SPE, _find, _jax_cfg

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests


def test_param_shardings_match_jax():
    """Every parameter's split, name by name, is JAX's _param_spec on the
    same leaf, carried to the port's axes (a Linear is (out, in))."""
    cfg = _jax_cfg(Path("/nonexistent")).model
    jm = jax_model.build_model(cfg)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 48, 3)))
    jspecs = jax_param_shardings(variables["params"], jax_make_mesh(8, 2))
    model = build_model(ModelConfig(**MODEL), device="cpu")
    names = [n for n, _ in model.named_parameters()]
    index = dict(zip(names, _port_leaf_index(variables["params"], variables["batch_stats"],
                                             names)))
    leaves = _leaves_in_order(jax.tree_util.tree_map(lambda s: tuple(s.spec), jspecs,
                                                     is_leaf=lambda s: hasattr(s, "spec")))
    kinds = dict(zip(names, param_layouts(model)))
    specs = param_shardings(model)
    assert sum("model" in s for s in specs.values()) == 12
    for n in names:
        jspec = leaves[index[n]]
        p = dict(model.named_parameters())[n]
        jspec = tuple(jspec) + (None,) * (p.dim() - len(jspec))
        axes = JAX_AXES.get(kinds[n], tuple(range(p.dim())))
        want = tuple(jspec[axes[a]] for a in range(p.dim()))
        got = specs[n] + (None,) * (p.dim() - len(specs[n]))
        assert got == want, n


def _mesh(data, model):
    return SimpleNamespace(mesh_dim_names=("data", "model"), mesh=torch.zeros(data, model))


def test_head_batch_spec_matches_jax():
    for (data, model), batch in [((8, 1), 8), ((4, 2), 8), ((4, 2), 4), ((2, 2), 12)]:
        ref = jax_head_batch_spec(jax_make_mesh(data * model, model), batch)
        got = head_batch_spec(_mesh(data, model), batch)
        assert got == (None if ref is None else tuple(ref[0])), (data, model, batch)
    assert head_batch_spec(None, 8) is None


def test_zero1_axis_choice_matches_jax():
    """ZeRO-1 splits each Adam moment along the axis JAX picks on its own
    layout of the leaf (largest axis the data axis divides, >= 1024
    elements), carried to the port's axes."""
    jcfg = _jax_cfg(Path("/nonexistent"))
    jtr = JaxTrainer.create(jcfg, SPE)
    adam = _find(jtr.state.opt_state, "mu")
    jspecs = jax_opt_state_shardings(adam.mu, jax_make_mesh(8, 1))
    trainer = Trainer.create(TrainConfig.from_json(jcfg.to_json()), SPE, device="cpu")
    names = trainer.state.names
    dims = opt_state_shardings(trainer.state.opt_state, _mesh(8, 1),
                               layouts=param_layouts(trainer.model))
    index = dict(zip(names, _port_leaf_index(jtr.state.params, jtr.state.batch_stats, names)))
    leaves = _leaves_in_order(jax.tree_util.tree_map(lambda s: tuple(s.spec), jspecs,
                                                     is_leaf=lambda s: hasattr(s, "spec")))
    kinds = param_layouts(trainer.model)
    split = 0
    for i, n in enumerate(names):
        jspec = leaves[index[n]]
        d = dims["mu"][i]
        if "data" not in jspec:
            assert d is None, n
            continue
        split += 1
        axes = JAX_AXES.get(kinds[i], tuple(range(len(jspec))))
        assert d is not None and axes[d] == list(jspec).index("data"), n
    assert split > 0 and dims["nu"] == dims["mu"]


def test_batch_iterator_process_slices_match_jax():
    """Each process's slice of every global batch, JAX's, shuffled too."""
    ds_j = JaxSynthetic(20, (32, 24), 5)
    ds_p = SyntheticPoseDataset(20, (32, 24), 5)
    for pidx in range(2):
        kw = dict(shuffle=True, seed=3, num_workers=1, process_index=pidx, process_count=2)
        got = list(batch_iterator(ds_p, 8, **kw))
        ref = list(jax_batch_iterator(ds_j, 8, **kw))
        assert len(got) == len(ref) == 2
        for g, r in zip(got, ref):
            for k in r:
                np.testing.assert_array_equal(g[k], r[k])
    with pytest.raises(ValueError, match="not divisible"):
        next(batch_iterator(ds_p, 8, process_index=0, process_count=3))


# --------------------------------------------------------------------------
# the head-major layout


def test_permutation_is_a_bijection_and_roundtrips():
    C, H = 12, 3
    perm = layouts.qkv_head_major_permutation(C, H)
    np.testing.assert_array_equal(perm, jax_layouts.qkv_head_major_permutation(C, H))
    rng = np.random.default_rng(0)
    sd = {"backbone.blocks.0.attn.qkv.weight": torch.randn(3 * C, C),
          "backbone.blocks.0.attn.qkv.bias": torch.randn(3 * C),
          "backbone.blocks.0.attn.qkv_lora.b": torch.randn(4, 3 * C),
          "backbone.blocks.0.attn.qkv_lora.a": torch.randn(C, 4),
          "backbone.blocks.0.attn.proj.weight": torch.randn(C, C)}
    back = layouts.qkv_to_qkv_major(layouts.qkv_to_head_major(sd, H), H)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    hm = layouts.qkv_to_head_major(sd, H)
    for k in ("backbone.blocks.0.attn.qkv_lora.a", "backbone.blocks.0.attn.proj.weight"):
        assert hm[k] is sd[k]
    # the nested JAX tree converts exactly as JAX's own function converts it
    tree = {"block0": {"attn": {"qkv": {"kernel": rng.normal(size=(C, 3 * C)),
                                        "bias": rng.normal(size=(3 * C,))},
                                "qkv_lora": {"a": rng.normal(size=(C, 4)),
                                             "b": rng.normal(size=(4, 3 * C))}}}}
    ours = layouts.qkv_to_head_major(tree, H)
    ref = jax_layouts.qkv_to_head_major(tree, H)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the port's Linear rows permute as JAX's Dense columns
    w = sd["backbone.blocks.0.attn.qkv.weight"].numpy()
    np.testing.assert_array_equal(hm["backbone.blocks.0.attn.qkv.weight"].numpy(),
                                  np.asarray(jax_layouts.qkv_to_head_major(
                                      {"attn": {"qkv": {"kernel": w.T}}}, H)
                                      ["attn"]["qkv"]["kernel"]).T)


def test_stack_and_unstack_vit_blocks_match_jax():
    rng = np.random.default_rng(1)
    trunk = {f"block{i}": {"norm1": {"scale": rng.normal(size=4), "bias": rng.normal(size=4)},
                           "attn": {"qkv": {"kernel": rng.normal(size=(4, 12)),
                                            "bias": rng.normal(size=12)},
                                    "proj": {"kernel": rng.normal(size=(4, 4)),
                                             "bias": rng.normal(size=4)}},
                           "norm2": {"scale": rng.normal(size=4), "bias": rng.normal(size=4)},
                           "mlp": {"fc1": {"kernel": rng.normal(size=(4, 8)),
                                           "bias": rng.normal(size=8)},
                                   "fc2": {"kernel": rng.normal(size=(8, 4)),
                                           "bias": rng.normal(size=4)}}}
             for i in range(3)}
    trunk["norm"] = {"scale": rng.normal(size=4)}
    stacked = layouts.stack_vit_blocks(trunk)
    ref = jax_layouts.stack_vit_blocks(trunk)
    assert set(stacked["blocks"]) == set(ref["blocks"])
    for k in ref["blocks"]:
        np.testing.assert_array_equal(stacked["blocks"][k], ref["blocks"][k])
    back = layouts.convert_trunk_layout({"backbone": stacked}, "stacked", "per_block")
    for a, b in zip(jax.tree_util.tree_leaves(back["backbone"]),
                    jax.tree_util.tree_leaves(jax_layouts.unstack_vit_blocks(ref))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        layouts.convert_qkv_layout(trunk, 2, "qkv_major", "other")


def test_head_major_attention_and_gradient_match_jax():
    """The plain head-major attention (K1's CPU path) and its gradient
    against JAX's _einsum_packed_attention(..., "head_major"), f32: sums in
    another order, 1e-5."""
    rng = np.random.default_rng(7)
    Bq, N, H, d = 3, 12, 2, 16
    qkv = rng.normal(size=(Bq, N, 3 * H * d)).astype(np.float32)
    w = rng.normal(size=(Bq, N, H * d)).astype(np.float32)
    ref = _einsum_packed_attention(jnp.asarray(qkv), H, "head_major")
    g_ref = jax.grad(lambda x: jnp.sum(_einsum_packed_attention(x, H, "head_major") * w))(
        jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = packed_attention(x, H, "head_major")
    (g,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), x)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-5)
    # the head-major packing of the same numbers gives the qkv-major context
    perm = torch.as_tensor(layouts.qkv_head_major_permutation(H * d, H))
    hm = torch.from_numpy(qkv)[..., perm]
    np.testing.assert_allclose(packed_attention_reference(hm, H, "head_major"),
                               packed_attention_reference(torch.from_numpy(qkv), H),
                               rtol=0, atol=0)


def test_sharded_packed_attention_tp_matches_jax():
    """On one model rank of a (data 1, model 2) mesh, the rank's columns of
    a head-major qkv (its own heads) give that rank's columns of JAX's
    head-major einsum attention over all heads, with no collective; a
    data-parallel rank runs K1 on its rows in either layout (f32, 1e-5)."""
    from probpose_pytorch_tpu_torch.ops.kernels.attention import sharded_packed_attention

    rng = np.random.default_rng(11)
    Bq, N, H, d = 2, 12, 4, 16
    qkv = rng.normal(size=(Bq, N, 3 * H * d)).astype(np.float32)
    ref = np.asarray(_einsum_packed_attention(jnp.asarray(qkv), H, "head_major"))
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), mesh=torch.zeros(1, 2))
    cols = 3 * H * d // 2
    for m in range(2):
        local = torch.from_numpy(qkv[..., m * cols:(m + 1) * cols].copy())
        out = sharded_packed_attention(local, H, mesh, model_axis="model")
        np.testing.assert_allclose(out.numpy(), ref[..., m * H * d // 2:(m + 1) * H * d // 2],
                                   rtol=1e-5, atol=1e-5)
    out = sharded_packed_attention(torch.from_numpy(qkv), H, mesh, layout="head_major")
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        sharded_packed_attention(torch.from_numpy(qkv), 3, mesh, model_axis="model")


@pytest.mark.parametrize("backbone", ["vit-nano", "vit-tiny-par"])
def test_fused_tp_forward_matches_jax(backbone):
    """A qkv-major model's weights converted by the port's
    qkv_to_head_major run the port's "fused_tp" model to JAX's "fused_tp"
    forward on JAX's converted weights (JAX's layout test's bound: atol
    2e-5, rtol 1e-5)."""
    kw = dict(MODEL, backbone=backbone)
    jm = jax_model.build_model(jax_model.ModelConfig(**kw, attn_impl="einsum"))
    x = np.random.default_rng(2).random((2, 64, 48, 3), dtype=np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    heads = JaxViTConfig.PRESETS[backbone]["num_heads"]
    jtp = jax_model.build_model(jax_model.ModelConfig(**kw, attn_impl="fused_tp"))
    ref = jtp.apply(jax_layouts.qkv_to_head_major(variables, heads), jnp.asarray(x),
                    train=False)
    pm = build_model(ModelConfig(**kw, attn_impl="fused_tp"), device="cpu")
    sd = state_dict_from_jax(jax.device_get(variables["params"]),
                             jax.device_get(variables["batch_stats"]))
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        layouts.qkv_to_head_major(sd, heads).items()})
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# what ROADMAP item 13b refused, which builds since


def test_pipeline_refusals_cite_item_13b(tmp_path):
    """The calls that raised citing ROADMAP item 13b build as JAX's do:
    build_model(pp_stages=2) stacks the trunk in JAX's leaves (names and
    shapes); Trainer.create(pipeline_parallel=2) with no mesh trains one
    device's per-block trunk, as JAX's; stacked JAX parameters convert
    (state_dict_from_jax: JAX's leaves as they are, the per-block ones
    stacked equal them); a stacked checkpoint restores onto a per-block
    trainer (its parameters exactly the stacked ones, unstacked); and
    pipeline_spmd with no mesh is JAX's sequential fallback (rtol and atol
    1e-6, JAX's bound). The pipelines run in tests/test_torch_pipeline.py."""
    jm = jax_model.build_model(jax_model.ModelConfig(**MODEL, pp_stages=2))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 48, 3)))
    params = jax.device_get(v["params"])
    pm = build_model(ModelConfig(**MODEL, pp_stages=2), device="cpu")
    sd = pm.state_dict()
    for name, leaf in params["backbone"]["blocks"].items():
        assert tuple(sd[f"backbone.blocks.{name}"].shape) == leaf.shape, name
    cfg = TrainConfig.from_json(_jax_cfg(tmp_path).to_json())
    piped = dataclasses.replace(cfg, pipeline_parallel=2)
    theirs = JaxTrainer.create(_jax_cfg(tmp_path, pipeline_parallel=2), 1)
    ours = Trainer.create(piped, 1, device="cpu")
    assert ours.cfg.model.pp_stages == theirs.cfg.model.pp_stages == 1
    assert not ours.model.backbone.stacked and "block0" in theirs.state.params["backbone"]
    stacked = state_dict_from_jax(params, jax.device_get(v["batch_stats"]))
    per_block = state_dict_from_jax(
        dict(params, backbone=jax_layouts.unstack_vit_blocks(params["backbone"])),
        jax.device_get(v["batch_stats"]))
    restacked = layouts.stack_state_dict(per_block)
    assert sorted(restacked) == sorted(stacked)
    for k in stacked:
        np.testing.assert_array_equal(restacked[k], stacked[k])
    stacked_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, pp_stages=2))
    src = Trainer.create(stacked_cfg, 1, device="cpu")
    ckpt = CheckpointManager(tmp_path / "ck")
    ckpt.save(0, src.state, metadata=layout_metadata(stacked_cfg))
    assert ckpt.read_metadata()["trunk_layout"] == "stacked"
    restore_state_with_layout(ckpt, ours.state, cfg)
    want = layouts.unstack_state_dict(dict(src.model.named_parameters()))
    for n, p in zip(ours.state.names, ours.state.params):
        assert torch.equal(p, want[n]), n
    from probpose_pytorch_tpu.parallel import pipeline_spmd as jax_pipeline_spmd
    from probpose_pytorch_tpu_torch.parallel import pipeline_spmd

    rng = np.random.RandomState(5)
    w, b, x = rng.randn(4, 8, 8) * 0.3, rng.randn(4, 8) * 0.1, rng.randn(4, 5, 8)
    ref = jax_pipeline_spmd(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
                            {"w": jnp.asarray(w, jnp.float32), "b": jnp.asarray(b, jnp.float32)},
                            jnp.asarray(x, jnp.float32), None)
    out = pipeline_spmd(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                        {"w": torch.tensor(w, dtype=torch.float32),
                         "b": torch.tensor(b, dtype=torch.float32)},
                        torch.tensor(x, dtype=torch.float32), None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_ranks_per_host_decide_the_backend(monkeypatch):
    """Two hosts of four ranks each, launched through JAX's variables (no
    LOCAL_WORLD_SIZE): each rank counts the four ranks of its host from the
    host names exchanged through the rendezvous store, so with four cards a
    host every rank has a card of its own and the backend is NCCL;
    torchrun's LOCAL_RANK and LOCAL_WORLD_SIZE are read where set."""
    import socket

    import torch.distributed as dist

    from probpose_pytorch_tpu_torch.parallel import distributed

    hosts = ["a"] * 4 + ["b"] * 4
    assert [distributed.host_ranks(hosts, r) for r in range(8)] == [(r % 4, 4) for r in range(8)]
    assert distributed.host_ranks(["a", "b", "a"], 2) == (1, 2)
    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    store = dist.HashStore()
    for r, h in enumerate(hosts):
        if r != 5:
            store.set(f"probpose/host/{r}", h)
    monkeypatch.setattr(socket, "gethostname", lambda: "b")
    assert distributed._local_ranks(store, 5, 8) == (1, 4)
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert distributed._local_ranks(dist.HashStore(), 7, 8) == (3, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed.backend_for(4, "cuda") == "nccl"
    assert distributed.backend_for(8, "cuda") == "gloo"  # ranks would share cards
    assert distributed.backend_for(4, "cpu") == "gloo"
