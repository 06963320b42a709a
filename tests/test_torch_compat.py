"""Reference-checkpoint import and export in the port against the JAX
package, on the CPU: the pos-embed resize against jax.image.resize, the
reference head, a timm ViT and a RADIO-style ViT (registers, linear
patchifier, adapter) imported by both packages and run through both
models, exact export round trips and refusals, and the convert and export
CLIs on state dicts the tests build (no reference checkpoint is in the
repository). Every tolerance is stated beside its assertion.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from probpose_pytorch_tpu.compat import torch_export as jax_export
from probpose_pytorch_tpu.compat import torch_import as jax_import
from probpose_pytorch_tpu.models.head import ProbMapHead as JaxHead
from probpose_pytorch_tpu.models.vit import ViTBackbone as JaxViT
from probpose_pytorch_tpu_torch.compat import convert, torch_export, torch_import
from probpose_pytorch_tpu_torch.inference import load_predictor
from probpose_pytorch_tpu_torch.models.head import ProbMapHead
from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model
from probpose_pytorch_tpu_torch.models.vit import ViTBackbone
from probpose_pytorch_tpu_torch.train import cli as train_cli
from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
from probpose_pytorch_tpu_torch.train.config import TrainConfig
from test_torch_import import _torch_head, _TorchRadioViT
from test_torch_lora import LORA_CFG
from test_torch_models import TINY_CFG, init_pair
from test_torch_train import RAW

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

TOL = 1e-5  # f32 model outputs after each package's import


def _np(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# --------------------------------------------------------------------------
# the pos-embed resize


@pytest.mark.parametrize("src,dst", [
    ((14, 14), (16, 12)),  # grows one axis, shrinks the other
    ((6, 6), (12, 9)),     # grows both
    ((16, 12), (8, 6)),    # shrinks both (antialiased)
    ((7, 5), (16, 12)),
    ((14, 14), (14, 10)),  # one axis only
])
def test_pos_embed_resize_matches_jax_image_resize(src, dst):
    """The port's separable weight matrices against jax.image.resize's
    bicubic (Keys a = -0.5, half-pixel centres, antialiased when
    shrinking), within 1e-6 of the values' scale (max(1, max |out|)): both
    build the same float32 weights and contract them in float32, each in
    its own summation order."""
    pos = np.random.default_rng(sum(src)).normal(size=(1, src[0] * src[1], 8)).astype(
        np.float32)
    ref = jax_import.interpolate_pos_embed(pos, src, dst)
    ours = torch_import.interpolate_pos_embed(torch.from_numpy(pos), src, dst)
    assert ours.shape == (1, dst[0] * dst[1], 8) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                               atol=1e-6 * max(1.0, float(np.abs(ref).max())))
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(pos).reshape(1, *src, 8).permute(0, 3, 1, 2), size=dst,
        mode="bicubic", align_corners=False).permute(0, 2, 3, 1).reshape(1, -1, 8)
    assert np.abs(plain.numpy() - ref).max() > 1e-3  # torch's bicubic is another function


def test_pos_embed_resize_identity():
    pos = torch.randn(1, 12, 4)
    assert torch_import.interpolate_pos_embed(pos, (4, 3), (4, 3)) is pos


# --------------------------------------------------------------------------
# imports, against JAX's import and model


def test_head_import_matches_jax():
    torch.manual_seed(0)
    sd = _np(_torch_head().state_dict())
    params, stats = jax_import.import_head_params(sd, num_deconv=2, num_conv=0,
                                                  num_pool_stages=2)
    jhead = JaxHead(out_channels=3, pool_sizes=((2, 2), (2, 2)), deconv_out_channels=(8, 8),
                    deconv_kernel_sizes=(4, 4), normalize=1.0, dtype=jnp.float32)
    head = ProbMapHead(16, 3, pool_sizes=((2, 2), (2, 2)), deconv_out_channels=(8, 8),
                       normalize=1.0, dtype=torch.float32)
    imported = torch_import.import_head_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, num_deconv=2, num_conv=0,
        num_pool_stages=2)
    head.load_state_dict(_strip(imported, "head."), strict=True)
    feats = np.random.default_rng(0).normal(size=(2, 4, 4, 16)).astype(np.float32)
    ref = jhead.apply({"params": params, "batch_stats": stats}, jnp.asarray(feats),
                      train=False)
    with torch.no_grad():
        out = head.eval()(torch.from_numpy(feats))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=TOL)


def _timm_state_dict(dim=32, depth=2, mlp=64, grid=(4, 3), seed=0, prefix="model."):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.tensor(rng.normal(0, 0.1, s).astype(np.float32))
    sd = {"patch_embed.proj.weight": t(dim, 3, 16, 16), "patch_embed.proj.bias": t(dim),
          "pos_embed": t(1, grid[0] * grid[1], dim), "norm.weight": 1 + t(dim),
          "norm.bias": t(dim)}
    for i in range(depth):
        p = f"blocks.{i}."
        sd.update({p + "norm1.weight": 1 + t(dim), p + "norm1.bias": t(dim),
                   p + "attn.qkv.weight": t(3 * dim, dim), p + "attn.qkv.bias": t(3 * dim),
                   p + "attn.proj.weight": t(dim, dim), p + "attn.proj.bias": t(dim),
                   p + "norm2.weight": 1 + t(dim), p + "norm2.bias": t(dim),
                   p + "mlp.fc1.weight": t(mlp, dim), p + "mlp.fc1.bias": t(mlp),
                   p + "mlp.fc2.weight": t(dim, mlp), p + "mlp.fc2.bias": t(dim)})
    return {prefix + k: v for k, v in sd.items()}


def test_timm_import_matches_jax():
    """A timm ViT state dict at the tiny geometry: the port's backbone
    after the port's import against JAX's after JAX's, within 1e-5; the
    import fills every trunk tensor."""
    sd = _timm_state_dict()
    params = jax_import.import_timm_vit_params(_np(sd), depth=2)
    jvit = JaxViT(img_size=(64, 48), patch_size=16, embed_dim=32, depth=2, num_heads=2,
                  mlp_ratio=2.0, dtype=jnp.float32)
    vit = ViTBackbone(img_size=(64, 48), embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0,
                      dtype=torch.float32)
    vit.load_state_dict(_strip(torch_import.import_timm_vit_state_dict(sd, depth=2),
                               "backbone."), strict=True)
    x = np.random.default_rng(1).random((2, 64, 48, 3), dtype=np.float32)
    ref = jvit.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = vit(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)


@pytest.mark.parametrize("regs,linear", [(2, False), (1, True)],
                         ids=["registers", "linear-patchifier"])
def test_radio_import_matches_jax(regs, linear):
    """A RADIO-style checkpoint (class and register tokens with their
    pos-embed rows, the 4 x 4 grid resampled to the model's 4 x 3, a token
    MLP adapter; or a linear patchifier) through each package's import
    into a frozen, exact-GELU trunk with prefix tokens: outputs within
    1e-5."""
    torch.manual_seed(regs)
    tm = _TorchRadioViT(regs=regs).eval()
    adapter = nn.Sequential(nn.Linear(32, 24), nn.ReLU(), nn.Linear(24, 32))
    sd = {k: v.detach() for k, v in tm.state_dict().items()}
    sd.update({f"mlp.{k}": v.detach() for k, v in adapter.state_dict().items()})
    if linear:
        w = sd.pop("patch_embed.proj.weight")
        sd["patch_embed.proj.weight"] = w.reshape(w.shape[0], -1)
    kw = dict(depth=2, src_grid=(4, 4), dst_grid=(4, 3), num_prefix_tokens=1,
              num_register_tokens=regs)
    params = jax_import.import_radio_vit_params(_np(sd), **kw)
    params.update(jax_import.import_radio_adapter_params(_np(sd)))
    geometry = dict(img_size=(32, 24), patch_size=8, embed_dim=32, depth=2, num_heads=2,
                    num_prefix_tokens=1 + regs, exact_gelu=True, adapter_hidden=(24, 32))
    jvit = JaxViT(dtype=jnp.float32, frozen=True, **geometry)
    vit = ViTBackbone(dtype=torch.float32, frozen=True, mlp_ratio=4.0, **geometry)
    imported = {**torch_import.import_radio_vit_state_dict(sd, **kw),
                **torch_import.import_radio_adapter_state_dict(sd)}
    vit.load_state_dict(_strip(imported, "backbone."), strict=True)
    x = np.random.default_rng(2).normal(size=(2, 32, 24, 3)).astype(np.float32)
    ref = jvit.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = vit(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_radio_input_stats_match_jax():
    sd = {"input_conditioner.norm_mean": torch.tensor([[[0.48]], [[0.46]], [[0.41]]]),
          "input_conditioner.norm_std": torch.tensor([[[0.27]], [[0.26]], [[0.28]]])}
    mean, std = torch_import.radio_input_stats(sd)
    ref = jax_import.radio_input_stats(_np(sd))
    np.testing.assert_array_equal(mean, ref[0])
    np.testing.assert_array_equal(std, ref[1])
    assert torch_import.radio_input_stats({}) is None


# --------------------------------------------------------------------------
# export


def test_export_round_trip_is_exact_and_matches_jax():
    """The port's model (a conv stage in the head) exported and imported
    back gives every tensor bit for bit, and the export equals the JAX
    package's export of the same weights."""
    _export_round_trip(dict(TINY_CFG, conv_out_channels=(8,), conv_kernel_sizes=(3,)))


def test_export_round_trip_takes_deconv_kernels_2_and_3():
    """The same with deconv kernel sizes 2 and 3, whose weights flip as
    k = 4's do."""
    _export_round_trip(dict(TINY_CFG, deconv_kernel_sizes=(2, 3)))


def _export_round_trip(kw):
    _, variables, pm = init_pair(kw)
    sd = pm.state_dict()
    trunk = torch_export.export_timm_vit_state_dict(sd)
    head = torch_export.export_head_state_dict(sd, prefix="head.")
    back = {**torch_import.import_timm_vit_state_dict(trunk, depth=2),
            **torch_import.import_head_state_dict(head, num_deconv=2,
                                                   num_conv=len(kw.get("conv_out_channels", ())),
                                                   num_pool_stages=2, prefix="head.")}
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    params, stats = variables["params"], variables["batch_stats"]
    ref = {**jax_export.export_timm_vit_params(params["backbone"]),
           **jax_export.export_head_params(params["head"], stats["head"], prefix="head.")}
    ours = {**trunk, **head}
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("over", [
    dict(lora_rank=2), dict(num_prefix_tokens=1), dict(adapter_hidden=(16,)),
], ids=["lora", "prefix_tokens", "adapters"])
def test_export_refuses_what_timm_lacks(over):
    """LoRA deltas, prefix tokens and adapters have no timm counterpart, as
    the JAX exporter says."""
    sd = build_model(ModelConfig(**dict(TINY_CFG, **over)), device="cpu").state_dict()
    with pytest.raises(ValueError, match="no timm counterpart"):
        torch_export.export_timm_vit_state_dict(sd)


# --------------------------------------------------------------------------
# the CLIs


def _tiny_config(path, **over):
    cfg = TrainConfig.from_dict(dict(RAW, **over))
    cfg.save(path)
    return cfg


def test_convert_cli_head_only(tmp_path):
    """A reference head save through `compat.convert --head-only --device
    cpu`: load_predictor takes the step-0 checkpoint with the head's
    weights in place, and the saved config resumes."""
    model = dict(TINY_CFG, deconv_out_channels=(8, 8), normalize=None)
    cfg_path = tmp_path / "cfg.json"
    _tiny_config(cfg_path, model=model)
    torch.manual_seed(0)
    tm = _torch_head(in_ch=32, out_ch=5, deconv=(8, 8), pools=((2, 2), (2, 2)))
    torch.save(tm.state_dict(), tmp_path / "head.pth")
    out = tmp_path / "imported"
    convert.main(["--torch-checkpoint", str(tmp_path / "head.pth"), "--config", str(cfg_path),
                  "--out", str(out), "--head-only", "--device", "cpu"])
    assert json.loads((out / "config.json").read_text())["resume"] is True
    pred = load_predictor(out / "checkpoints", device="cpu")
    assert torch.equal(pred.model.head.final.weight, tm.final_layer.weight)
    assert torch.equal(pred.model.head.deconv_bns[1].running_var,
                       tm.deconv_layers[4].running_var)


def test_convert_cli_full_model_imports_trunk_and_head(tmp_path):
    """A full-model save (timm trunk under `backbone.model.`, the head
    under `head.`): both land in the checkpoint."""
    cfg_path = tmp_path / "cfg.json"
    cfg = _tiny_config(cfg_path, model=dict(TINY_CFG, normalize=None))
    torch.manual_seed(1)
    tm = _torch_head(in_ch=32, out_ch=5, deconv=(16, 16), pools=((2, 2), (2, 2)))
    sd = {**_timm_state_dict(prefix="backbone.model."),
          **{f"head.{k}": v for k, v in tm.state_dict().items()}}
    torch.save(sd, tmp_path / "full.pth")
    out = tmp_path / "imported"
    convert.main(["--torch-checkpoint", str(tmp_path / "full.pth"), "--config", str(cfg_path),
                  "--out", str(out), "--device", "cpu"])
    params = CheckpointManager(out / "checkpoints").read(0)["params"]
    assert torch.equal(params["backbone.blocks.1.mlp.fc2.weight"],
                       sd["backbone.model.blocks.1.mlp.fc2.weight"])
    assert torch.equal(params["head.branches.oks.final.weight"], tm.oks_layers[8].weight)
    assert cfg.model.backbone == TrainConfig.load(out / "config.json").model.backbone


def test_radio_only_convert_then_train(tmp_path):
    """`compat.convert --radio-checkpoint` with no head writes a step-0
    checkpoint (the imported frozen trunk, a seeded head); the training
    CLI resumes from it and trains one step on the CPU, after which the
    trunk is bit for bit the import and the adapter and head have moved."""
    dim, depth, grid, regs = 64, 2, 4, 2
    rng = np.random.default_rng(0)
    t = lambda *s: torch.tensor(rng.normal(0, 0.02, s).astype(np.float32))
    sd = {"model.patch_embed.proj.weight": t(dim, 3, 16, 16),
          "model.patch_embed.proj.bias": t(dim), "model.cls_token": t(1, 1, dim),
          "model.reg_token": t(1, regs, dim),
          "model.pos_embed": t(1, 1 + regs + grid * grid, dim),
          "model.norm.weight": t(dim), "model.norm.bias": t(dim),
          "mlp.0.weight": t(24, dim), "mlp.0.bias": t(24),
          "mlp.2.weight": t(dim, 24), "mlp.2.bias": t(dim)}
    sd.update({k.replace("model.", "model.", 1): v
               for k, v in _timm_state_dict(dim, depth, 2 * dim).items()
               if k.startswith("model.blocks.")})
    torch.save(sd, tmp_path / "radio.pth")
    model = dict(TINY_CFG, backbone="vit-nano", frozen_backbone=True, adapter_hidden=(24, dim),
                 num_prefix_tokens=1 + regs, exact_gelu=True)
    cfg_path = tmp_path / "cfg.json"
    _tiny_config(cfg_path, model=model, dataset_format="synthetic", num_workers=1,
                 val_every=1000, resume=True)
    out = tmp_path / "imported"
    convert.main(["--radio-checkpoint", str(tmp_path / "radio.pth"), "--radio-src-grid",
                  str(grid), str(grid), "--radio-registers", str(regs), "--config",
                  str(cfg_path), "--out", str(out), "--device", "cpu"])
    imported = CheckpointManager(out / "checkpoints").read(0)["params"]
    want = torch_import.import_radio_vit_state_dict(
        sd, depth=depth, src_grid=(grid, grid), dst_grid=(4, 3), num_prefix_tokens=1,
        num_register_tokens=regs, prefix="model.")
    for k, v in want.items():
        assert torch.equal(imported[k], v), k
    assert torch.equal(imported["backbone.adapters.1.weight"], sd["mlp.2.weight"])
    train_cli.main([str(out), "--config", str(out / "config.json"), "--max-steps", "1",
                    "--device", "cpu"])
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite([x["training/loss"] for x in lines if "training/loss" in x]).all()
    trained = CheckpointManager(out / "checkpoints").read(1)["params"]
    for k, v in trained.items():
        trunk = k.startswith("backbone.") and "adapters" not in k
        moved = not torch.equal(v, imported[k])
        # the visibility branch's loss weight is 0: its zero biases get no
        # gradient, and weight decay cannot move a zero
        idle = k.startswith("head.branches.visibility.") and not imported[k].any()
        assert moved != (trunk or idle), k


def test_torch_export_cli(tmp_path):
    """`compat.torch_export` on a port checkpoint writes backbone.pth and
    head.pth that import back to the checkpoint's tensors; a LoRA run is
    refused until merged."""
    from probpose_pytorch_tpu_torch.train.loop import Trainer

    run = tmp_path / "run"
    cfg = _tiny_config(tmp_path / "cfg.json", out_dir=str(run))
    trainer = Trainer.create(cfg, 1, device="cpu")
    cfg.save(run.mkdir(parents=True) or run / "config.json")
    CheckpointManager(run / "checkpoints").save(0, trainer.state)
    torch_export.main(["--checkpoint", str(run / "checkpoints"), "--out", str(tmp_path / "x")])
    trunk = torch.load(tmp_path / "x" / "backbone.pth", weights_only=True)
    head = torch.load(tmp_path / "x" / "head.pth", weights_only=True)
    back = {**torch_import.import_timm_vit_state_dict(trunk, depth=2),
            **torch_import.import_head_state_dict(head, num_pool_stages=2)}
    sd = trainer.model.state_dict()
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    _tiny_config(run / "config.json", model=LORA_CFG)
    with pytest.raises(ValueError, match="merge_lora"):
        torch_export.main(["--checkpoint", str(run / "checkpoints"), "--out",
                           str(tmp_path / "y")])
