"""The port's pipeline parallelism against the JAX package's pipelined
programs, on the CPU.

World-free (this process): circular_chunk_order and pick_microbatches,
the sequential fallbacks, the errors, the stacked trunk's initialisation,
its block against JAX's, and stacked JAX parameters read both ways
(compat/from_jax.py).

In a 4-rank gloo world (tests/torch_mp_worker.py, one deadline, the JAX
references computed here while the ranks run, on meshes of the same shape
drawn from the 8 virtual CPU devices of tests/conftest.py; a depth-4 tiny
ViT, so that S = 2, S = 4 and S V = 4 divide it): GPipe's forward and
gradients (microbatch counts, a pipe-only mesh, remat, TP inside a
stage), 1F1B (JAX's edge geometries, bf16 activations, dx chained into an
embedding, TP inside a stage with the toy Megatron block and with the ViT
block's head-major K1 plain version), the interleaved schedule (JAX's
(S, V, M, B) cases, aux, V = 1 against plain 1F1B), the train step on
pipe and pipe x model meshes with GPipe and 1F1B against JAX's trainer, a
per-block checkpoint resumed onto a pipe mesh and back, the training CLI
with pipeline_parallel=2 against JAX's CLI, the predictor on a pipe mesh
against JAX's, and LoRA on a model-parallel mesh against JAX's.

Tolerances, stated at each assert, are those of JAX's own tests of the
same functions (tests/test_pipeline_parallel.py, test_pipeline_interleaved.py)
and of tests/test_torch_parallel.py: losses rtol 1e-5, predictions 1e-4,
the train state at `_check_step`'s bounds.
"""

import contextlib
import dataclasses
import functools
import io
import json
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from probpose_pytorch_tpu.compat import layouts as jax_layouts
from probpose_pytorch_tpu.inference import TopDownPredictor as JaxPredictor
from probpose_pytorch_tpu.models import model as jax_model
from probpose_pytorch_tpu.models import vit as jax_vit
from probpose_pytorch_tpu.parallel import make_mesh as jax_make_mesh
from probpose_pytorch_tpu.parallel import pipeline as jax_pp
from probpose_pytorch_tpu.train import Trainer as JaxTrainer
from probpose_pytorch_tpu.train import cli as jax_cli
from probpose_pytorch_tpu.train.config import TrainConfig as JaxTrainConfig
from probpose_pytorch_tpu_torch.compat.from_jax import load_jax_variables, state_dict_from_jax
from probpose_pytorch_tpu_torch.compat.layouts import stack_state_dict, unstack_state_dict
from probpose_pytorch_tpu_torch.models import vit
from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model
from probpose_pytorch_tpu_torch.parallel import pipeline as pp
from probpose_pytorch_tpu_torch.train import TrainConfig, Trainer
from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
from probpose_pytorch_tpu_torch.train.loop import layout_metadata, restore_state_with_layout
from test_torch_models import peaked_variables
from test_torch_parallel import _batch, _check_step, _jax_steps, _port_checkpoint
from torch_mp_worker import start_world, wait_world

torch.set_num_threads(2)

TINY = dict(embed_dim=64, depth=4, num_heads=2, mlp_ratio=2.0)
for _presets in (jax_vit.ViTConfig.PRESETS, vit.ViTConfig.PRESETS):
    _presets.setdefault("vit-tiny-pp", TINY)
MODEL = dict(img_size=(64, 48), num_keypoints=5, backbone="vit-tiny-pp",
             compute_dtype="float32", deconv_out_channels=(32, 32),
             deconv_kernel_sizes=(4, 4), pool_sizes=((2, 2), (2, 2)), normalize=1.0)
SPE = 4
WORLD = 4
# The world fixture's wait for JAX's CLI thread, from its start: past it
# the fixture raises (the thread is a daemon), and the ranks' own deadline
# (tests/torch_mp_worker.py) is counted from there.
CLI_DEADLINE_S = 600.0


class StandIn:
    """A world-free mesh of a given shape, rank 0 on every axis."""

    def __init__(self, **shape):
        self.mesh_dim_names = tuple(shape)
        self.mesh = torch.zeros(*shape.values())

    def get_group(self, name):
        return None

    def get_coordinate(self):
        return [0] * len(self.mesh_dim_names)


def _jax_cfg(out, model=None, **kw) -> JaxTrainConfig:
    return JaxTrainConfig(model=jax_model.ModelConfig(**{**MODEL, **(model or {})}), epochs=1,
                          train_batch_size=8, augment=None, out_dir=str(out), **kw)


# ------------------------------------------------------------------ toys

def _jax_toy(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def _jax_bf16(p, h):
    return jnp.tanh(h @ p["w"].astype(jnp.bfloat16) + p["b"].astype(jnp.bfloat16))


def _jax_tp(p, h):
    u = jnp.tanh(jax_pp.tp_enter(h, "model") @ p["w1"])
    return h + jax_pp.tp_leave(u @ p["w2"], "model") + p["b"]


def _jax_tp_seq(p, h):
    return h + jnp.tanh(h @ p["w1"]) @ p["w2"] + p["b"]


def _jax_loss(name):
    mse = lambda lp, h, t: jnp.mean((h @ lp["w"] - t) ** 2)  # noqa: E731
    if name == "bf16":
        return lambda lp, h, t: jnp.mean((h.astype(jnp.float32) @ lp["w"] - t) ** 2)
    if name == "aux":
        def aux(lp, h, t):
            loss = mse(lp, h, t)
            return loss, {"h_mean": jnp.mean(h), "loss_copy": loss}
        return aux
    return mse


TP_SPECS = {"w1": ["pipe", None, "model"], "w2": ["pipe", "model", None], "b": ["pipe"]}


def _toy_cases() -> tuple[list, dict]:
    """(the cases, their numpy inputs keyed "<case>/<name>"): JAX's test
    geometries on the 4-rank world."""
    cases, arrays = [], {}
    rng = np.random.RandomState(0)

    def add(name, kind, pipe, depth, B, m=0, model=1, block="toy", **kw):
        case = dict(name=name, kind=kind, pipe=pipe, model=model, depth=depth, m=m,
                    block=block, **kw)
        cases.append(case)
        a = {}
        if block == "vit":  # the stacked leaves' shapes, at a LeCun-like scale
            for k, shape in vit._stacked_shapes(depth, 64, 128).items():
                fan = shape[1] if len(shape) == 3 else 1
                w = rng.randn(*shape) / np.sqrt(fan) if fan > 1 else 0.05 * rng.randn(*shape)
                a[f"p_{k}"] = (w + (k.endswith("_scale"))).astype(np.float32)
            a["x"] = rng.randn(B, 12, 64).astype(np.float32) * 0.5
        elif block == "tp":
            a["p_w1"] = (rng.randn(depth, 8, 16) * 0.3).astype(np.float32)
            a["p_w2"] = (rng.randn(depth, 16, 8) * 0.3).astype(np.float32)
            a["p_b"] = (rng.randn(depth, 8) * 0.1).astype(np.float32)
            a["x"] = rng.randn(B, 5, 8).astype(np.float32)
        else:
            a["p_w"] = (rng.randn(depth, 8, 8) * 0.3).astype(np.float32)
            a["p_b"] = (rng.randn(depth, 8) * 0.1).astype(np.float32)
            a["x"] = rng.randn(B, 5, 8).astype(np.float32)
        if kind != "gpipe":
            dim = a["x"].shape[-1]
            a["lp_w"] = (rng.randn(dim, 3) * 0.4).astype(np.float32)
            a["t"] = rng.randn(*a["x"].shape[:-1], 3).astype(np.float32)
        if kw.get("embed"):
            a["ep_w"] = (rng.randn(6, 8) * 0.4).astype(np.float32)
            a["x"] = rng.randn(B, 5, 6).astype(np.float32)
        if kind == "interleaved":  # the circular layout the engine shards
            order = np.asarray(pp.circular_chunk_order(depth, pipe, kw["v"]))
            for k in [k for k in a if k.startswith("p_")]:
                a[k] = a[k][order]
        arrays.update({f"{name}/{k}": v for k, v in a.items()})

    add("g_s2", "gpipe", 2, 4, 16)
    for m in (1, 2, 8):
        add(f"g_m{m}", "gpipe", 4, 4, 16, m=m)
    add("g_vit", "gpipe", 4, 4, 8, block="vit", heads=2, attn="fused")
    add("g_vit_remat", "gpipe", 4, 4, 8, block="vit", heads=2, attn="fused", remat=True)
    add("g_vit_tp", "gpipe", 2, 4, 8, model=2, block="vit", heads=2, attn="fused_tp",
        specs=jax_vit.stacked_param_specs())
    add("f_s2", "1f1b", 2, 4, 16)
    add("f_s4", "1f1b", 4, 4, 16)
    for i, (S, m, B) in enumerate(((4, 3, 24), (2, 5, 20), (4, 2, 16), (2, 10, 40))):
        add(f"f_edge{i}", "1f1b", S, 8, B, m=m)
    add("f_bf16", "1f1b", 4, 4, 16, x_dtype="bfloat16", block="bf16", loss="bf16")
    add("f_embed", "1f1b", 4, 4, 16, embed=True)
    add("f_tp", "1f1b", 2, 4, 16, model=2, block="tp", specs=TP_SPECS)
    add("f_vit_tp", "1f1b", 2, 4, 8, model=2, block="vit", heads=2, attn="fused_tp",
        specs=jax_vit.stacked_param_specs())
    add("f_v1", "1f1b", 2, 4, 16, m=4)
    for i, (S, V, m, B) in enumerate(((2, 2, 4, 16), (4, 2, 8, 16), (2, 4, 4, 16),
                                      (2, 2, 3, 12), (2, 2, 7, 28))):
        add(f"i_{i}", "interleaved", S, S * V * 2, B, m=m, v=V)
    add("i_v1", "interleaved", 2, 4, 16, m=4, v=1)
    add("i_aux", "interleaved", 2, 8, 16, m=4, v=2, aux=True, loss="aux")
    # f_v1 and i_v1 share their inputs: V = 1 is plain 1F1B
    for k in [k for k in arrays if k.startswith("f_v1/")]:
        arrays["i_v1/" + k[5:]] = arrays[k]
    for c in cases:
        if "specs" in c:
            c["specs"] = {k: list(v) for k, v in c["specs"].items()}
    return cases, arrays


def _jax_case(case, arrays) -> dict:
    """JAX's outputs of one toy case, whole, as numpy."""
    name, S, mp = case["name"], case["pipe"], case["model"]
    mesh = jax_make_mesh(WORLD, mp, pipeline_parallel=S)
    a = {k[len(name) + 1:]: v for k, v in arrays.items() if k.startswith(name + "/")}
    stacked = {k[2:]: jnp.asarray(v) for k, v in a.items() if k.startswith("p_")}
    x = jnp.asarray(a["x"])
    if case.get("x_dtype") == "bfloat16":
        x = x.astype(jnp.bfloat16)
    specs = ({k: P(*v) for k, v in case["specs"].items()} if "specs" in case else None)
    seq = None
    if case["block"] == "vit":
        block, seq, _ = jax_vit.pp_block_fns(
            num_heads=case["heads"], mlp_ratio=2.0, embed_dim=64, dtype=jnp.float32,
            attn_impl=case["attn"], tp=mp, remat=case.get("remat", False),
            vjp_boundaries=case["kind"] != "gpipe")
    else:
        block = {"toy": _jax_toy, "bf16": _jax_bf16, "tp": _jax_tp}[case["block"]]
        seq = _jax_tp_seq if case["block"] == "tp" else None
    out = {}
    if case["kind"] == "gpipe":
        run = lambda p: jax_pp.pipeline_spmd(block, p, x, mesh, microbatches=case["m"],  # noqa
                                             param_specs=specs, seq_block_fn=seq)
        reduce_ = (lambda o: jnp.mean(o ** 2)) if case["block"] == "vit" else (
            lambda o: jnp.sum(o ** 2))
        value, grads = jax.jit(lambda p: (run(p), jax.grad(lambda q: reduce_(run(q)))(p)))(
            stacked)
        out["out"] = np.asarray(value)
        out.update({f"g_{k}": np.asarray(v) for k, v in grads.items()})
        return out
    lp = {"w": jnp.asarray(a["lp_w"])}
    t = jnp.asarray(a["t"])
    loss_fn = _jax_loss(case.get("loss", "mse"))
    kw = dict(microbatches=case["m"], param_specs=specs, seq_block_fn=seq,
              loss_has_aux=case.get("aux", False),
              model_axis="model" if mp > 1 else None)
    engine = (jax_pp.pipeline_1f1b if case["kind"] == "1f1b" else functools.partial(
        jax_pp.pipeline_1f1b_interleaved, virtual=case["v"]))

    def run(p, lp, x, t):
        return engine(block, p, loss_fn, lp, x, t, mesh, **kw)

    embed = None
    if case.get("embed"):
        ep = {"w": jnp.asarray(a["ep_w"])}
        x, embed = jax.vjp(lambda e: jnp.tanh(jnp.asarray(a["x"]) @ e["w"]), ep)
    got = jax.jit(run)(stacked, lp, x, t)
    loss, d_p, d_lp, dx = got[:4]
    out["loss"] = np.asarray(loss)
    out.update({f"g_{k}": np.asarray(v) for k, v in d_p.items()})
    out["dlp_w"] = np.asarray(d_lp["w"])
    out["dx"] = np.asarray(dx, np.float32)
    out["dx_dtype"] = str(dx.dtype)
    if case.get("aux"):
        out.update({f"aux_{k}": np.asarray(v) for k, v in got[4].items()})
    if embed is not None:
        out["dep_w"] = np.asarray(embed(dx)[0]["w"])
    return out


# ------------------------------------------------------------------ the world

def _mesh_trainer(cfg, mp, pipe, tmp):
    trainer = JaxTrainer.create(dataclasses.replace(cfg, out_dir=str(tmp / "jax")), SPE,
                                mesh=jax_make_mesh(WORLD, mp, pipeline_parallel=pipe))
    return trainer, jax.device_get(trainer.state)


def _step_scenario(job, tmp, name, batch, *, mp, pipe, steps=1, model=None, **kw):
    jcfg = _jax_cfg(tmp / name, model, **kw)
    trainer, state0 = _mesh_trainer(jcfg, mp, pipe, tmp / name)
    # JAX's state as a per-block port checkpoint, its qkv columns in the
    # layout JAX's trainer gave them (head-major where it made "fused_tp")
    meta = dict(layout_metadata(TrainConfig.from_json(trainer.cfg.to_json())),
                trunk_layout="per_block")
    ckpt = _port_checkpoint(job, name, jcfg, state0, metadata=meta)
    ref = dict(jcfg=jcfg, attn_impl=trainer.cfg.model.attn_impl,
               pp_stages=trainer.cfg.model.pp_stages)

    def finish():
        ref["losses"], ref["states"] = _jax_steps(trainer, batch, steps)

    ref["finish"] = finish
    return ref, dict(kind="step", config=f"{name}.json", checkpoint=ckpt, batch="batch.npz",
                     steps=steps, steps_per_epoch=SPE, model_parallel=mp,
                     pipeline_parallel=pipe, with_layout=True)


def _cli_config(path: Path) -> JaxTrainConfig:
    cfg = JaxTrainConfig(
        model=jax_model.ModelConfig(**{**MODEL, "deconv_out_channels": (16, 16)}), epochs=1,
        train_batch_size=8, val_batch_size=8, val_every=1000, dataset_format="synthetic",
        num_workers=1, pipeline_parallel=2, augment=None, log_every=1)
    cfg.save(path)
    return cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every scenario's JAX reference and the 4-rank world's results."""
    tmp = tmp_path_factory.mktemp("pipeline")
    job = tmp / "job"
    job.mkdir()
    batch = _batch()
    np.savez(job / "batch.npz", **batch)
    refs, scenarios = {}, {}

    def add(name, ref, spec):
        refs[name], scenarios[name] = ref, spec

    cases, arrays = _toy_cases()
    assert [c["name"] for c in cases] == TOY_NAMES
    np.savez(job / "toy.npz", **arrays)
    toy = {}
    toy["finish"] = lambda: toy.update({c["name"]: _jax_case(c, arrays) for c in cases})
    add("toy", toy, dict(kind="pp_toy", inputs="toy.npz", cases=cases))

    # the train step: GPipe and 1F1B on (data 2, pipe 2) and (model 2, pipe 2)
    add("gpipe_dp", *_step_scenario(job, tmp, "gpipe_dp", batch, mp=1, pipe=2,
                                    model=dict(attn_impl="fused")))
    add("gpipe_tp", *_step_scenario(job, tmp, "gpipe_tp", batch, mp=2, pipe=2,
                                    model=dict(attn_impl="fused")))
    add("f1b_dp", *_step_scenario(job, tmp, "f1b_dp", batch, mp=1, pipe=2,
                                  model=dict(attn_impl="fused", pp_microbatches=2),
                                  pipeline_schedule="1f1b"))
    # (JAX's init sample of one row meets this mesh's data axis of 1: the
    # automatic microbatch count, 8 here)
    add("f1b_tp", *_step_scenario(job, tmp, "f1b_tp", batch, mp=2, pipe=2,
                                  model=dict(attn_impl="fused"), pipeline_schedule="1f1b"))
    # LoRA deltas on a (data 2, model 2) mesh: two steps, so that `a` moves
    add("lora_tp", *_step_scenario(job, tmp, "lora_tp", batch, mp=2, pipe=1, steps=2,
                                   model=dict(attn_impl="fused", lora_rank=2)))

    # a per-block checkpoint after one single-device step, resumed onto a
    # (data 2, pipe 2) trainer for a step and saved there (stacked)
    jcfg = _jax_cfg(tmp / "layout", dict(attn_impl="fused"))
    jtr = JaxTrainer.create(jcfg, SPE)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    s1, _ = jtr.train_step(jtr.state, jb)
    ckpt = _port_checkpoint(job, "layout", jcfg, jax.device_get(s1),
                            metadata=layout_metadata(TrainConfig.from_json(jcfg.to_json())))
    layout = {"jcfg": jcfg}

    def layout_finish(s1=s1):
        s2, m2 = jtr.train_step(s1, jb)
        _, m3 = jtr.train_step(s2, jb)
        layout.update(loss2=float(m2["loss"]), loss3=float(m3["loss"]))

    layout["finish"] = layout_finish
    add("layout", layout, dict(kind="step", config="layout.json", checkpoint=ckpt,
                               batch="batch.npz", steps=1, steps_per_epoch=SPE,
                               model_parallel=1, pipeline_parallel=2, with_layout=True,
                               save_to="layout_pp"))

    # the predictor on a (data 2, pipe 2) mesh, from its checkpoint and from
    # a single-device model
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (8, 100, 120, 3), dtype=np.uint8)
    boxes = rng.uniform([0, 0, 40, 50], [50, 40, 70, 60], (8, 4)).astype(np.float32)
    np.savez(job / "frames.npz", frames=frames, boxes=boxes)
    jcfg = _jax_cfg(tmp / "predict", dict(attn_impl="fused"))
    jtr = JaxTrainer.create(jcfg, 1)
    variables = peaked_variables({"params": jtr.state.params,
                                  "batch_stats": jtr.state.batch_stats})
    pck = _port_checkpoint(job, "predict", jcfg, jax.device_get(jtr.state).replace(
        params=variables["params"], batch_stats=variables["batch_stats"]))
    pred = {}
    pred["finish"] = lambda: pred.update(out=JaxPredictor(
        model=jtr.model, variables=variables, codec=jtr.encode_codec,
        input_size=MODEL["img_size"], mesh=jax_make_mesh(WORLD, 1, pipeline_parallel=2))(
        frames, boxes))
    add("predict", pred, dict(kind="predict", checkpoint=pck, config="predict.json",
                              inputs="frames.npz", model_parallel=1, pipeline_parallel=2,
                              from_model=True))

    # the training CLI with pipeline_parallel=2: the port's over the world
    # (data 2, pipe 2) from a checkpoint of JAX's initial state, JAX's CLI on
    # its 8 devices (data 4, pipe 2)
    ccfg = _cli_config(job / "cli.json")
    state0 = jax.device_get(JaxTrainer.create(
        dataclasses.replace(ccfg, out_dir=str(tmp / "cli_init")), 400,
        mesh=jax_make_mesh(WORLD, 1, pipeline_parallel=2)).state)
    TrainConfig.from_json(ccfg.to_json()).save(job / "cli_port.json")
    _port_checkpoint(job, "cli_init", ccfg, state0)
    (job / "cli_run").mkdir()
    (job / "cli_init_ckpt").rename(job / "cli_run" / "checkpoints")
    cli = {}

    def jax_cli_run(cli=cli):
        out = tmp / "cli_jax"
        with contextlib.redirect_stdout(io.StringIO()):
            jax_cli.main([str(out), "--config", str(job / "cli.json"), "--max-steps", "2"])
        cli["losses"] = [json.loads(line)["training/loss"] for line in
                         (out / "metrics.jsonl").read_text().splitlines()
                         if "training/loss" in line]

    cli["finish"] = jax_cli_run
    add("cli", cli, dict(kind="train_cli", args=["@cli_run", "--config", "@cli_port.json",
                                                 "--max-steps", "2", "--device", "cpu"]))

    (job / "job.json").write_text(json.dumps({"presets": {"vit-tiny-pp": TINY},
                                              "scenarios": scenarios}))
    handle = start_world(job, WORLD)
    # JAX's CLI run beside the other references (it compiles while they run)
    cli_thread = threading.Thread(target=refs["cli"].pop("finish"), daemon=True)
    cli_deadline = time.monotonic() + CLI_DEADLINE_S
    cli_thread.start()
    try:
        for ref in refs.values():
            ref.pop("finish", lambda: None)()
    finally:
        cli_thread.join(timeout=max(1.0, cli_deadline - time.monotonic()))
        wait_world(handle)
    if cli_thread.is_alive():
        raise RuntimeError(f"JAX's training CLI did not end within {CLI_DEADLINE_S:.0f} s")
    return SimpleNamespace(job=job, refs=refs, size=WORLD, cases=cases)


def _ranks(world, name):
    return [json.loads((world.job / name / f"rank{r}.json").read_text())
            for r in range(world.size)]


def _coords(rank: int, case: dict) -> dict:
    S, M = case["pipe"], case["model"]
    return dict(pipe=rank % S, model=(rank // S) % M, data=rank // (S * M),
                dp=WORLD // (S * M))


def _slice(a: np.ndarray, spec, co: dict, case: dict) -> np.ndarray:
    sizes = dict(pipe=case["pipe"], model=case["model"])
    for dim, ax in enumerate(spec):
        if ax is not None and sizes.get(ax, 1) > 1:
            n = a.shape[dim] // sizes[ax]
            a = np.take(a, np.arange(co[ax] * n, (co[ax] + 1) * n), axis=dim)
    return a


# JAX's tolerances per case: (loss rtol, grads rtol, grads atol)
def _tols(case: dict) -> tuple[float, float, float]:
    if case.get("x_dtype") == "bfloat16":
        return 1e-3, 2e-2, 2e-3  # test_bf16_activations
    if case["block"] == "vit":
        return 1e-5, 5e-4, 2e-5  # the ViT block in stages
    if case["block"] == "tp":
        return 1e-5, 2e-5, 2e-6  # test_tensor_parallel_stages
    if case["kind"] == "interleaved":
        return 1e-5, 2e-5, 1e-6
    return 1e-5, 1e-5, 1e-6


TOY_NAMES = ["g_s2", "g_m1", "g_m2", "g_m8", "g_vit", "g_vit_remat", "g_vit_tp", "f_s2", "f_s4",
             "f_edge0", "f_edge1", "f_edge2", "f_edge3", "f_bf16", "f_embed", "f_tp",
             "f_vit_tp", "f_v1", "i_0", "i_1", "i_2", "i_3", "i_4", "i_v1", "i_aux"]


@pytest.mark.parametrize("name", TOY_NAMES)
def test_engine_matches_jax(world, name):
    """One engine case on every rank against JAX's program on a mesh of
    the same shape: GPipe's output rows (rtol and atol 1e-6; the ViT block
    2e-5) and its gradients; 1F1B's and the interleaved engine's loss, the
    rank's stage (and model slice) of the trunk gradients, the loss-side
    gradients and dx of its rows (and the embedding's gradient, aux), at
    JAX's tests' tolerances (`_tols`)."""
    case = next(c for c in world.cases if c["name"] == name)
    ref = world.refs["toy"][name]
    loss_rtol, rtol, atol = _tols(case)
    specs = case.get("specs", {})
    for r in range(world.size):
        got = dict(np.load(world.job / "toy" / f"rank{r}.npz"))
        got = {k[len(name) + 1:]: v for k, v in got.items() if k.startswith(name + "/")}
        co = _coords(r, case)
        rows = lambda a: np.array_split(a, co["dp"])[co["data"]]  # noqa: E731
        for k in [k for k in ref if k.startswith("g_")]:
            want = _slice(ref[k], specs.get(k[2:], ["pipe"]), co, case)
            np.testing.assert_allclose(got[k], want, rtol=rtol, atol=atol,
                                       err_msg=f"{k} rank {r}")
        if case["kind"] == "gpipe":
            tol = 2e-5 if case["block"] == "vit" else 1e-6
            np.testing.assert_allclose(got["out"], rows(ref["out"]), rtol=tol, atol=tol)
            continue
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=loss_rtol)
        np.testing.assert_allclose(got["dlp_w"], ref["dlp_w"], rtol=rtol, atol=atol)
        np.testing.assert_allclose(got["dx"], rows(ref["dx"]), rtol=rtol, atol=atol)
        assert str(got["dx_dtype"]).split(".")[-1] == ref["dx_dtype"]
        if "dep_w" in ref:
            np.testing.assert_allclose(got["dep_w"], ref["dep_w"], rtol=1e-5, atol=1e-6)
        for k in [k for k in ref if k.startswith("aux_")]:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5)


def test_interleaved_v1_is_plain_1f1b(world):
    """V = 1 reproduces plain 1F1B (JAX's rtol 1e-6, atol 1e-7): the port
    runs the same slots, so the outputs are equal."""
    for r in range(world.size):
        got = dict(np.load(world.job / "toy" / f"rank{r}.npz"))
        keys = [k[len("f_v1/"):] for k in got if k.startswith("f_v1/")]
        assert keys
        for k in keys:
            if k == "dx_dtype":
                continue
            np.testing.assert_allclose(got[f"i_v1/{k}"], got[f"f_v1/{k}"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["gpipe_dp", "gpipe_tp", "f1b_dp", "f1b_tp"])
def test_pipelined_train_step_matches_jax(world, name):
    """One step on a (data 2, pipe 2) and a (model 2, pipe 2) mesh, GPipe
    and 1F1B, == JAX's trainer on a mesh of that shape from the same
    state: the loss on every rank, every parameter, Adam's moments and the
    BatchNorm statistics, gathered into the per-block names (test_torch_
    parallel.py's `_check_step` bounds); the trunk staged (pp_stages from
    the mesh) and "fused" made "fused_tp" on the model axis, as JAX's."""
    ranks, out = _check_step(world, name)
    ref = world.refs[name]
    assert ranks[0]["attn_impl"] == ref["attn_impl"]
    assert ranks[0]["pp_stages"] == ref["pp_stages"] == 2
    assert any("running_var" in k for k in out)


def test_lora_on_model_parallel_mesh_matches_jax(world):
    """LoRA deltas (rank 2) on a (data 2, model 2) mesh, "fused" made
    "fused_tp": two steps == JAX's mesh steps (`_check_step`); the deltas
    stay whole, as JAX's _param_spec keeps them."""
    ranks, out = _check_step(world, "lora_tp")
    assert ranks[0]["attn_impl"] == "fused_tp"
    names = [k[len("param/"):] for k in out if k.startswith("param/")]
    whole = {n: out[f"param/{n}"].size for n in names}
    local = dict(zip(names, ranks[0]["param_numel"]))
    assert all(local[n] == whole[n] for n in names if "_lora." in n)
    assert any("_lora." in n for n in names)


def test_per_block_checkpoint_resumes_onto_pipe_mesh_and_back(world, tmp_path):
    """A single-device per-block checkpoint restores onto a (data 2, pipe
    2) trainer (restore_state_with_layout stacks the parameters and Adam's
    moments): its step's loss is JAX's uninterrupted second step's (rtol
    1e-5); the checkpoint that trainer saves is stacked (metadata and
    leaves) and restores onto a single-device per-block trainer, whose
    step gives JAX's third (rtol 1e-5)."""
    ref = world.refs["layout"]
    for r in _ranks(world, "layout"):
        np.testing.assert_allclose(r["losses"][0], ref["loss2"], rtol=1e-5)
    ckpt = CheckpointManager(world.job / "layout_pp")
    assert ckpt.read_metadata()["trunk_layout"] == "stacked"
    assert ckpt.read()["params"]["backbone.blocks.qkv_kernel"].shape[0] == TINY["depth"]
    cfg = TrainConfig.from_json(ref["jcfg"].to_json())
    trainer = Trainer.create(dataclasses.replace(cfg, out_dir=str(tmp_path)), SPE,
                             device="cpu")
    restore_state_with_layout(ckpt, trainer.state, trainer.cfg)
    assert trainer.state.host_step == 2
    _, m = trainer.train_step(trainer.state, trainer.device_batch(_batch()))
    np.testing.assert_allclose(float(m["loss"]), ref["loss3"], rtol=1e-5)


def test_training_cli_pipeline_parallel_matches_jax(world):
    """The training CLI with pipeline_parallel=2 over the world (data 2,
    pipe 2), resumed from a checkpoint of JAX's initial state, logs JAX's
    CLI losses on its (data 4, pipe 2) mesh, step for step (rtol 1e-5), and
    checkpoints the stacked trunk."""
    run = world.job / "cli_run"
    lines = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [line["training/loss"] for line in lines if "training/loss" in line]
    assert len(losses) == len(world.refs["cli"]["losses"]) == 2
    np.testing.assert_allclose(losses, world.refs["cli"]["losses"], rtol=1e-5)
    meta = CheckpointManager(run / "checkpoints").read_metadata()
    assert meta["trunk_layout"] == "stacked"


def test_predictor_on_pipe_mesh_matches_jax(world):
    """load_predictor(mesh=) on a (data 2, pipe 2) mesh serves through the
    GPipe forward (the trunk staged: each rank its 2 of 4 blocks), and so
    does a single-device model handed to TopDownPredictor(mesh=): every rank
    returns JAX's mesh predictor's outputs (rtol and atol 1e-4)."""
    ref = world.refs["predict"]["out"]
    for r in range(world.size):
        info = json.loads((world.job / "predict" / f"rank{r}.json").read_text())
        assert info["staged"] and info["model_staged"] == info["staged"]
        for path in (f"rank{r}.npz", f"model{r}.npz"):
            got = dict(np.load(world.job / "predict" / path))
            assert set(got) == set(ref)
            for k in ref:
                np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-4, atol=1e-4,
                                           err_msg=f"{k} {path}")


# ------------------------------------------------------------------ no world

@pytest.mark.parametrize("depth,S,V", [(8, 2, 2), (16, 4, 2), (16, 2, 4), (4, 2, 1), (6, 2, 2)])
def test_circular_chunk_order_matches_jax(depth, S, V):
    """JAX's order, its inverse a round trip, JAX's ValueError where S V
    does not divide the depth."""
    if depth % (S * V):
        with pytest.raises(ValueError, match="divisible"):
            pp.circular_chunk_order(depth, S, V)
        with pytest.raises(ValueError, match="divisible"):
            jax_pp.circular_chunk_order(depth, S, V)
        return
    order = pp.circular_chunk_order(depth, S, V)
    assert order == jax_pp.circular_chunk_order(depth, S, V)
    assert [order[i] for i in np.argsort(order)] == list(range(depth))


def test_pick_microbatches_matches_jax():
    for local in range(1, 41):
        for S in (1, 2, 4, 8):
            assert pp.pick_microbatches(local, S) == jax_pp.pick_microbatches(local, S)


def _toy_inputs(seed, depth=4, B=8):
    rng = np.random.RandomState(seed)
    stacked = {"w": (rng.randn(depth, 8, 8) * 0.3).astype(np.float32),
               "b": (rng.randn(depth, 8) * 0.1).astype(np.float32)}
    lp = {"w": (rng.randn(8, 3) * 0.4).astype(np.float32)}
    x = rng.randn(B, 5, 8).astype(np.float32)
    t = rng.randn(B, 5, 3).astype(np.float32)
    return stacked, lp, x, t


def _torch(tree):
    return {k: torch.from_numpy(v).requires_grad_() for k, v in tree.items()}


@pytest.mark.parametrize("engine", ["gpipe", "1f1b", "interleaved"])
def test_sequential_fallbacks_match_jax(engine):
    """With no pipe axis (mesh None) each engine runs the blocks in turn,
    JAX's sequential fallback: the output, loss and gradients (and aux) as
    JAX's with mesh=None (rtol 1e-5, atol 1e-6)."""
    stacked, lp, x, t = _toy_inputs(3)
    toy = lambda p, h: torch.tanh(h @ p["w"] + p["b"])  # noqa: E731
    mse = lambda l, h, tt: ((h @ l["w"] - tt) ** 2).mean()  # noqa: E731
    jst = {k: jnp.asarray(v) for k, v in stacked.items()}
    if engine == "gpipe":
        out = pp.pipeline_spmd(toy, _torch(stacked), torch.from_numpy(x), None)
        ref = jax_pp.pipeline_spmd(_jax_toy, jst, jnp.asarray(x), None)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
        return

    def aux_loss(l, h, tt):
        loss = mse(l, h, tt)
        return loss, {"h_mean": h.mean()}

    fn = pp.pipeline_1f1b if engine == "1f1b" else pp.pipeline_1f1b_interleaved
    jfn = jax_pp.pipeline_1f1b if engine == "1f1b" else jax_pp.pipeline_1f1b_interleaved
    got = fn(toy, _torch(stacked), aux_loss, _torch(lp), torch.from_numpy(x),
             torch.from_numpy(t), None, loss_has_aux=True)
    ref = jfn(_jax_toy, jst, _jax_loss("aux"), {"w": jnp.asarray(lp["w"])}, jnp.asarray(x),
              jnp.asarray(t), None, loss_has_aux=True)
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5)
    for g, w in zip(jax.tree_util.tree_leaves(got[1:]), jax.tree_util.tree_leaves(ref[1:])):
        np.testing.assert_allclose(np.asarray(g.detach()), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_engine_errors_match_jax():
    """JAX's ValueErrors: microbatches that do not divide the rows, a depth
    that V chunks a stage do not divide (world-free: the stand-in mesh's
    pipe axis, before any send)."""
    stacked, lp, x, t = _toy_inputs(4, B=6)
    toy = lambda p, h: torch.tanh(h @ p["w"] + p["b"])  # noqa: E731
    mse = lambda l, h, tt: ((h @ l["w"] - tt) ** 2).mean()  # noqa: E731
    mesh = StandIn(data=1, model=1, pipe=2)
    half = {k: torch.from_numpy(v[:2]) for k, v in stacked.items()}
    with pytest.raises(ValueError, match="not divisible by microbatches=4"):
        pp.pipeline_spmd(toy, half, torch.from_numpy(x), mesh, microbatches=4)
    with pytest.raises(ValueError, match="not divisible by microbatches=4"):
        pp.pipeline_1f1b(toy, half, mse, _torch(lp), torch.from_numpy(x), torch.from_numpy(t),
                         mesh, microbatches=4)
    three = {k: torch.from_numpy(v[:3]) for k, v in stacked.items()}
    with pytest.raises(ValueError, match="not divisible by stages\\*virtual=4"):
        pp.pipeline_1f1b_interleaved(toy, three, mse, _torch(lp), torch.from_numpy(x),
                                     torch.from_numpy(t), mesh, virtual=2)


@pytest.mark.parametrize("kw,match", [
    (dict(attn_impl="fused"), "requires attn_impl='fused_tp'"),
    (dict(attn_impl="fused_tp", num_heads=3), "must divide the model axis"),
    (dict(attn_impl="fused_tp", mlp_impl="fused"), "does not compose with tensor"),
])
def test_pp_block_fns_errors_match_jax(kw, match):
    """pp_block_fns's three ValueErrors at tp > 1, JAX's messages."""
    args = dict(num_heads=2, mlp_ratio=2.0, embed_dim=64, tp=2)
    args.update(kw)
    with pytest.raises(ValueError, match=match) as ours:
        vit.pp_block_fns(dtype=torch.float32, **args)
    with pytest.raises(ValueError, match=match) as theirs:
        jax_vit.pp_block_fns(dtype=jnp.float32, **args)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("layout", ["qkv_major", "head_major"])
def test_stacked_block_matches_jax(layout):
    """stacked_block_apply on one block of a stacked leaf set == JAX's
    block of the stacked trunk: Block.apply over `_block_tree` (qkv-major,
    pp_block_fns at tp = 1) and tp_block_apply without a model axis
    (head-major); the model bar (rtol 1e-4, atol 1e-5)."""
    v = jax_vit._StackedBlockParams(2, 64, 128).init(jax.random.PRNGKey(5))["params"]
    h = np.random.RandomState(6).randn(3, 12, 64).astype(np.float32)
    p1 = {k: np.asarray(a)[1] for k, a in v.items()}
    if layout == "qkv_major":
        ref = jax_vit.Block(2, 2.0, dtype=jnp.float32, attn_impl="fused").apply(
            {"params": jax_vit._block_tree(p1)}, jnp.asarray(h))
        attn = "fused"
    else:
        ref = jax_vit.tp_block_apply(p1, jnp.asarray(h), heads=2, dtype=jnp.float32)
        attn = "fused_tp"
    out = vit.stacked_block_apply({k: torch.from_numpy(a) for k, a in p1.items()},
                                  torch.from_numpy(h), heads=2, dtype=torch.float32,
                                  attn_impl=attn)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_stacked_init_matches_per_block_and_jax():
    """A stacked trunk built in one process equals the per-block one of the
    same seed, stacked (bit for bit); as JAX's test_stacked_init_distribution
    asserts, no two blocks share a kernel and the LeCun scale holds."""
    cfg = ModelConfig(**{**MODEL, "backbone": "vit-s", "img_size": (64, 48)})
    per_block = build_model(cfg, device="cpu", seed=3).state_dict()
    stacked = build_model(dataclasses.replace(cfg, pp_stages=4), device="cpu", seed=3)
    sd = stacked.state_dict()
    want = stack_state_dict(per_block)
    assert sorted(sd) == sorted(want)
    for k in sd:
        assert torch.equal(sd[k], want[k]), k
    qkv = sd["backbone.blocks.qkv_kernel"].numpy()
    assert qkv.shape == (12, 384, 1152)
    for i in range(1, 12):
        assert not np.allclose(qkv[0], qkv[i])
    assert 0.8 / np.sqrt(384) < qkv.std() < 1.2 / np.sqrt(384)
    assert unstack_state_dict(sd).keys() == per_block.keys()


@pytest.mark.parametrize("src,dst", [("stacked", "stacked"), ("stacked", "per_block"),
                                     ("per_block", "stacked")])
def test_stacked_from_jax_both_directions(src, dst):
    """JAX's variables of either trunk layout load into a port model of
    either (compat/from_jax.py; a stacked JAX trunk into the pipelined port
    model and into a single-device per-block one): the forward equals
    JAX's (the model bar, rtol 1e-4, atol 1e-5), and the stacked state
    dict is JAX's leaves as they are."""
    kw = {**MODEL, "attn_impl": "fused"}
    jm = jax_model.build_model(jax_model.ModelConfig(**kw, pp_stages=2 if src == "stacked"
                                                     else 1))
    x = np.random.default_rng(8).random((2, 64, 48, 3), dtype=np.float32)
    variables = peaked_variables(jax.jit(jm.init)(jax.random.PRNGKey(2),
                                                  jnp.zeros((1, 64, 48, 3))), 2)
    ref = jax.jit(functools.partial(jm.apply, train=False))(variables, jnp.asarray(x))
    pm = build_model(ModelConfig(**kw, pp_stages=2 if dst == "stacked" else 1), device="cpu")
    load_jax_variables(pm, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    if src == "stacked":
        sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
        for name, leaf in variables["params"]["backbone"]["blocks"].items():
            np.testing.assert_array_equal(sd[f"backbone.blocks.{name}"], leaf)
        back = jax_layouts.unstack_vit_blocks(variables["params"]["backbone"])
        per_block = state_dict_from_jax(dict(variables["params"], backbone=back),
                                        variables["batch_stats"])
        restacked = stack_state_dict(per_block)
        for k, v in sd.items():
            np.testing.assert_array_equal(restacked[k], v)


def test_trainer_create_pipe_errors_match_jax(tmp_path):
    """Trainer.create on a stand-in pipe mesh raises JAX's ValueErrors: TP
    inside a stage without "fused_tp", a conv trunk, ZeRO-1 on a pipe mesh,
    an unknown schedule, LoRA on the stacked trunk, and distillation with
    1F1B."""
    base = TrainConfig.from_json(_jax_cfg(tmp_path).to_json())
    model = lambda **kw: dataclasses.replace(base, model=dataclasses.replace(  # noqa: E731
        base.model, **kw))
    cases = [
        (model(attn_impl="einsum"), StandIn(data=1, model=2, pipe=2),
         "tensor parallelism inside a pipeline stage requires"),
        (model(backbone="conv-t"), StandIn(data=1, model=1, pipe=2),
         "pipeline parallelism needs a ViT backbone"),
        (dataclasses.replace(base, shard_opt_state=True), StandIn(data=1, model=1, pipe=2),
         "supported on dp-only meshes"),
        (dataclasses.replace(base, pipeline_schedule="zb"), StandIn(data=1, model=1, pipe=2),
         "unknown pipeline_schedule 'zb'"),
        (model(lora_rank=2), StandIn(data=1, model=1, pipe=2),
         "does not compose with the stacked pipeline-parallel trunk layout"),
    ]
    for cfg, mesh, match in cases:
        with pytest.raises(ValueError, match=match):
            Trainer.create(cfg, 1, mesh, device="cpu")
    teacher = tmp_path / "teacher"
    from probpose_pytorch_tpu_torch.train.checkpoint import write_run

    write_run(base, teacher, 0, build_model(base.model, device="cpu").state_dict(), None,
              device="cpu")
    from probpose_pytorch_tpu_torch.train.config import DistillConfig

    cfg = dataclasses.replace(base, pipeline_schedule="1f1b", distill=DistillConfig(
        teacher_checkpoint=str(teacher / "checkpoints")))
    with pytest.raises(ValueError, match="distillation does not compose with "
                                         "pipeline_schedule='1f1b'"):
        Trainer.create(cfg, 1, StandIn(data=1, model=1, pipe=2), device="cpu")


def test_trainer_create_stages_the_trunk_like_jax(tmp_path):
    """Trainer.create(cfg, steps, mesh) and (..., mesh=mesh) on a pipe
    mesh (a stand-in, stage 0 of 2) bind like JAX's: pp_stages is the pipe
    axis's size, the trunk stacked in JAX's leaves, this stage holding the
    first half of each leaf's depth; the (data, model) specs of the stacked
    leaves are JAX's."""
    jcfg = _jax_cfg(tmp_path / "j")
    jtr = JaxTrainer.create(jcfg, 1, mesh=jax_make_mesh(2, 1, pipeline_parallel=2))
    cfg = TrainConfig.from_json(jcfg.to_json())
    mesh = StandIn(data=1, model=1, pipe=2)
    for trainer in (Trainer.create(cfg, 1, mesh, device="cpu"),
                    Trainer.create(cfg, 1, mesh=mesh, device="cpu")):
        assert trainer.cfg.model.pp_stages == jtr.cfg.model.pp_stages == 2
        params = dict(trainer.model.named_parameters())
        for name, leaf in jtr.state.params["backbone"]["blocks"].items():
            local = params[f"backbone.blocks.{name}"]
            assert local.shape == (leaf.shape[0] // 2, *leaf.shape[1:]), name
        assert set(trainer.model.pp_splits) == {f"backbone.blocks.{n}"
                                                for n in vit.BLOCK_LEAF_PATHS}
    specs = vit.stacked_param_specs()
    theirs = jax_vit.stacked_param_specs()
    assert {k: tuple(v) for k, v in specs.items()} == {k: tuple(v) for k, v in theirs.items()}


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_trunk_layout_round_trip_carries_the_moments(tmp_path, optimizer):
    """restore_state_with_layout, per-block -> stacked -> per-block on one
    device, after a step: the parameters, the EMA and every moment of the
    optimizer (Adam's mu and nu; Adafactor's rows, columns and v, its
    reduced moments stacked along the depth axis) land stacked where JAX's
    convert_trunk_layout puts them and come back bit for bit; with AdamW
    the stacked trainer's next loss is the per-block one's (rtol 1e-6)."""
    cfg = TrainConfig.from_json(_jax_cfg(tmp_path).to_json())
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, optimizer=optimizer))
    stacked_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, pp_stages=2))
    batch = _batch()
    a = Trainer.create(cfg, SPE, device="cpu")
    a.train_step(a.state, a.device_batch(batch))
    first = CheckpointManager(tmp_path / "per_block")
    first.save(1, a.state, metadata=layout_metadata(cfg))
    s = Trainer.create(stacked_cfg, SPE, device="cpu")
    restore_state_with_layout(first, s.state, stacked_cfg)
    back = CheckpointManager(tmp_path / "stacked")
    back.save(1, s.state, metadata=layout_metadata(stacked_cfg))
    c = Trainer.create(cfg, SPE, device="cpu")
    restore_state_with_layout(back, c.state, cfg)

    def moments(trainer):
        opt = trainer.state.opt_state
        return {f.name: dict(zip(trainer.state.names, getattr(opt, f.name)))
                for f in dataclasses.fields(opt) if isinstance(getattr(opt, f.name), (list, tuple))}

    shapes = {n: tuple(p.shape) for n, p in zip(a.state.names, a.state.params)}
    mine, stacked = moments(a), moments(s)
    assert mine and sorted(mine) == sorted(stacked)
    for field, leaves in mine.items():
        want = stack_state_dict(leaves, shapes=shapes)
        assert sorted(want) == sorted(stacked[field])
        for n, t in want.items():
            assert torch.equal(stacked[field][n], t), (field, n)
    for field, leaves in moments(c).items():
        for n, t in leaves.items():
            assert torch.equal(t, mine[field][n]), (field, n)
    for n, p, q, e, f in zip(a.state.names, a.state.params, c.state.params,
                             a.state.ema_params or a.state.params,
                             c.state.ema_params or c.state.params):
        assert torch.equal(p, q) and torch.equal(e, f), n
    if optimizer == "adamw":
        _, m1 = a.train_step(a.state, a.device_batch(batch))
        _, m2 = s.train_step(s.state, s.device_batch(batch))
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
