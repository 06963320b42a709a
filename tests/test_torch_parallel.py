"""The port's scale-out against the JAX package's sharded programs, on the
CPU, in a 4-rank gloo world (tests/torch_mp_worker.py): meshes and their
errors, the train step over (data, model) meshes, Trainer.fit, checkpoints
onto and off a mesh, the predictor, the detector and the eval CLI, each
held against JAX's result on a mesh (the 8-device virtual CPU mesh of
tests/conftest.py: the same (data, model) shape, except JAX's eval CLI,
which spans all 8 devices). Trainer.fit and the checkpoints' round trips
are held against themselves, bit for bit. The decisions and layouts that
need no world are tests/test_torch_layouts.py's.

The world is launched once for the module: the `world` fixture computes
every JAX reference here, hands the inputs to the ranks as files (the
single-device port checkpoint of JAX's initial state, the batch, the
config), runs the ranks with a deadline and each test reads its scenario's
results. Tolerances, stated where they are asserted:
  * losses, rtol 1e-5 (JAX's own mesh tests' bound);
  * every moment of the optimizer after the steps (Adam's mu and nu,
    Lion's mu, Adafactor's rows, columns and v), gathered from its shards,
    within 1e-4 of each leaf's largest JAX entry: sums in another order,
    and over other row splits (a leaf that is all rounding noise,
    head.final.bias, within 1e-6 of the largest entry anywhere);
  * parameters after the steps within 1e-6, except elements where a step's
    update followed the sign of a value below that tolerance (Adam's
    gradient, Lion's interpolation, Adafactor's unfactored |g|, read off
    JAX's moments after each step): such a step moves an element by lr
    whatever the value's size, so a rounding-level value may take the
    other sign; those stay within 2 lr a step;
  * BatchNorm running statistics, rtol 1e-5 and atol 1e-6 (the batch
    statistics of the global batch, summed in another order; atol 1e-5
    after two steps);
  * predictions, rtol and atol 1e-4 (JAX's mesh predictor tests' bound);
    the detectors', their single-device tests' bounds.
"""

import contextlib
import dataclasses
import io
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.data import SyntheticPoseDataset as JaxSynthetic
from probpose_pytorch_tpu.data import batch_iterator as jax_batch_iterator
from probpose_pytorch_tpu.detect import pipeline as jax_pipeline
from probpose_pytorch_tpu.eval import run as jax_eval_run
from probpose_pytorch_tpu.inference import TopDownPredictor as JaxPredictor
from probpose_pytorch_tpu.models import model as jax_model
from probpose_pytorch_tpu.models.vit import ViTConfig as JaxViTConfig
from probpose_pytorch_tpu.parallel import make_mesh as jax_make_mesh
from probpose_pytorch_tpu.parallel import shard_batch as jax_shard_batch
from probpose_pytorch_tpu.train import Trainer as JaxTrainer
from probpose_pytorch_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from probpose_pytorch_tpu.train.config import TrainConfig as JaxTrainConfig
from probpose_pytorch_tpu_torch.compat.from_jax import load_jax_train_state
from probpose_pytorch_tpu_torch.data import generate_coco_synth
from probpose_pytorch_tpu_torch.models.vit import ViTConfig
from probpose_pytorch_tpu_torch.train import TrainConfig, Trainer
from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
from probpose_pytorch_tpu_torch.train.loop import layout_metadata
from probpose_pytorch_tpu_torch.train.state import build_schedule
from test_torch_detect import detector_pair
from test_torch_models import peaked_variables
from torch_mp_worker import start_world, wait_world

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

TINY = dict(embed_dim=64, depth=2, num_heads=2, mlp_ratio=2.0)
for _presets in (JaxViTConfig.PRESETS, ViTConfig.PRESETS):
    _presets.setdefault("vit-tiny-par", TINY)
MODEL = dict(img_size=(64, 48), num_keypoints=5, backbone="vit-tiny-par",
             compute_dtype="float32", deconv_out_channels=(32, 32),
             deconv_kernel_sizes=(4, 4), pool_sizes=((2, 2), (2, 2)), normalize=1.0)
B = 8
SPE = 4  # steps per epoch: the schedule's span


def _jax_cfg(out: Path, model=None, **kw) -> JaxTrainConfig:
    return JaxTrainConfig(model=jax_model.ModelConfig(**{**MODEL, **(model or {})}),
                          epochs=1, train_batch_size=B, augment=None,
                          out_dir=str(out), **kw)


def _batch() -> dict[str, np.ndarray]:
    ds = JaxSynthetic(B, MODEL["img_size"], MODEL["num_keypoints"])
    return next(iter(jax_batch_iterator(ds, B, num_workers=1)))


def _find(tree, attr):
    """The first node of an optax state with attribute `attr`."""
    if hasattr(tree, attr):
        return tree
    if isinstance(tree, (tuple, list)):
        for t in tree:
            found = _find(t, attr)
            if found is not None:
                return found
    if isinstance(tree, dict):
        for t in tree.values():
            found = _find(t, attr)
            if found is not None:
                return found
    return None


def _jax_mesh_trainer(cfg, dp, mp, tmp):
    """JAX's trainer on a (dp, mp) mesh and its initial state (that of one
    device from the same seed)."""
    trainer = JaxTrainer.create(dataclasses.replace(cfg, out_dir=str(tmp / "jax")), SPE,
                                mesh=jax_make_mesh(dp * mp, mp))
    return trainer, jax.device_get(trainer.state)


def _jax_steps(trainer, batch, steps):
    """(losses, the state after each step) of `steps` JAX steps on the
    trainer's mesh."""
    state = trainer.state
    sb = jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, trainer.mesh)
    losses, states = [], []
    for _ in range(steps):
        state, m = trainer.train_step(state, sb)
        losses.append(float(m["loss"]))
        states.append(jax.device_get(state))
    return losses, states


def _port_checkpoint(job: Path, name: str, jcfg, jstate, metadata=None) -> str:
    """The port's config file and a single-device port checkpoint holding
    the JAX state `jstate`; returns the checkpoint's directory name."""
    cfg = TrainConfig.from_json(jcfg.to_json())
    cfg.save(job / f"{name}.json")
    trainer = Trainer.create(cfg, SPE, device="cpu")
    load_jax_train_state(trainer.state, jstate)
    CheckpointManager(job / f"{name}_ckpt").save(trainer.state.host_step, trainer.state,
                                                 metadata=metadata)
    return f"{name}_ckpt"


def _step_scenario(job, tmp, name, batch, *, dp, mp, steps=1, model=None, **kw):
    """(the reference, which `finish` completes with JAX's steps while the
    world runs, the scenario's spec)."""
    jcfg = _jax_cfg(tmp / name, model, **kw)
    trainer, state0 = _jax_mesh_trainer(jcfg, dp, mp, tmp / name)
    ckpt = _port_checkpoint(job, name, jcfg, state0)
    ref = dict(jcfg=jcfg, attn_impl=trainer.cfg.model.attn_impl)

    def finish():
        ref["losses"], ref["states"] = _jax_steps(trainer, batch, steps)

    ref["finish"] = finish
    return ref, dict(kind="step", config=f"{name}.json", checkpoint=ckpt, batch="batch.npz",
                     steps=steps, steps_per_epoch=SPE, model_parallel=mp)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every scenario's JAX reference and the 4-rank world's results."""
    tmp = tmp_path_factory.mktemp("parallel")
    job = tmp / "job"
    job.mkdir()
    batch = _batch()
    np.savez(job / "batch.npz", **batch)
    refs, scenarios = {}, {}

    def add(name, ref, spec):
        refs[name], scenarios[name] = ref, spec

    add("mesh", {}, dict(kind="mesh"))
    # a data-parallel mesh keeps "fused" (K1 on each rank's rows)
    add("dp", *_step_scenario(job, tmp, "dp", batch, dp=4, mp=1, model=dict(attn_impl="fused")))
    # heads (2) divide the model axis: "fused" becomes "fused_tp", split by heads
    add("tp", *_step_scenario(job, tmp, "tp", batch, dp=2, mp=2, model=dict(attn_impl="fused")))
    # qkv-major "einsum": the attention whole on each model rank, the MLP split
    add("dp_tp", *_step_scenario(job, tmp, "dp_tp", batch, dp=2, mp=2))
    # heads (2) do not divide the model axis (4): "einsum"; K5 with whole weights
    add("heads", *_step_scenario(job, tmp, "heads", batch, dp=1, mp=4,
                                 model=dict(attn_impl="fused", mlp_impl="fused")))

    # a single-device "fused" (qkv-major) checkpoint after one JAX step,
    # resumed onto a tensor-parallel "fused_tp" trainer (layout converted)
    jcfg = _jax_cfg(tmp / "layout", dict(attn_impl="fused"))
    jtr = JaxTrainer.create(jcfg, SPE)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    s1, _ = jtr.train_step(jtr.state, jb)
    s1_host = jax.device_get(s1)
    _, m2 = jtr.train_step(s1, jb)
    ckpt = _port_checkpoint(job, "layout", jcfg, s1_host,
                            metadata=layout_metadata(TrainConfig.from_json(jcfg.to_json())))
    add("layout", dict(loss=float(m2["loss"])),
        dict(kind="step", config="layout.json", checkpoint=ckpt, batch="batch.npz",
             steps=1, steps_per_epoch=SPE, model_parallel=2, with_layout=True))

    add("fit", {}, dict(kind="fit", config="dp_tp.json", model_parallel=2, max_steps=2))

    # the predictor on a data-parallel and on a tensor-parallel mesh
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (B, 100, 120, 3), dtype=np.uint8)
    boxes = rng.uniform([0, 0, 40, 50], [50, 40, 70, 60], (B, 4)).astype(np.float32)
    np.savez(job / "frames.npz", frames=frames, boxes=boxes)
    for name, mp, model in (("predict_dp", 1, None), ("predict_tp", 2, dict(attn_impl="fused"))):
        jcfg = _jax_cfg(tmp / name, model)
        jtr = JaxTrainer.create(jcfg, 1)
        # peaked head kernels: a decode of near-flat heatmaps is ill-conditioned
        variables = peaked_variables({"params": jtr.state.params,
                                      "batch_stats": jtr.state.batch_stats})
        ckpt = _port_checkpoint(job, name, jcfg, jax.device_get(jtr.state).replace(
            params=variables["params"], batch_stats=variables["batch_stats"]))
        ref = {}
        ref["finish"] = lambda ref=ref, jtr=jtr, variables=variables, mp=mp: ref.update(
            out=JaxPredictor(model=jtr.model, variables=variables, codec=jtr.encode_codec,
                             input_size=MODEL["img_size"],
                             mesh=jax_make_mesh(4, mp))(frames, boxes))
        add(name, ref, dict(kind="predict", checkpoint=ckpt, config=f"{name}.json",
                            inputs="frames.npz", model_parallel=mp))

    # the eval CLI on a synthetic COCO-format val set, a 17-keypoint model
    # (peaked head), the same state as JAX's checkpoint and as the port's
    generate_coco_synth(job / "coco", n_train_images=1, n_val_images=3, frame_hw=(160, 200),
                        seed=3)
    jcfg = _jax_cfg(tmp / "eval", dict(num_keypoints=17, attn_impl="fused"))
    jtr = JaxTrainer.create(jcfg, 1)
    variables = peaked_variables({"params": jtr.state.params,
                                  "batch_stats": jtr.state.batch_stats})
    as_jnp = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    jstate = jtr.state.replace(params=as_jnp(variables["params"]),
                               batch_stats=as_jnp(variables["batch_stats"]))
    _port_checkpoint(job, "eval", jcfg, jax.device_get(jstate))
    jax_run = tmp / "eval_jax"
    jax_run.mkdir()
    jcfg.save(jax_run / "config.json")
    mgr = JaxCheckpointManager(jax_run / "checkpoints", keep=1)
    mgr.save(0, jstate)
    mgr.close()
    data = ["--annotations", "@coco/annotations/person_keypoints_val2017.json", "--images",
            "@coco/val2017", "--batch-size", "3", "--data-parallel", "--model-parallel", "2"]
    ref = {}

    def jax_eval_cli(ref=ref):  # JAX's CLI on the (4, 2) mesh of the 8 devices
        args = [a if not a.startswith("@") else str(job / a[1:]) for a in data]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            jax_eval_run.main(["--checkpoint", str(jax_run / "checkpoints"), "--config",
                               str(jax_run / "config.json"), *args])
        ref["line"] = json.loads(printed.getvalue().strip().splitlines()[-1])

    ref["finish"] = jax_eval_cli
    add("eval_cli", ref, dict(kind="eval_cli", args=[
        "--checkpoint", "@eval_ckpt", "--config", "@eval.json", *data, "--device", "cpu"]))

    # the detector and the bottom-up predictor, JAX's weights in the port's
    dets = dict(det=detector_pair(seed=4), bu=detector_pair(5, kpt_heatmaps=True, seed=6))
    torch.save({k: pm.state_dict() for k, (_, _, pm) in dets.items()}, job / "detectors.pt")
    det_frames = rng.integers(0, 256, (3, 80, 96, 3), np.uint8)
    np.savez(job / "det_frames.npz", frames=det_frames)
    ref = {}

    def jax_detectors(ref=ref):  # 3 frames padded to the data axis of a (2, 2) mesh
        mesh = jax_make_mesh(4, 2)
        (jm, variables, _), (bm, bvariables, _) = dets["det"], dets["bu"]
        ref["boxes"], ref["scores"] = jax_pipeline.DetectorPredictor(
            model=jm, variables=variables, max_detections=4, mesh=mesh)(det_frames)
        ref.update(zip(("bu_boxes", "bu_scores", "bu_keypoints", "bu_kscores"),
                       jax_pipeline.BottomUpPredictor(model=bm, variables=bvariables,
                                                      max_detections=4, mesh=mesh)(det_frames)))

    ref["finish"] = jax_detectors
    add("detect", ref, dict(kind="detect", inputs="det_frames.npz", weights="detectors.pt",
                            model_parallel=2))

    (job / "job.json").write_text(json.dumps({"presets": {"vit-tiny-par": TINY},
                                              "scenarios": scenarios}))
    handle = start_world(job, 4)
    try:  # JAX's mesh programs while the world runs
        for ref in refs.values():
            ref.pop("finish", lambda: None)()
    finally:
        wait_world(handle)
    return SimpleNamespace(job=job, refs=refs, size=4)


def _ranks(world, name):
    return [json.loads((world.job / name / f"rank{r}.json").read_text())
            for r in range(world.size)]


def test_mesh_construction_and_errors(world):
    """make_mesh over the 4-rank world: JAX's shapes and errors, the model
    axis innermost (the rows of a global batch follow the data
    coordinate), make_hybrid_mesh on one host = make_mesh, a pipe axis
    innermost with JAX's dict(mesh.shape); process_info and
    local_batch_size as JAX's."""
    want_pipe = {k: int(v) for k, v in jax_make_mesh(4, 1, pipeline_parallel=2).shape.items()}
    for r, got in enumerate(_ranks(world, "mesh")):
        assert got["shape"] == got["hybrid"] == {"data": 2, "model": 2}
        assert got["dp"] == {"data": 4, "model": 1} and got["spec"] == ["data"]
        d = r // 2  # rank = data index * model + model index
        assert got["rows"] == list(range(d * 32, d * 32 + 32, 4))
        assert got["process"] == [r, 4] and got["local_batch"] == 2
        assert got["local_batch_6"].startswith("ValueError: global batch 6 not divisible")
        assert got["model_3"].startswith("ValueError: model_parallel=3")
        assert got["too_many"] == "ValueError: requested 8 devices, only 4 available"
        assert got["pipe"] == want_pipe == {"data": 2, "model": 1, "pipe": 2}


def _port_views(jcfg, states) -> list[dict[str, np.ndarray]]:
    """JAX's states on the port's names and layouts (compat/from_jax.py into
    a single-device port trainer), keyed as the ranks' out.npz: param/,
    buffer/ and each moment field/ by parameter name."""
    from torch_mp_worker import _whole_state

    trainer = Trainer.create(TrainConfig.from_json(jcfg.to_json()), SPE, device="cpu")
    views = []
    for state in states:
        load_jax_train_state(trainer.state, state)
        views.append({k: np.array(v) for k, v in _whole_state(trainer).items()})
    return views


def _directions(cfg, views, names) -> list[dict[str, np.ndarray]]:
    """Per step and leaf, the quantity whose sign the step's update follows
    (so a rounding-level value may take the other sign in the port), from
    JAX's moments after each step: Adam's gradient, Lion's interpolation
    (1 - b1) g + b1 m, Adafactor's |g| on a leaf it does not factor (a
    factored leaf scales g by its rows and columns: nothing flips)."""
    o = cfg.optim
    out, prev = [], None
    for t, view in enumerate(views, start=1):
        step = {}
        for n in names:
            if o.optimizer == "adamw":
                m0 = 0.0 if prev is None else prev[f"mu/{n}"]
                step[n] = (view[f"mu/{n}"] - o.b1 * m0) / (1 - o.b1)
            elif o.optimizer == "lion":
                m0 = 0.0 if prev is None else prev[f"mu/{n}"]
                g = (view[f"mu/{n}"] - o.b2 * m0) / (1 - o.b2)
                step[n] = (1 - o.b1) * g + o.b1 * m0
            else:
                v, v0 = view[f"v/{n}"], 0.0 if prev is None else prev[f"v/{n}"]
                if v.shape != view[f"param/{n}"].shape:
                    step[n] = np.full(v.shape, np.inf, np.float32)
                    continue
                decay = 1.0 - t ** -0.8
                step[n] = np.sqrt(np.maximum((v - decay * v0) / (1 - decay), 0.0))
        out.append(step)
        prev = view
    return out


def _leaf_tolerances(arrays: dict[str, np.ndarray]) -> dict[str, float]:
    """1e-4 of each leaf's largest entry; a leaf that is all rounding noise
    (its largest entry below 1e-6 of the largest anywhere) 1e-6 of that."""
    top = max(float(np.abs(a).max(initial=0.0)) for a in arrays.values())
    tols = {}
    for n, a in arrays.items():
        m = float(np.abs(a).max(initial=0.0))
        tols[n] = 1e-6 * top if m < 1e-6 * top else 1e-4 * m
    return tols


def _check_step(world, name):
    """The scenario's losses on every rank against JAX's mesh losses, and
    rank 0's whole state after the steps against JAX's: every parameter
    leaf, every moment of the optimizer (Adam's mu and nu, Lion's mu,
    Adafactor's rows, columns and v) and the BatchNorm running
    statistics."""
    ref = world.refs[name]
    ranks = _ranks(world, name)
    for r in ranks:  # every rank holds the one global loss
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)
    out = dict(np.load(world.job / name / "out.npz"))
    cfg = TrainConfig.from_json(ref["jcfg"].to_json())
    views = _port_views(ref["jcfg"], ref["states"])
    final = views[-1]
    names = [k[len("param/"):] for k in out if k.startswith("param/")]
    assert names and {f"param/{n}" for n in names} <= set(final)
    fields = sorted({k.split("/")[0] for k in out} - {"param", "buffer"})
    assert fields == sorted({k.split("/")[0] for k in final} - {"param", "buffer"})
    assert fields, "no moment in the gathered state"
    for f in fields:  # the moments, gathered from their shards
        want = {n: final[f"{f}/{n}"] for n in names}
        for n, tol in _leaf_tolerances(want).items():
            np.testing.assert_allclose(out[f"{f}/{n}"], want[n], rtol=0, atol=tol,
                                       err_msg=f"{f}/{n}")
    sched = build_schedule(cfg.optim, SPE * cfg.epochs)
    lr = sum(float(sched(torch.tensor(i))) for i in range(len(ref["losses"])))
    small = {n: np.zeros(out[f"param/{n}"].shape, bool) for n in names}
    for step in _directions(cfg, views, names):
        for n, tol in _leaf_tolerances(step).items():
            noise = float(np.abs(step[n]).max()) < tol  # the leaf is all noise
            small[n] |= (np.abs(step[n]) < tol) | noise
    for n in names:
        d = np.abs(out[f"param/{n}"] - final[f"param/{n}"])
        assert (d[~small[n]] <= 1e-6).all(), (n, d[~small[n]].max())
        assert (d[small[n]] <= 2 * lr + 1e-7).all(), (n, d[small[n]].max())
    # after a second step the batch statistics come from parameters that
    # may differ by 2 lr where the first gradient was rounding noise
    atol = 1e-6 if len(ref["losses"]) == 1 else 1e-5
    stats = [k for k in out if k.startswith("buffer/") and "running" in k]
    for k in stats:
        np.testing.assert_allclose(out[k], final[k], rtol=1e-5, atol=atol, err_msg=k)
    return ranks, out


@pytest.mark.parametrize("name", ["dp", "tp", "dp_tp", "heads"])
def test_sharded_train_step_matches_jax(world, name):
    """One step on a (data, model) mesh == JAX's step on a mesh of that
    shape: the loss, every parameter leaf, the gradient (Adam's mu) and
    the head's BatchNorm running statistics of the global batch."""
    ranks, out = _check_step(world, name)
    assert ranks[0]["attn_impl"] == world.refs[name]["attn_impl"]
    assert any("running_var" in k for k in out)


def test_tp_mesh_splits_heads_and_mlp(world):
    """On the (2, 2) mesh "fused" became "fused_tp": each model rank holds
    half of qkv's and fc1's output rows and of proj's and fc2's input
    columns; "einsum" kept its attention whole and split the MLP only."""
    tp = _ranks(world, "tp")[0]
    dp_tp = _ranks(world, "dp_tp")[0]
    assert tp["attn_impl"] == "fused_tp" and dp_tp["attn_impl"] == "einsum"
    out = dict(np.load(world.job / "tp" / "out.npz"))
    names = [k[len("param/"):] for k in out if k.startswith("param/")]
    whole = dict(zip(names, [out[f"param/{n}"].size for n in names]))
    local = dict(zip(names, tp["param_numel"]))
    split = {n for n in names if local[n] * 2 == whole[n]}
    assert split == {f"backbone.blocks.{i}.{p}" for i in range(2) for p in (
        "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
        "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight")}
    fit = _ranks(world, "fit")[0]
    assert fit["split"] == sorted(f"backbone.blocks.{i}.mlp.{p}" for i in range(2)
                                  for p in ("fc1.weight", "fc1.bias", "fc2.weight"))


def test_checkpoint_cross_layout_resume(world):
    """A single-device "fused" (qkv-major) checkpoint resumes onto a
    tensor-parallel "fused_tp" trainer: restore_state_with_layout permutes
    the parameters and Adam's moments before the mesh takes its slices, so
    the next step's loss is the uninterrupted single-device run's."""
    for r in _ranks(world, "layout"):
        assert r["attn_impl"] == "fused_tp"
        np.testing.assert_allclose(r["losses"][0], world.refs["layout"]["loss"], rtol=1e-5)


def test_trainer_fit_over_mesh_and_restore_onto_mesh(world):
    """Trainer.fit over the (2, 2) mesh takes its steps and checkpoints; a
    trainer of another seed restores the checkpoint bit for bit on the
    mesh and trains on."""
    for r in _ranks(world, "fit"):
        assert r["step"] == 2 and r["restored_step"] == 2
        assert r["restored_equal"]
        assert np.isfinite(r["next_loss"])
    assert (world.job / "fit" / "run" / "checkpoints" / "2").exists()


def test_mesh_checkpoint_restores_onto_one_device(world, tmp_path):
    """The checkpoint a mesh run wrote (the split leaves and moments
    gathered by rank 0) loads into a single-device trainer whole."""
    cfg = TrainConfig.load(world.job / "dp_tp.json")
    trainer = Trainer.create(cfg, 2, device="cpu")
    CheckpointManager(world.job / "fit" / "run" / "checkpoints").restore(trainer.state)
    assert trainer.state.host_step == 2
    payload = CheckpointManager(world.job / "fit" / "run" / "checkpoints").read()
    for n, p in zip(trainer.state.names, trainer.state.params):
        assert torch.equal(p, payload["params"][n]), n


@pytest.mark.parametrize("name", ["predict_dp", "predict_tp"])
def test_mesh_predictor_matches_jax(world, name):
    """load_predictor(mesh=) on a data-parallel and on a tensor-parallel
    mesh: every rank returns the whole batch's outputs, JAX's mesh
    predictor's; on the model axis the qkv-major checkpoint became
    "fused_tp" with its heads split."""
    ref = world.refs[name]["out"]
    for r in range(4):
        got = dict(np.load(world.job / name / f"rank{r}.npz"))
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-4, atol=1e-4,
                                       err_msg=f"{k} rank {r}")
    info = _ranks(world, name)[0]
    assert info["attn_impl"] == ("fused_tp" if name == "predict_tp" else "einsum")
    assert bool(info["split"]) == (name == "predict_tp")


def test_detector_predictors_on_mesh(world):
    """The detector and the bottom-up predictor on a (2, 2) mesh: 3 frames
    padded to the data axis, each data rank runs its rows with whole
    weights, the maps are gathered before the one decode, and every rank
    returns JAX's predictors' outputs on their (2, 2) mesh (the
    single-device tests' tolerances: detector scores 1e-6 and boxes 1e-4
    px, bottom-up scores 1e-5 and boxes and joints 1e-3 px)."""
    ref = world.refs["detect"]
    tols = dict(scores=1e-6, boxes=1e-4, bu_scores=1e-5, bu_kscores=1e-5)
    for r in range(world.size):
        got = dict(np.load(world.job / "detect" / f"rank{r}.npz"))
        assert set(got) == set(ref)
        for k in ref:
            want = np.asarray(ref[k])
            assert got[k].shape == want.shape and got[k].shape[0] == 3, k
            np.testing.assert_allclose(got[k], want, rtol=0, atol=tols.get(k, 1e-3),
                                       err_msg=f"{k} rank {r}")


def test_eval_cli_data_and_model_parallel(world):
    """The eval CLI with --data-parallel --model-parallel 2 over the 4-rank
    world ("fused" loaded as "fused_tp" with its heads split, the batch
    rounded up to the data axis and padded) prints, on every rank, the line
    of JAX's CLI on its (4, 2) mesh for the same state (to the line's
    rounding, 1e-4)."""
    ref = world.refs["eval_cli"]["line"]
    for r in _ranks(world, "eval_cli"):
        assert set(r) == set(ref)
        for k in ref:
            assert abs(r[k] - ref[k]) <= 1e-4 + 1e-9, (k, r[k], ref[k])
