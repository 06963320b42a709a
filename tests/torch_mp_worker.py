"""One rank of a gloo world on the CPU for the port's scale-out tests
(tests/test_torch_parallel.py, tests/test_torch_multiprocess.py,
tests/test_torch_pipeline.py).

    python tests/torch_mp_worker.py <job dir> <rank> <world size>

reads <job dir>/job.json, joins the world through a file rendezvous in the
job dir, runs every scenario of the job in order and writes each one's
results to <job dir>/<scenario>/: rank 0 the whole state (`out.npz`),
every rank its own numbers (`rank<r>.json`). Imports the port only, never
JAX; one CPU thread per rank.
"""

from __future__ import annotations

import json
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)


def _cfg(path: Path):
    from probpose_pytorch_tpu_torch.train import TrainConfig

    return TrainConfig.load(path)


def _whole_state(trainer) -> dict[str, np.ndarray]:
    """Every parameter, buffer and moment of the trainer's state, whole, by
    name (the checkpoint payload's gathers; collective); a stacked trunk's
    leaves by the per-block names (compat/layouts.py:unstack_state_dict)."""
    from probpose_pytorch_tpu_torch.compat.layouts import unstack_state_dict
    from probpose_pytorch_tpu_torch.train.checkpoint import _state_payload

    payload = _state_payload(trainer.state)
    out = {f"param/{k}": v.numpy() for k, v in unstack_state_dict(payload["params"]).items()}
    out.update({f"buffer/{k}": v.numpy() for k, v in payload["buffers"].items()})
    opt = payload["opt_state"]
    opt = opt.get("inner", opt)
    inner = getattr(trainer.tx, "inner", trainer.tx)
    names = trainer.state.names
    trainable = names if inner.trainable is None else [names[i] for i in inner.trainable]
    for field, leaves in opt.items():
        if isinstance(leaves, list):
            moved = unstack_state_dict(dict(zip(trainable, leaves)))
            out.update({f"{field}/{n}": t.numpy() for n, t in moved.items()})
    return out


def _batches(spec: dict, job: Path, trainer):
    batch = dict(np.load(job / spec["batch"]))
    if spec.get("local_batches"):
        from probpose_pytorch_tpu_torch.data import batch_iterator
        from probpose_pytorch_tpu_torch.parallel.mesh import mesh_coords, mesh_shape

        trainer.local_batches = True
        n = len(next(iter(batch.values())))

        class _Rows:  # the global batch as a dataset
            def __len__(self):
                return n

            def get_batch(self, idx):
                return {k: v[idx] for k, v in batch.items()}

        batch = next(iter(batch_iterator(
            _Rows(), n, num_workers=1, process_index=mesh_coords(trainer.mesh)["data"],
            process_count=mesh_shape(trainer.mesh)["data"])))
    return batch


def run_step(spec: dict, job: Path, out: Path, rank: int) -> None:
    """Trainer.create on the scenario's mesh, restore the single-device
    checkpoint, take `steps` steps; rank 0 writes the whole state."""
    from probpose_pytorch_tpu_torch.parallel import make_mesh
    from probpose_pytorch_tpu_torch.train import Trainer
    from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
    from probpose_pytorch_tpu_torch.train.loop import restore_state_with_layout

    mesh = make_mesh(None, spec["model_parallel"],
                     pipeline_parallel=spec.get("pipeline_parallel", 1))
    cfg = _cfg(job / spec["config"])
    trainer = Trainer.create(cfg, spec["steps_per_epoch"], mesh, device="cpu")
    ckpt = CheckpointManager(job / spec["checkpoint"])
    if spec.get("with_layout"):
        restore_state_with_layout(ckpt, trainer.state, trainer.cfg)
    else:
        ckpt.restore(trainer.state)
    batch = _batches(spec, job, trainer)
    losses, norms = [], []
    for _ in range(spec.get("steps", 1)):
        _, m = trainer.train_step(trainer.state, trainer.device_batch(batch))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    mine = {"losses": losses, "grad_norms": norms, "attn_impl": trainer.cfg.model.attn_impl,
            "pp_stages": trainer.cfg.model.pp_stages,
            "moment_numel": [int(t.numel()) for t in getattr(
                getattr(trainer.state.opt_state, "inner", trainer.state.opt_state), "mu", [])],
            "param_numel": [int(p.numel()) for p in trainer.state.params]}
    whole = _whole_state(trainer)
    if spec.get("save_to"):
        from probpose_pytorch_tpu_torch.train.loop import layout_metadata

        CheckpointManager(job / spec["save_to"]).save(trainer.state.host_step, trainer.state,
                                                      metadata=layout_metadata(trainer.cfg))
    if rank == 0:
        np.savez(out / "out.npz", **whole)
    (out / f"rank{rank}.json").write_text(json.dumps(mine))


def run_fit(spec: dict, job: Path, out: Path, rank: int) -> None:
    """Trainer.fit over the mesh for `max_steps` steps, then a second
    trainer of another seed restores the checkpoint fit wrote."""
    import dataclasses

    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
    from probpose_pytorch_tpu_torch.parallel import make_mesh
    from probpose_pytorch_tpu_torch.train import Trainer
    from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager

    mesh = make_mesh(None, spec["model_parallel"])
    cfg = _cfg(job / spec["config"])
    cfg = dataclasses.replace(cfg, out_dir=str(out / "run"))
    trainer = Trainer.create(cfg, 2, mesh, device="cpu")
    ds = SyntheticPoseDataset(2 * cfg.train_batch_size, cfg.model.img_size,
                              cfg.model.num_keypoints)
    state = trainer.fit(lambda: batch_iterator(ds, cfg.train_batch_size, num_workers=1),
                        max_steps=spec["max_steps"])
    fitted = _whole_state(trainer)
    other = Trainer.create(dataclasses.replace(cfg, seed=cfg.seed + 1,
                                               out_dir=str(out / "run2")), 2, mesh, device="cpu")
    CheckpointManager(out / "run" / "checkpoints").restore(other.state)
    restored = _whole_state(other)
    same = all(np.array_equal(fitted[k], restored[k]) for k in fitted)
    restored_step = other.state.host_step
    _, m = other.train_step(other.state, other.device_batch(
        next(iter(batch_iterator(ds, cfg.train_batch_size, num_workers=1)))))
    mine = {"step": state.host_step, "restored_equal": bool(same),
            "restored_step": restored_step, "next_loss": float(m["loss"]),
            "split": sorted(trainer.model.tp_splits)}
    (out / f"rank{rank}.json").write_text(json.dumps(mine))


def run_predict(spec: dict, job: Path, out: Path, rank: int) -> None:
    """load_predictor on the mesh from the single-device checkpoint; every
    rank calls with the same frames and boxes and writes what it got."""
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor, load_predictor
    from probpose_pytorch_tpu_torch.parallel import make_mesh

    mesh = make_mesh(None, spec["model_parallel"],
                     pipeline_parallel=spec.get("pipeline_parallel", 1))
    pred = load_predictor(job / spec["checkpoint"], config_path=job / spec["config"],
                          mesh=mesh, device="cpu")
    data = np.load(job / spec["inputs"])
    res = pred(data["frames"], data["boxes"])
    np.savez(out / f"rank{rank}.npz", **res)
    bb = pred.model.backbone
    mine = {"attn_impl": bb.attn_impl if bb.stacked else bb.blocks[0].attn.impl,
            "split": sorted(pred.model.tp_splits), "staged": sorted(pred.model.pp_splits)}
    if spec.get("from_model"):  # a single-device model handed to the mesh predictor
        one = load_predictor(job / spec["checkpoint"], config_path=job / spec["config"],
                             device="cpu")
        staged = TopDownPredictor(model=one.model, codec=one.codec, input_size=one.input_size,
                                  mesh=mesh)
        np.savez(out / f"model{rank}.npz", **staged(data["frames"], data["boxes"]))
        mine["model_staged"] = sorted(staged.model.pp_splits)
    (out / f"rank{rank}.json").write_text(json.dumps(mine))


def run_detect(spec: dict, job: Path, out: Path, rank: int) -> None:
    """The detector and the bottom-up predictor (conv-t at 64 x 64, the
    job's weights) on the mesh's data axis, on an odd number of frames
    (padded to the axis)."""
    from probpose_pytorch_tpu_torch.detect.model import PersonDetector
    from probpose_pytorch_tpu_torch.detect.pipeline import BottomUpPredictor, DetectorPredictor
    from probpose_pytorch_tpu_torch.parallel import make_mesh

    mesh = make_mesh(None, spec["model_parallel"])
    weights = torch.load(job / spec["weights"], weights_only=True)
    preds = {}
    for name, cls, k in (("det", DetectorPredictor, 0), ("bu", BottomUpPredictor, 5)):
        model = PersonDetector((64, 64), "conv-t", dtype=torch.float32, num_keypoints=k,
                               kpt_heatmaps=k > 0)
        model.load_state_dict(weights[name])
        preds[name] = cls(model=model.eval(), max_detections=4, mesh=mesh)
    frames = np.load(job / spec["inputs"])["frames"]
    boxes, scores = preds["det"](frames)
    res = dict(zip(("bu_boxes", "bu_scores", "bu_keypoints", "bu_kscores"), preds["bu"](frames)))
    np.savez(out / f"rank{rank}.npz", boxes=boxes, scores=scores, **res)
    (out / f"rank{rank}.json").write_text(json.dumps({}))


def run_mesh(spec: dict, job: Path, out: Path, rank: int) -> None:
    """Meshes and their errors, the batch's rows and the process numbers on
    this rank; each outcome recorded by name (an error by its type and
    message)."""
    from probpose_pytorch_tpu_torch.parallel import (
        batch_sharding,
        local_batch_size,
        make_hybrid_mesh,
        make_mesh,
        mesh_shape,
        process_info,
        shard_batch,
    )

    def outcome(fn):
        try:
            return fn()
        except Exception as e:  # recorded for the test to read
            return f"{type(e).__name__}: {e}"

    mesh = make_mesh(None, 2)
    rows = shard_batch({"x": np.arange(16 * 4).reshape(16, 4)}, mesh)["x"]
    mine = {
        "shape": mesh_shape(mesh), "hybrid": mesh_shape(make_hybrid_mesh(2)),
        "dp": mesh_shape(make_mesh(4)), "spec": list(batch_sharding(mesh)),
        "rows": rows[:, 0].tolist(), "process": list(process_info()),
        "local_batch": local_batch_size(8),
        "local_batch_6": outcome(lambda: local_batch_size(6)),
        "model_3": outcome(lambda: make_mesh(4, model_parallel=3)),
        "too_many": outcome(lambda: make_mesh(8)),
        "pipe": outcome(lambda: mesh_shape(make_mesh(4, 1, pipeline_parallel=2))),
    }
    (out / f"rank{rank}.json").write_text(json.dumps(mine))


def run_eval_cli(spec: dict, job: Path, out: Path, rank: int) -> None:
    """The eval CLI with --data-parallel (and --model-parallel) over the
    world; every rank writes the summary line it returns."""
    from probpose_pytorch_tpu_torch.eval import run as eval_run

    line = eval_run.main([str(a) if not str(a).startswith("@") else str(job / str(a)[1:])
                          for a in spec["args"]])
    (out / f"rank{rank}.json").write_text(json.dumps(line))


def _toy_block(name: str, mesh):
    """(block_fn, seq_block_fn) of the pipeline tests' blocks (the JAX
    tests' toys and the ViT block) on `mesh`."""
    import torch.nn.functional as F

    from probpose_pytorch_tpu_torch.parallel.pipeline import tp_enter, tp_leave

    if name == "toy":
        fn = lambda p, h: torch.tanh(h @ p["w"] + p["b"])  # noqa: E731
        return fn, fn
    if name == "bf16":
        fn = lambda p, h: torch.tanh(h @ p["w"].bfloat16() + p["b"].bfloat16())  # noqa: E731
        return fn, fn
    if name == "tp":
        g = mesh.get_group("model")
        return (lambda p, h: h + tp_leave(torch.tanh(tp_enter(h, g) @ p["w1"]) @ p["w2"], g)
                + p["b"],
                lambda p, h: h + torch.tanh(h @ p["w1"]) @ p["w2"] + p["b"])
    raise ValueError(name)


def _toy_loss(name: str):
    mse = lambda lp, h, t: ((h @ lp["w"] - t) ** 2).mean()  # noqa: E731
    if name == "bf16":
        return lambda lp, h, t: ((h.float() @ lp["w"] - t) ** 2).mean()
    if name == "aux":
        def aux(lp, h, t):
            loss = mse(lp, h, t)
            return loss, {"h_mean": h.float().mean(), "loss_copy": loss}
        return aux
    return mse


def _local(arrays: dict, specs: dict, coords: dict, shape: dict) -> dict:
    """This rank's slices of whole stacked leaves under their specs."""
    from probpose_pytorch_tpu_torch.parallel.sharding import local_slice

    out = {}
    for k, a in arrays.items():
        t = torch.from_numpy(a)
        for dim, ax in enumerate(specs.get(k, ["pipe"])):
            if ax is not None and shape.get(ax, 1) > 1:
                t = local_slice(t, dim, coords[ax], shape[ax])
        out[k] = t.clone().requires_grad_()
    return out


def run_pp_toy(spec: dict, job: Path, out: Path, rank: int) -> None:
    """The pipeline engines on the job's cases (GPipe forward and
    gradients, 1F1B and interleaved 1F1B; the toys, bf16, aux, dx chained
    into an embedding, a Megatron toy and the ViT block in stages); every
    rank writes its outputs: its rows, its stage's (and model slice's)
    gradients, summed over the data axis where they are partial."""
    import torch.distributed as dist

    from probpose_pytorch_tpu_torch.models.vit import pp_block_fns
    from probpose_pytorch_tpu_torch.parallel import make_mesh
    from probpose_pytorch_tpu_torch.parallel.mesh import mesh_coords, mesh_shape
    from probpose_pytorch_tpu_torch.parallel.pipeline import (
        pipeline_1f1b,
        pipeline_1f1b_interleaved,
        pipeline_spmd,
    )

    data = dict(np.load(job / spec["inputs"]))
    res, meshes = {}, {}
    for case in spec["cases"]:
        key = (case["model"], case["pipe"])
        if key not in meshes:
            meshes[key] = make_mesh(None, case["model"], pipeline_parallel=case["pipe"])
        mesh = meshes[key]
        coords, shape = mesh_coords(mesh), mesh_shape(mesh)
        name = case["name"]
        arrays = {k[len(name) + 3:]: v for k, v in data.items() if k.startswith(f"{name}/p_")}
        local = _local(arrays, case.get("specs", {}), coords, shape)
        rows = lambda a: torch.from_numpy(a).chunk(shape["data"])[coords["data"]]  # noqa: E731
        x = rows(data[f"{name}/x"])
        if case.get("x_dtype") == "bfloat16":
            x = x.bfloat16()
        if case["block"] == "vit":
            g = mesh.get_group("model") if shape.get("model", 1) > 1 else None
            block, seq, _ = pp_block_fns(num_heads=case["heads"], mlp_ratio=2.0,
                                         embed_dim=x.shape[-1], dtype=torch.float32,
                                         attn_impl=case["attn"], tp=shape.get("model", 1),
                                         remat=case.get("remat", False), tp_group=g)
        else:
            block, seq = _toy_block(case["block"], mesh)
        if case["kind"] == "gpipe":
            out_ = pipeline_spmd(block, local, x, mesh, microbatches=case["m"],
                                 seq_block_fn=seq)
            res[f"{name}/out"] = out_.detach().numpy()
            grads = torch.autograd.grad((out_ ** 2).sum() if case["block"] != "vit"
                                        else (out_ ** 2).mean() / shape["data"],
                                        list(local.values()))
            for k, gr in zip(local, grads):
                gr = gr.contiguous()
                if shape["data"] > 1:
                    dist.all_reduce(gr, group=mesh.get_group("data"))
                res[f"{name}/g_{k}"] = gr.numpy()
            continue
        t = rows(data[f"{name}/t"])
        lp = {"w": torch.from_numpy(data[f"{name}/lp_w"]).requires_grad_()}
        loss_fn = _toy_loss(case.get("loss", "mse"))
        ep = None
        if f"{name}/ep_w" in data:  # dx chained into an upstream embedding
            ep = torch.from_numpy(data[f"{name}/ep_w"]).requires_grad_()
            x = torch.tanh(x @ ep)
        kw = dict(microbatches=case["m"], seq_block_fn=seq, loss_has_aux=case.get("aux", False),
                  model_axis="model" if shape.get("model", 1) > 1 else None)
        if case["kind"] == "interleaved":
            got = pipeline_1f1b_interleaved(block, local, loss_fn, lp, x.detach(), t, mesh,
                                            virtual=case["v"], **kw)
        else:
            got = pipeline_1f1b(block, local, loss_fn, lp, x.detach(), t, mesh, **kw)
        loss, d_p, d_lp, dx = got[:4]
        res[f"{name}/loss"] = loss.numpy()
        res.update({f"{name}/g_{k}": v.numpy() for k, v in d_p.items()})
        res[f"{name}/dlp_w"] = d_lp["w"].numpy()
        res[f"{name}/dx"] = dx.float().numpy()
        res[f"{name}/dx_dtype"] = np.array(str(dx.dtype))
        if case.get("aux"):
            res.update({f"{name}/aux_{k}": v.numpy() for k, v in got[4].items()})
        if ep is not None:
            (dep,) = torch.autograd.grad(x, [ep], dx)
            if shape["data"] > 1:
                dist.all_reduce(dep, group=mesh.get_group("data"))
            res[f"{name}/dep_w"] = dep.numpy()
    np.savez(out / f"rank{rank}.npz", **res)
    (out / f"rank{rank}.json").write_text(json.dumps({"coords": mesh_coords(
        next(iter(meshes.values())))}))


def run_train_cli(spec: dict, job: Path, out: Path, rank: int) -> None:
    """The training CLI on every rank of the world (the world already up:
    the CLI's launch finds it)."""
    from probpose_pytorch_tpu_torch.train import cli

    cli.main([str(a) if not str(a).startswith("@") else str(job / str(a)[1:])
              for a in spec["args"]])
    (out / f"rank{rank}.json").write_text(json.dumps({}))


RUNNERS = {"step": run_step, "fit": run_fit, "predict": run_predict, "detect": run_detect,
           "eval_cli": run_eval_cli, "mesh": run_mesh, "pp_toy": run_pp_toy,
           "train_cli": run_train_cli}


def main() -> None:
    job, rank, world = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    spec = json.loads((job / "job.json").read_text())
    from probpose_pytorch_tpu_torch.models.vit import ViTConfig
    from probpose_pytorch_tpu_torch.parallel import maybe_initialize_distributed

    for name, preset in spec.get("presets", {}).items():
        ViTConfig.PRESETS.setdefault(name, preset)
    maybe_initialize_distributed(f"file://{job / 'rendezvous'}", world, rank, device="cpu")
    failed = False
    for name, scenario in spec["scenarios"].items():
        out = job / name
        out.mkdir(exist_ok=True)
        try:
            RUNNERS[scenario["kind"]](scenario, job, out, rank)
        except Exception:
            (out / f"rank{rank}.error").write_text(traceback.format_exc())
            failed = True
            break  # the other ranks may wait in a collective: end the world
    import torch.distributed as dist

    if not failed:
        dist.barrier()
        dist.destroy_process_group()
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()


def start_world(job: Path, world: int) -> tuple:
    """Start `world` ranks of this script on `job`; returns the handle
    `wait_world` takes."""
    import os
    import subprocess

    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(Path(__file__).parents[1]))
    logs = [open(job / f"log{r}.txt", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, str(job), str(r), str(world)],
                              env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    return job, procs, logs


def wait_world(handle: tuple, timeout: float = 240.0) -> None:
    """Wait at most `timeout` seconds for the ranks, kill what is left and
    raise on a rank that failed (with its traceback and the end of its
    output)."""
    import subprocess
    import time

    job, procs, logs = handle
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        errors = "\n".join(e.read_text() for e in sorted(job.glob("*/rank*.error")))
        tail = (job / f"log{bad[0]}.txt").read_text()[-3000:]
        raise RuntimeError(f"ranks {bad} of the world failed or were killed at the "
                           f"{timeout:.0f} s deadline:\n{errors}\n{tail}")
