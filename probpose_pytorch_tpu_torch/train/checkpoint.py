"""Checkpoints with resume (port of probpose_pytorch_tpu/train/checkpoint.py),
in the port's own format.

A checkpoint is one `torch.save` file, `<directory>/<step>`, holding the
step, the parameters and buffers (the BatchNorm statistics) by name, the
optimizer state (with MultiSteps' accumulator) and the EMA, all on the CPU;
beside it, `meta_<step>.json` holds the caller's metadata. Files are written
under a temporary name and moved into place with `os.replace`, so a reader
never sees half a checkpoint. A JAX run's state loads through
compat/from_jax.py:load_jax_train_state instead; `write_run` writes a
fresh run of given weights for the checkpoint tools.

A run on a mesh saves the same file as a run on one device: every rank
calls `save`, the split parameters, their EMA and the moments are gathered
whole (train/state.py: the optimizer's `ShardPlan`; a pipelined trunk's
stages over the pipe axis, into JAX's stacked layout), rank 0 writes, and
every rank waits for the file before it goes on (the write is then not
asynchronous). Every rank restores from the whole tensors and keeps its
slices, so a checkpoint moves between one device and any mesh.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist

from probpose_pytorch_tpu_torch.train.state import ShardPlan, TrainState

__all__ = ["CheckpointManager", "state_is_finite", "write_run"]


def _to_host(x: Any) -> Any:
    """A copy of an optimizer-state tree on the CPU, dataclasses as dicts."""
    if dataclasses.is_dataclass(x):
        return {f.name: _to_host(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_to_host(v) for v in x]
    return x.detach().to("cpu", copy=True)


def _like(template: Any, saved: Any, what: str) -> Any:
    """`saved` (a `_to_host` tree) in the structure, devices and dtypes of
    `template`."""
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _like(getattr(template, f.name), saved[f.name], f"{what}.{f.name}")
            for f in dataclasses.fields(template)})
    if isinstance(template, (list, tuple)):
        if len(saved) != len(template):
            raise ValueError(f"{what}: {len(saved)} saved tensors, the state has {len(template)}")
        return [_like(t, s, f"{what}[{i}]") for i, (t, s) in enumerate(zip(template, saved))]
    if saved.shape != template.shape:
        raise ValueError(f"{what}: saved shape {tuple(saved.shape)} != {tuple(template.shape)}")
    return saved.to(device=template.device, dtype=template.dtype)


def state_is_finite(state: TrainState) -> bool:
    """True when every parameter, floating buffer and EMA tensor is finite.
    A non-finite state is never saved: the keep-N rotation would evict the
    clean checkpoints that non-finite recovery restores. One read of the
    device per call, at save sites only."""
    tensors = list(state.params) + list(state.ema_params or [])
    tensors += [b for b in state.model.buffers() if b.is_floating_point()]
    finite = torch.stack([torch.isfinite(t).all() for t in tensors]).all()
    if _on_mesh(state):  # every rank decides alike, or the save's gathers hang
        finite = finite.float()
        dist.all_reduce(finite, op=dist.ReduceOp.MIN)
    return bool(finite)


def _on_mesh(state: TrainState) -> bool:
    return getattr(state.model, "mesh", None) is not None


def _split(state: TrainState) -> tuple[ShardPlan, list, list]:
    """(the state's plan, each parameter's model-axis dim and pipe-axis dim)."""
    plan = getattr(state.tx, "plan", None) or ShardPlan()
    none = [None] * len(state.params)
    return plan, plan.tp_dims or none, plan.pp_dims or none


def _state_payload(state: TrainState) -> dict[str, Any]:
    """The whole train state as CPU tensors (a snapshot: training may go on
    changing the live tensors in place)."""
    model = state.model
    plan, dims, pp = _split(state)
    whole = lambda ts: {n: plan.whole(t.detach(), d, e).to("cpu", copy=True)
                        for n, t, d, e in zip(state.names, ts, dims, pp)}
    opt = state.tx.whole_state(state.opt_state) if _on_mesh(state) else state.opt_state
    return {
        "step": state.host_step,
        "params": whole(state.params),
        "buffers": {n: b.detach().to("cpu", copy=True) for n, b in model.named_buffers()},
        "opt_state": _to_host(opt),
        "ema": None if state.ema_params is None else whole(state.ema_params),
    }


def _load_payload(state: TrainState, payload: dict[str, Any]) -> None:
    """Copy a `_state_payload` into the live `state` in place, on its
    devices: the model's parameters and buffers keep their identity."""
    if sorted(payload["params"]) != sorted(state.names):
        raise ValueError("the checkpoint's parameter names differ from the model's")
    buffers = dict(state.model.named_buffers())
    if sorted(payload["buffers"]) != sorted(buffers):
        raise ValueError("the checkpoint's buffer names differ from the model's")
    if (payload["ema"] is None) != (state.ema_params is None):
        raise ValueError("the checkpoint and the state disagree on keeping an EMA")
    plan, dims, pp = _split(state)
    with torch.no_grad():
        for n, p, d, e in zip(state.names, state.params, dims, pp):
            p.copy_(_like(p, plan.part(payload["params"][n], d, e), n))
        for n, b in buffers.items():
            b.copy_(_like(b, payload["buffers"][n], n))
        if state.ema_params is not None:
            state.ema_params = [_like(t, plan.part(payload["ema"][n], d, e), n)
                                for n, t, d, e in zip(state.names, state.ema_params, dims, pp)]
    if _on_mesh(state):
        template = state.tx.whole_state(state.opt_state)
        state.opt_state = state.tx.part_state(_like(template, payload["opt_state"], "opt_state"))
    else:
        state.opt_state = _like(state.opt_state, payload["opt_state"], "opt_state")
    state.step = torch.tensor(payload["step"], dtype=torch.int32, device=state.step.device)
    state.host_step = int(payload["step"])


class CheckpointManager:
    """Save, rotate and restore train states under one directory.

    `async_save=True` returns from `save` once the state is copied to host
    memory and writes the file in a background thread; `save`, `wait`,
    `restore` and `close` first join the write in flight, so no read sees a
    torn or missing file."""

    def __init__(self, directory: str | Path, keep: int = 3, async_save: bool = False):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.directory.iterdir() if p.name.isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, force: bool = True,
             metadata: dict | None = None) -> None:
        """Save `state` as checkpoint `step`, over any checkpoint of that
        step (a stale one from an earlier run in a reused directory would
        otherwise be restored), then remove the oldest until `keep` are
        left. `force` is JAX's flag; the port always overwrites, so any
        value writes."""
        self.wait()
        payload = _state_payload(state)
        if _on_mesh(state):
            if dist.get_rank() == 0:
                self._write(step, payload, metadata)
            dist.barrier()
        elif self.async_save:
            self._thread = threading.Thread(target=self._write_async,
                                            args=(step, payload, metadata))
            self._thread.start()
        else:
            self._write(step, payload, metadata)

    def _write_async(self, step: int, payload: dict, metadata: dict | None) -> None:
        try:
            self._write(step, payload, metadata)
        except BaseException as e:  # raised again by wait()
            self._error = e

    def _write(self, step: int, payload: dict, metadata: dict | None) -> None:
        tmp = self.directory / f".{step}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.directory / str(step))
        if metadata is not None:
            tmp = self.directory / f".meta_{step}.json.tmp"
            tmp.write_text(json.dumps(metadata))
            os.replace(tmp, self.directory / f"meta_{step}.json")
        for old in self.all_steps()[:-self.keep] if self.keep > 0 else []:
            (self.directory / str(old)).unlink()
            (self.directory / f"meta_{old}.json").unlink(missing_ok=True)

    def wait(self) -> None:
        """Join the write in flight, and raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def read_metadata(self, step: int | None = None) -> dict:
        """The metadata saved with checkpoint `step` (default the latest);
        {} when there is none."""
        self.wait()
        step = self.latest_step() if step is None else step
        path = self.directory / f"meta_{step}.json"
        if step is None or not path.exists():
            return {}
        return json.loads(path.read_text())

    def read(self, step: int | None = None, mmap: bool = False) -> dict[str, Any]:
        """Checkpoint `step` (default the latest) as saved: a dict of `step`,
        `params`, `buffers` and `ema` (name -> CPU tensor; `ema` may be
        None) and `opt_state`. With `mmap`, the tensors are mapped from the
        file (copy on write), so what the caller never reads is never
        loaded."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(self.directory / str(step), map_location="cpu", weights_only=True,
                          mmap=mmap)

    def restore(self, target_state: TrainState, step: int | None = None) -> TrainState:
        """Load checkpoint `step` (default the latest) into the live
        `target_state` on its devices, and return it."""
        _load_payload(target_state, self.read(step))
        return target_state

    def close(self) -> None:
        self.wait()


def write_run(cfg: Any, out_dir: str | Path, step: int, weights: dict[str, torch.Tensor],
              ema: dict[str, torch.Tensor] | None, device: torch.device | str = "cuda",
              partial: bool = False) -> None:
    """Write `<out_dir>/config.json` (`cfg`) and `<out_dir>/checkpoints/<step>`:
    the model of `cfg` with `weights` (parameters and buffers by name:
    every one, or with `partial` any, the rest as `cfg.seed` draws them),
    the EMA `ema` (the parameters when None and `cfg` keeps one) and a
    fresh optimizer state, built on `device`. The tools that make a
    checkpoint of their own write through this (compat/merge_lora.py,
    train/average.py, compat/convert.py)."""
    from probpose_pytorch_tpu_torch.train.loop import Trainer

    state = Trainer.create(cfg, steps_per_epoch=1, device=device).state
    with torch.no_grad():
        unknown = state.model.load_state_dict(weights, strict=not partial).unexpected_keys
        if unknown:
            raise ValueError(f"entries the model of the config lacks: {unknown}")
        if state.ema_params is not None:
            state.ema_params = [p.detach().clone() if ema is None else ema[n].to(p)
                                for n, p in zip(state.names, state.params)]
    state.step = torch.tensor(step, dtype=torch.int32, device=state.step.device)
    state.host_step = int(step)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg.save(out_dir / "config.json")
    CheckpointManager(out_dir / "checkpoints").save(int(step), state)
