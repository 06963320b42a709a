"""Train state, learning-rate schedule and optimizer (port of
probpose_pytorch_tpu/train/state.py).

The optimizer is a functional update written out in optax's order, so a run
continues a JAX run step for step (compat/from_jax.py carries the state):

    MultiSteps(k,                         # when accum_steps = k > 1
      apply_if_finite(                    # when max_nonfinite_skips > 0
        multi_transform(                  # with frozen labels
          trainable:
            clip_by_global_norm(clip)     # optax form: t / |g| * clip, no epsilon
            -> scale_by_adam(b1, b2, 1e-8)  # eps outside the square root
            -> add_decayed_weights(wd)    # every leaf: biases, LN and BN too
            -> scale_by_schedule(-lr(count)),
          frozen: set_to_zero())))

With frozen labels (train/loop.py: `frozen_backbone`, `train_lora_only`)
the inner chain sees the trainable leaves only, as optax's masked states
do: the clip's norm is theirs, Adam keeps moments for them alone, and a
frozen leaf's update is exactly 0, weight decay included. apply_if_finite
still tests every leaf and MultiSteps accumulates every leaf.

`torch.optim.AdamW` with `clip_grad_norm_` and `OneCycleLR` is not the same
function: clip_grad_norm_ adds 1e-6 to the norm and OneCycleLR's phase
boundaries sit one step from optax's. State lives on the parameters' device
and nothing here synchronises with the host: a non-finite step is skipped
with `torch.where`, not a Python branch, and the schedule's constants are
copied to a device once (a blocking host-to-device copy waits for the
stream). Parameters are updated in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Callable, Sequence

import numpy as np
import torch

from probpose_pytorch_tpu_torch.train.config import OptimConfig

__all__ = [
    "onecycle_schedule",
    "build_schedule",
    "global_norm",
    "AdamW",
    "OptState",
    "MultiSteps",
    "MultiStepsState",
    "make_optimizer",
    "TrainState",
]

Schedule = Callable[[torch.Tensor], torch.Tensor]


def onecycle_schedule(cfg: OptimConfig, total_steps: int) -> Schedule:
    """optax.cosine_onecycle_schedule(max(total_steps, min_total), peak_lr,
    pct_start, div_factor, final_div_factor), min_total being the floor
    that keeps the warmup interval non-empty. Phase boundaries are
    int(pct_start * T) and T; between them the value is
    end + (start - end) / 2 * (cos(pi * pct) + 1), rounded as XLA rounds
    the jitted optax schedule: (start - end) / 2 is taken in float64 on the
    host, the rest in float32 on the count's device."""
    min_total = int(np.ceil(1.0 / max(cfg.pct_start, 1e-3))) + 1
    T = max(total_steps, min_total)
    bounds = np.array([0, int(cfg.pct_start * T), int(T)])
    values = np.cumprod([cfg.peak_lr / cfg.div_factor, cfg.div_factor,
                         1.0 / (cfg.div_factor * cfg.final_div_factor)])
    half = (values[:-1] - values[1:]) / 2.0
    consts: dict[torch.device, tuple[torch.Tensor, ...]] = {}

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = torch.as_tensor(count)
        dev = count.device
        if dev not in consts:
            f32 = lambda v: torch.tensor(np.asarray(v, np.float32), device=dev)
            consts[dev] = (torch.tensor(bounds[:-1], device=dev),
                           torch.tensor(bounds[1:], device=dev),
                           f32(values[1:]), f32(half), f32(values[-1]))
        lo, hi, ends, halves, last = consts[dev]
        # XLA turns the division by the constant interval into a product
        # with its float32 reciprocal; so does this.
        pct = (count - lo).float() * (1.0 / (hi - lo).float())
        # cos of the float32 argument, correctly rounded to float32.
        cos = torch.cos((math.pi * pct).double()).float()
        # end + half * (cos + 1) as one fused multiply-add, as XLA emits it.
        interp = (ends.double() + halves.double() * (cos + 1).double()).float()
        inside = (lo <= count) & (count < hi)
        return (inside.float() * interp).sum() + (int(bounds[-1]) <= count).float() * last

    return schedule


def build_schedule(cfg: OptimConfig, total_steps: int) -> Schedule:
    """`OptimConfig.schedule`: "onecycle" (the reference recipe) or
    "constant" (flat peak_lr)."""
    if cfg.schedule == "onecycle":
        return onecycle_schedule(cfg, total_steps)
    if cfg.schedule == "constant":
        return lambda count: torch.full((), cfg.peak_lr, dtype=torch.float32,
                                        device=torch.as_tensor(count).device)
    if cfg.schedule == "cosine":
        raise NotImplementedError(
            "optim.schedule='cosine' is not ported to PyTorch yet (ROADMAP item 6)")
    raise ValueError(f"unknown optim.schedule {cfg.schedule!r}")


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


@dataclass
class OptState:
    """optax's state of the chain above, one tensor per trainable parameter
    in the order of `TrainState.names` (every parameter without frozen
    labels). `count` is scale_by_adam's,
    `schedule_count` scale_by_schedule's; the last three are
    apply_if_finite's (all 0-d, on the parameters' device)."""

    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: torch.Tensor
    schedule_count: torch.Tensor
    notfinite_count: torch.Tensor
    last_finite: torch.Tensor
    total_notfinite: torch.Tensor


class AdamW:
    """The functional optimizer: `init(params)` and
    `update(grads, state, params) -> (updates, state)`. `trainable`, the
    indices of the parameters that train (None: all), masks the others as
    optax.multi_transform with set_to_zero does."""

    def __init__(self, cfg: OptimConfig, schedule: Schedule,
                 trainable: Sequence[int] | None = None):
        self.cfg = cfg
        self.schedule = schedule
        self.eps = 1e-8
        self.trainable = None if trainable is None else list(trainable)

    def _masked(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """The trainable entries of a per-parameter list."""
        return tensors if self.trainable is None else [tensors[i] for i in self.trainable]

    def init(self, params: list[torch.Tensor]) -> OptState:
        dev = params[0].device
        zero = lambda dtype: torch.zeros((), dtype=dtype, device=dev)
        params = self._masked(params)
        return OptState(
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params],
            count=zero(torch.int32),
            schedule_count=zero(torch.int32),
            notfinite_count=zero(torch.int32),
            last_finite=torch.ones((), dtype=torch.bool, device=dev),
            total_notfinite=zero(torch.int32),
        )

    def update(self, grads: list[torch.Tensor], state: OptState,
               params: list[torch.Tensor]) -> tuple[list[torch.Tensor], OptState]:
        cfg = self.cfg
        grads = [g.float() for g in grads]
        every, grads, params = grads, self._masked(grads), self._masked(params)
        g_norm = global_norm(grads)
        # clip_by_global_norm: t where |g| < clip, else (t / |g|) * clip.
        clipped = torch._foreach_mul(torch._foreach_div(grads, g_norm), cfg.clip_grad_norm)
        trigger = g_norm < cfg.clip_grad_norm
        g = [torch.where(trigger, t, c) for t, c in zip(grads, clipped)]
        # scale_by_adam: moments as (1 - b) * g^order + b * m.
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - cfg.b1),
                                torch._foreach_mul(state.mu, cfg.b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - cfg.b2),
                                torch._foreach_mul(state.nu, cfg.b2))
        count = state.count + 1
        bc1 = 1 - torch.pow(cfg.b1, count)
        bc2 = 1 - torch.pow(cfg.b2, count)
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), self.eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        # add_decayed_weights on every leaf, then -lr(count).
        u = torch._foreach_add(u, torch._foreach_mul(params, cfg.weight_decay))
        u = torch._foreach_mul(u, -self.schedule(state.schedule_count))
        if self.trainable is not None:  # set_to_zero on the frozen leaves
            full = [torch.zeros_like(g) for g in every]
            for i, t in zip(self.trainable, u):
                full[i] = t
            u = full
        new = OptState(mu, nu, count, state.schedule_count + 1, state.notfinite_count,
                       state.last_finite, state.total_notfinite)
        if cfg.max_nonfinite_skips <= 0:
            return u, new
        # apply_if_finite: a step with non-finite gradients leaves the inner
        # state (moments and both counts) as it was and updates nothing,
        # unless more than max_nonfinite_skips came in a row.
        finite = torch.isfinite(torch.stack(
            torch._foreach_norm(every, ord=float("inf")))).all()
        notfinite = torch.where(finite, 0, state.notfinite_count + 1).int()
        accept = finite | (notfinite > cfg.max_nonfinite_skips)
        pick = lambda a, b: [torch.where(accept, x, y) for x, y in zip(a, b)]
        return [torch.where(accept, x, 0.0) for x in u], OptState(
            mu=pick(mu, state.mu),
            nu=pick(nu, state.nu),
            count=torch.where(accept, count, state.count),
            schedule_count=torch.where(accept, new.schedule_count, state.schedule_count),
            notfinite_count=notfinite,
            last_finite=finite,
            total_notfinite=torch.where(finite, state.total_notfinite,
                                        state.total_notfinite + 1).int(),
        )


@dataclass
class MultiStepsState:
    """optax.MultiStepsState: the micro-step within the current k, the
    count of emitted updates, the inner optimizer's state and the running
    mean of the micro-steps' gradients (one tensor per parameter)."""

    mini_step: torch.Tensor
    gradient_step: torch.Tensor
    inner: OptState
    acc: list[torch.Tensor]


class MultiSteps:
    """optax.MultiSteps(inner, every_k_schedule=k) with use_grad_mean: the
    gradients of k micro-steps are averaged (Welford: acc + (g - acc) /
    (n + 1)) and the inner optimizer's update is applied on every k-th.
    As optax does, the inner update is computed on every micro-step and
    kept only on the k-th, the zero updates of the others are the inner
    updates times 0, and the accumulator is reset by a product with 0, so
    a non-finite micro-batch stays in it as it does in optax."""

    def __init__(self, inner: AdamW, k: int):
        self.inner = inner
        self.k = k

    def init(self, params: list[torch.Tensor]) -> MultiStepsState:
        zero = torch.zeros((), dtype=torch.int32, device=params[0].device)
        return MultiStepsState(mini_step=zero, gradient_step=zero.clone(),
                               inner=self.inner.init(params),
                               acc=[torch.zeros_like(p) for p in params])

    def update(self, grads: list[torch.Tensor], state: MultiStepsState,
               params: list[torch.Tensor]) -> tuple[list[torch.Tensor], MultiStepsState]:
        grads = [g.float() for g in grads]
        n = (state.mini_step + 1).float()
        acc = torch._foreach_add(state.acc, torch._foreach_div(
            torch._foreach_sub(grads, state.acc), n))
        updates, inner = self.inner.update(acc, state.inner, params)
        emit = state.mini_step == self.k - 1

        def pick(new, old):  # the inner state moves on the k-th micro-step only
            if isinstance(new, (list, tuple)):
                return [torch.where(emit, a, b) for a, b in zip(new, old)]
            return torch.where(emit, new, old)

        return torch._foreach_mul(updates, emit.float()), MultiStepsState(
            mini_step=((state.mini_step + 1) % self.k).int(),
            gradient_step=torch.where(emit, state.gradient_step + 1, state.gradient_step).int(),
            inner=OptState(**{f.name: pick(getattr(inner, f.name), getattr(state.inner, f.name))
                              for f in fields(OptState)}),
            acc=torch._foreach_mul(acc, (~emit).float()))


def make_optimizer(cfg: OptimConfig, total_steps: int,
                   frozen_labels: Sequence[str] | None = None) -> AdamW | MultiSteps:
    """The optimizer of `cfg`, wrapped in MultiSteps when accum_steps > 1;
    the families this port does not run raise, naming their ROADMAP
    item. `frozen_labels`, "trainable" or "frozen" for each parameter in
    the order the optimizer is given them, masks the frozen ones."""
    if cfg.optimizer != "adamw":
        raise NotImplementedError(
            f"optim.optimizer={cfg.optimizer!r} is not ported to PyTorch yet "
            "(ROADMAP item 6); the port has 'adamw'")
    trainable = None
    if frozen_labels is not None:
        unknown = set(frozen_labels) - {"trainable", "frozen"}
        if unknown:
            raise ValueError(f"frozen labels must be 'trainable' or 'frozen', not {unknown}")
        trainable = [i for i, label in enumerate(frozen_labels) if label == "trainable"]
    tx = AdamW(cfg, build_schedule(cfg, total_steps), trainable)
    return MultiSteps(tx, cfg.accum_steps) if cfg.accum_steps > 1 else tx


class TrainState:
    """step, the model's parameters (float32 masters, updated in place) and
    BatchNorm statistics (its buffers), the optimizer state and the EMA of
    the parameters. `names` fixes the parameter order of every list.

    `host_step` mirrors `step` on the host, so the step can seed its
    augmentation draws without reading the device; whatever sets `step`
    (a checkpoint's restore, compat/from_jax.py) sets both."""

    def __init__(self, model: torch.nn.Module, tx: AdamW | MultiSteps, ema: bool):
        self.model = model
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        device = self.params[0].device
        self.step = torch.zeros((), dtype=torch.int32, device=device)
        self.host_step = 0
        self.opt_state = tx.init(self.params)
        self.ema_params = [p.detach().clone() for p in self.params] if ema else None

    def apply_gradients(self, grads: list[torch.Tensor], tx: AdamW | MultiSteps,
                        ema_decay: float | None = None) -> None:
        """One optimizer step (or micro-step) in place; the EMA (e * decay
        + p * (1 - decay)) follows the new parameters even when the step was
        skipped, and `step` and the EMA advance on every micro-step, as
        the JAX TrainState's do."""
        updates, self.opt_state = tx.update(grads, self.opt_state, self.params)
        with torch.no_grad():
            torch._foreach_add_(self.params, updates)
            if ema_decay is not None and self.ema_params is not None:
                new = torch._foreach_add(torch._foreach_mul(self.ema_params, ema_decay),
                                         torch._foreach_mul(self.params, 1.0 - ema_decay))
                torch._foreach_copy_(self.ema_params, new)
        self.step = self.step + 1
        self.host_step += 1
