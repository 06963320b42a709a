"""Train state, learning-rate schedule and optimizer (port of
probpose_pytorch_tpu/train/state.py).

The optimizer is a functional update written out in optax's order, so a run
continues a JAX run step for step (compat/from_jax.py carries the state):

    MultiSteps(k,                         # when accum_steps = k > 1
      apply_if_finite(                    # when max_nonfinite_skips > 0
        multi_transform(                  # with frozen labels
          trainable:
            clip_by_global_norm(clip)     # optax form: t / |g| * clip, no epsilon
            -> <family>,
          frozen: set_to_zero())))

where the family is optax's adamw, lion or adafactor as the JAX package
builds them:

    adamw:     scale_by_adam(b1, b2, 1e-8)  # eps outside the square root
               -> add_decayed_weights(wd)   # every leaf: biases, LN and BN too
               -> scale_by_schedule(-lr(count))
    lion:      scale_by_lion(b1, b2) -> add_decayed_weights(wd)
               -> scale_by_schedule(-lr(count))
    adafactor: scale_by_factored_rms -> clip_by_block_rms(1)
               -> scale_by_schedule(lr(count)) -> scale_by_param_block_rms
               -> add_decayed_weights(wd) (when wd != 0) -> scale(-1)

Adafactor factors a leaf over the two largest axes of its JAX layout
(`param_layouts`, `factored_dims`), so a carried JAX state lands on the
same physical axes.

With frozen labels (train/loop.py: `frozen_backbone`, `train_lora_only`)
the inner chain sees the trainable leaves only, as optax's masked states
do: the clip's norm is theirs, Adam keeps moments for them alone, and a
frozen leaf's update is exactly 0, weight decay included. Every family
keeps its moments for the trainable leaves only. apply_if_finite
still tests every leaf and MultiSteps accumulates every leaf.

`torch.optim.AdamW` with `clip_grad_norm_` and `OneCycleLR` is not the same
function: clip_grad_norm_ adds 1e-6 to the norm and OneCycleLR's phase
boundaries sit one step from optax's. State lives on the parameters' device
and nothing here synchronises with the host: a non-finite step is skipped
with `torch.where`, not a Python branch, and the schedule's constants are
copied to a device once (a blocking host-to-device copy waits for the
stream). Parameters are updated in place.

On a mesh (`ShardPlan`) the optimizer takes the gradients already summed
over the data axis and works as JAX's sharded program computes:
  * a leaf split over the model axis (parallel/sharding.py:shard_params)
    adds its squares to the clip's global norm once over the model group,
    a whole leaf once;
  * AdamW and Lion, elementwise, update the rank's slices: of a split leaf
    its own slice, and under ZeRO-1 the data-axis slice of each moment the
    plan splits, after which the parameter delta is gathered over "data";
  * Adafactor, whose factored rows and columns and block RMS span whole
    leaves, gathers the leaves and the ZeRO-1 moments it needs, computes
    whole (its moments of a split leaf stay whole on every model rank) and
    keeps the rank's slices.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, fields
from typing import Callable, Sequence

import numpy as np
import torch

from probpose_pytorch_tpu_torch.parallel.collectives import (
    all_gather_cat,
    all_reduce_,
    group_rank,
    group_size,
)
from probpose_pytorch_tpu_torch.train.config import OptimConfig

__all__ = [
    "onecycle_schedule",
    "cosine_schedule",
    "warmup_cosine_decay_schedule",
    "build_schedule",
    "global_norm",
    "Optimizer",
    "AdamW",
    "Lion",
    "Adafactor",
    "OptState",
    "LionState",
    "AdafactorState",
    "param_layouts",
    "factored_dims",
    "MultiSteps",
    "MultiStepsState",
    "make_optimizer",
    "TrainState",
    "ShardPlan",
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


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule(init_value, peak_value,
    warmup_steps, decay_steps, end_value): a linear ramp over the warm-up,
    then a cosine to `end_value` over the rest of decay_steps, which counts
    the warm-up. Rounded as XLA rounds the jitted optax schedule: each
    division by a constant is a product with the float32 reciprocal, and
    constant factors are folded in float32."""
    f32 = np.float32
    warmup = int(warmup_steps)
    span = float(decay_steps - warmup)
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    inv_warmup = float(f32(1.0 / warmup))
    rise, top, end = float(f32(init_value - peak_value)), float(f32(peak_value)), float(f32(alpha))
    omega = float(f32(f32(math.pi) * f32(1.0 / span)))
    half = float(f32(f32(0.5) * f32(1.0 - alpha)))

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = torch.as_tensor(count)
        ramp = (1 - count.clamp(0, warmup).float() * inv_warmup) * rise + top
        arg = torch.clamp_max((count - warmup).float(), span) * omega
        # cos of the float32 argument, correctly rounded to float32.
        cos = torch.cos(arg.double()).float()
        return torch.where(count < warmup, ramp, ((cos + 1) * half + end) * top)

    return schedule


def cosine_schedule(cfg: OptimConfig, total_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule(peak_lr / div_factor, peak_lr,
    warmup, max(total_steps, warmup + 1), peak_lr / final_div_factor) with
    warmup = max(int(total_steps * pct_start), 1)."""
    warmup = max(int(total_steps * cfg.pct_start), 1)
    return warmup_cosine_decay_schedule(cfg.peak_lr / cfg.div_factor, cfg.peak_lr, warmup,
                                        max(total_steps, warmup + 1),
                                        cfg.peak_lr / cfg.final_div_factor)


def build_schedule(cfg: OptimConfig, total_steps: int) -> Schedule:
    """`OptimConfig.schedule`: "onecycle" (the reference recipe), "cosine"
    (linear warm-up over pct_start, then cosine decay to
    peak_lr / final_div_factor) or "constant" (flat peak_lr)."""
    if cfg.schedule == "onecycle":
        return onecycle_schedule(cfg, total_steps)
    if cfg.schedule == "constant":
        return lambda count: torch.full((), cfg.peak_lr, dtype=torch.float32,
                                        device=torch.as_tensor(count).device)
    if cfg.schedule == "cosine":
        return cosine_schedule(cfg, total_steps)
    raise ValueError(f"unknown optim.schedule {cfg.schedule!r} "
                     "(expected onecycle | cosine | constant)")


def global_norm(tensors: list[torch.Tensor], dims: Sequence[int | None] | None = None,
                group=None, pp_dims: Sequence[int | None] | None = None,
                pp_group=None) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors (optax.global_norm). With the
    model group `group`, the tensors whose `dims` entry is not None are
    this rank's slices of split leaves: their squares are summed over the
    group, the whole ones' counted once; likewise `pp_dims` over the pipe
    group `pp_group` (a stacked trunk's stage)."""
    norms = torch.stack(torch._foreach_norm(tensors))
    n = len(tensors)
    tp = [group is not None and dims is not None and dims[i] is not None for i in range(n)]
    pp = [pp_group is not None and pp_dims is not None and pp_dims[i] is not None
          for i in range(n)]
    if not any(tp) and not any(pp):
        return torch.linalg.vector_norm(norms)
    sq = norms * norms
    kind = lambda t, p: torch.where(torch.tensor([a == t and b == p for a, b in zip(tp, pp)],
                                                 device=sq.device), sq, 0.0).sum()
    whole, tp_only = kind(False, False), kind(True, False)
    pp_sums = torch.stack([kind(False, True), kind(True, True)])
    if any(pp):
        pp_sums = all_reduce_(pp_sums, pp_group)
    tp_sums = torch.stack([tp_only, pp_sums[1]])
    if any(tp):
        tp_sums = all_reduce_(tp_sums, group)
    return torch.sqrt(whole + pp_sums[0] + tp_sums.sum())


def _part(t: torch.Tensor, dim: int | None, group) -> torch.Tensor:
    """This rank's slice of a whole `t` along `dim` over `group`."""
    if dim is None or group is None:
        return t
    n = t.shape[dim] // group_size(group)
    return t.narrow(dim, group_rank(group) * n, n)


def _whole_shape(shape: Sequence[int], dim: int | None, group) -> tuple[int, ...]:
    """The shape of the whole tensor of which a slice of `shape` is one."""
    if dim is None or group is None:
        return tuple(shape)
    return (*shape[:dim], shape[dim] * group_size(group), *shape[dim + 1:])


def _whole(t: torch.Tensor, dim: int | None, group) -> torch.Tensor:
    """The whole tensor of which every rank of `group` holds a slice."""
    if dim is None or group is None:
        return t
    return all_gather_cat(t, group, dim)


@dataclass
class ShardPlan:
    """Where the optimizer's tensors lie on a mesh: `tp_dims`, per
    parameter (the order of `TrainState.names`), the dimension split over
    the model group `tp_group` (None: whole); `pp_dims` likewise over the
    pipe group `pp_group` (a stacked trunk's stage); `zero_dims`, per moment
    field of the family's state, per leaf, the dimension split over the data
    group `dp_group` by ZeRO-1 (parallel/sharding.py:shard_opt_state)."""

    tp_group: object = None
    tp_dims: list[int | None] | None = None
    dp_group: object = None
    zero_dims: dict[str, list[int | None]] | None = None
    pp_group: object = None
    pp_dims: list[int | None] | None = None

    def whole(self, t: torch.Tensor, tp: int | None, pp: int | None) -> torch.Tensor:
        """The whole leaf of which this rank holds the slice `t`."""
        return _whole(_whole(t, tp, self.tp_group), pp, self.pp_group)

    def part(self, t: torch.Tensor, tp: int | None, pp: int | None) -> torch.Tensor:
        """This rank's slice of a whole leaf `t`."""
        return _part(_part(t, tp, self.tp_group), pp, self.pp_group)


# apply_if_finite's counters, the last three fields of every state below.
_FINITE = ("notfinite_count", "last_finite", "total_notfinite")


@dataclass
class OptState:
    """AdamW's state of the chain above, one tensor per trainable parameter
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


@dataclass
class LionState:
    """Lion's: scale_by_lion's momentum `mu` and `count`, then as OptState."""

    mu: list[torch.Tensor]
    count: torch.Tensor
    schedule_count: torch.Tensor
    notfinite_count: torch.Tensor
    last_finite: torch.Tensor
    total_notfinite: torch.Tensor


@dataclass
class AdafactorState:
    """Adafactor's: scale_by_factored_rms's FactoredState. A factored leaf
    holds `v_row` (the mean of g^2 over the leaf's largest axis) and
    `v_col` (over the second largest), in the port's layout, and a (1,)
    zero `v`; any other leaf a (1,) zero `v_row` and `v_col` and `v` of its
    shape, as optax keeps them."""

    v_row: list[torch.Tensor]
    v_col: list[torch.Tensor]
    v: list[torch.Tensor]
    count: torch.Tensor
    schedule_count: torch.Tensor
    notfinite_count: torch.Tensor
    last_finite: torch.Tensor
    total_notfinite: torch.Tensor


State = OptState | LionState | AdafactorState

# The port's layout of a parameter against the JAX package's, by the module
# that holds it: JAX_AXES[kind][a] is the JAX axis of the port's axis a
# (a Linear's (out, in) is a Dense's (in, out); a Conv2d's OIHW a Conv's
# HWIO; a ConvTranspose2d's (I, O, kh, kw), spatially flipped, a
# ConvTranspose's HWIO). "plain" tensors share JAX's layout.
JAX_AXES = {"dense": (1, 0), "conv": (3, 2, 0, 1), "deconv": (2, 3, 0, 1)}


def param_layouts(model: torch.nn.Module) -> list[str]:
    """"dense", "conv", "deconv" or "plain" for each of `model`'s parameters,
    in `named_parameters()` order: the JAX layout each is converted from."""
    kinds = {}
    for m in model.modules():
        kind = {torch.nn.Linear: "dense", torch.nn.Conv2d: "conv",
                torch.nn.ConvTranspose2d: "deconv"}.get(type(m))
        if kind is not None:
            kinds[id(m.weight)] = kind
    return [kinds.get(id(p), "plain") for _, p in model.named_parameters()]


def factored_dims(shape: Sequence[int], layout: str = "plain",
                  min_dim: int = 128) -> tuple[int, int] | None:
    """optax's `_factored_dims` on the JAX layout of a port tensor, as port
    axes: (second largest, largest) of the JAX shape, or None when the
    smaller of them is below `min_dim` or the tensor has fewer than two
    axes. Ties fall where numpy's argsort of the JAX shape puts them."""
    if len(shape) < 2:
        return None
    axes = JAX_AXES.get(layout, tuple(range(len(shape))))
    jax_shape = [0] * len(shape)
    for a, j in enumerate(axes):
        jax_shape[j] = shape[a]
    order = np.argsort(jax_shape)
    if jax_shape[order[-2]] < min_dim:
        return None
    return axes.index(int(order[-2])), axes.index(int(order[-1]))


class Optimizer:
    """The functional optimizer: `init(params)` and
    `update(grads, state, params) -> (updates, state)`, optax's
    chain(clip_by_global_norm, <family>) under its masks and guards.
    `trainable`, the indices of the parameters that train (None: all),
    masks the others as optax.multi_transform with set_to_zero does;
    `layouts` ("dense", "conv", "deconv" or "plain" for every parameter,
    `param_layouts`; None: all "plain") is each parameter's JAX layout. A
    family gives its state's moments (`_moments`) and its update direction
    from the clipped gradients (`_direction`)."""

    State: type = OptState
    elementwise = True  # whether the update of an element reads that element only

    def __init__(self, cfg: OptimConfig, schedule: Schedule,
                 trainable: Sequence[int] | None = None,
                 layouts: Sequence[str] | None = None):
        self.cfg = cfg
        self.schedule = schedule
        self.trainable = None if trainable is None else list(trainable)
        self.layouts = None if layouts is None else list(layouts)
        self.plan: ShardPlan | None = None

    def _masked(self, items: list) -> list:
        """The trainable entries of a per-parameter list."""
        return items if self.trainable is None else [items[i] for i in self.trainable]

    def _moments(self, params: list[torch.Tensor]) -> dict[str, list[torch.Tensor]]:
        raise NotImplementedError

    def _direction(self, g: list[torch.Tensor], state: State, params: list[torch.Tensor],
                   lr: torch.Tensor) -> tuple[list[torch.Tensor], dict]:
        """(updates, new moments) from the clipped gradients `g` of the
        trainable leaves, `lr` the schedule's value at this step."""
        raise NotImplementedError

    def _tp_dims(self, n: int) -> list[int | None]:
        """The model-axis dims of the `n` trainable leaves (all None off a
        model axis)."""
        if self.plan is None or self.plan.tp_dims is None:
            return [None] * n
        return self._masked(self.plan.tp_dims)

    def _pp_dims(self, n: int) -> list[int | None]:
        """The pipe-axis dims of the `n` trainable leaves (all None off a
        pipe axis)."""
        if self.plan is None or self.plan.pp_dims is None:
            return [None] * n
        return self._masked(self.plan.pp_dims)

    def _norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        plan = self.plan
        return global_norm(grads, self._tp_dims(len(grads)), plan.tp_group if plan else None,
                           self._pp_dims(len(grads)), plan.pp_group if plan else None)

    def init(self, params: list[torch.Tensor]) -> State:
        dev = params[0].device
        zero = lambda dtype: torch.zeros((), dtype=dtype, device=dev)
        leaves = self._masked(params)
        if not self.elementwise and self.plan is not None:
            plan = self.plan  # moments of the whole leaves
            leaves = [p.new_zeros(_whole_shape(_whole_shape(p.shape, d, plan.tp_group),
                                               e, plan.pp_group))
                      for p, d, e in zip(leaves, self._tp_dims(len(leaves)),
                                         self._pp_dims(len(leaves)))]
        return self.State(
            **self._moments(leaves),
            count=zero(torch.int32),
            schedule_count=zero(torch.int32),
            notfinite_count=zero(torch.int32),
            last_finite=torch.ones((), dtype=torch.bool, device=dev),
            total_notfinite=zero(torch.int32),
        )

    def update(self, grads: list[torch.Tensor], state: State,
               params: list[torch.Tensor]) -> tuple[list[torch.Tensor], State]:
        cfg = self.cfg
        grads = [g.float() for g in grads]
        every, grads, params = grads, self._masked(grads), self._masked(params)
        g_norm = self._norm(grads)
        # clip_by_global_norm: t where |g| < clip, else (t / |g|) * clip.
        clipped = torch._foreach_mul(torch._foreach_div(grads, g_norm), cfg.clip_grad_norm)
        trigger = g_norm < cfg.clip_grad_norm
        g = [torch.where(trigger, t, c) for t, c in zip(grads, clipped)]
        u, moments = self._planned_direction(g, state, params,
                                             self.schedule(state.schedule_count))
        if self.trainable is not None:  # set_to_zero on the frozen leaves
            full = [torch.zeros_like(g) for g in every]
            for i, t in zip(self.trainable, u):
                full[i] = t
            u = full
        new = dataclasses.replace(state, **moments, count=state.count + 1,
                                  schedule_count=state.schedule_count + 1)
        if cfg.max_nonfinite_skips <= 0:
            return u, new
        # apply_if_finite: a step with non-finite gradients leaves the inner
        # state (moments and both counts) as it was and updates nothing,
        # unless more than max_nonfinite_skips came in a row.
        finite = torch.isfinite(torch.stack(
            torch._foreach_norm(every, ord=float("inf")))).all()
        notfinite = torch.where(finite, 0, state.notfinite_count + 1).int()

        accept = finite | (notfinite > cfg.max_nonfinite_skips)

        def pick(a, b):
            if isinstance(a, (list, tuple)):
                return [torch.where(accept, x, y) for x, y in zip(a, b)]
            return torch.where(accept, a, b)

        kept = {f.name: pick(getattr(new, f.name), getattr(state, f.name))
                for f in dataclasses.fields(new) if f.name not in _FINITE}
        return [torch.where(accept, x, 0.0) for x in u], self.State(
            **kept,
            notfinite_count=notfinite,
            last_finite=finite,
            total_notfinite=torch.where(finite, state.total_notfinite,
                                        state.total_notfinite + 1).int(),
        )


    def _moment_dims(self, state: State) -> dict[str, tuple[list, list, list]]:
        """Per moment field: (its leaves' model-axis dims, their pipe-axis
        dims, their data-axis dims)."""
        plan = self.plan
        out = {}
        for f in dataclasses.fields(state):
            leaves = getattr(state, f.name)
            if not isinstance(leaves, (list, tuple)):
                continue
            n = len(leaves)
            tp = self._tp_dims(n) if self.elementwise else [None] * n
            pp = self._pp_dims(n) if self.elementwise else [None] * n
            zero = (plan.zero_dims or {}).get(f.name, [None] * n)
            out[f.name] = (tp, pp, zero)
        return out

    def whole_state(self, state: State) -> State:
        """`state` with every moment whole (collective over the mesh)."""
        plan = self.plan
        if plan is None:
            return state
        return dataclasses.replace(state, **{
            f: [plan.whole(_whole(t, z, plan.dp_group), d, e)
                for t, d, e, z in zip(getattr(state, f), tp, pp, zero)]
            for f, (tp, pp, zero) in self._moment_dims(state).items()})

    def part_state(self, state: State) -> State:
        """Inverse of `whole_state`: this rank's slices of whole moments."""
        plan = self.plan
        if plan is None:
            return state
        return dataclasses.replace(state, **{
            f: [_part(plan.part(t, d, e), z, plan.dp_group).clone()
                for t, d, e, z in zip(getattr(state, f), tp, pp, zero)]
            for f, (tp, pp, zero) in self._moment_dims(state).items()})

    def _planned_direction(self, g, state, params, lr):
        """`_direction` under the plan: see the module's docstring."""
        plan = self.plan
        if plan is None:
            return self._direction(g, state, params, lr)
        zero, dp = plan.zero_dims or {}, plan.dp_group
        if self.elementwise:
            if not zero:  # a split leaf's slice is all its elements need
                return self._direction(g, state, params, lr)
            dims = next(iter(zero.values()))  # every moment has its leaf's shape
            gl = [_part(t, d, dp) for t, d in zip(g, dims)]
            pl = [_part(t, d, dp) for t, d in zip(params, dims)]
            u, moments = self._direction(gl, state, pl, lr)
            return [_whole(t, d, dp) for t, d in zip(u, dims)], moments
        tp, pp = self._tp_dims(len(g)), self._pp_dims(len(g))
        gf = [plan.whole(t, d, e) for t, d, e in zip(g, tp, pp)]
        pf = [plan.whole(t, d, e) for t, d, e in zip(params, tp, pp)]
        whole = dataclasses.replace(state, **{
            f: [_whole(t, d, dp) for t, d in zip(getattr(state, f), ds)]
            for f, ds in zero.items()})
        u, moments = self._direction(gf, whole, pf, lr)
        moments = {f: [_part(t, d, dp) for t, d in zip(v, zero[f])] if f in zero else v
                   for f, v in moments.items()}
        return [plan.part(t, d, e) for t, d, e in zip(u, tp, pp)], moments


class AdamW(Optimizer):
    """scale_by_adam(b1, b2, 1e-8) -> add_decayed_weights(wd) ->
    scale_by_schedule(-lr)."""

    State = OptState
    eps = 1e-8

    def _moments(self, params):
        return dict(mu=[torch.zeros_like(p) for p in params],
                    nu=[torch.zeros_like(p) for p in params])

    def _direction(self, g, state, params, lr):
        cfg = self.cfg
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
        return torch._foreach_mul(u, -lr), dict(mu=mu, nu=nu)


class Lion(Optimizer):
    """optax.lion(schedule, b1, b2, weight_decay): scale_by_lion (the update
    sign((1 - b1) g + b1 m), then m <- (1 - b2) g + b2 m) ->
    add_decayed_weights(wd), before the learning rate ->
    scale_by_schedule(-lr)."""

    State = LionState

    def _moments(self, params):
        return dict(mu=[torch.zeros_like(p) for p in params])

    def _direction(self, g, state, params, lr):
        cfg = self.cfg
        u = torch._foreach_sign(torch._foreach_add(torch._foreach_mul(g, 1 - cfg.b1),
                                                   torch._foreach_mul(state.mu, cfg.b1)))
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - cfg.b2),
                                torch._foreach_mul(state.mu, cfg.b2))
        u = torch._foreach_add(u, torch._foreach_mul(params, cfg.weight_decay))
        return torch._foreach_mul(u, -lr), dict(mu=mu)


def _block_rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


class Adafactor(Optimizer):
    """optax.adafactor(learning_rate=schedule, weight_decay_rate=wd or None):
    scale_by_factored_rms (decay 1 - (t + 1)^-0.8, epsilon 1e-30, a leaf
    factored over its two largest JAX axes when the smaller is >= 128) ->
    clip_by_block_rms(1) -> scale_by_schedule(lr) ->
    scale_by_param_block_rms(1e-3) -> add_decayed_weights(wd), which the
    learning rate does not scale -> scale(-1). The layouts map the factored
    axes onto the port's."""

    State = AdafactorState
    elementwise = False
    decay_rate, eps, min_dim, min_scale = 0.8, 1e-30, 128, 1e-3

    def _dims(self, params: list[torch.Tensor]) -> list[tuple[int, int] | None]:
        layouts = ["plain"] * len(params) if self.layouts is None else self._masked(self.layouts)
        return [factored_dims(p.shape, kind, self.min_dim) for p, kind in zip(params, layouts)]

    def _moments(self, params):
        one = lambda p: torch.zeros((1,), dtype=p.dtype, device=p.device)
        rows, cols, vs = [], [], []
        for p, dims in zip(params, self._dims(params)):
            if dims is None:
                rows.append(one(p)), cols.append(one(p)), vs.append(torch.zeros_like(p))
            else:
                d1, d0 = dims
                rows.append(torch.zeros_like(p.sum(dim=d0)))
                cols.append(torch.zeros_like(p.sum(dim=d1)))
                vs.append(one(p))
        return dict(v_row=rows, v_col=cols, v=vs)

    def _direction(self, g, state, params, lr):
        t = (state.count + 1).float()
        decay = 1.0 - t ** -self.decay_rate
        rows, cols, vs, u = [], [], [], []
        for grad, v_row, v_col, v, p, dims in zip(g, state.v_row, state.v_col, state.v,
                                                  params, self._dims(params)):
            sq = grad * grad + self.eps
            if dims is None:
                v = decay * v + (1.0 - decay) * sq
                x = grad * v ** -0.5
            else:
                d1, d0 = dims
                v_row = decay * v_row + (1.0 - decay) * sq.mean(dim=d0)
                v_col = decay * v_col + (1.0 - decay) * sq.mean(dim=d1)
                row_mean = v_row.mean(dim=d1 - 1 if d1 > d0 else d1, keepdim=True)
                x = (grad * ((v_row / row_mean) ** -0.5).unsqueeze(d0)
                     * (v_col ** -0.5).unsqueeze(d1))
            rows.append(v_row), cols.append(v_col), vs.append(v)
            # clip_by_block_rms(1), the learning rate, then the parameter's
            # block rms (at least min_scale).
            x = x / torch.clamp_min(_block_rms(x) / 1.0, 1.0)
            x = lr * x
            rms = _block_rms(p)
            x = x * torch.where(rms <= self.min_scale, self.min_scale, rms)
            if self.cfg.weight_decay:
                x = x + self.cfg.weight_decay * p
            u.append(-1 * x)
        return u, dict(v_row=rows, v_col=cols, v=vs)


_FAMILIES = {"adamw": AdamW, "lion": Lion, "adafactor": Adafactor}


@dataclass
class MultiStepsState:
    """optax.MultiStepsState: the micro-step within the current k, the
    count of emitted updates, the inner optimizer's state and the running
    mean of the micro-steps' gradients (one tensor per parameter)."""

    mini_step: torch.Tensor
    gradient_step: torch.Tensor
    inner: State
    acc: list[torch.Tensor]


class MultiSteps:
    """optax.MultiSteps(inner, every_k_schedule=k) with use_grad_mean: the
    gradients of k micro-steps are averaged (Welford: acc + (g - acc) /
    (n + 1)) and the inner optimizer's update is applied on every k-th.
    As optax does, the inner update is computed on every micro-step and
    kept only on the k-th, the zero updates of the others are the inner
    updates times 0, and the accumulator is reset by a product with 0, so
    a non-finite micro-batch stays in it as it does in optax."""

    def __init__(self, inner: Optimizer, k: int):
        self.inner = inner
        self.k = k

    @property
    def plan(self) -> ShardPlan | None:
        return self.inner.plan

    @plan.setter
    def plan(self, plan: ShardPlan | None) -> None:
        self.inner.plan = plan

    def _acc_dims(self, n: int) -> tuple[list, list]:
        """(model-axis dims, pipe-axis dims) of the accumulator's leaves."""
        plan = self.inner.plan
        none = [None] * n
        if plan is None:
            return none, none
        return plan.tp_dims or none, plan.pp_dims or none

    def whole_state(self, state: MultiStepsState) -> MultiStepsState:
        plan = self.plan
        if plan is None:
            return state
        acc = [plan.whole(t, d, e) for t, d, e in zip(state.acc, *self._acc_dims(len(state.acc)))]
        return dataclasses.replace(state, inner=self.inner.whole_state(state.inner), acc=acc)

    def part_state(self, state: MultiStepsState) -> MultiStepsState:
        plan = self.plan
        if plan is None:
            return state
        acc = [plan.part(t, d, e).clone()
               for t, d, e in zip(state.acc, *self._acc_dims(len(state.acc)))]
        return dataclasses.replace(state, inner=self.inner.part_state(state.inner), acc=acc)

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
            inner=type(inner)(**{f.name: pick(getattr(inner, f.name), getattr(state.inner, f.name))
                                 for f in fields(inner)}),
            acc=torch._foreach_mul(acc, (~emit).float()))


def make_optimizer(cfg: OptimConfig, total_steps: int,
                   frozen_labels: Sequence[str] | None = None,
                   layouts: Sequence[str] | None = None) -> Optimizer | MultiSteps:
    """The optimizer of `cfg` ("adamw", "lion" or "adafactor"), wrapped in
    MultiSteps when accum_steps > 1. `frozen_labels`, "trainable" or
    "frozen" for each parameter in the order the optimizer is given them,
    masks the frozen ones; `layouts` (`param_layouts`) tells Adafactor each
    parameter's JAX layout."""
    if cfg.optimizer not in _FAMILIES:
        raise ValueError(f"unknown optim.optimizer {cfg.optimizer!r} "
                         "(expected adamw | lion | adafactor)")
    trainable = None
    if frozen_labels is not None:
        unknown = set(frozen_labels) - {"trainable", "frozen"}
        if unknown:
            raise ValueError(f"frozen labels must be 'trainable' or 'frozen', not {unknown}")
        trainable = [i for i, label in enumerate(frozen_labels) if label == "trainable"]
    tx = _FAMILIES[cfg.optimizer](cfg, build_schedule(cfg, total_steps), trainable, layouts)
    return MultiSteps(tx, cfg.accum_steps) if cfg.accum_steps > 1 else tx


class TrainState:
    """step, the model's parameters (float32 masters, updated in place) and
    BatchNorm statistics (its buffers), the optimizer state and the EMA of
    the parameters. `names` fixes the parameter order of every list.

    `host_step` mirrors `step` on the host, so the step can seed its
    augmentation draws without reading the device; whatever sets `step`
    (a checkpoint's restore, compat/from_jax.py) sets both."""

    def __init__(self, model: torch.nn.Module, tx: Optimizer | MultiSteps, ema: bool):
        self.model = model
        self.tx = tx  # its plan places the state on a mesh (checkpoints read it)
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        device = self.params[0].device
        self.step = torch.zeros((), dtype=torch.int32, device=device)
        self.host_step = 0
        self.opt_state = tx.init(self.params)
        self.ema_params = [p.detach().clone() for p in self.params] if ema else None

    def apply_gradients(self, grads: list[torch.Tensor], tx: Optimizer | MultiSteps,
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
