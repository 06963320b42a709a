"""Carry the JAX package's weights and training state into the port.

`load_jax_variables(model, params, batch_stats)` takes the JAX model's
`variables["params"]` and `variables["batch_stats"]` as nested dicts of
numpy arrays (no jax needed here) and loads them into a `ProbPoseModel`
(ViT or conv trunk) or a `PersonDetector`.
`load_jax_train_state(state, jax_state)` carries a whole JAX `TrainState`
(after `jax.device_get`) into the port's train/state.py `TrainState`, so a
run started in JAX continues in the port step for step.
The layout conversions are those of the JAX package's
compat/torch_export.py:
  * Conv kernel (kh, kw, I, O)          -> Conv2d weight (O, I, kh, kw)
  * ConvTranspose kernel (kh, kw, I, O) -> ConvTranspose2d weight
                                           (I, O, kh, kw), spatially flipped
  * Dense kernel (I, O)                 -> Linear weight (O, I) (the
                                           SimCC head's mlp_x, mlp_y too)
  * BN scale / bias + mean / var        -> BatchNorm2d weight / bias /
                                           running_mean / running_var
  * LoRA `<layer>_lora/{a, b}`          -> `<layer>_lora.{a, b}`, as they are
  * conv trunk `stage{s}_block{b}`      -> `blocks.{i}`, in stage order
A masked optax state (`multi_transform` with frozen labels) holds moments
for the trainable leaves only, `MaskedNode` in the frozen ones' places; it
carries into the port's masked optimizer state, which holds the same.
Adafactor's factored `v_row` and `v_col` lose one axis of their leaf's JAX
layout; they are carried onto the port's layout of the axes left.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch

from probpose_pytorch_tpu_torch.train.state import (
    JAX_AXES,
    AdafactorState,
    LionState,
    MultiStepsState,
    OptState,
    TrainState,
    factored_dims,
    param_layouts,
)

__all__ = ["state_dict_from_jax", "load_jax_variables", "load_jax_train_state"]

Tree = Mapping[str, Any]


def _conv(sd: dict, prefix: str, p: Tree) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _deconv(sd: dict, prefix: str, p: Tree) -> None:
    w = np.asarray(p["kernel"]).transpose(2, 3, 0, 1)
    sd[f"{prefix}.weight"] = w[:, :, ::-1, ::-1]


def _dense(sd: dict, prefix: str, p: Tree) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _lora(sd: dict, prefix: str, p: Tree, layers: tuple[str, ...]) -> None:
    for layer in layers:
        if f"{layer}_lora" in p:
            for f in ("a", "b"):
                sd[f"{prefix}.{layer}_lora.{f}"] = np.asarray(p[f"{layer}_lora"][f])


def _norm(sd: dict, prefix: str, p: Tree) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _bn(sd: dict, prefix: str, p: Tree, stats: Tree) -> None:
    _norm(sd, prefix, p)
    sd[f"{prefix}.running_mean"] = np.asarray(stats["mean"])
    sd[f"{prefix}.running_var"] = np.asarray(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _count(tree: Tree, stem: str, not_stem: str | None = None) -> int:
    """Number of `stem{i}` keys, leaving out those starting `not_stem`."""
    return sum(
        1 for k in tree
        if k.startswith(stem) and not (not_stem and k.startswith(not_stem))
    )


def _conv_backbone(sd: dict, p: Tree, s: Tree) -> None:
    """models/convnet.py's trunk: stem, then the blocks in stage order."""
    q = "backbone."
    _conv(sd, q + "stem", p["stem"])
    _bn(sd, q + "stem_bn", p["stem_bn"], s["stem_bn"])
    names = sorted((k for k in p if k.startswith("stage")),
                   key=lambda k: tuple(int(v) for v in k[5:].split("_block")))
    for i, name in enumerate(names):
        blk, st, b = p[name], s[name], f"{q}blocks.{i}."
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2"), ("proj", "proj_bn")):
            if conv in blk:
                _conv(sd, b + conv, blk[conv])
                _bn(sd, b + bn, blk[bn], st[bn])


def _detector(sd: dict, p: Tree, s: Tree) -> None:
    """detect/model.py's PersonDetector: the trunk, then its layers under
    their flax names."""
    _conv_backbone(sd, p["backbone"], s["backbone"])
    for name in p:
        if name.endswith("_bn"):
            _bn(sd, name, p[name], s[name])
        elif name != "backbone":
            _conv(sd, name, p[name])


def _backbone(sd: dict, p: Tree) -> None:
    q = "backbone."
    _conv(sd, q + "patch_embed", p["patch_embed"])
    sd[q + "pos_embed"] = np.asarray(p["pos_embed"])
    if "prefix_tokens" in p:
        sd[q + "prefix_tokens"] = np.asarray(p["prefix_tokens"])
    for i in range(_count(p, "block", "blocks")):
        blk, b = p[f"block{i}"], f"{q}blocks.{i}."
        _norm(sd, b + "norm1", blk["norm1"])
        _dense(sd, b + "attn.qkv", blk["attn"]["qkv"])
        _dense(sd, b + "attn.proj", blk["attn"]["proj"])
        _norm(sd, b + "norm2", blk["norm2"])
        _dense(sd, b + "mlp.fc1", blk["mlp"]["fc1"])
        _dense(sd, b + "mlp.fc2", blk["mlp"]["fc2"])
        _lora(sd, b + "attn", blk["attn"], ("qkv", "proj"))
        _lora(sd, b + "mlp", blk["mlp"], ("fc1", "fc2"))
    _norm(sd, q + "norm", p["norm"])
    for j in range(_count(p, "adapter", "adapters")):
        _dense(sd, f"{q}adapters.{j}", p[f"adapter{j}"])


def _head(sd: dict, p: Tree, s: Tree) -> None:
    q = "head."
    for i in range(_count(p, "deconv", "deconv_bn")):
        _deconv(sd, f"{q}deconvs.{i}", p[f"deconv{i}"])
        _bn(sd, f"{q}deconv_bns.{i}", p[f"deconv_bn{i}"], s[f"deconv_bn{i}"])
    for i in range(_count(p, "conv", "conv_bn")):
        _conv(sd, f"{q}convs.{i}", p[f"conv{i}"])
        _bn(sd, f"{q}conv_bns.{i}", p[f"conv_bn{i}"], s[f"conv_bn{i}"])
    if "final" in p:
        _conv(sd, q + "final", p["final"])
    for name in ("mlp_x", "mlp_y"):  # the SimCC head's projections
        if name in p:
            _dense(sd, q + name, p[name])
    for name in ("probability", "visibility", "oks", "error"):
        bp, bs, b = p[name], s[name], f"{q}branches.{name}."
        for i in range(_count(bp, "conv")):
            _conv(sd, f"{b}convs.{i}", bp[f"conv{i}"])
            _bn(sd, f"{b}bns.{i}", bp[f"bn{i}"], bs[f"bn{i}"])
        _conv(sd, b + "final", bp["final"])


def state_dict_from_jax(params: Tree, batch_stats: Tree) -> dict[str, np.ndarray]:
    """The port's state dict, as numpy arrays, from the JAX params and
    batch_stats of a ProbPoseModel ({"backbone": ..., "head": ...} each) or
    of a PersonDetector (its trunk under "backbone", "center" among its
    heads)."""
    sd: dict[str, np.ndarray] = {}
    if "head" not in params:
        _detector(sd, params, batch_stats)
    elif "stem" in params["backbone"]:
        _conv_backbone(sd, params["backbone"], batch_stats["backbone"])
        _head(sd, params["head"], batch_stats["head"])
    else:
        if "blocks" in params["backbone"]:
            raise NotImplementedError(
                "stacked pipeline-parallel trunk params are not ported (ROADMAP "
                "item 13); unstack them with the JAX package's "
                "compat.unstack_vit_blocks first"
            )
        _backbone(sd, params["backbone"])
        _head(sd, params["head"], batch_stats["head"])
    # np.array, not np.ascontiguousarray, which turns 0-d arrays into (1,).
    return {k: np.array(v, order="C") for k, v in sd.items()}


def load_jax_variables(model: torch.nn.Module, params: Tree, batch_stats: Tree) -> None:
    """Load JAX `variables["params"]` / `["batch_stats"]` into the port's
    `ProbPoseModel` or `PersonDetector` in place (strict: every tensor must
    be matched)."""
    sd = state_dict_from_jax(params, batch_stats)
    ref = model.state_dict()
    tensors = {}
    for k, v in sd.items():
        if k in ref and tuple(ref[k].shape) != v.shape:
            raise ValueError(f"{k}: JAX shape {v.shape} != port shape {tuple(ref[k].shape)}")
        tensors[k] = torch.from_numpy(v)
    model.load_state_dict(tensors, strict=True)


def _named_tuples(node: Any) -> Iterator[tuple]:
    """Every NamedTuple in an optax state (nested tuples of NamedTuples, and
    multi_transform's dict of masked states)."""
    if isinstance(node, Mapping):
        for child in node.values():
            yield from _named_tuples(child)
    elif isinstance(node, tuple):
        if hasattr(node, "_fields"):
            yield node
        for child in node:
            yield from _named_tuples(child)


def _is_masked(leaf: Any) -> bool:
    """optax's MaskedNode: the empty NamedTuple in a frozen leaf's place."""
    return isinstance(leaf, tuple) and not leaf and hasattr(leaf, "_fields")


def _unmask(tree: Any, like: Tree, present: bool = False) -> Any:
    """A masked tree in the shapes of `like` (the params): each MaskedNode
    as zeros; with `present`, every leaf as a bool array, True where the
    tree holds a value."""
    if isinstance(like, Mapping):
        return {k: _unmask(tree[k], like[k], present) for k in like}
    if present:
        return np.full(np.shape(like), not _is_masked(tree))
    return np.zeros(np.shape(like), np.float32) if _is_masked(tree) else tree


def _one(states: list, what: str):
    if len(states) != 1:
        raise ValueError(f"expected one {what} in the optax state, found {len(states)}")
    return states[0]


def _leaves_in_order(tree: Any) -> list:
    """The leaves of a nested dict, keys sorted at every level (the order of
    any tree of the params' structure)."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in _leaves_in_order(tree[k])]
    return [tree]


def _port_leaf_index(params: Tree, batch_stats: Tree, names: list[str]) -> list[int]:
    """For each port parameter name, the index of its JAX leaf in
    `_leaves_in_order(params)`: every leaf is filled with its index and
    sent through the layout conversions."""
    counter = iter(range(1 << 30))

    def fill(node):
        if isinstance(node, Mapping):
            return {k: fill(node[k]) for k in sorted(node)}
        return np.full(np.shape(node), next(counter), np.float64)

    sd = state_dict_from_jax(fill(params), batch_stats)
    return [int(sd[n].flat[0]) for n in names]


def _onto_port_axes(a: np.ndarray, kind: str, ndim: int, drop: int | None) -> np.ndarray:
    """A moment in the JAX layout of a `kind` leaf of `ndim` axes, with the
    port axis `drop` reduced away (None: none), in the port's layout: the
    axes left in the port's order, a ConvTranspose's spatial axes flipped."""
    axes = JAX_AXES.get(kind, tuple(range(ndim)))
    keep = [p for p in range(ndim) if p != drop]
    jax_kept = sorted(axes[p] for p in keep)
    out = np.transpose(np.asarray(a), [jax_kept.index(axes[p]) for p in keep])
    if kind == "deconv":
        out = np.flip(out, [i for i, p in enumerate(keep) if p in (2, 3)])
    return np.array(out, order="C")


def _factored_moments(state: TrainState, fac: Any, params: Tree, batch_stats: Tree,
                      trainable: list[str]) -> dict[str, list[torch.Tensor]]:
    """optax's FactoredState trees (v_row, v_col, v) on the port's
    trainable leaves, each onto its port layout."""
    device = state.params[0].device
    kinds = dict(zip(state.names, param_layouts(state.model)))
    shapes = {n: tuple(p.shape) for n, p in zip(state.names, state.params)}
    index = dict(zip(trainable, _port_leaf_index(params, batch_stats, trainable)))
    trees = {f: _leaves_in_order(getattr(fac, f)) for f in ("v_row", "v_col", "v")}
    out: dict[str, list[torch.Tensor]] = {f: [] for f in trees}
    for n in trainable:
        kind, shape = kinds[n], shapes[n]
        dims = factored_dims(shape, kind)
        drops = {"v_row": None, "v_col": None, "v": None}
        if dims is not None:
            drops["v_row"], drops["v_col"] = dims[1], dims[0]
        for f, leaves in trees.items():
            a = np.asarray(leaves[index[n]])
            placeholder = (dims is None) == (f != "v")
            moved = a if placeholder else _onto_port_axes(a, kind, len(shape), drops[f])
            out[f].append(torch.from_numpy(np.array(moved, np.float32)).to(device))
    return out


def load_jax_train_state(state: TrainState, jax_state: Any) -> None:
    """Carry a JAX `TrainState` with numpy leaves (`jax.device_get(state)`)
    into the port's `state` in place: step, params and batch_stats, the EMA
    params, and the optax state of train/state.py's chain (Adam's mu, nu
    and count, Lion's mu and count, or Adafactor's v_row, v_col, v and
    count; the schedule's count, apply_if_finite's counters and, with
    accum_steps > 1, MultiSteps' counters and accumulator). The moments go
    through the same layout conversions as the params. A masked state's
    moments are carried for its trainable leaves, which must be those of
    the port state's optimizer."""
    load_jax_variables(state.model, jax_state.params, jax_state.batch_stats)
    device = state.params[0].device

    def leaves(tree: Tree, names: list[str] = state.names) -> list[torch.Tensor]:
        sd = state_dict_from_jax(_unmask(tree, jax_state.params), jax_state.batch_stats)
        return [torch.from_numpy(sd[n]).to(device) for n in names]

    def scalar(v, dtype=torch.int32) -> torch.Tensor:
        return torch.tensor(np.asarray(v).item(), dtype=dtype, device=device)

    state.step = scalar(jax_state.step)
    state.host_step = int(np.asarray(jax_state.step))
    if jax_state.ema_params is not None:
        state.ema_params = leaves(jax_state.ema_params)
    named = list(_named_tuples(jax_state.opt_state))
    sched = _one([s for s in named if s._fields == ("count",)], "ScaleByScheduleState")
    opt = state.opt_state
    if isinstance(opt, MultiStepsState):
        multi = _one([s for s in named if "acc_grads" in s._fields], "MultiStepsState")
        opt.mini_step, opt.gradient_step = scalar(multi.mini_step), scalar(multi.gradient_step)
        opt.acc = leaves(multi.acc_grads)
        opt = opt.inner
    fields = {OptState: {"mu", "nu", "count"}, LionState: {"mu", "count"},
              AdafactorState: {"v_row", "v_col", "v", "count"}}[type(opt)]
    family = _one([s for s in named if set(s._fields) == fields],
                  f"state with the fields {sorted(fields)}")
    first = family.v if isinstance(opt, AdafactorState) else family.mu
    held = state_dict_from_jax(_unmask(first, jax_state.params, present=True),
                               jax_state.batch_stats)
    trainable = [n for n in state.names if held[n].all()]
    if len(trainable) != len(opt.v if isinstance(opt, AdafactorState) else opt.mu):
        raise ValueError(f"the JAX optimizer trains {len(trainable)} leaves, the port's "
                         "do not match: their frozen labels differ")
    if isinstance(opt, AdafactorState):
        for f, moments in _factored_moments(state, family, jax_state.params,
                                            jax_state.batch_stats, trainable).items():
            setattr(opt, f, moments)
    else:
        opt.mu = leaves(family.mu, trainable)
        if isinstance(opt, OptState):
            opt.nu = leaves(family.nu, trainable)
    opt.count, opt.schedule_count = scalar(family.count), scalar(sched.count)
    finite = [s for s in named if "notfinite_count" in s._fields]
    if finite:
        f = _one(finite, "ApplyIfFiniteState")
        opt.notfinite_count = scalar(f.notfinite_count)
        opt.last_finite = scalar(f.last_finite, torch.bool)
        opt.total_notfinite = scalar(f.total_notfinite)
