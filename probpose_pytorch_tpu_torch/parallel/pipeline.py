"""Pipeline parallelism over a mesh's "pipe" axis and the Megatron
boundaries of a tensor-parallel block (port of
probpose_pytorch_tpu/parallel/pipeline.py).

`tp_enter` and `tp_leave` are JAX's custom-VJP boundaries as autograd
Functions over a model group (models/vit.py places them): where a
replicated activation enters the column-parallel matmul, and where the
row-parallel matmul's partial sums leave it. With both in place every
activation and its gradient between blocks is whole and the same on every
rank of the group, so the gradients of the replicated parameters need no
reduction over the model axis.

The schedules. JAX runs one lock-step program on every device (a scan over
ticks inside a shard_map, a ppermute between neighbours); the port runs one
process per rank, and rank p of a pipe group of S holds its stage: blocks
[p L, (p + 1) L) of the trunk, L = depth / S. So here:

  * `stacked_params` is this rank's stage (every leaf's leading dim is its
    L blocks; all `depth` of them where the mesh has no pipe axis > 1),
    laid out and split as `param_specs` say (models/vit.py:
    stacked_param_specs, parallel/sharding.py:shard_params);
  * `x` (and `targets`) are this rank's rows of the global batch, those of
    its data index, as the model takes them on a mesh; the microbatch count
    divides them (JAX's "per-device batch");
  * the slots that JAX's scan computes and masks (the warm-up and drain
    ticks, the stash's scratch slot, the last stage's second forward) are
    skipped: their results never reach an output. The results are JAX's.

GPipe (`pipeline_spmd`) sends each microbatch's activation to the next stage
through `send_next` / `recv_prev` (parallel/collectives.py) and hands the
last stage's outputs to every stage through `last_to_all`, so its backward
is autograd through the ticks: the cotangents travel back the same way.
The 1F1B engines (`pipeline_1f1b`, `pipeline_1f1b_interleaved`) run JAX's
cycles: in each, a stage forwards one microbatch (no graph kept; its input
stashed), then backwards one, recomputing its stage from the stash under
autograd, and the cycle ends with one exchange with both neighbours
(`exchange`, all sends and receives posted together). The last stage
forwards its microbatch under autograd once, seeds its backward from the
loss in the same cycle and skips the recompute. Reductions are JAX's: the
1/M cotangent seed, float32 gradient accumulators, the trunk's gradients
averaged over the data axis, the loss-side ones and the loss (and aux)
handed from the last stage to all and averaged over the data axis, dx
handed from stage 0 to all and divided by the data axis's size.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from probpose_pytorch_tpu_torch.parallel.collectives import (
    all_reduce_,
    broadcast_,
    exchange,
    group_rank,
    group_size,
    last_to_all,
    recv_prev,
    send_next,
)
from probpose_pytorch_tpu_torch.parallel.mesh import mesh_shape

__all__ = ["tp_enter", "tp_leave", "pick_microbatches", "pipeline_spmd", "pipeline_1f1b",
           "pipeline_1f1b_interleaved", "circular_chunk_order"]


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def tp_enter(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron "f": identity forward, the gradient summed over `group`
    backward."""
    if group is None or group_size(group) == 1:
        return x
    return _Enter.apply(x, group)


def tp_leave(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron "g": the partial sums summed over `group` forward, identity
    backward."""
    if group is None or group_size(group) == 1:
        return x
    return _Leave.apply(x, group)


def pick_microbatches(local_batch: int, n_stages: int) -> int:
    """Largest microbatch count <= 2 S that divides the per-device batch."""
    cap = min(2 * n_stages, local_batch)
    for m in range(cap, 0, -1):
        if local_batch % m == 0:
            return m
    return 1


def _pick_1f1b(local_batch: int, n_stages: int, microbatches: int) -> int:
    """JAX's 1F1B count: the given one, else the largest divisor <= 4 S."""
    if microbatches:
        M = microbatches
    else:
        M = next(m for m in range(min(4 * n_stages, local_batch), 0, -1)
                 if local_batch % m == 0)
    if local_batch % M:
        raise ValueError(f"per-device batch {local_batch} not divisible by microbatches={M}")
    return M


def _depth(stacked_params: Any) -> int:
    return pytree.tree_leaves(stacked_params)[0].shape[0]


def _index(stacked_params: Any, i: int) -> Any:
    return pytree.tree_map(lambda a: a[i], stacked_params)


def _run(block_fn: Callable, params: Any, h: torch.Tensor) -> torch.Tensor:
    for i in range(_depth(params)):
        h = block_fn(_index(params, i), h)
    return h


def _pipe(mesh, pipe_axis: str, batch_axis: str) -> tuple[int, int, Any, Any]:
    """(S, dp, the pipe group or None, the data group or None)."""
    shape = mesh_shape(mesh)
    S, dp = shape.get(pipe_axis, 1), shape.get(batch_axis, 1)
    return (S, dp, mesh.get_group(pipe_axis) if S > 1 else None,
            mesh.get_group(batch_axis) if dp > 1 else None)


def pipeline_spmd(block_fn: Callable[[Any, torch.Tensor], torch.Tensor], stacked_params: Any,
                  x: torch.Tensor, mesh: Any, *, pipe_axis: str = "pipe",
                  batch_axis: str = "data", microbatches: int = 0, param_specs: Any = None,
                  seq_block_fn: Callable | None = None) -> torch.Tensor:
    """Run the trunk's blocks over this rank's rows `x` as JAX's S-stage
    GPipe pipeline: `block_fn(params_i, h)` applies one block (params_i:
    `stacked_params` with the leading axis indexed away); this rank holds
    its stage's blocks (see the module's docstring; `param_specs` say how
    they were cut and are not read). `microbatches`: M, 0 for
    `pick_microbatches`. Returns the trunk's output of `x` on every stage
    (the last stage's, handed to all). Where the mesh has no pipe axis > 1
    the blocks run in turn with `seq_block_fn` (default `block_fn`), JAX's
    sequential fallback."""
    S, _, group, _ = _pipe(mesh, pipe_axis, batch_axis)
    if S == 1:
        return _run(seq_block_fn or block_fn, stacked_params, x)
    B = x.shape[0]
    M = microbatches or pick_microbatches(B, S)
    if B % M:
        raise ValueError(f"per-device batch {B} not divisible by microbatches={M}")
    p = group_rank(group)
    mbs = x.split(B // M)
    # the smallest leaf's zero-size slice: the receives' backward lies on
    # the path of the stage's gradients
    anchor = min(pytree.tree_leaves(stacked_params), key=lambda a: a.numel())[:0]
    outs = []
    for j in range(M):
        h = mbs[j] if p == 0 else recv_prev(anchor, mbs[j], p - 1, group)
        y = _run(block_fn, stacked_params, h)
        outs.append(y if p == S - 1 else send_next(y, p + 1, group))
    return last_to_all(torch.cat(outs), x, group)


def _requiring_grad(leaves: list[torch.Tensor]) -> list[torch.Tensor]:
    """The leaves as tensors autograd can differentiate with respect to."""
    return [t if t.requires_grad else t.detach().requires_grad_() for t in leaves]


def _grads(out: torch.Tensor, inputs: list[torch.Tensor], seed: torch.Tensor) -> list:
    got = torch.autograd.grad(out, inputs, seed, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for g, t in zip(got, inputs)]


def _split_tree(tree: Any, n: int) -> list[Any]:
    """A pytree of (B, ...) tensors as n pytrees of its row blocks."""
    leaves, spec = pytree.tree_flatten(tree)
    parts = [t.split(t.shape[0] // n) for t in leaves]
    return [pytree.tree_unflatten([p[j] for p in parts], spec) for j in range(n)]


def _sequential_grads(block_fn, stacked_params, loss_fn, loss_params, x, targets,
                      loss_has_aux, dp, data_group, order=None):
    """JAX's sequential fallback of the 1F1B engines: plain autodiff of the
    blocks (in `order`) and the loss; on a data axis > 1, averaged over it
    (JAX's global-batch mean)."""
    p_leaves, p_spec = pytree.tree_flatten(stacked_params)
    lp_leaves, lp_spec = pytree.tree_flatten(loss_params)
    p_req, lp_req = _requiring_grad(p_leaves), _requiring_grad(lp_leaves)
    xr = x.detach().requires_grad_()
    with torch.enable_grad():
        params = pytree.tree_unflatten(p_req, p_spec)
        h = xr
        for i in (order if order is not None else range(_depth(params))):
            h = block_fn(_index(params, i), h)
        out = loss_fn(pytree.tree_unflatten(lp_req, lp_spec), h, targets)
        loss, aux = out if loss_has_aux else (out, None)
        got = _grads(loss, p_req + lp_req + [xr], torch.ones_like(loss))
    loss = loss.detach().float()
    d_p = [g.float() for g in got[:len(p_req)]]
    d_lp = [g.float() for g in got[len(p_req):-1]]
    dx = got[-1]
    aux_leaves, aux_spec = pytree.tree_flatten(aux) if loss_has_aux else ([], None)
    aux_leaves = [a.detach().float() for a in aux_leaves]
    if dp > 1:
        flat = [loss.reshape(1)] + d_p + d_lp + aux_leaves
        summed = all_reduce_(torch._utils._flatten_dense_tensors(flat), data_group) / dp
        flat = torch._utils._unflatten_dense_tensors(summed, flat)
        loss, flat = flat[0][0], flat[1:]
        d_p, d_lp = flat[:len(d_p)], flat[len(d_p):len(d_p) + len(d_lp)]
        aux_leaves = flat[len(d_p) + len(d_lp):]
        dx = dx / dp
    result = (loss, pytree.tree_unflatten(d_p, p_spec), pytree.tree_unflatten(d_lp, lp_spec), dx)
    if loss_has_aux:
        return result + (pytree.tree_unflatten(list(aux_leaves), aux_spec),)
    return result


def _reduce_outputs(S, dp, group, data_group, loss, d_p, d_lp, aux, dx_parts, x,
                    p_spec, lp_spec, aux_spec):
    """The engines' closing reductions (see the module's docstring)."""
    s = group_rank(group)
    last = S - 1
    side = [loss.reshape(1)] + d_lp + aux
    flat = torch._utils._flatten_dense_tensors(side)
    broadcast_(flat, last, group)
    dx = torch.cat(dx_parts) if s == 0 else torch.empty_like(x)
    broadcast_(dx, 0, group)
    if dp > 1:
        flat = all_reduce_(flat, data_group) / dp
        trunk = torch._utils._flatten_dense_tensors(d_p)
        trunk = all_reduce_(trunk, data_group) / dp
        d_p = list(torch._utils._unflatten_dense_tensors(trunk, d_p))
        dx = dx / dp
    side = list(torch._utils._unflatten_dense_tensors(flat, side))
    loss, d_lp, aux = side[0][0], side[1:1 + len(d_lp)], side[1 + len(d_lp):]
    out = (loss, pytree.tree_unflatten(d_p, p_spec), pytree.tree_unflatten(d_lp, lp_spec), dx)
    if aux_spec is not None:
        return out + (pytree.tree_unflatten(aux, aux_spec),)
    return out


class _Engine:
    """The state one rank carries through a 1F1B schedule: the stash, the
    float32 accumulators, the last stage's loss and aux, stage 0's dx."""

    def __init__(self, block_fn, stacked_params, loss_fn, loss_params, xs, ts, M, loss_has_aux):
        self.block_fn, self.loss_fn, self.M, self.has_aux = block_fn, loss_fn, M, loss_has_aux
        self.p_leaves, self.p_spec = pytree.tree_flatten(stacked_params)
        self.p_leaves = _requiring_grad(self.p_leaves)
        lp, self.lp_spec = pytree.tree_flatten(loss_params)
        self.lp_leaves = _requiring_grad(lp)
        self.xs, self.ts = xs, ts
        self.d_p = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                    for t in self.p_leaves]
        self.d_lp = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                     for t in self.lp_leaves]
        self.loss = torch.zeros((), dtype=torch.float32, device=xs[0].device)
        self.aux, self.aux_spec = None, None
        self.stash: dict = {}
        self.dx: dict = {}

    def chunk(self, start: int, n: int) -> list[torch.Tensor]:
        return [t[start:start + n] for t in self.p_leaves]

    def run(self, leaves: list[torch.Tensor], h: torch.Tensor) -> torch.Tensor:
        return _run(self.block_fn, pytree.tree_unflatten(leaves, self.p_spec), h)

    def forward(self, key, start: int, n: int, h: torch.Tensor) -> torch.Tensor:
        """A forward slot: no graph kept, the input stashed under `key`."""
        self.stash[key] = h
        with torch.no_grad():
            return self.run(self.chunk(start, n), h)

    def backward(self, start: int, n: int, h: torch.Tensor, g_in: torch.Tensor | None,
                 m: int) -> torch.Tensor:
        """A backward slot on input `h`: the chunk recomputed under
        autograd; with `g_in` None (the last chunk) the loss of microbatch
        `m` seeds it. Accumulates the gradients; returns dh."""
        h = h.detach().requires_grad_()
        with torch.enable_grad():
            leaves = self.chunk(start, n)
            y = self.run(leaves, h)
            if g_in is None:
                g_in = self._loss(y, m)
            got = _grads(y, leaves + [h], g_in)
        for acc, g in zip(self.d_p, got[:-1]):
            acc[start:start + n] += g.float()
        return got[-1]

    def _loss(self, y: torch.Tensor, m: int) -> torch.Tensor:
        """The loss of microbatch m on the stage output y: its vjp seeded
        with 1/M, the loss-side gradients, loss and aux accumulated; returns
        y's cotangent."""
        yd = y.detach().requires_grad_()
        out = self.loss_fn(pytree.tree_unflatten(self.lp_leaves, self.lp_spec), yd, self.ts[m])
        lval, aux = out if self.has_aux else (out, None)
        got = _grads(lval, self.lp_leaves + [yd],
                     torch.full_like(lval, 1.0 / self.M))
        for acc, g in zip(self.d_lp, got[:-1]):
            acc += g.float()
        self.loss += lval.detach().float() / self.M
        if self.has_aux:
            leaves, self.aux_spec = pytree.tree_flatten(aux)
            if self.aux is None:
                self.aux = [torch.zeros(a.shape, dtype=torch.float32, device=a.device)
                            for a in leaves]
            for acc, a in zip(self.aux, leaves):
                acc += a.detach().float() / self.M
        return got[-1]


def pipeline_1f1b(block_fn: Callable, stacked_params: Any, loss_fn: Callable, loss_params: Any,
                  x: torch.Tensor, targets: Any, mesh: Any, *, pipe_axis: str = "pipe",
                  batch_axis: str = "data", model_axis: str | None = None,
                  microbatches: int = 0, param_specs: Any = None,
                  seq_block_fn: Callable | None = None, loss_has_aux: bool = False) -> tuple:
    """JAX's one-forward-one-backward engine: the loss computed inside the
    pipeline at the last stage, the gradients returned. `loss_fn(lp, h,
    t_mb)` is the scalar mean loss of a microbatch (with `loss_has_aux`,
    (loss, aux), aux a pytree of float tensors); `loss_params` a pytree of
    tensors it reads (the engine differentiates with respect to them, and
    to `stacked_params`, this rank's stage). At most 2 (S - 1) + 1 stage
    inputs are stashed. `model_axis` names a tensor-parallel axis whose
    block runs tp_enter / tp_leave (nothing else to do here). Auto M: the
    largest divisor of the rows <= 4 S. The last stage sends the aux's
    structure to the stages that run no loss (JAX's eval_shape).

    Returns (loss, d_stacked, d_loss_params, dx[, aux]): the global mean
    loss, the stage's float32 trunk gradients, the float32 loss-side ones,
    dx (x's dtype) of this rank's rows on every stage, and the
    microbatch-averaged aux; all averaged over the data axis as JAX's."""
    S, dp, group, data_group = _pipe(mesh, pipe_axis, batch_axis)
    if S == 1:
        return _sequential_grads(seq_block_fn or block_fn, stacked_params, loss_fn,
                                 loss_params, x, targets, loss_has_aux, dp, data_group)
    B = x.shape[0]
    M = _pick_1f1b(B, S, microbatches)
    s = group_rank(group)
    mb = B // M
    eng = _Engine(block_fn, stacked_params, loss_fn, loss_params, x.split(mb),
                  _split_tree(targets, M), M, loss_has_aux)
    L = _depth(stacked_params)
    fwd_in = bwd_in = None
    for c in range(M + 2 * (S - 1)):
        f, b = c - s, c - 2 * (S - 1) + s
        sends = []
        if 0 <= f < M and s < S - 1:
            h = eng.xs[f] if s == 0 else fwd_in
            sends.append((eng.forward(f, 0, L, h), s + 1))
        if 0 <= b < M:
            if s == S - 1:  # b == f: forward under autograd once, seeded by the loss
                dh = eng.backward(0, L, fwd_in, None, b)
            else:
                dh = eng.backward(0, L, eng.stash.pop(b), bwd_in, b)
            if s > 0:
                sends.append((dh, s - 1))
            else:
                eng.dx[b] = dh
        recvs = []
        if s > 0 and 0 <= c + 1 - s < M:
            recvs.append((eng.xs[0], s - 1))
        if s < S - 1 and 0 <= c + 1 - 2 * (S - 1) + s < M:
            recvs.append((eng.xs[0], s + 1))
        got = exchange(sends, recvs, group)
        fwd_in = got.pop(0) if s > 0 and 0 <= c + 1 - s < M else None
        bwd_in = got.pop(0) if got else None
    return _finish(eng, S, dp, group, data_group, x, loss_has_aux)


def _finish(eng, S, dp, group, data_group, x, loss_has_aux):
    aux, aux_spec = [], None
    if loss_has_aux:  # the aux's structure, from the last stage
        last = S - 1
        shapes = [(pytree.treespec_dumps(eng.aux_spec), [tuple(a.shape) for a in eng.aux])
                  if group_rank(group) == last else None]
        dist.broadcast_object_list(shapes, dist.get_global_rank(group, last), group=group)
        aux_spec, sizes = pytree.treespec_loads(shapes[0][0]), shapes[0][1]
        aux = eng.aux if eng.aux is not None else [
            torch.zeros(n, dtype=torch.float32, device=x.device) for n in sizes]
    dx_parts = [eng.dx[m] for m in range(eng.M)] if eng.dx else []
    return _reduce_outputs(S, dp, group, data_group, eng.loss, eng.d_p, eng.d_lp, aux,
                           dx_parts, x, eng.p_spec, eng.lp_spec,
                           aux_spec if loss_has_aux else None)


def circular_chunk_order(depth: int, n_stages: int, virtual: int) -> list:
    """Depth permutation taking the logical block order to the circular
    layout `pipeline_1f1b_interleaved` shards: device s's contiguous depth
    shard holds its `virtual` chunks [chunk s, chunk S+s, ..., chunk
    (V-1)S+s] (chunk k = logical blocks [k L', (k+1) L'), L' = depth/(S V)).
    order[pos] = logical index; invert with np.argsort(order)."""
    S, V = n_stages, virtual
    if depth % (S * V):
        raise ValueError(f"depth={depth} not divisible by stages*virtual={S * V}")
    Lp = depth // (S * V)
    return [(r * S + s) * Lp + l for s in range(S) for r in range(V) for l in range(Lp)]


def pipeline_1f1b_interleaved(block_fn: Callable, stacked_params: Any, loss_fn: Callable,
                              loss_params: Any, x: torch.Tensor, targets: Any, mesh: Any, *,
                              virtual: int = 2, pipe_axis: str = "pipe",
                              batch_axis: str = "data", model_axis: str | None = None,
                              microbatches: int = 0, param_specs: Any = None,
                              seq_block_fn: Callable | None = None,
                              loss_has_aux: bool = False) -> tuple:
    """JAX's circular-interleaved 1F1B: `pipeline_1f1b` with V = `virtual`
    depth chunks per stage. `stacked_params` is this rank's contiguous shard
    of the circular layout (`circular_chunk_order`): its V chunks of L' =
    L / V blocks, chunk r holding logical chunk r S + s. Microbatch m = g S
    + j forwards through chunk k = r S + s at mini-cycle g S V + r S + s +
    j, and its backward through chunk k runs SV - 1 - k mini-cycles after
    the last chunk's forward (JAX's schedule, its slots decoded the same
    way). At most 2 S + 2 inputs a chunk are stashed. Returns as
    `pipeline_1f1b`, the trunk gradients in the circular layout."""
    S, dp, group, data_group = _pipe(mesh, pipe_axis, batch_axis)
    V = virtual
    if S == 1:
        return _sequential_grads(seq_block_fn or block_fn, stacked_params, loss_fn,
                                 loss_params, x, targets, loss_has_aux, dp, data_group)
    L = _depth(stacked_params)
    if L % V:
        raise ValueError(f"depth={L * S} not divisible by stages*virtual={S * V}")
    Lp, SV = L // V, S * V
    B = x.shape[0]
    M = _pick_1f1b(B, S, microbatches)
    s = group_rank(group)
    eng = _Engine(block_fn, stacked_params, loss_fn, loss_params, x.split(B // M),
                  _split_tree(targets, M), M, loss_has_aux)
    gM, jM = (M - 1) // S, (M - 1) % S
    C = gM * SV + (V - 1) * S + (S - 1) + jM + (SV - 1) + 1
    nxt, prv = (s + 1) % S, (s - 1) % S

    def fwd_slot(c: int, stage: int):
        cf = c - stage
        if cf < 0:
            return None
        j, r, g = cf % S, (cf // S) % V, cf // SV
        m = g * S + j
        return (r, m) if m < M else None

    def bwd_slot(c: int, stage: int):
        t = c + stage + 2
        j = t % S
        q = (t - j) // S
        r = (-q) % V
        g = (q + r) // V - 2
        m = g * S + j
        return (r, m) if g >= 0 and 0 <= m < M else None

    fwd_in = bwd_in = None
    for c in range(C):
        sends = []
        fs, bs = fwd_slot(c, s), bwd_slot(c, s)
        last_f = fs is not None and s == S - 1 and fs[0] == V - 1
        if fs is not None and not last_f:
            r, m = fs
            h = eng.xs[m] if s == 0 and r == 0 else fwd_in
            sends.append((eng.forward((r, m), r * Lp, Lp, h), nxt))
        if bs is not None:
            r, m = bs
            if s == S - 1 and r == V - 1:  # the last chunk: this cycle's forward slot
                if fs != bs:
                    raise AssertionError(f"interleaved schedule: slots {fs} and {bs} differ")
                dh = eng.backward(r * Lp, Lp, fwd_in, None, m)
            else:
                dh = eng.backward(r * Lp, Lp, eng.stash.pop((r, m)), bwd_in, m)
            if s == 0 and r == 0:
                eng.dx[m] = dh
            else:
                sends.append((dh, prv))
        fn, bn = fwd_slot(c + 1, s), bwd_slot(c + 1, s)
        want_f = fn is not None and not (s == 0 and fn[0] == 0)
        want_b = bn is not None and not (s == S - 1 and bn[0] == V - 1)
        recvs = ([(eng.xs[0], prv)] if want_f else []) + ([(eng.xs[0], nxt)] if want_b else [])
        got = exchange(sends, recvs, group)
        fwd_in = got.pop(0) if want_f else None
        bwd_in = got.pop(0) if want_b else None
    return _finish(eng, S, dp, group, data_group, x, loss_has_aux)
