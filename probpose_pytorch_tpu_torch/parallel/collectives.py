"""The collectives the scale-out path calls, and their autograd forms.

GSPMD inserts JAX's collectives from shardings; the port calls them by
hand, on the process groups of a mesh's axes (`DeviceMesh.get_group`).
Gloo moves CUDA tensors for all_reduce and broadcast only, so on a gloo
group a CUDA tensor's all_gather, send and recv go through host memory: a
rule of the backend, stated here, not a reaction to a failure. NCCL and
CPU tensors run every collective in place.

Autograd forms, each with the backward its forward needs when every rank
of the group computes the same global loss:
  * `all_reduce_sum`: sum forward, sum backward (BatchNorm's batch sums);
  * `gather_rows`: all_gather along dim 0 forward, this rank's rows of the
    gradient backward (every rank's loss is the one global loss);
  * `scatter_rows`: this rank's rows of a tensor that every rank of the
    group holds forward, the rows of every rank's gradient gathered
    backward (the head's share of the batch on a model group);
  * `send_next` / `recv_prev`: a pipeline stage's activation to the next
    stage forward, its cotangent back from there backward (GPipe's ticks,
    parallel/pipeline.py); `recv_prev` takes an `anchor`, a zero-size
    slice of the stage's parameters, so that its backward lies on the path
    of any gradient of them and runs;
  * `last_to_all`: the last stage's tensor on every stage of the group
    forward (JAX's masked psum), and backward the last stage's own
    gradient only: every stage computes the one global loss from the same
    tensor, so summing their gradients would count it once per stage.

`exchange` posts one tick's sends and receives between pipe neighbours
at once (`batch_isend_irecv`), so no order of them can deadlock.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["group_size", "group_rank", "all_reduce_", "all_gather_cat", "broadcast_",
           "all_reduce_sum", "gather_rows", "scatter_rows", "send_", "recv_", "exchange",
           "send_next", "recv_prev", "last_to_all"]


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a gather, send or recv of `t` on `group` goes through host
    memory: a CUDA tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _global(group, group_rank_: int) -> int:
    return dist.get_global_rank(group, group_rank_)


def send_(t: torch.Tensor, dst: int, group) -> None:
    """Send `t` to the group's rank `dst` (blocking)."""
    t = t.detach().contiguous()
    dist.send(t.cpu() if _staged(t, group) else t, _global(group, dst), group=group)


def _buffer(like, group) -> tuple[torch.Tensor, torch.device, bool]:
    """(a receive buffer for a tensor like `like`, a tensor or its (shape,
    dtype, device), the device it belongs on, whether it is staged)."""
    shape, dtype, device = ((like.shape, like.dtype, like.device)
                            if isinstance(like, torch.Tensor) else like)
    host = torch.device(device).type == "cuda" and dist.get_backend(group) == "gloo"
    return torch.empty(shape, dtype=dtype, device="cpu" if host else device), device, host


def recv_(like, src: int, group) -> torch.Tensor:
    """A tensor like `like` (a tensor, or its (shape, dtype, device))
    received from the group's rank `src` (blocking)."""
    buf, device, host = _buffer(like, group)
    dist.recv(buf, _global(group, src), group=group)
    return buf.to(device) if host else buf


def exchange(sends: list[tuple[torch.Tensor, int]], recvs: list[tuple[torch.Tensor, int]],
             group) -> list[torch.Tensor]:
    """Post every send (tensor, group rank) and every receive (a tensor
    like the one expected, group rank) of one tick together and wait for
    all: the received tensors, in the order of `recvs`. Every rank lists
    its operations with one peer in the order that peer lists its own;
    `recvs` take what `recv_` takes."""
    if not sends and not recvs:
        return []
    ops, staged = [], []
    for t, dst in sends:
        t = t.detach().contiguous()
        t = t.cpu() if _staged(t, group) else t
        ops.append(dist.P2POp(dist.isend, t, _global(group, dst), group))
    for like, src in recvs:
        buf, device, host = _buffer(like, group)
        staged.append((buf, device, host))
        ops.append(dist.P2POp(dist.irecv, buf, _global(group, src), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [buf.to(device) if host else buf for buf, device, host in staged]


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` in place and return it."""
    if group_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src_group_rank: int, group) -> torch.Tensor:
    """`t` of the group's rank `src_group_rank` on every rank, in place."""
    if group_size(group) > 1:
        dist.broadcast(t, dist.get_global_rank(group, src_group_rank), group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` (one shape on all) concatenated along `dim`, in the
    group's rank order."""
    n = group_size(group)
    if n == 1:
        return t
    src = t.detach().contiguous()
    host = _staged(src, group)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if host else out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group`, differentiable (its backward sums the
    gradients over the group)."""
    if group is None or group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather_cat(x, group)

    @staticmethod
    def backward(ctx, grad):
        r = group_rank(ctx.group) * ctx.rows
        return grad[r:r + ctx.rows], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of `x` stacked in the group's rank order. Its
    backward keeps this rank's rows of the gradient: the ranks compute one
    loss from the gathered rows, each the same."""
    if group is None or group_size(group) == 1:
        return x
    return _GatherRows.apply(x, group)


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = x.shape[0] // group_size(group)
        r = group_rank(group) * n
        return x[r:r + n]

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(grad, ctx.group), None


def scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's share of the rows of `x`, which every rank of `group`
    holds alike; its backward gathers the shares' gradients, so the
    gradient of `x` is whole on every rank."""
    if group is None or group_size(group) == 1:
        return x
    return _ScatterRows.apply(x, group)


class _SendNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dst, group):
        ctx.dst, ctx.group = dst, group
        ctx.like = (y.shape, y.dtype, y.device)
        send_(y, dst, group)
        return y.new_empty((0,))

    @staticmethod
    def backward(ctx, _):
        return recv_(ctx.like, ctx.dst, ctx.group), None, None


def send_next(y: torch.Tensor, dst: int, group) -> torch.Tensor:
    """Send `y` to the group's rank `dst`; returns a zero-size token whose
    backward receives `y`'s cotangent from `dst`."""
    return _SendNext.apply(y, dst, group)


class _RecvPrev(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, like, src, group):
        ctx.src, ctx.group = src, group
        return recv_(like, src, group)

    @staticmethod
    def backward(ctx, grad):
        send_(grad, ctx.src, ctx.group)
        return grad.new_zeros((0,)), None, None, None


def recv_prev(anchor: torch.Tensor, like: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor like `like` received from the group's rank `src`; its
    backward sends the cotangent back there. `anchor` is a zero-size
    tensor on the path of the gradients the backward is run for."""
    return _RecvPrev.apply(anchor.reshape(0), like, src, group)


class _LastToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, like, group):
        last = group_size(group) - 1
        ctx.last = group_rank(group) == last
        if ctx.last:
            return broadcast_(x.detach().contiguous().clone(), last, group)
        return broadcast_(torch.empty(like.shape, dtype=like.dtype, device=like.device),
                          last, group)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.last else grad.new_zeros((0,))), None, None


def last_to_all(x: torch.Tensor, like: torch.Tensor, group) -> torch.Tensor:
    """The last rank of `group`'s `x` on every rank (the other ranks pass a
    zero-size `x`, the tokens of their sends, and `like` of the result's
    shape, dtype and device). Backward: the last rank's own gradient to
    its `x`, a zero-size gradient to the others' tokens."""
    if group is None or group_size(group) == 1:
        return x
    return _LastToAll.apply(x, like, group)
