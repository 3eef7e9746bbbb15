"""Collectives along one tensor dim, and the autograd Functions of tensor
parallelism and ZeRO-3 (what GSPMD inserts for the JAX package).

Every function takes a process group (a `Mesh.group(axis)`); None stands
for no group (a run of one process), where each is the identity. A group of
one process runs the collective all the same. A collective that fails
raises: nothing here falls back to a local result.

- `copy_to(x, g)`: identity forward, all-reduce backward (the input of a
  column-parallel product, whose gradient each rank holds a part of);
- `reduce_from(x, g)`: all-reduce forward, identity backward (the output of
  a row-parallel product);
- `gather_from(x, dim, g)`: all-gather forward, this rank's slice backward
  (a vocab-parallel output that every rank then uses whole);
- `gather_shard(x, dim, g)`: all-gather forward, reduce-scatter backward
  (a ZeRO-3 parameter gathered for its use; its gradient, summed over the
  data ranks, lands on each rank's slice).

The training variants need no Function of their own: a LoRA product's
x·A passes through `copy_to` or `reduce_from`, and the switch sits before
the vocab-parallel head's `copy_to`, so every leaf whole on the model ranks
gets its whole gradient on each (`models/llama.py`, `models/switch.py`).

Point to point, for context and pipeline parallelism:

- `ring_shift(xs, g)`: each tensor of `xs` sent to the next rank of the
  group's line and replaced by the one from the rank before (`shift=-1`:
  the other way round), every send and receive issued together by
  `dist.batch_isend_irecv`, so that a ring of two does not deadlock;
- `send_to(x, dst, g)` / `recv_from(x, src, g)`: a tensor to / into the
  rank `dst` / from `src` of the group (ranks within the group).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, in place; returns x."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's slices concatenated along `dim`, in rank order."""
    if group is None:
        return x
    n = size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along `dim` of the sum over the group."""
    if group is None:
        return x
    n = size(group)
    moved = x.movedim(dim, 0)
    chunks = [c.contiguous() for c in moved.chunk(n)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out.movedim(0, dim)


def local_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of x along `dim` (a view)."""
    n = size(group)
    if n == 1:
        return x
    c = x.shape[dim] // n
    return x.narrow(dim, rank(group) * c, c)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.dim, ctx.group).contiguous(), None, None


class _GatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


def copy_to(x, group):
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x, group):
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x, dim: int, group):
    return x if group is None else _GatherFrom.apply(x, dim, group)


def gather_shard(x, dim: int, group):
    return x if group is None else _GatherShard.apply(x, dim, group)


def _global(group, r: int) -> int:
    return dist.get_global_rank(group, r)


def ring_shift(xs, group, shift: int = 1):
    """`xs` (a tensor or a list of tensors) sent `shift` places along the
    group's ring, as new tensors: rank r's arrive at rank r + shift (mod
    n), and rank r returns those of rank r - shift. The identity without a
    group or on a group of one."""
    one = torch.is_tensor(xs)
    xs = [xs] if one else list(xs)
    n = size(group)
    if n == 1:
        return xs[0] if one else xs
    r = rank(group)
    dst, src = _global(group, (r + shift) % n), _global(group, (r - shift) % n)
    xs = [x.contiguous() for x in xs]
    out = [torch.empty_like(x) for x in xs]
    ops = []
    for x, y in zip(xs, out):
        ops.append(dist.P2POp(dist.isend, x, dst, group))
        ops.append(dist.P2POp(dist.irecv, y, src, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out[0] if one else out


def send_to(x: torch.Tensor, dst: int, group) -> None:
    """Send x to rank `dst` of the group (blocking; nothing without a
    group)."""
    if group is not None:
        dist.send(x.contiguous(), _global(group, dst), group=group)


def recv_from(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Receive into x from rank `src` of the group (blocking; x as it is
    without a group); returns x."""
    if group is not None:
        dist.recv(x, _global(group, src), group=group)
    return x
