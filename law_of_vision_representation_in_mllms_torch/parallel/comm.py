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
