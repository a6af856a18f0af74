"""Shard groups: the port's counterpart of a JAX `Mesh` axis with
`lax.axis_index`, `lax.ppermute`, `lax.psum` and `shard_map`'s split and
join of the global arrays.

A group has `size` positions 0 .. size − 1 around a ring; a process holds
some of them (`positions`). The sharded attention functions are written
once, as loops over the positions a process holds, against this interface:

  * `split_rows(x, dim)`: the chunks of the global tensor `x` along `dim`
    that the held positions own (shard_map's in_spec P(axis) on that dim);
  * `join_rows(chunks, dim)`: the global tensor from the held positions'
    chunks (the out_spec);
  * `ppermute_next(items)`: one hop of the ring; `items` holds one entry per
    held position (a tensor or a tuple of tensors), and position p receives
    the entry of position p − 1 (mod size); `ppermute_prev(items)` the hop
    the other way (p receives p + 1's);
  * `all_reduce_sum(parts)`: the sum over every position of its part, one
    part per held position (psum).

Two implementations:

  * `LocalGroup(size, device)` holds every position in one process on one
    device, as the JAX tests' virtual CPU devices do; a hop rotates the list,
    and split and join are `chunk` and `cat`;
  * `DistGroup(process_group)` holds one position per process of a
    `torch.distributed` group (NCCL on GPUs, gloo on the CPU): a hop is one
    batched send/receive (`batch_isend_irecv`), the join an all-gather, the
    sum an all-reduce. Every process passes and gets the same global
    tensors, as under shard_map.

Neither records autograd history: the sharded attention functions call
them inside their own `torch.autograd.Function`s. The region functions at
the end (`copy_to_group`, `reduce_from_group`, `gather_from_group`,
`scatter_to_group`, `ring_hop`) are the differentiable collectives of tensor
and pipeline parallelism: Megatron's f/g pair and its gather and scatter,
and one hop of a pipeline's ring. On a `LocalGroup` they are plain tensor
operations, whose autograd is already right; on a `DistGroup` each is a
`torch.autograd.Function` that keeps its group on `ctx`.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


class LocalGroup:
    """Every position of a ring of `size` in this process, its shards on
    `device`. The group moves nothing: `split_rows` refuses a tensor on
    another device (None accepts any)."""

    def __init__(self, size: int, device=None):
        if size < 1:
            raise ValueError(f"a group has at least one position, got {size}")
        self.size = size
        self.device = torch.device(device) if device is not None else None
        self.positions = list(range(size))

    def split_rows(self, x: torch.Tensor, dim: int = 2) -> List[torch.Tensor]:
        d = self.device
        if d is not None and (x.device.type != d.type
                              or d.index is not None and x.device.index != d.index):
            raise ValueError(f"a tensor on {x.device} given to a group on {d}")
        if x.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {self.size} ways")
        return [c.contiguous() for c in x.chunk(self.size, dim)]

    def join_rows(self, chunks: Sequence[torch.Tensor], dim: int = 2) -> torch.Tensor:
        return torch.cat(list(chunks), dim)

    def ppermute_next(self, items: list) -> list:
        return [items[-1], *items[:-1]]

    def ppermute_prev(self, items: list) -> list:
        return [*items[1:], items[0]]

    def all_reduce_sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        return total


class DistGroup:
    """One position per process of `process_group` (default: the world), at
    the process's rank in it."""

    def __init__(self, process_group=None):
        if not dist.is_initialized():
            raise RuntimeError("DistGroup needs torch.distributed.init_process_group first")
        self.group = process_group
        self.size = dist.get_world_size(process_group)
        self.rank = dist.get_rank(process_group)
        self.positions = [self.rank]

    def _global(self, rank: int) -> int:
        return dist.get_global_rank(self.group, rank) if self.group is not None else rank

    def split_rows(self, x: torch.Tensor, dim: int = 2) -> List[torch.Tensor]:
        if x.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {self.size} ways")
        return [x.chunk(self.size, dim)[self.rank].contiguous()]

    def join_rows(self, chunks: Sequence[torch.Tensor], dim: int = 2) -> torch.Tensor:
        (mine,) = chunks
        mine = mine.contiguous()
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(parts, mine, group=self.group)
        return torch.cat(parts, dim)

    def ppermute_next(self, items: list) -> list:
        return self._hop(items, 1)

    def ppermute_prev(self, items: list) -> list:
        return self._hop(items, -1)

    def _hop(self, items: list, step: int) -> list:
        """Send to the position `step` ahead, receive from the one behind."""
        (item,) = items
        if self.size == 1:
            return [item]
        single = torch.is_tensor(item)
        sends = [item] if single else list(item)
        recvs = [torch.empty_like(t) for t in sends]
        dst = self._global((self.rank + step) % self.size)
        src = self._global((self.rank - step) % self.size)
        ops = [dist.P2POp(dist.isend, t.contiguous(), dst, self.group) for t in sends]
        ops += [dist.P2POp(dist.irecv, t, src, self.group) for t in recvs]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [recvs[0] if single else tuple(recvs)]

    def all_reduce_sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        (mine,) = parts
        total = mine.clone()
        dist.all_reduce(total, group=self.group)
        return total


# ---------------------------------------------------------------------------
# Differentiable collectives (tensor and pipeline parallelism). Each takes
# and returns one entry per held position, as the group's methods do.


class _CopyToGroup(torch.autograd.Function):
    """f: identity forward, the positions' gradients summed backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_sum([g]), None


class _ReduceFromGroup(torch.autograd.Function):
    """g: the sum over the positions forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce_sum([x])

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """The global tensor from each position's chunk along `dim`; backward,
    the position's own chunk of the gradient (the global tensor feeds a
    computation replicated on every position)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.join_rows([x], dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.split_rows(g, ctx.dim)[0], None, None


class _ScatterToGroup(torch.autograd.Function):
    """The position's chunk of a replicated tensor along `dim`; backward,
    the chunks' gradients joined."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.split_rows(x, dim)[0]

    @staticmethod
    def backward(ctx, g):
        return ctx.group.join_rows([g.contiguous()], ctx.dim), None, None


def copy_to_group(group, x: torch.Tensor) -> List[torch.Tensor]:
    """A replicated tensor entering a parallel region, one entry per held
    position; the backward sums the positions' gradients (Megatron's f)."""
    if isinstance(group, LocalGroup):
        return [x] * group.size
    return [_CopyToGroup.apply(x, group)]


def reduce_from_group(group, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum over every position of its part, replicated; the backward
    hands each part the gradient as it is (Megatron's g)."""
    if isinstance(group, LocalGroup):
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total
    (mine,) = parts
    return _ReduceFromGroup.apply(mine, group)


def gather_from_group(group, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The global tensor from the held positions' chunks along `dim`
    (`join_rows`), differentiable."""
    if isinstance(group, LocalGroup):
        return torch.cat(list(parts), dim)
    (mine,) = parts
    return _GatherFromGroup.apply(mine, group, dim)


def scatter_to_group(group, x: torch.Tensor, dim: int) -> List[torch.Tensor]:
    """The held positions' chunks of a replicated tensor along `dim`
    (`split_rows`), differentiable."""
    if isinstance(group, LocalGroup):
        if x.shape[dim] % group.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {group.size} ways")
        return list(x.chunk(group.size, dim))
    return [_ScatterToGroup.apply(x, group, dim)]


class _RingHop(torch.autograd.Function):
    """One `ppermute_next` of a tuple of tensors on a DistGroup; the
    backward sends the received tensors' gradients back (`ppermute_prev`).
    `token` chains every hop of a schedule, so that each process runs the
    hops' backwards in one order (the reverse of the forward's) and each
    runs every one of them, even where a received tensor went unused."""

    @staticmethod
    def forward(ctx, group, token, *xs):
        ctx.group = group
        (recv,) = group.ppermute_next([tuple(x.detach() for x in xs)])
        return (token.detach().clone(), *recv)

    @staticmethod
    def backward(ctx, g_token, *gs):
        (back,) = ctx.group.ppermute_prev([tuple(g.contiguous() for g in gs)])
        return (None, g_token, *back)


def ring_hop(group, items: list, token: torch.Tensor):
    """One differentiable hop of a pipeline's ring: `items` one tuple of
    tensors per held position, position p receiving p − 1's. Returns (the
    received items, the next token)."""
    if isinstance(group, LocalGroup):
        return group.ppermute_next(items), token
    (item,) = items
    token, *recv = _RingHop.apply(group, token, *item)
    return [tuple(recv)], token
