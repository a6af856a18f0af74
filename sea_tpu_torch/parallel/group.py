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
    the entry of position p − 1 (mod size);
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
them inside their own `torch.autograd.Function`s.
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
        (item,) = items
        if self.size == 1:
            return [item]
        single = torch.is_tensor(item)
        sends = [item] if single else list(item)
        recvs = [torch.empty_like(t) for t in sends]
        nxt = self._global((self.rank + 1) % self.size)
        prv = self._global((self.rank - 1) % self.size)
        ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, self.group) for t in sends]
        ops += [dist.P2POp(dist.irecv, t, prv, self.group) for t in recvs]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [recvs[0] if single else tuple(recvs)]

    def all_reduce_sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        (mine,) = parts
        total = mine.clone()
        dist.all_reduce(total, group=self.group)
        return total
