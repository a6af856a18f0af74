"""The (dp, sp) mesh and its sharding rules (port of
`sea_tpu/parallel/mesh.py`).

A mesh is dp × sp positions, row-major: position (i, j) is the i-th data-
parallel replica's j-th sequence shard.

  * `dp` — data parallel: the batch axis of activations; the optimizer's
    moments may be sharded over it (`opt_state_sharding`, the ZeRO-1 rule);
  * `sp` — sequence parallel: the query-row axis of the SEA attention
    (`sharded_attention_scope(mesh, axis="sp")`).

Each axis of this process's positions is a shard group (`group.py`):

  * one process holds every position (`make_mesh(..., devices=[d] * n)`, all
    on one device `d`): each axis is a `LocalGroup`, as the JAX tests' virtual
    CPU devices are one process's;
  * one process per position (`devices=None` inside a `torch.distributed`
    world of dp·sp processes, rank r at (r // sp, r % sp)): each axis is a
    `DistGroup` over its row (sp) or column (dp), one
    `torch.distributed.new_group` each, which every process creates.

The shardings are specs, as `jax.sharding.NamedSharding` is one: the mesh
and one axis name (or None) per leading dimension of the leaf; the empty
spec replicates. Parameters stay replicated; the trainer shards only the
batch (`training/opt_trainer.py`'s `data_parallel`), as JAX's does.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .group import DistGroup, LocalGroup

AXES = ("dp", "sp")


class Mesh:
    """dp × sp positions and this process's shard group along each axis
    (`group("dp")`, `group("sp")`). `devices` is the (dp, sp) array of the
    positions' devices (a local mesh) or of their ranks (one process per
    position)."""

    def __init__(self, devices: np.ndarray, groups: dict):
        self.devices = devices
        self.shape = {name: int(n) for name, n in zip(AXES, devices.shape)}
        self.axis_names = AXES
        self._groups = groups

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def group(self, axis: str):
        """This process's shard group along `axis` ('dp' or 'sp')."""
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}; one of {AXES}")
        return self._groups[axis]


def _axis_groups(dp: int, sp: int):
    """This rank's (dp, sp) groups of a world of dp·sp processes: its column
    and its row, each a `torch.distributed` group that every rank creates (a
    group of the whole world is the default one)."""
    n, rank = dp * sp, dist.get_rank()

    def made(members):
        return None if len(members) == n else dist.new_group(members)

    rows = [made(list(range(i * sp, (i + 1) * sp))) for i in range(dp)]
    cols = [made(list(range(j, n, sp))) for j in range(sp)]
    return {"dp": DistGroup(cols[rank % sp]), "sp": DistGroup(rows[rank // sp])}


def make_mesh(dp: Optional[int] = None, sp: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, sp) mesh over `devices`: one entry per position, every one on
    this process's one device (LocalGroup axes), or None: one position per
    process of the initialised `torch.distributed` world (DistGroup axes),
    and outside one a single position on "cuda". JAX's defaults: with
    neither size given, sp = min(n, 4) and dp = n // sp; with one, the other
    is n over it; dp · sp must be n."""
    distributed = devices is None and dist.is_available() and dist.is_initialized()
    if distributed:
        n = dist.get_world_size()
    else:
        devices = [torch.device(d) for d in (devices if devices is not None else ["cuda"])]
        n = len(devices)
    if dp is None and sp is None:
        # favour sequence sharding, as JAX does within a host
        sp = min(n, 4)
        dp = n // sp
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    assert dp * sp == n, (dp, sp, n)
    if distributed:
        return Mesh(np.arange(n).reshape(dp, sp), _axis_groups(dp, sp))
    if len(set(devices)) != 1:
        raise ValueError(f"a local mesh holds its positions on one device, got {set(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    d = devices[0]
    return Mesh(arr.reshape(dp, sp), {"dp": LocalGroup(dp, d), "sp": LocalGroup(sp, d)})


class NamedSharding(NamedTuple):
    """A leaf's layout over `mesh`: `spec[i]` names the mesh axis its
    dimension i is split over (None: whole); the empty spec replicates."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """(N, T, ...) activations: batch over dp, sequence over sp."""
    return NamedSharding(mesh, ("dp", "sp"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _tree_map(fn, tree):
    """`fn` on every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree(x) -> Any:
    """An optimizer (its `state_dict()`) or a module (its parameters by
    name) as a tree; any other tree as it is."""
    if isinstance(x, torch.nn.Module):
        return dict(x.named_parameters())
    if hasattr(x, "state_dict") and callable(x.state_dict):
        return x.state_dict()
    return x


def param_sharding(mesh: Mesh, params):
    """Parameters replicated (the 125m scale); larger models would shard the
    FFN and the embedding over sp (tensor parallelism, not ported)."""
    return _tree_map(lambda _: replicated(mesh), _tree(params))


def opt_state_sharding(mesh: Mesh, opt_state):
    """The ZeRO-1 rule: each leaf of the optimizer state (a tree, or an
    optimizer such as `GroupedAdamW`, read through its state dict) sharded
    along its first dimension over dp where that dimension is longer than
    one and dp divides it, else replicated (the step count, scalars)."""
    dp = mesh.shape["dp"]

    def rule(leaf):
        shape = getattr(leaf, "shape", None)
        if shape is not None and len(shape) >= 1 and shape[0] % dp == 0 and shape[0] > 1:
            return NamedSharding(mesh, ("dp",))
        return replicated(mesh)

    return _tree_map(rule, _tree(opt_state))
