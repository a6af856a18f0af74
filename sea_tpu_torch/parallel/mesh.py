"""Two-axis meshes and their sharding rules (port of
`sea_tpu/parallel/mesh.py`, with the meshes of `tp.py` and `pp.py`).

A mesh is a × b positions over two named axes, row-major: position (i, j) is
the i-th replica of the first axis's j-th shard of the second. The axes:

  * `dp` — data parallel: the batch axis of activations; the optimizer's
    moments may be sharded over it (`opt_state_sharding`, the ZeRO-1 rule);
  * `sp` — sequence parallel: the query-row axis of the SEA attention
    (`sharded_attention_scope(mesh, axis="sp")`), `make_mesh`'s second axis;
  * `tp` — tensor parallel (`tp.make_tp_mesh`): the heads and FFN columns;
  * `pp` — pipeline parallel (`pp.make_pp_mesh`): the blocks of layers.

Each axis of this process's positions is a shard group (`group.py`):

  * one process holds every position (`make_mesh(..., devices=[d] * n)`, all
    on one device `d`): each axis is a `LocalGroup`, as the JAX tests' virtual
    CPU devices are one process's;
  * one process per position (`devices=None` inside a `torch.distributed`
    world of a·b processes, rank r at (r // b, r % b)): each axis is a
    `DistGroup` over its row (the second axis) or column (the first), one
    `torch.distributed.new_group` each, which every process creates.

The shardings are specs, as `jax.sharding.NamedSharding` is one: the mesh
and one axis name (or None) per leading dimension of the leaf; the empty
spec replicates. Under `make_mesh` parameters stay replicated and the
trainer shards only the batch (`training/opt_trainer.py`'s
`data_parallel`), as JAX's does; `tp.tp_param_specs` shards them by name.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .group import DistGroup, LocalGroup

AXES = ("dp", "sp")


class Mesh:
    """Positions over two named axes (`axis_names`, `make_mesh`'s ("dp",
    "sp") by default) and this process's shard group along each
    (`group(name)`). `devices` is the array of the positions' devices (a
    local mesh) or of their ranks (one process per position), one dimension
    per axis."""

    def __init__(self, devices: np.ndarray, groups: dict, axis_names: Tuple[str, ...] = AXES):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = {name: int(n) for name, n in zip(self.axis_names, devices.shape)}
        self._groups = groups

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def group(self, axis: str):
        """This process's shard group along `axis` (one of `axis_names`)."""
        if axis not in self.axis_names:
            raise ValueError(f"unknown mesh axis {axis!r}; one of {self.axis_names}")
        return self._groups[axis]


def _axis_groups(a: int, b: int, names: Tuple[str, str]):
    """This rank's groups of a world of a·b processes over the axes `names`:
    its column (the first axis) and its row (the second), each a
    `torch.distributed` group that every rank creates (a group of the whole
    world is the default one)."""
    n, rank = a * b, dist.get_rank()

    def made(members):
        return None if len(members) == n else dist.new_group(members)

    rows = [made(list(range(i * b, (i + 1) * b))) for i in range(a)]
    cols = [made(list(range(j, n, b))) for j in range(b)]
    return {names[0]: DistGroup(cols[rank % b]), names[1]: DistGroup(rows[rank // b])}


def make_axes_mesh(names: Tuple[str, str], a: Optional[int] = None, b: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> Mesh:
    """An (a, b) mesh over the axes `names` and `devices`: one entry per
    position, every one on this process's one device (LocalGroup axes), or
    None: one position per process of the initialised `torch.distributed`
    world (DistGroup axes), and outside one a single position on "cuda".
    JAX's defaults: with neither size given, b = min(n, 4) and a = n // b;
    with one, the other is n over it; a · b must be n."""
    distributed = devices is None and dist.is_available() and dist.is_initialized()
    if distributed:
        n = dist.get_world_size()
    else:
        devices = [torch.device(d) for d in (devices if devices is not None else ["cuda"])]
        n = len(devices)
    if a is None and b is None:
        # favour the second (within-host) axis, as JAX does
        b = min(n, 4)
        a = n // b
    elif a is None:
        a = n // b
    elif b is None:
        b = n // a
    assert a * b == n, (a, b, n)
    if distributed:
        return Mesh(np.arange(n).reshape(a, b), _axis_groups(a, b, names), names)
    if len(set(devices)) != 1:
        raise ValueError(f"a local mesh holds its positions on one device, got {set(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    d = devices[0]
    return Mesh(arr.reshape(a, b), {names[0]: LocalGroup(a, d), names[1]: LocalGroup(b, d)},
                names)


def make_mesh(dp: Optional[int] = None, sp: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, sp) mesh (`make_axes_mesh`): with neither size given, sp =
    min(n, 4) and dp = n // sp, favouring sequence sharding as JAX does
    within a host."""
    return make_axes_mesh(AXES, dp, sp, devices)


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
    """Parameters replicated (the 125m scale); a larger model shards its
    projections by name over a tp axis (`tp.tp_param_specs`,
    `tp.shard_params_tp`)."""
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
