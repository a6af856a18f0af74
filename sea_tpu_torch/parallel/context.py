"""Sharding scope that routes SeaAttention's fused causal paths (the
benchmark forward and the `use_fused_train` path) through the sharded
attention functions of `parallel/sharded_attention.py`.

The port of `sea_tpu/parallel/context.py`, with a shard group (`LocalGroup`
or `DistGroup`, `parallel/group.py`) in place of the mesh and its axis, or a
mesh (`parallel/mesh.py`) and the name of its axis, as in JAX:

    with sharded_attention_scope(LocalGroup(4), kind="ring"):
        losses = train_steps(model, ids, mask, steps)
    with sharded_attention_scope(make_mesh(dp=1, sp=4, devices=["cuda"] * 4), axis="sp"):
        out = model(ids, mask, benchmarking=True)

The scope is thread-local, as in JAX; the model reads it while it runs its
forward (the sharded functions keep what their backward needs).
"""

from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import Any, Optional

from .mesh import Mesh

_TLS = threading.local()


@dataclasses.dataclass(frozen=True)
class AttnShardingContext:
    group: Any  # LocalGroup | DistGroup
    kind: str = "auto"  # 'auto' | 'seq' (zigzag row blocks) | 'head' | 'ring'
    #   'ring': K/V stay sequence-sharded and rotate around the group's
    #   positions; differentiable on the use_fused_train path (dk/dv ring
    #   home with their chunks)
    #   'auto': resolve_attention_kind picks 'ring' at long T, else 'seq'
    zigzag: bool = True
    block_q: Optional[int] = None
    block_k: Optional[int] = None


# 'seq' replicates the full K/V on every shard (SEA's mask is global, so
# there is no bounded halo), 2·N·H·T·D words per shard whatever the shard
# count; 'ring' keeps K/V (and dk/dv in training) sequence-sharded at the
# price of S hops and a per-window logsumexp merge. Below this T the
# replicated K/V is small and the hops are pure overhead. The JAX package's
# rule, kept as it is.
RING_MIN_T = 16384


def resolve_attention_kind(
    ctx: AttnShardingContext, *, t: int, oversample: float = 1.0
) -> str:
    """Resolve kind='auto' by (T, shard count): 'ring' when the sequence is
    long enough that per-shard K/V replication dominates, 'seq' otherwise.
    'ring' does not implement the k_oversample keep-predicate, so any
    oversampled config stays on 'seq'; a group of one position never
    rings."""
    if ctx.kind != "auto":
        return ctx.kind
    if ctx.group.size > 1 and t >= RING_MIN_T and oversample == 1.0:
        return "ring"
    return "seq"


def current_attention_sharding() -> Optional[AttnShardingContext]:
    return getattr(_TLS, "ctx", None)


@contextmanager
def sharded_attention_scope(
    group,
    kind: str = "auto",
    zigzag: bool = True,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    axis: str = "sp",
):
    """`group`: a shard group, or a `Mesh`, whose `axis` group is taken."""
    if kind not in ("auto", "seq", "head", "ring"):
        raise ValueError(f"unknown sharded attention kind {kind!r}")
    if isinstance(group, Mesh):
        group = group.group(axis)
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = AttnShardingContext(
        group=group, kind=kind, zigzag=zigzag, block_q=block_q, block_k=block_k,
    )
    try:
        yield _TLS.ctx
    finally:
        _TLS.ctx = prev
