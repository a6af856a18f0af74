"""Sharded attention over shard groups (the port of `sea_tpu/parallel/`'s
context and sharded attention).

`LocalGroup` / `DistGroup` (`group.py`) stand for a mesh axis;
`sharded_attention_scope` (`context.py`) routes SeaAttention's fused causal
paths through the 'seq', 'head' and 'ring' kinds of `sharded_attention.py`.
The JAX package's `mesh.py` (data parallelism and ZeRO-style optimizer
sharding), `tp.py` and `pp.py` are not ported yet.
"""

from .context import (
    RING_MIN_T,
    AttnShardingContext,
    current_attention_sharding,
    resolve_attention_kind,
    sharded_attention_scope,
)
from .group import DistGroup, LocalGroup

__all__ = [
    "RING_MIN_T",
    "AttnShardingContext",
    "DistGroup",
    "LocalGroup",
    "current_attention_sharding",
    "resolve_attention_kind",
    "sharded_attention_scope",
]
