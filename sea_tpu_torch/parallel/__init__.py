"""Sharded attention over shard groups, and the (dp, sp) mesh (the port of
`sea_tpu/parallel/`'s context, sharded attention and mesh).

`LocalGroup` / `DistGroup` (`group.py`) stand for a mesh axis; `make_mesh`
(`mesh.py`) builds the (dp, sp) mesh of them, one process holding every
position or one process per position, with its sharding rules
(`batch_sharding`, `replicated`, `param_sharding`, `opt_state_sharding`);
`sharded_attention_scope` (`context.py`) routes SeaAttention's fused causal
paths through the 'seq', 'head' and 'ring' kinds of `sharded_attention.py`,
over a group or a mesh's axis. The KD trainer's `data_parallel`
(`training/opt_trainer.py`) splits the batch over the world's processes. The
JAX package's `tp.py` and `pp.py` are not ported yet.
"""

from .context import (
    RING_MIN_T,
    AttnShardingContext,
    current_attention_sharding,
    resolve_attention_kind,
    sharded_attention_scope,
)
from .group import DistGroup, LocalGroup
from .mesh import (
    Mesh,
    NamedSharding,
    batch_sharding,
    make_mesh,
    opt_state_sharding,
    param_sharding,
    replicated,
)

__all__ = [
    "RING_MIN_T",
    "AttnShardingContext",
    "DistGroup",
    "LocalGroup",
    "Mesh",
    "NamedSharding",
    "batch_sharding",
    "current_attention_sharding",
    "make_mesh",
    "opt_state_sharding",
    "param_sharding",
    "replicated",
    "resolve_attention_kind",
    "sharded_attention_scope",
]
