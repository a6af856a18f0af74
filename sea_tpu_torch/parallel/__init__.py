"""Sharded attention over shard groups, the meshes, tensor and pipeline
parallelism (the port of `sea_tpu/parallel/`).

`LocalGroup` / `DistGroup` (`group.py`) stand for a mesh axis, with the
differentiable collectives of tensor and pipeline parallelism; `make_mesh`
(`mesh.py`) builds the (dp, sp) mesh of them, one process holding every
position or one process per position, with its sharding rules
(`batch_sharding`, `replicated`, `param_sharding`, `opt_state_sharding`);
`sharded_attention_scope` (`context.py`) routes SeaAttention's fused causal
paths through the 'seq', 'head' and 'ring' kinds of `sharded_attention.py`,
over a group or a mesh's axis. `tp.py` makes a model tensor parallel over a
(dp, tp) mesh (`make_tp_mesh`, `tensor_parallel`, JAX's `tp_param_specs`
rule), `pp.py` pipelines its layers over a (dp, pp) mesh (`make_pp_mesh`,
GPipe, interleaved, 1F1B, KD). The KD trainer's `data_parallel`
(`training/opt_trainer.py`) splits the batch over the world's processes.
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
    make_axes_mesh,
    make_mesh,
    opt_state_sharding,
    param_sharding,
    replicated,
)
from .pp import make_pp_mesh
from .tp import make_tp_mesh, tensor_parallel

__all__ = [
    "RING_MIN_T",
    "AttnShardingContext",
    "DistGroup",
    "LocalGroup",
    "Mesh",
    "NamedSharding",
    "batch_sharding",
    "current_attention_sharding",
    "make_axes_mesh",
    "make_mesh",
    "make_pp_mesh",
    "make_tp_mesh",
    "opt_state_sharding",
    "param_sharding",
    "replicated",
    "resolve_attention_kind",
    "sharded_attention_scope",
    "tensor_parallel",
]
