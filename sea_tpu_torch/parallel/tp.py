"""Tensor parallelism, Megatron-style (port of `sea_tpu/parallel/tp.py`).

JAX states tensor parallelism as GSPMD sharding rules by parameter name and
lets the partitioner insert the collectives. The port keeps the rule as it
is and writes the collectives out:

  * column-parallel (the output dim sharded over `tp`): q/k/v projections,
    fc1 / gate_proj / up_proj, LLaMA's untied lm_head. Each position
    computes its slice of the output;
  * row-parallel (the input dim sharded): out_proj / o_proj, fc2 /
    down_proj. Each position takes its slice of the input, the partial
    products end in the group's sum, and the bias is added once, after it;
  * everything else (embeddings, norms, OPT's tied head, the SEA estimator)
    replicated.

A dimension that `tp` does not divide falls back to replicated, as in JAX
(LLaMA's GQA k/v projections at some sizes).

The SEA estimator mixes heads: the performer value is H·D wide, the
predictor CNN takes splits·H channels and the grouped top-k flattens H·T_M.
So the estimator cannot run on one position's heads. `tensor_parallel`
gathers q, k and v over `tp` after their projections and runs the
estimator replicated (it is small next to the base weights); the benchmark
path's K1 then runs on each position's own heads of the compressed mask
(the 'head' kind of `sharded_attention.py`, `SeaAttention.head_group`), so
an OPT-125m benchmark forward launches K1 12·tp times. The FFN is a plain
Megatron pair: fc1's columns stay on their position through the activation
into fc2's rows.

Every collective sits in a differentiable region function of `group.py`
(Megatron's f and g, the gather and the scatter), so the forward trains.
On a `LocalGroup` every position is in this process and each region is a
plain tensor operation; on a `DistGroup` each process holds its own shard.

    model = OptForCausalLM(opt_125m(), device="cpu")
    tensor_parallel(model, make_tp_mesh(dp=1, tp=2, devices=["cpu"] * 2))
    logits = model(ids, mask, benchmarking=True)["logits"]
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.modules import Dense, linear
from .group import (LocalGroup, copy_to_group, gather_from_group, reduce_from_group,
                    scatter_to_group)
from .mesh import Mesh, make_axes_mesh

# the projections by name (JAX's tables)
COLUMN_PARALLEL = {
    "q_proj", "k_proj", "v_proj",  # OPT + LLaMA attention inputs
    "fc1",                          # OPT MLP up
    "gate_proj", "up_proj",         # LLaMA SwiGLU up
    "lm_head",                      # untied head (LLaMA)
}
ROW_PARALLEL = {
    "out_proj", "o_proj",  # attention output
    "fc2", "down_proj",    # MLP down
}
# column-parallel outputs that the next layer reads whole (the estimator
# reads every head; the logits are the model's output); the FFN's stay on
# their position
GATHERED = {"q_proj", "k_proj", "v_proj", "lm_head"}


def make_tp_mesh(dp: Optional[int] = None, tp: Optional[int] = None,
                 devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, tp) mesh (`mesh.make_axes_mesh`; JAX's defaults: tp =
    min(n, 4) with neither size given)."""
    return make_axes_mesh(("dp", "tp"), dp, tp, devices)


def _owner(names: Sequence[str]) -> Optional[str]:
    owner = None
    for n in names:
        if n in COLUMN_PARALLEL or n in ROW_PARALLEL:
            owner = n
    return owner


def _spec_for(names, shape, axis: str, tp_size: int, stacked: bool, torch_layout: bool
              ) -> Tuple[Optional[str], ...]:
    """JAX's `_spec_for`: the spec of a kernel/bias of `shape` (a stacked
    leaf carries a leading layer dim). `torch_layout`: a Dense `weight` is
    (out, in), flax's kernel transposed, and its spec is given in that
    layout."""
    owner = _owner(names)
    if owner is None:
        return ()
    field = names[-1]
    kernel = "weight" if torch_layout else "kernel"
    lead = (None,) if stacked else ()
    body = tuple(shape[1:] if stacked else shape)
    # (in, out) of a kernel in either layout
    io = body[::-1] if torch_layout and field == kernel and len(body) == 2 else body

    def kspec(in_ax, out_ax):
        return (*lead, out_ax, in_ax) if torch_layout else (*lead, in_ax, out_ax)

    if owner in COLUMN_PARALLEL:
        if field == kernel and len(body) == 2 and io[1] % tp_size == 0:
            return kspec(None, axis)
        if field == "bias" and len(body) == 1 and body[0] % tp_size == 0:
            return (*lead, axis)
        return ()
    # row-parallel: shard the input dim; bias and output replicated (summed)
    if field == kernel and len(body) == 2 and io[0] % tp_size == 0:
        return kspec(axis, None)
    return ()


def _tp_size(mesh, axis: str) -> int:
    return mesh.shape[axis] if isinstance(mesh, Mesh) else mesh.size


def tp_param_specs(params, mesh, axis: str = "tp"):
    """The spec of every parameter by JAX's rule, over `mesh`'s `axis` (or a
    shard group). `params` is a flat state dict or module (the port's
    layout: a Dense `weight` (out, in), the spec in that layout), or a JAX
    variables tree of nested dicts, loop or scan layout (`kernel` (in, out),
    a stacked kernel (L, in, out) and bias (L, out)): the same tree of
    specs, each a tuple of axis names (None: whole) per leading dim."""
    tp_size = _tp_size(mesh, axis)
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    if params and all(not isinstance(v, Mapping) for v in params.values()) and any(
            "." in k for k in params):
        return {name: _spec_for(name.split("."), tuple(leaf.shape), axis, tp_size, False, True)
                for name, leaf in params.items()}

    def rule(path, leaf):
        if isinstance(leaf, Mapping):
            return {k: rule(path + [k], v) for k, v in leaf.items()}
        if not hasattr(leaf, "ndim"):
            return ()
        field = path[-1]
        stacked = (field == "kernel" and leaf.ndim == 3) or (field == "bias" and leaf.ndim == 2)
        return _spec_for(path, tuple(leaf.shape), axis, tp_size, stacked, False)

    return {k: rule([k], v) for k, v in params.items()}


def _group(mesh, axis: str):
    return mesh.group(axis) if isinstance(mesh, Mesh) else mesh


def shard_params_tp(state_dict: Mapping[str, torch.Tensor], mesh, axis: str = "tp"
                    ) -> List[Dict[str, torch.Tensor]]:
    """Each held position's shard of a flat state dict (the port's layout):
    one dict per position of `mesh`'s `axis` group that this process holds
    (every position on a LocalGroup, its own on a DistGroup), a sharded
    parameter cut to that position's chunk of its sharded dim, a replicated
    one the same tensor in every dict."""
    group = _group(mesh, axis)
    specs = tp_param_specs(dict(state_dict), group, axis)
    out = [dict() for _ in group.positions]
    for name, x in state_dict.items():
        spec = specs[name]
        dim = spec.index(axis) if axis in spec else None
        for i, p in enumerate(group.positions):
            out[i][name] = x if dim is None else x.chunk(group.size, dim)[p]
    return out


# ---------------------------------------------------------------------------
# The parallel projections


class ColumnParallelDense(nn.Module):
    """A Dense whose output columns are split over the group: `weight[i]`
    (out/tp, in) and `bias[i]` are held position i's. `forward` gives the
    global output (gathered) when `gather_output`, else the positions'
    outputs side by side: on a LocalGroup the same global tensor, on a
    DistGroup this process's chunk, which only a row-parallel Dense with
    `input_is_parallel` may read."""

    def __init__(self, dense: Dense, group, gather_output: bool):
        super().__init__()
        self.group = group
        self.gather_output = gather_output
        self.in_features, self.out_features = dense.in_features, dense.out_features
        held = group.positions

        def shards(x):
            return nn.ParameterList(
                [nn.Parameter(x.detach().chunk(group.size, 0)[p].clone()) for p in held])

        self.weight = shards(dense.weight)
        self.bias = shards(dense.bias) if dense.bias is not None else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = copy_to_group(self.group, x)
        parts = [linear(xi, w, None if self.bias is None else self.bias[i])
                 for i, (xi, w) in enumerate(zip(xs, self.weight))]
        if self.gather_output or isinstance(self.group, LocalGroup):
            return gather_from_group(self.group, parts, -1)
        return parts[0]


class RowParallelDense(nn.Module):
    """A Dense whose input rows are split over the group: `weight[i]` (out,
    in/tp) is held position i's, and the bias (replicated) is added once,
    after the sum. With `input_is_parallel` a DistGroup process reads its
    own chunk of the input (a column-parallel output), else the whole
    input, of which each position takes its chunk."""

    def __init__(self, dense: Dense, group, input_is_parallel: bool):
        super().__init__()
        self.group = group
        self.input_is_parallel = input_is_parallel
        self.in_features, self.out_features = dense.in_features, dense.out_features
        self.weight = nn.ParameterList(
            [nn.Parameter(dense.weight.detach().chunk(group.size, 1)[p].clone())
             for p in group.positions])
        self.bias = dense.bias

    def from_parts(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The output from each held position's chunk of the input."""
        partial = [linear(x, w) for x, w in zip(parts, self.weight)]
        out = reduce_from_group(self.group, partial)
        if self.bias is None:
            return out
        return out + self.bias.to(out.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.input_is_parallel and not isinstance(self.group, LocalGroup):
            return self.from_parts([x])
        return self.from_parts(scatter_to_group(self.group, x, -1))


def tensor_parallel(model: nn.Module, mesh, axis: str = "tp") -> nn.Module:
    """Make `model` (an OPT or LLaMA causal LM, or any module) tensor
    parallel over `mesh`'s `axis` (or a shard group), in place: every Dense
    that JAX's rule shards becomes a `ColumnParallelDense` or
    `RowParallelDense` holding this process's shards (the whole Dense
    dropped), and every SEA module runs its benchmark path's kernels on each
    position's heads (`SeaAttention.head_group`). Every other parameter
    stays as it is. Returns the model; `model.tp_group` is the group."""
    from ..models.attention import SeaAttention

    group = _group(mesh, axis)
    for name, module in list(model.named_modules()):
        if not isinstance(module, Dense):
            continue
        path = name.split(".")
        spec = _spec_for(path + ["weight"], tuple(module.weight.shape), axis, group.size,
                         False, True)
        if axis not in spec:
            continue
        parent = model.get_submodule(".".join(path[:-1])) if len(path) > 1 else model
        owner = _owner(path)
        if owner in COLUMN_PARALLEL:
            new = ColumnParallelDense(module, group, gather_output=owner in GATHERED)
        else:
            new = RowParallelDense(module, group,
                                   input_is_parallel=owner in ("fc2", "down_proj"))
        setattr(parent, path[-1], new)
    for module in model.modules():
        if isinstance(module, SeaAttention):
            module.head_group = group
    model.tp_group = group
    return model


def gather_tp(model: nn.Module, grads: bool = False) -> Dict[str, torch.Tensor]:
    """A tensor-parallel model's parameters (or, with `grads`, their
    gradients; None where a parameter has none) under the unsharded model's
    names, each sharded one joined from its shards (on a DistGroup, over the
    processes)."""
    def value(p):
        return p.grad if grads else p.detach()

    parallel = {name: m for name, m in model.named_modules()
                if isinstance(m, (ColumnParallelDense, RowParallelDense))}
    out = {}
    for name, p in model.named_parameters():
        owner = name.split(".weight")[0].split(".bias")[0]
        if owner not in parallel:
            out[name] = value(p)
    for name, module in parallel.items():
        dim = 0 if isinstance(module, ColumnParallelDense) else 1
        for field in ("weight", "bias"):
            shards = getattr(module, field)
            if shards is None:
                continue
            if not isinstance(shards, nn.ParameterList):  # a row-parallel bias
                out[f"{name}.{field}"] = value(shards)
                continue
            xs = [value(x) for x in shards]
            out[f"{name}.{field}"] = None if any(x is None for x in xs) else \
                module.group.join_rows(xs, dim if field == "weight" else 0)
    return out


# ---------------------------------------------------------------------------
# Head-sharded decode (the serving engine's `mesh=`)


def _out_proj(attn: nn.Module) -> nn.Module:
    return attn.out_proj if hasattr(attn, "out_proj") else attn.o_proj


@torch.no_grad()
def tp_decode_step_paged(model, token_ids: torch.Tensor, position, states, pools_k, pools_v,
                         pages: torch.Tensor):
    """One serving step of a tensor-parallel causal LM (`tensor_parallel`)
    over head-sharded decode states and pools: `states[i]` the held position
    i's per-layer states (`state.head_shard`), `pools_k[i]`/`pools_v[i]` its
    (L, P, page_size, H/tp, D) pools, written in place. Each position
    decodes its own heads (its FAVOR+ sums, CNN rows, K/V pages and running
    sums); the CNN windows are gathered every step, since the estimator's
    CNN and its top-k over H·T_M mix heads, and each position takes its heads
    of the row mask; the output projection ends in the group's sum. Returns
    (logits (N, 1, V), the new states per held position)."""
    group = model.tp_group
    n = group.size
    h, extra = model._embed_step(token_ids, position)
    new_states = [[] for _ in group.positions]
    for li, layer in enumerate(model.model.layers):
        attn = layer.self_attn

        def attend(x):
            if attn.cfg.attention_method != "perlin":
                raise NotImplementedError("decode is ported for the SEA student ('perlin') only")
            q, k, v = attn._qkv(x, *extra)
            perlin = attn.perlin
            heads = [(q_, k_, v_) for q_, k_, v_ in zip(*(x.chunk(n, 1) for x in (q, k, v)))]
            mine = [heads[p] for p in group.positions]
            steps = [perlin._decode_rows(*hv, st[li]) for hv, st in zip(mine, states)]
            window = group.join_rows([s[3] for s in steps], 1)
            pos_b = steps[0][5]
            max_len = pages.shape[1] * pools_k[0].shape[2]
            masks = group.split_rows(perlin.decode_row_mask(window, pos_b, max_len, q.dtype), 1)
            outs, sts = [], []
            for i, (hv, st, step, mask) in enumerate(zip(mine, states, steps, masks)):
                t_pred, S, z, _, filled, _ = step
                out, new, _, _ = perlin.paged_attend(
                    *hv, mask, t_pred, (S, z, step[3], filled), st[li], pools_k[i][li],
                    pools_v[i][li], pages, pos_b)
                outs.append(out)
                sts.append(new)
            proj = _out_proj(attn)
            if isinstance(proj, RowParallelDense):
                return proj.from_parts(outs), sts
            return proj(group.join_rows(outs, -1)), sts

        h, sts = layer._around_attention(h, attend)
        for i, st in enumerate(sts):
            new_states[i].append(st)
    return model.logits(model.model.finalize(h)), new_states
