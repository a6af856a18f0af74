"""Pipeline parallelism over a `pp` mesh axis (port of
`sea_tpu/parallel/pp.py`).

The layer stack is cut into S contiguous blocks, one per stage of the pp
group (`shard_params_pp`); embed, finalize and the logits stay replicated
(the model's `external_layers` shell holds just those). The schedules:

  * GPipe (`pipeline_layers`): M + S − 1 ticks; at each, every stage runs
    its layers on the microbatch it holds and the tick ends with one hop of
    the ring (`ppermute_next`). Microbatches enter at stage 0 and drain at
    stage S − 1. A stage skips the ticks where it holds no microbatch
    (JAX's scan computes them and masks the result), so each layer runs M
    times. The forward is differentiable: autograd runs the backward in
    GPipe's order, with every microbatch's activations live in between
    (`use_remat` keeps each layer's input alone);
  * interleaved (`pipeline_layers_interleaved`): stage s holds V chunks of
    layers (global chunks s, s + S, ...), the bubble shrinking to
    (S − 1)/(V·M + S − 1) of the ticks; the hop from the last stage back to
    stage 0 waits in a per-stage pending ring of M slots;
  * 1F1B (`pipeline_1f1b_value_and_grad`): an explicit schedule
    (`sim_1f1b_schedule`, PipeDream-flush), not autograd over a forward. A
    forward tick runs the stage under `no_grad` and stashes its input (at
    most S − s of them); a backward tick recomputes the stage and calls
    `torch.autograd.grad` with the cotangent from the next stage (the last
    stage's from the head's loss). Activation memory is O(S), not O(M).
    Per-layer losses that must be differentiated ride in the carry.

The functions run over the held positions of the pp group: on a
`LocalGroup` every stage is in this process and runs in turn (so on one
card a peak is the sum over the stages), on a `DistGroup` each process is
one stage and a hop is a send/receive (`group.ring_hop` chains the hops'
backwards so every process runs them in one order). With `dp_axis` the
batch rows are split over that axis of the mesh, each replica pipelines its
rows, and the aux values, losses and gradients are averaged over it.

`pp_causal_lm_forward`, `pp_kd_loss` and `pp_kd_1f1b_value_and_grad` drive
an OPT or LLaMA causal LM through these; the KD pair carries exactly the
math of `training.distill.SeaOptKDScan` (no jitter, no teacher gradients).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .group import LocalGroup, gather_from_group, reduce_from_group, ring_hop, scatter_to_group
from .mesh import Mesh, make_axes_mesh


def make_pp_mesh(dp: Optional[int] = None, pp: Optional[int] = None,
                 devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, pp) mesh (`mesh.make_axes_mesh`; JAX's defaults: pp =
    min(n, 4) with neither size given)."""
    return make_axes_mesh(("dp", "pp"), dp, pp, devices)


# ---------------------------------------------------------------------------
# trees: tensors in nested tuples, lists and dicts


def _tmap(fn, *trees):
    """`fn` over the leaves of trees of one structure (the first's)."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tmap(fn, *(t[i] for t in trees)) for i in range(len(first)))
    return fn(*trees)


def _leaves(tree) -> List[Any]:
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)
    return _tmap(lambda _: next(it), tree)


def _tadd(a, b):
    return b if a is None else a + b


def pp_stage_specs(layer_vars, axis: str = "pp"):
    """A stacked layer tree's specs: every leaf's leading (layer) dim over
    `axis`."""
    return _tmap(lambda _: (axis,), layer_vars)


def _group(mesh, axis: str):
    return mesh.group(axis) if isinstance(mesh, Mesh) else mesh


def shard_params_pp(layer_vars, mesh, axis: str = "pp") -> list:
    """Each held stage's contiguous block of layers: `layer_vars` is a
    sequence of L layers (modules, or any per-layer items) or a stacked tree
    (every leaf with a leading layer dim, `weights.stack_layer_params`'s
    `layers_scan/layer`); one block (a list, or a tree of the stage's rows)
    per position of `mesh`'s `axis` group that this process holds."""
    group = _group(mesh, axis)
    S = group.size
    if isinstance(layer_vars, (Sequence, nn.ModuleList)) and not torch.is_tensor(layer_vars):
        items = list(layer_vars)
        if len(items) % S:
            raise ValueError(f"{len(items)} layers do not split into {S} stages")
        per = len(items) // S
        return [items[p * per:(p + 1) * per] for p in group.positions]
    L = _leaves(layer_vars)[0].shape[0]
    if L % S:
        raise ValueError(f"{L} layers do not split into {S} stages")
    per = L // S
    return [_tmap(lambda x, p=p: x[p * per:(p + 1) * per], layer_vars) for p in group.positions]


def split_scan_vars(variables) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Split scan-layout variables (JAX's nested trees, as
    `weights.stack_layer_params` makes them) into (layer stacks, the rest):
    {collection: stacked tree} for every collection carrying
    `model/layers_scan/layer`, and the variables as they are (embed,
    finalize and logits read them)."""
    layer_vars = {}
    for col, tree in variables.items():
        sub = tree.get("model", {}) if isinstance(tree, Mapping) else {}
        if "layers_scan" in sub:
            layer_vars[col] = sub["layers_scan"]["layer"]
    return layer_vars, variables


def _rows(x, n: int) -> bool:
    """Whether a leaf has the batch's leading dim (and is cut with it)."""
    return torch.is_tensor(x) and x.dim() >= 1 and x.shape[0] == n


def _micro(tree, n: int, m: int) -> List[Any]:
    """`tree` cut into m microbatches along dim 0: leaves with a leading dim
    of n are chunked, every other leaf is kept in each."""
    if n % m:
        raise ValueError(f"a batch of {n} rows does not split into {m} microbatches")
    return [_tmap(lambda x, i=i: x.chunk(m, 0)[i] if _rows(x, n) else x, tree)
            for i in range(m)]


def _run_local(layer_apply, layers, x, bundle):
    """The stage's layers in order: (output, sum of their aux values)."""
    aux = None
    for item in layers:
        x, a = layer_apply(item, x, bundle)
        aux = _tadd(aux, a)
    return x, aux


def _zeros_like_tree(tree):
    return _tmap(lambda x: torch.zeros_like(x) if torch.is_tensor(x) else x, tree)


def _hop(group, items: list, template, token):
    """One differentiable hop of the ring: `items` one tree per held
    position (None: the position sent nothing this tick). On a DistGroup
    every process sends (zeros for nothing) and receives."""
    if isinstance(group, LocalGroup):
        return group.ppermute_next(items), token
    (item,) = items
    if item is None:
        item = _zeros_like_tree(template)
    (recv,), token = ring_hop(group, [tuple(_leaves(item))], token)
    return [_unflatten(template, recv)], token


def _token(group, ref: torch.Tensor):
    """The first link of a schedule's hop chain (a DistGroup's; None on a
    LocalGroup)."""
    if isinstance(group, LocalGroup) or not torch.is_grad_enabled():
        return None
    return torch.zeros((), dtype=torch.float32, device=ref.device, requires_grad=True)


def _close_chain(tree, token):
    """Tie the hop chain into every floating leaf of the output, so that
    its backward runs whichever of them the loss differentiates (the KD
    carry's teacher half reaches it under no_grad)."""
    if token is None:
        return tree
    return _tmap(lambda x: x + (token * 0).to(x.dtype)
                 if torch.is_tensor(x) and x.is_floating_point() else x, tree)


def _broadcast_last(group, out, template):
    """The last stage's output tree on every process: as it is on a
    LocalGroup (which holds the last stage), else the sum over the group of
    the last stage's values and the others' zeros (`out` None),
    differentiable."""
    if isinstance(group, LocalGroup):
        return out
    part = out if out is not None else _zeros_like_tree(template)
    return _unflatten(template, [reduce_from_group(group, [x]) for x in _leaves(part)])


def _cat_micro(outs: Sequence[Any]):
    return _tmap(lambda *xs: torch.cat(xs, 0), *outs)


def _over_dp(mesh, dp_axis: Optional[str], trees: Sequence[Any], run):
    """`run(*trees)` on each held dp replica's rows of `trees` (whole
    without `dp_axis`): the list of its results, and the dp group (None)."""
    if dp_axis is None:
        return [run(*trees)], None
    dp = mesh.group(dp_axis)
    n = _leaves(trees[0])[0].shape[0]
    results = []
    for i in range(len(dp.positions)):
        rows = [_tmap(lambda x: scatter_to_group(dp, x, 0)[i] if _rows(x, n) else x, tree)
                for tree in trees]
        results.append(run(*rows))
    return results, dp


def _dp_join(dp, outs: Sequence[Any]):
    """The held replicas' row blocks joined into the global rows."""
    return _tmap(lambda *xs: gather_from_group(dp, list(xs), 0), *outs)


def _dp_mean(dp, values: Sequence[torch.Tensor]) -> torch.Tensor:
    return reduce_from_group(dp, list(values)) / dp.size


# ---------------------------------------------------------------------------
# GPipe


def _gpipe(layer_apply, stages, h, bundle, group, M: int):
    S = group.size
    n = _leaves(h)[0].shape[0]
    h_m, b_m = _micro(h, n, M), _micro(bundle, n, M)
    num_layers = len(stages[0]) * S
    template = h_m[0]
    token = _token(group, _leaves(h)[0])
    state = [None] * len(group.positions)
    aux = [None] * len(group.positions)
    outs = [[None] * M for _ in group.positions]
    for t in range(M + S - 1):
        ys = []
        for i, s in enumerate(group.positions):
            m = t - s
            y = None
            if 0 <= m < M:
                x = h_m[m] if s == 0 else state[i]
                y, a = _run_local(layer_apply, stages[i], x, b_m[m])
                aux[i] = _tadd(aux[i], a)
                if s == S - 1:
                    outs[i][m] = y
            ys.append(y)
        if t < M + S - 2:
            state, token = _hop(group, ys, template, token)
    i_last = group.positions.index(S - 1) if S - 1 in group.positions else None
    got = [_broadcast_last(group, None if i_last is None else outs[i_last][m], template)
           for m in range(M)]
    out = _close_chain(_cat_micro(got), token)
    ref = _leaves(h)[0]
    aux = [a if a is not None else torch.zeros((), device=ref.device) for a in aux]
    return out, reduce_from_group(group, aux) / float(num_layers * M)


def pipeline_layers(layer_apply: Callable, stages, h, bundle, *, mesh, num_microbatches: int,
                    axis: str = "pp", dp_axis: Optional[str] = None):
    """GPipe forward through the held stages' layers.

    layer_apply(layer, h_mb, bundle_mb) -> (h_mb', aux); `stages` one list
    of layers per held position of the pp group (`shard_params_pp`). h: an
    (N, T, D) tensor, or a tree of tensors sharing the leading batch dim N
    (the KD pair), N divisible by num_microbatches; the bundle's leaves with
    a leading dim N are cut into microbatches with h, every other leaf is
    handed whole. aux: a float32 scalar or any fixed-shape float32 tensor.

    Returns (h_out, aux_mean): aux averaged over the layers and the
    microbatches, as the loop path's mean over per-layer aux."""
    group = _group(mesh, axis)
    results, dp = _over_dp(mesh, dp_axis, (h, bundle),
                           lambda h_, b_: _gpipe(layer_apply, stages, h_, b_, group,
                                                 num_microbatches))
    if dp is None:
        return results[0]
    return (_dp_join(dp, [r[0] for r in results]), _dp_mean(dp, [r[1] for r in results]))


# ---------------------------------------------------------------------------
# interleaved


def _interleaved(layer_apply, stages, h, bundle, group, M: int, V: int):
    S = group.size
    n = h.shape[0]
    h_m, b_m = _micro(h, n, M), _micro(bundle, n, M)
    per_chunk = len(stages[0]) // V
    num_layers = len(stages[0]) * S
    token = _token(group, h)
    pend = [[None] * M for _ in group.positions]
    aux = [None] * len(group.positions)
    outs = [None] * M
    total = V * M + S - 1
    for t in range(total):
        ys = []
        for i, s in enumerate(group.positions):
            rel = t - s
            m, d = max(rel, 0) % M, max(rel, 0) // M
            y = None
            if rel >= 0 and d < V:
                x = h_m[m] if (s == 0 and d == 0) else pend[i][m]
                chunk = stages[i][d * per_chunk:(d + 1) * per_chunk]
                y, a = _run_local(layer_apply, chunk, x, b_m[m])
                aux[i] = _tadd(aux[i], a)
                if s == S - 1 and d == V - 1:
                    outs[m] = y
            ys.append(y)
        if t == total - 1:
            break
        recv, token = _hop(group, ys, h_m[0], token)
        for i, s in enumerate(group.positions):
            # the slot is the sender's microbatch: read next tick, or after
            # the wrap from the last stage back to stage 0
            if recv[i] is not None:
                pend[i][max(t - (s - 1) % S, 0) % M] = recv[i]
    got = [_broadcast_last(group, outs[m], h_m[0]) for m in range(M)]
    out = _close_chain(torch.cat(got, 0), token)
    aux = [a if a is not None else torch.zeros((), device=h.device) for a in aux]
    return out, reduce_from_group(group, aux) / float(num_layers * M)


def pipeline_layers_interleaved(layer_apply: Callable, stages, h: torch.Tensor, bundle, *, mesh,
                                num_microbatches: int, num_chunks: int, axis: str = "pp",
                                dp_axis: Optional[str] = None):
    """The interleaved ("looped") pipeline: stage s holds V = num_chunks
    chunks of layers, global chunks s, s + S, ..., s + (V − 1)·S (`stages`
    from `interleaved_stages`). At tick t stage s runs microbatch (t − s)
    mod M of its chunk (t − s) div M; chunk boundaries ride the same
    one-hop ring as GPipe, the wrap from stage S − 1 back to stage 0 held
    in a pending ring of M slots. Needs M >= S and L divisible by S·V. Same
    contract as `pipeline_layers` (h one tensor)."""
    group = _group(mesh, axis)
    S, M, V = group.size, num_microbatches, num_chunks
    if M < S:
        raise ValueError(f"the interleaved schedule needs M >= S (got M={M}, S={S})")
    if len(stages[0]) % V:
        raise ValueError(f"a stage's {len(stages[0])} layers do not split into {V} chunks")
    results, dp = _over_dp(mesh, dp_axis, (h, bundle),
                           lambda h_, b_: _interleaved(layer_apply, stages, h_, b_, group, M, V))
    if dp is None:
        return results[0]
    return (_dp_join(dp, [r[0] for r in results]), _dp_mean(dp, [r[1] for r in results]))


def interleaved_stages(layers: Sequence[Any], mesh, num_chunks: int, axis: str = "pp") -> list:
    """Each held stage's V chunks of layers, concatenated in its order:
    stage s holds global chunks s, s + S, ..., of L / (S·V) layers each."""
    group = _group(mesh, axis)
    S, V = group.size, num_chunks
    layers = list(layers)
    if len(layers) % (S * V):
        raise ValueError(f"{len(layers)} layers do not split into {S}x{V} chunks")
    lc = len(layers) // (S * V)
    return [[x for d in range(V) for x in layers[(d * S + s) * lc:(d * S + s + 1) * lc]]
            for s in group.positions]


# ---------------------------------------------------------------------------
# 1F1B


def sim_1f1b_schedule(S: int, M: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side greedy simulation of the synchronous 1F1B (PipeDream-flush)
    schedule: one op (F or B) per stage per tick, backward preferred when
    ready, forwards capped by the per-stage in-flight window S - s. Returns
    int32 tables (T, S): f_m[t, s] / b_m[t, s] = microbatch id, -1 = idle.

    The window cap is what distinguishes 1F1B from GPipe: a stage never
    holds more than S - s microbatches between forward and backward, so
    the activation stash is O(S), not O(M)."""
    done_f = np.full((S, M), -1)  # tick at which F(s, m) completed
    done_b = np.full((S, M), -1)
    next_f = [0] * S
    next_b = [0] * S
    f_tab, b_tab = [], []
    t = 0
    while any(nb < M for nb in next_b):
        assert t < 4 * (M + S) + 8, "1F1B schedule simulation did not drain"
        f_row, b_row = [-1] * S, [-1] * S
        for s in range(S):
            m_b = next_b[s]
            b_ready = m_b < M and (
                done_f[s][m_b] >= 0 and done_f[s][m_b] < t
                if s == S - 1
                else done_b[s + 1][m_b] >= 0 and done_b[s + 1][m_b] < t
            )
            m_f = next_f[s]
            f_ready = (
                m_f < M
                and (s == 0 or (done_f[s - 1][m_f] >= 0 and done_f[s - 1][m_f] < t))
                and (next_f[s] - next_b[s]) < (S - s)
            )
            if b_ready:
                b_row[s] = m_b
                done_b[s][m_b] = t
                next_b[s] += 1
            elif f_ready:
                f_row[s] = m_f
                done_f[s][m_f] = t
                next_f[s] += 1
        f_tab.append(f_row)
        b_tab.append(b_row)
        t += 1
    return np.asarray(f_tab, np.int32), np.asarray(b_tab, np.int32)


def _stage_params(layers) -> List[Tuple[str, torch.Tensor]]:
    """A stage's trainable parameters, named "<layer index>.<name>"."""
    return [(f"{j}.{n}", p) for j, item in enumerate(layers)
            for n, p in item.named_parameters() if p.requires_grad]


def _psum(group, parts: Sequence[Optional[torch.Tensor]], like: torch.Tensor) -> torch.Tensor:
    """The sum over every position (None: zeros like `like`); no graph."""
    parts = [p if p is not None else torch.zeros_like(like) for p in parts]
    return group.all_reduce_sum(parts)


def _1f1b(layer_apply, head_loss, stages, head_params, h, bundle, head_args, group, M: int,
          head_has_aux: bool):
    S = group.size
    n = _leaves(h)[0].shape[0]
    h_m, b_m, ha_m = _micro(h, n, M), _micro(bundle, n, M), _micro(head_args, n, M)
    num_layers = len(stages[0]) * S
    f_tab, b_tab = sim_1f1b_schedule(S, M)
    template = h_m[0]
    held = group.positions
    params = [_stage_params(stage) for stage in stages]
    head_names = list(head_params)
    d_stage = [{name: None for name, _ in ps} for ps in params]
    d_head = {name: None for name in head_names}
    d_h = [None] * M
    loss_t, aux_t, haux_t = [None] * len(held), [None] * len(held), [None] * len(held)
    stash = [dict() for _ in held]  # microbatch -> stage input (received or injected)
    cot = [dict() for _ in held]  # microbatch -> cotangent of the stage's output

    for t in range(f_tab.shape[0]):
        y_msgs, dx_msgs = [], []
        for i, s in enumerate(held):
            fm, bm = int(f_tab[t, s]), int(b_tab[t, s])
            y_msg = dx_msg = None
            if fm >= 0:
                x = h_m[fm] if s == 0 else stash[i][fm]
                with torch.no_grad():
                    y_msg, a = _run_local(layer_apply, stages[i], x, b_m[fm])
                aux_t[i] = _tadd(aux_t[i], a)
                stash[i][fm] = x
            if bm >= 0:
                x = _tmap(lambda v: v.detach().requires_grad_(v.is_floating_point())
                          if torch.is_tensor(v) else v, stash[i].pop(bm))
                x_leaves = [v for v in _leaves(x) if torch.is_tensor(v) and v.requires_grad]
                with torch.enable_grad():
                    y, _ = _run_local(layer_apply, stages[i], x, b_m[bm])
                    wrt = [p for _, p in params[i]] + x_leaves
                    if s == S - 1:
                        out = head_loss(y, ha_m[bm])
                        loss_m, h_aux = out if head_has_aux else (out, None)
                        wrt = wrt + [head_params[k] for k in head_names]
                        outputs, seeds = [loss_m], [torch.ones_like(loss_m)]
                        loss_t[i] = _tadd(loss_t[i], loss_m.detach())
                        if h_aux is not None:
                            haux_t[i] = _tadd(haux_t[i], h_aux.detach().float())
                    else:
                        g_y = cot[i].pop(bm)
                        pairs = [(yv, gv) for yv, gv in zip(_leaves(y), _leaves(g_y))
                                 if torch.is_tensor(yv) and yv.requires_grad]
                        outputs, seeds = [p[0] for p in pairs], [p[1] for p in pairs]
                    grads = torch.autograd.grad(outputs, wrt, seeds, allow_unused=True)
                np_ = len(params[i])
                for (name, _), g in zip(params[i], grads[:np_]):
                    if g is not None:
                        d_stage[i][name] = _tadd(d_stage[i][name], g)
                g_x = list(grads[np_:np_ + len(x_leaves)])
                if s == S - 1:
                    for name, g in zip(head_names, grads[np_ + len(x_leaves):]):
                        if g is not None:
                            d_head[name] = _tadd(d_head[name], g)
                # the input's cotangent, zeros where an input is not differentiable
                g_iter = iter(g_x)

                def cotangent(v):
                    if not torch.is_tensor(v):
                        return v
                    g = next(g_iter) if v.requires_grad else None
                    return g if g is not None else torch.zeros_like(v)

                dx_msg = _tmap(cotangent, x)
                if s == 0:
                    d_h[bm] = dx_msg
            y_msgs.append(y_msg)
            dx_msgs.append(dx_msg)
        # the exchanges: forward activations to the next stage, cotangents
        # to the previous one (every process takes part at every tick)
        if not isinstance(group, LocalGroup):
            y_msgs = [tuple(_leaves(y if y is not None else _zeros_like_tree(template)))
                      for y in y_msgs]
            dx_msgs = [tuple(_leaves(d if d is not None else _zeros_like_tree(template)))
                       for d in dx_msgs]
        f_recv = group.ppermute_next(y_msgs)
        b_recv = group.ppermute_prev(dx_msgs)
        for i, s in enumerate(held):
            if s > 0 and f_tab[t, s - 1] >= 0:
                v = f_recv[i]
                stash[i][int(f_tab[t, s - 1])] = (v if isinstance(group, LocalGroup)
                                                  else _unflatten(template, v))
            if s < S - 1 and b_tab[t, s + 1] >= 0:
                v = b_recv[i]
                cot[i][int(b_tab[t, s + 1])] = (v if isinstance(group, LocalGroup)
                                                else _unflatten(template, v))

    zero = torch.zeros((), dtype=torch.float32, device=_leaves(h)[0].device)
    loss = _psum(group, loss_t, zero) / M
    aux = _psum(group, aux_t, _first(aux_t, zero)) / float(num_layers * M)
    haux = None
    if head_has_aux:
        # the head's aux lives on the last stage: every process learns its size
        size = _psum(group, [zero + a.numel() if a is not None else None for a in haux_t],
                     zero)
        haux = _psum(group, haux_t, torch.zeros(int(size), device=zero.device)) / M
    d_head = {k: _psum(group, [v if s == S - 1 else None for s in held], head_params[k])
              for k, v in d_head.items()}
    like = _zeros_like_tree(h_m[0])
    d_h = _cat_micro([g if g is not None else like for g in d_h])
    if not isinstance(group, LocalGroup):
        # stage 0's, on every process
        d_h = _tmap(lambda g: group.all_reduce_sum([g]) if torch.is_tensor(g) else g, d_h)
    return loss, aux, haux, d_stage, d_head, d_h


def _first(values, default):
    return next((v for v in values if v is not None), default)


def pipeline_1f1b_value_and_grad(layer_apply: Callable, head_loss: Callable, stages,
                                 head_params: Mapping[str, torch.Tensor], h, bundle, head_args,
                                 *, mesh, num_microbatches: int, axis: str = "pp",
                                 dp_axis: Optional[str] = None, head_has_aux: bool = False):
    """True 1F1B: one combined forward and backward pass over the
    PipeDream-flush schedule, an explicit gradient (`torch.autograd.grad` at
    each backward tick, the stage recomputed from its stashed input) rather
    than autograd over a forward schedule.

    layer_apply as in `pipeline_layers`; head_loss(h_out_mb, head_args_mb)
    -> the microbatch's scalar loss (or (loss, float32 aux vector) with
    `head_has_aux`), differentiable in `head_params` (name -> tensor); it
    runs on the last stage at each backward tick and seeds the cotangent.
    head_args' leaves with a leading batch dim are cut into microbatches
    like the bundle. h may be a tree (the KD carry); per-layer losses that
    must be differentiated ride in it, since only head_loss seeds
    cotangents (the aux channel reports).

    Returns (loss_mean, aux_mean, (d_stages, d_head, d_h)): loss_mean the
    mean over microbatches of head_loss (aux_mean (layer aux, head aux)
    with `head_has_aux`); the gradients of the sum of the microbatches'
    losses over M (`jax.grad` of the equivalent GPipe loss): d_stages one
    dict per held stage, "<layer index in the stage>.<parameter name>" ->
    gradient (None where a parameter got none), d_head name -> gradient,
    d_h the pipeline input's (h's structure), for the caller's embedding
    backward."""
    group = _group(mesh, axis)
    M = num_microbatches
    results, dp = _over_dp(mesh, dp_axis, (h, bundle, head_args),
                           lambda h_, b_, a_: _1f1b(layer_apply, head_loss, stages, head_params,
                                                    h_, b_, a_, group, M, head_has_aux))
    with torch.no_grad():
        if dp is None:
            loss, aux, haux, d_stage, d_head, d_h = results[0]
        else:
            # every replica's values at the same parameters, averaged (its
            # rows' d_h scaled by the share of the loss)
            loss = _dp_mean(dp, [r[0] for r in results])
            aux = _dp_mean(dp, [r[1] for r in results])
            haux = _dp_mean(dp, [r[2] for r in results]) if head_has_aux else None
            d_stage = [{k: _dp_mean(dp, [r[3][i][k] for r in results])
                        if results[0][3][i][k] is not None else None for k in results[0][3][i]}
                       for i in range(len(results[0][3]))]
            d_head = {k: _dp_mean(dp, [r[4][k] for r in results]) for k in results[0][4]}
            d_h = _tmap(lambda *xs: gather_from_group(dp, list(xs), 0) / dp.size
                        if torch.is_tensor(xs[0]) else xs[0], *(r[5] for r in results))
        scale = 1.0 / M
        d_stage = [{k: (g * scale if g is not None else None) for k, g in d.items()}
                   for d in d_stage]
        d_head = {k: g * scale for k, g in d_head.items()}
        d_h = _tmap(lambda g: g * scale if torch.is_tensor(g) else g, d_h)
    out_aux = (aux, haux) if head_has_aux else aux
    return loss, out_aux, (d_stage, d_head, d_h)


# ---------------------------------------------------------------------------
# causal LMs through the pipeline


def _layer_list(model, layers):
    layers = list(layers if layers is not None else model.model.layers)
    if not layers:
        raise ValueError("no layers: an external_layers shell needs its stack as `layers`")
    return layers


def _aux_or_zero(aux, h):
    return aux if aux is not None else torch.zeros((), dtype=torch.float32, device=h.device)


def pp_causal_lm_forward(model, input_ids: torch.Tensor, attention_mask_1d: torch.Tensor, *,
                         mesh, num_microbatches: int, benchmarking: bool = False,
                         axis: str = "pp", dp_axis: Optional[str] = None,
                         use_remat: bool = False, interleave: int = 1,
                         layers: Optional[Sequence[nn.Module]] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pipeline-parallel forward of an OPT or LLaMA causal LM: embed,
    finalize and the logits replicated (the model's, or an
    `external_layers` shell's), the layer stack (`layers`, the model's own
    by default: all L of them, in order) streamed through the pp stages.
    Returns (logits, aux_mean).

    use_remat: each layer under a non-reentrant `torch.utils.checkpoint`
    while grad is enabled (the scan_remat counterpart: the backward keeps a
    layer's input and recomputes the rest). interleave > 1 runs the
    interleaved schedule with that many chunks a stage (needs
    num_microbatches >= the pp size)."""
    layers = _layer_list(model, layers)
    h, bundle = model.model.embed(input_ids, attention_mask_1d)

    def run(layer, h_mb, bundle_mb):
        out, aux, _ = layer(h_mb, bundle_mb, benchmarking=benchmarking)
        return out, _aux_or_zero(aux, out)

    def layer_apply(layer, h_mb, bundle_mb):
        if use_remat and torch.is_grad_enabled():
            return checkpoint(run, layer, h_mb, bundle_mb, use_reentrant=False)
        return run(layer, h_mb, bundle_mb)

    if interleave > 1:
        stages = interleaved_stages(layers, mesh, interleave, axis)
        h, aux = pipeline_layers_interleaved(
            layer_apply, stages, h, bundle, mesh=mesh, num_microbatches=num_microbatches,
            num_chunks=interleave, axis=axis, dp_axis=dp_axis)
    else:
        stages = shard_params_pp(layers, mesh, axis)
        h, aux = pipeline_layers(layer_apply, stages, h, bundle, mesh=mesh,
                                 num_microbatches=num_microbatches, axis=axis, dp_axis=dp_axis)
    return model.logits(model.model.finalize(h)), aux


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a.float() - b.float()) ** 2)


def _kd_pairs(teacher, student) -> List[nn.ModuleDict]:
    """The (teacher, student) layer pairs the KD carry streams through."""
    t_layers, s_layers = teacher.model.layers, student.model.layers
    if len(t_layers) != len(s_layers):
        raise ValueError("teacher and student must have the same depth")
    return [nn.ModuleDict({"t": t, "s": s}) for t, s in zip(t_layers, s_layers)]


def _check_kd(teacher, student):
    if teacher.cfg.attention_method != "none":
        raise ValueError("the teacher must be dense (attention_method='none')")
    if type(teacher) is not type(student):
        raise ValueError("teacher and student must be of one model family")


def pp_kd_loss(teacher, student, input_ids: torch.Tensor, attention_mask_1d: torch.Tensor,
               labels: torch.Tensor, *, mesh, num_microbatches: int, axis: str = "pp",
               dp_axis: Optional[str] = None, task_scale: float = 0.1, ignore_kd: bool = False,
               use_remat: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Knowledge distillation through the pipeline (GPipe): the (teacher,
    student) layer pair streams through the pp stages as one carry, so each
    layer's (N, H, T, T) teacher capture stays on its stage; only the two
    hidden states cross a hop.

    Exactly `SeaOptKDScan.kd_loss`'s math: task_scale · task CE + 5 · the
    mean hidden MSE over the L + 1 hidden states + 0.2 · logit KL + the mean
    attention-distill aux; the teacher under no_grad (no gradients), no
    jitter; with `use_remat` each pair under a checkpoint. Returns (loss,
    details) with `SeaOptKD.kd_loss`'s keys; loss.backward() fills the
    student's gradients."""
    from ..training.distill import SeaOptKD

    _check_kd(teacher, student)
    pairs = _kd_pairs(teacher, student)
    L = len(pairs)
    with torch.no_grad():
        h_t, bundle = teacher.model.embed(input_ids, attention_mask_1d)
    h_s, _ = student.model.embed(input_ids, attention_mask_1d)
    mse0 = _mse(h_t, h_s)

    def pair(item, carry, bundle_mb):
        ht, hs = carry
        with torch.no_grad():
            ht2, _, cap = item["t"](ht, bundle_mb)
        hs2, aux, _ = item["s"](hs, bundle_mb, cap, training=True)
        return (ht2, hs2), torch.stack([_aux_or_zero(aux, hs2).float(), _mse(ht2, hs2)])

    def layer_apply(item, carry, bundle_mb):
        if use_remat and torch.is_grad_enabled():
            return checkpoint(pair, item, carry, bundle_mb, use_reentrant=False)
        return pair(item, carry, bundle_mb)

    (h_t, h_s), aux_mean = pipeline_layers(
        layer_apply, shard_params_pp(pairs, mesh, axis), (h_t, h_s), bundle, mesh=mesh,
        num_microbatches=num_microbatches, axis=axis, dp_axis=dp_axis)
    # aux_mean[c] = (1/(L·M))·ΣΣ: with equal microbatches the per-layer
    # full-batch means are the microbatch means, so Σ_layers mse = L·mean
    loss_special = aux_mean[0]
    loss_hidden = (mse0 + aux_mean[1] * L) / (L + 1) * 5.0
    task_loss, loss_logit_kl = SeaOptKD(teacher, student)._logit_losses(h_t, h_s, labels)
    if ignore_kd:
        loss = task_loss
    else:
        loss = task_scale * task_loss + loss_hidden + loss_logit_kl + loss_special
    return loss, {
        "loss": loss,
        "loss_model": task_scale * task_loss,
        "loss_kd_hidden": loss_hidden,
        "loss_kd_logit": loss_logit_kl,
        "loss_sp": loss_special,
        "student_task_loss": task_loss,
    }


def pp_kd_1f1b_value_and_grad(teacher, student, input_ids: torch.Tensor,
                              attention_mask_1d: torch.Tensor, labels: torch.Tensor, *, mesh,
                              num_microbatches: int, axis: str = "pp",
                              dp_axis: Optional[str] = None, task_scale: float = 0.1):
    """The KD pair on the 1F1B schedule: `pp_kd_loss`'s math, with the
    per-layer differentiable losses (hidden MSE and the attention-distill
    aux) riding in the carry as a per-row accumulator, the only way they
    reach the explicit schedule, whose cotangents the last stage's head
    alone seeds. Activation stash O(S) in place of GPipe's O(M).

    Returns (loss, details, d_student): d_student the student's gradient
    by parameter name (its `named_parameters()`'s, the layers'
    `model.layers.<i>.…`), the embedding's and head's merged in; the teacher
    gets none. (No `use_remat`: the backward ticks recompute every stage
    from its input anyway.)"""
    from ..training.distill import SeaOptKD

    _check_kd(teacher, student)
    pairs = _kd_pairs(teacher, student)
    L = len(pairs)
    kd = SeaOptKD(teacher, student)
    with torch.no_grad():
        h_t, bundle = teacher.model.embed(input_ids, attention_mask_1d)
    head_params = {n: p for n, p in student.named_parameters()
                   if p.requires_grad and not n.startswith("model.layers.")}
    with torch.enable_grad():
        h_s, _ = student.model.embed(input_ids, attention_mask_1d)
        mse0 = _mse(h_t, h_s)
    mse0_w = 5.0 / (L + 1)

    def layer_apply(item, carry, bundle_mb):
        ht, hs, acc = carry
        with torch.no_grad():
            ht2, _, cap = item["t"](ht, bundle_mb)
        hs2, aux, _ = item["s"](hs, bundle_mb, cap, training=True)
        mse = _mse(ht2, hs2)
        aux = _aux_or_zero(aux, hs2).float()
        acc = acc + aux / L + mse * mse0_w
        return (ht2, hs2, acc), torch.stack([aux.detach(), mse.detach()])

    def head_loss(y, ha):
        ht, hs, acc = y
        task, kl = kd._logit_losses(ht, hs, ha["labels"])
        loss = task_scale * task + kl + torch.mean(acc)
        return loss, torch.stack([task.detach(), kl.detach()])

    acc0 = torch.zeros((h_s.shape[0],), dtype=torch.float32, device=h_s.device)
    loss_pipe, (layer_aux, head_aux), (d_stages, d_head, d_h) = pipeline_1f1b_value_and_grad(
        layer_apply, head_loss, shard_params_pp(pairs, mesh, axis), head_params,
        (h_t, h_s.detach(), acc0), bundle, {"labels": labels}, mesh=mesh,
        num_microbatches=num_microbatches, axis=axis, dp_axis=dp_axis, head_has_aux=True)
    loss = loss_pipe + mse0_w * mse0.detach()

    # the embedding's backward: the pipeline input's cotangent and the
    # embedding's own MSE term
    names = list(head_params)
    g_embed = torch.autograd.grad(
        [h_s, mse0], [head_params[n] for n in names],
        [d_h[1], torch.full_like(mse0, mse0_w)], allow_unused=True)
    d_student = {}
    for n, g in zip(names, g_embed):
        g = g if g is not None else torch.zeros_like(head_params[n])
        d_student[n] = g + d_head[n]
    group = _group(mesh, axis)
    per = L // group.size
    for stage, grads in zip(group.positions, d_stages):
        for key, g in grads.items():
            j, rest = key.split(".", 1)
            if rest.startswith("s.") and g is not None:
                d_student[f"model.layers.{stage * per + int(j)}.{rest[2:]}"] = g
    loss_sp = layer_aux[0]
    loss_hidden = (mse0.detach() + layer_aux[1] * L) * mse0_w
    details = {
        "loss": loss,
        "loss_model": task_scale * head_aux[0],
        "loss_kd_hidden": loss_hidden,
        "loss_kd_logit": head_aux[1],
        "loss_sp": loss_sp,
        "student_task_loss": head_aux[0],
    }
    return loss, details, d_student
