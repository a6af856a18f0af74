"""Sequence- and head-sharded SEA sparse attention, and the K/V ring.

The port of `sea_tpu/parallel/sharded_attention.py` over a shard group
(`parallel/group.py`) in place of `shard_map` over a mesh axis. Inputs and
outputs are the global (N, H, T, ...) tensors, as in JAX; every function is
one loop over the positions this process holds, so it runs the same on a
`LocalGroup` (every shard in one process) and a `DistGroup` (one shard per
process).

Every stage of the SEA sparse pipeline is query-row independent, so the
query rows shard cleanly. SEA's estimated mask is global (the top-k can
pick any source position), so K/V have no bounded halo:

  * 'seq' (`sharded_sea_attention`, `sharded_fused_train_attention`): each
    shard keeps the full K/V and runs K1 (forward) or K2-K4 (training) on
    its rows with `row_base`, the global base row of each q-block; dk/dv are
    summed over the shards (`all_reduce_sum`);
  * 'head' (`head_sharded_sea_attention`, `head_sharded_fused_train`):
    heads shard with no communication at all;
  * 'ring' (`ring_sea_attention`, `ring_fused_train_attention`): K/V stay
    sequence-sharded and rotate around the group. Each step a shard runs
    the windowed kernel K6 on the K/V chunk it holds; the windows' partial
    outputs merge by logaddexp of their logsumexps. The backward rotates
    (k, v, dk, dv) together: K7 adds each window's dq, K8 each window's
    dk/dv to the chunk's accumulators, which end on their owner.

Every path here is causal, as only causal inputs are sharded. The work of
a row grows with its index, so `zigzag` deals whole row blocks round-robin
to the shards (`_zigzag_perm`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.kernels import block_sparse as bs
from ..utils.profiler import region


def _zigzag_perm(t: int, n_shards: int, block: int, device=None) -> torch.Tensor:
    """Permutation assigning row-blocks round-robin to shards: shard s gets
    blocks s, s+n, s+2n, ... (concatenated order)."""
    nb = t // block
    order = [b for s in range(n_shards) for b in range(s, nb, n_shards)]
    idx = torch.tensor(order, dtype=torch.int64, device=device)
    return (idx[:, None] * block + torch.arange(block, device=device)[None, :]).reshape(-1)


def _row_order(t: int, n_shards: int, block: int, zigzag: bool, device):
    """(perm, inv, rows): the zigzag permutation of the rows and its
    inverse (None without zigzag or with one shard), and the global row id
    (int32) of each row in that order."""
    if zigzag and n_shards > 1:
        perm = _zigzag_perm(t, n_shards, block, device)
        return perm, torch.argsort(perm), perm.to(torch.int32)
    return None, None, torch.arange(t, dtype=torch.int32, device=device)


def _permuted(perm, *xs):
    """Each of xs with its rows (dim 2) in the order `perm` (if any)."""
    return [x if perm is None else x[:, :, perm] for x in xs]


def _ones_scaler(q, row_scaler):
    return row_scaler if row_scaler is not None else torch.ones(
        q.shape[:3], dtype=q.dtype, device=q.device)


# ---------------------------------------------------------------------------
# Head-sharded
# ---------------------------------------------------------------------------


def head_sharded_sea_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask_m: torch.Tensor,
    row_scaler: Optional[torch.Tensor],
    group,
    *,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    oversample: float = 1.0,
    k_cfg: float = 64.0,
) -> torch.Tensor:
    """Head-partitioned causal forward: every SEA stage is head-independent
    except the shared per-row budget, which is already baked into `mask_m`,
    so heads shard with no communication (K/V shard by head too)."""
    H = q.shape[1]
    if H % group.size:
        raise ValueError(f"{H} heads do not split over {group.size} shards")
    parts = [
        bs.sea_block_sparse_attention(
            q_l, k_l, v_l, m_l, s_l, block_q=block_q, block_k=block_k, oversample=oversample, k_cfg=k_cfg,
        )
        for q_l, k_l, v_l, m_l, s_l in zip(*(
            group.split_rows(x, 1) for x in (q, k, v, mask_m, _ones_scaler(q, row_scaler))
        ))
    ]
    return group.join_rows(parts, 1)


class _HeadShardedFusedTrain(torch.autograd.Function):
    """K2 forward and K3/K4 backward on each shard's heads; every cotangent
    is head-local, so the backward joins like the forward."""

    @staticmethod
    def forward(ctx, q, k, v, mask_m, scaler, group, block_q, block_k):
        T = q.shape[2]
        row_base = torch.arange(T // block_q, dtype=torch.int32, device=q.device) * block_q
        outs, ctx.parts = [], []
        for q_l, k_l, v_l, m_l, s_l in zip(*(
            group.split_rows(x, 1) for x in (q, k, v, mask_m, scaler)
        )):
            o, meta, saved = bs.fused_forward(
                q_l, k_l, v_l, m_l, s_l, row_base, None, block_q, block_k)
            outs.append(o)
            ctx.parts.append((meta, saved))
        ctx.group = group
        return group.join_rows(outs, 1)

    @staticmethod
    def backward(ctx, do):
        grads = [
            bs.fused_backward(meta, saved, d)
            for (meta, saved), d in zip(ctx.parts, ctx.group.split_rows(do, 1))
        ]
        dq, dk, dv, dscaler = (ctx.group.join_rows(g, 1) for g in zip(*grads))
        return dq, dk, dv, None, dscaler, None, None, None


def head_sharded_fused_train(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask_m: torch.Tensor,
    row_scaler: torch.Tensor,
    group,
    *,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """Head-partitioned differentiable fused attention: like
    `head_sharded_sea_attention` but through the differentiable kernels, so
    gradients flow, with no communication in forward or backward."""
    if q.shape[1] % group.size:
        raise ValueError(f"{q.shape[1]} heads do not split over {group.size} shards")
    return _HeadShardedFusedTrain.apply(q, k, v, mask_m, row_scaler, group, block_q, block_k)


# ---------------------------------------------------------------------------
# Sequence-sharded, K/V replicated
# ---------------------------------------------------------------------------


def sharded_sea_attention(
    q: torch.Tensor,  # (N, H, T, D) pre-scaled
    k: torch.Tensor,
    v: torch.Tensor,
    mask_m: torch.Tensor,  # (N, H, T, T_M)
    row_scaler: Optional[torch.Tensor],  # (N, H, T) or None
    group,
    *,
    zigzag: bool = True,
    use_kernel: bool = True,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    oversample: float = 1.0,
    k_cfg: float = 64.0,
) -> torch.Tensor:
    """Causal attention with the query rows sharded over the group (zigzag
    row blocks), K/V whole on every shard, and K1 on each shard's rows with
    `row_base`, so that the causal widths and the pixel math use global
    rows. `use_kernel=False` takes `_masked_rowwise_attention` instead."""
    T, S = q.shape[2], group.size
    bq = block_q or 128
    if T % S or (T // S) % bq:
        raise ValueError(f"T={T} must split into {S} shards of whole {bq}-row blocks")
    perm, inv, rows = _row_order(T, S, bq, zigzag, q.device)
    qp, maskp, scalerp = _permuted(perm, q, mask_m, _ones_scaler(q, row_scaler))
    parts = []
    for q_l, m_l, s_l, r_l in zip(
        group.split_rows(qp), group.split_rows(maskp), group.split_rows(scalerp),
        group.split_rows(rows, 0),
    ):
        if use_kernel:
            parts.append(bs.sea_block_sparse_attention(
                q_l, k, v, m_l, s_l, row_base=r_l[::bq], block_q=bq, block_k=block_k, oversample=oversample, k_cfg=k_cfg,
            ))
        else:
            parts.append(_masked_rowwise_attention(q_l, k, v, m_l, s_l, r_l))
    out = group.join_rows(parts)
    return out if inv is None else out[:, :, inv]


class _ShardedFusedTrain(torch.autograd.Function):
    """K2 on each shard's rows with `row_base` (inputs in the shards' row
    order, `rows` their global ids); backward K3/K4 per shard, dq and
    dscaler row-local, dk and dv per-shard partials over the whole source
    summed over the group (the psum of shard_map's replicated in_spec)."""

    @staticmethod
    def forward(ctx, q, k, v, mask_m, scaler, rows, group, block_q, block_k):
        outs, ctx.parts = [], []
        for q_l, m_l, s_l, r_l in zip(
            group.split_rows(q), group.split_rows(mask_m), group.split_rows(scaler),
            group.split_rows(rows, 0),
        ):
            o, meta, saved = bs.fused_forward(
                q_l, k, v, m_l, s_l, r_l[::block_q].contiguous(),
                (r_l + 1).to(torch.float32), block_q, block_k)
            outs.append(o)
            ctx.parts.append((meta, saved))
        ctx.group = group
        return group.join_rows(outs)

    @staticmethod
    def backward(ctx, do):
        g = ctx.group
        grads = [bs.fused_backward(meta, saved, d)
                 for (meta, saved), d in zip(ctx.parts, g.split_rows(do))]
        dq, dk, dv, dscaler = zip(*grads)
        return (g.join_rows(dq), g.all_reduce_sum(dk), g.all_reduce_sum(dv), None,
                g.join_rows(dscaler), None, None, None, None)


def sharded_fused_train_attention(
    q: torch.Tensor,  # (N, H, T, D) pre-scaled
    k: torch.Tensor,
    v: torch.Tensor,
    mask_m: torch.Tensor,  # (N, H, T, T_M)
    row_scaler: torch.Tensor,  # (N, H, T)
    group,
    *,
    zigzag: bool = True,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """Sequence-sharded differentiable fused attention: query rows
    zigzag-shard over the group, K/V are whole on every shard, and the
    differentiable kernels run with each shard's global `row_base`. dq and
    dscaler ride the row sharding; dk/dv are summed over the shards."""
    T, S = q.shape[2], group.size
    block_q = min(block_q, T // S)  # shard-local rows bound the tile
    if T % S or (T // S) % block_q:
        raise ValueError(f"T={T} must split into {S} shards of whole {block_q}-row blocks")
    perm, inv, rows = _row_order(T, S, block_q, zigzag, q.device)
    qp, maskp, scalerp = _permuted(perm, q, mask_m, row_scaler)
    out = _ShardedFusedTrain.apply(qp, k, v, maskp, scalerp, rows, group, block_q, block_k)
    return out if inv is None else out[:, :, inv]


# ---------------------------------------------------------------------------
# The ring: K/V sequence-sharded, rotating around the group
# ---------------------------------------------------------------------------


def _ring_blocks(t: int, n_shards: int, block_q: int, block_k: int):
    if t % n_shards:
        raise ValueError(f"T={t} does not split over {n_shards} shards")
    tl = t // n_shards
    block_q, block_k = min(block_q, tl), min(block_k, tl)
    if tl % block_q or tl % block_k:
        raise ValueError(f"shards of {tl} rows must be whole blocks ({block_q}, {block_k})")
    return block_q, block_k


def _ring_forward(q, k, v, mask_m, scaler, rows, group, block_q, block_k):
    """The ring's forward on inputs whose rows (q, mask_m, scaler; global
    ids `rows`) are in the shards' order and whose K/V are in the natural
    order: S steps, each a K6 launch per held shard on the K/V window it
    holds, then a hop. Returns (out (N, H, T, D), L (N, H, T) the rows'
    total logsumexp, −inf on rows with nothing alive, each shard's
    `WindowOperands`)."""
    T, S = q.shape[2], group.size
    with region("ring.prep"):
        ops = [
            bs.window_operands(q_l, m_l, r_l, T, S, block_q, block_k)
            for q_l, m_l, r_l in zip(group.split_rows(q), group.split_rows(mask_m),
                                     group.split_rows(rows, 0))
        ]
    with region("ring.steps"):
        out, L = _ring_steps(ops, k, v, scaler, group)
    return out.to(q.dtype), L, ops


def _ring_steps(ops, k, v, scaler, group):
    """The forward's S steps over the shards' `WindowOperands`."""
    S = group.size
    N, H, TL, D = ops[0].shape
    kv = list(zip(group.split_rows(k), group.split_rows(v)))
    L = [torch.full((N, H, TL), float("-inf"), device=k.device) for _ in ops]
    acc = [torch.zeros((N, H, TL, D), device=k.device) for _ in ops]
    for s in range(S):
        for j, me in enumerate(group.positions):
            o_s, lse_s = bs.fwd_stats_window(ops[j], (me - s) % S, *kv[j])
            # a window with nothing alive for a row (lse +inf) weighs 0; the
            # weights of a −inf logsumexp are 0 without evaluating exp(−inf + inf)
            lse_m = torch.where(torch.isposinf(lse_s), float("-inf"), lse_s)
            L_new = torch.logaddexp(L[j], lse_m)
            w_old = torch.where(torch.isneginf(L[j]), 0.0, torch.exp(L[j] - L_new))
            w_s = torch.where(torch.isneginf(lse_m), 0.0, torch.exp(lse_m - L_new))
            acc[j] = acc[j] * w_old[..., None] + o_s.float() * w_s[..., None]
            L[j] = L_new
        if s < S - 1:  # the last hop would bring K/V back to where they started
            kv = group.ppermute_next(kv)
    out = group.join_rows([
        a * s_l[..., None].float() for a, s_l in zip(acc, group.split_rows(scaler))
    ])
    return out, group.join_rows(L)


def ring_sea_attention(
    q: torch.Tensor,  # (N, H, T, D) pre-scaled
    k: torch.Tensor,
    v: torch.Tensor,
    mask_m: torch.Tensor,  # (N, H, T, T_M)
    row_scaler: Optional[torch.Tensor],
    group,
    *,
    zigzag: bool = True,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Memory-scalable sequence-sharded forward: K/V stay sharded over the
    group (per-shard K/V O(T/S)) and rotate around it; each shard's flash
    partials per window (window-normalised output and logsumexp from K6)
    merge by logaddexp, so the result is one full-width pass up to float
    reassociation. It is the differentiable ring's forward with the rows'
    total logsumexp discarded."""
    T = q.shape[2]
    block_q, block_k = _ring_blocks(T, group.size, block_q, block_k)
    perm, inv, rows = _row_order(T, group.size, block_q, zigzag, q.device)
    qp, maskp, scalerp = _permuted(perm, q, mask_m, _ones_scaler(q, row_scaler))
    out, _, _ = _ring_forward(qp, k, v, maskp, scalerp, rows, group, block_q, block_k)
    return out if inv is None else out[:, :, inv]


class RingFusedTrainAttention(torch.autograd.Function):
    """The differentiable ring (the JAX package's `ring_fused_train_attention`
    custom_vjp) on inputs whose rows are in the shards' order. Forward:
    `_ring_forward`, keeping the rows' total logsumexp. Backward:
    `backward_terms` on the merged output, dou rounded to the operands' type
    as in JAX; then (k, v, dk_acc, dv_acc) rotate together, each step adding
    the resident window's dk/dv partials from the shard's rows (K8) and its
    dq contribution (K7) to float32 accumulators, so that after S hops every
    dk/dv chunk is home. The gradients come back in the operands' type; the
    mask gets a zero gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask_m, scaler, rows, group, block_q, block_k):
        out, L, ctx.ops = _ring_forward(q, k, v, mask_m, scaler, rows, group,
                                        block_q, block_k)
        ctx.group = group
        ctx.mask_like = (mask_m.shape, mask_m.dtype)
        ctx.save_for_backward(k, v, scaler, out, L)
        return out

    @staticmethod
    def backward(ctx, do):
        k, v, scaler, out, L = ctx.saved_tensors
        g, S = ctx.group, ctx.group.size
        # dou in the operands' type (k's is q's), delta from the rounded dou
        dscaler, dou, delta = bs.backward_terms(do, out, scaler, k.dtype)
        # the merge gives −inf on rows with nothing alive; the kernels'
        # exp(s − lse) -> 0 convention needs +inf there
        L_b = torch.where(torch.isneginf(L), float("inf"), L)
        dou_l, L_l, delta_l = g.split_rows(dou), g.split_rows(L_b), g.split_rows(delta)
        N, H, T, D = k.shape

        def zeros():
            return torch.zeros((N, H, T // S, D), device=k.device)

        dq_acc = [zeros() for _ in g.positions]
        state = [(k_l, v_l, zeros(), zeros())
                 for k_l, v_l in zip(g.split_rows(k), g.split_rows(v))]
        for s in range(S):
            nxt = []
            for j, me in enumerate(g.positions):
                k_cur, v_cur, dk_acc, dv_acc = state[j]
                w = (me - s) % S
                dq_acc[j] = dq_acc[j] + bs.dq_window(
                    ctx.ops[j], w, k_cur, v_cur, dou_l[j], L_l[j], delta_l[j])
                dk_w, dv_w = bs.dkv_window(
                    ctx.ops[j], w, k_cur, v_cur, dou_l[j], L_l[j], delta_l[j])
                nxt.append((k_cur, v_cur, dk_acc + dk_w, dv_acc + dv_w)
                           if s < S - 1 else (dk_acc + dk_w, dv_acc + dv_w))
            # on the last hop only the gradients move: each chunk's dk/dv
            # then lands on the shard that owns the chunk
            state = g.ppermute_next(nxt)
        dq = g.join_rows(dq_acc).to(k.dtype)
        dk = g.join_rows([st[0] for st in state]).to(k.dtype)
        dv = g.join_rows([st[1] for st in state]).to(k.dtype)
        dmask = None
        if ctx.needs_input_grad[3]:
            shape, dtype = ctx.mask_like
            dmask = torch.zeros(shape, dtype=dtype, device=k.device)
        return dq, dk, dv, dmask, dscaler, None, None, None, None


def ring_fused_train_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask_m: torch.Tensor,
    row_scaler: torch.Tensor,
    group,
    zigzag: bool = True,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Differentiable ring attention: K/V and dk/dv stay sequence-sharded
    in forward and backward (per-shard K/V memory O(T/S)), the form of the
    sharded attention that long-context training takes past one device.
    Float32 or bfloat16 operands, as the kernels K6-K8 (head width 64)."""
    T = q.shape[2]
    block_q, block_k = _ring_blocks(T, group.size, block_q, block_k)
    perm, inv, rows = _row_order(T, group.size, block_q, zigzag, q.device)
    qp, maskp, scalerp = _permuted(perm, q, mask_m, row_scaler)
    out = RingFusedTrainAttention.apply(qp, k, v, maskp, scalerp, rows, group,
                                        block_q, block_k)
    return out if inv is None else out[:, :, inv]


# ---------------------------------------------------------------------------
# The plain per-shard path
# ---------------------------------------------------------------------------


def _masked_rowwise_attention(q_l, k_full, v_full, mask_l, scaler_l, rows_l):
    """Per-shard causal dense-resize masked attention with explicit global
    row ids (plain PyTorch; the rows of one shard are few)."""
    T_SRC = k_full.shape[2]
    w = (rows_l.to(torch.float32) + 1.0)[:, None]
    out, _, _ = bs._softmax_pv(q_l, k_full, v_full, bs._alive_dense(mask_l, T_SRC, w),
                               scaler_l)
    return out.to(q_l.dtype)
