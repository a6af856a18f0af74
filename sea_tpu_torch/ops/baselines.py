"""Baseline efficient-attention operators (PyTorch port of
`sea_tpu/ops/baselines.py`), the students and BERT methods other than SEA:

  * `SynthesizerDense` — learned dense attention from q alone:
    softmax(W2 relu(W1 q))[:, :T];
  * `reformer_lsh_attention` — shared-QK LSH attention: hash q by random
    rotations, sort by bucket, attend within each chunk and the previous
    one, average the hash rounds;
  * `scatterbrain_attention` — FAVOR+ low-rank attention with the exact
    kernel in place of the estimate inside LSH chunks;
  * `sinkhorn_block_attention` and `sinkhorn_causal_attention` — block
    attention against the own block and a Sinkhorn-matched (causal: a
    row-normalised, strictly earlier) block.

The cosformer is `ops/cosformer.py` and the performer `ops/performer.py`.
Plain PyTorch in float32, as the JAX functions are plain jnp: no kernel.

The random rotations are inputs here. JAX draws rotation i of a call from
`fold_in(key, i)` of the caller's key (its default `key(0)`; OPT's and
LLaMA's reformer students `key(7)` without a training rng); the port draws
them with `lsh_rotations` from a `torch.Generator`, by default one seeded
like JAX's key, and the parity tests pass JAX's draws in.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.modules import Dense
from .performer import softmax_kernel_features


class SynthesizerDense(nn.Module):
    """Dense synthesizer head: attn = softmax(W2 relu(W1 q))[:, :T]."""

    def __init__(self, head_dim: int, max_seq_len: int, d_hid: int = 64):
        super().__init__()
        self.w_1 = Dense(head_dim, d_hid)
        self.w_2 = Dense(d_hid, max_seq_len)

    def forward(self, q: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """q, v (N, H, T, D); mask broadcastable to (N, H, T, T), True where
        a key may be read. Returns (context, probs)."""
        T = q.shape[2]
        scores = self.w_2(torch.relu(self.w_1(q)))[..., :T]
        if mask is not None:
            scores = torch.where(mask, scores, torch.full((), -1e9, dtype=scores.dtype,
                                                          device=scores.device))
        probs = torch.softmax(scores.float(), -1).to(q.dtype)
        return torch.einsum("nhts,nhsd->nhtd", probs, v), probs


def lsh_buckets(T: int, bucket_size: int) -> Tuple[int, int]:
    """(bucket size clamped to T, even number of buckets) of a reformer
    call, as `reformer_lsh_attention` takes them."""
    while bucket_size > T:
        bucket_size //= 2
    bucket_size = max(bucket_size, 1)
    n_buckets = max(2, T // bucket_size)
    return bucket_size, n_buckets + n_buckets % 2


def lsh_rotations(head_dim: int, n_buckets: int, n_hashes: int,
                  generator: Optional[torch.Generator] = None, seed: int = 0,
                  device="cpu") -> List[torch.Tensor]:
    """`n_hashes` random rotations (head_dim, n_buckets / 2), standard
    normal, float32, drawn from `generator` (a new CPU one seeded `seed`
    when None), on `device`."""
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    return [torch.randn((head_dim, n_buckets // 2), generator=generator,
                        device=generator.device).to(device)
            for _ in range(n_hashes)]


def _bucket_ids(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Angular LSH: argmax over the rotations [R; −R]."""
    proj = torch.einsum("...td,dr->...tr", x.float(), rot.float())
    return torch.argmax(torch.cat([proj, -proj], dim=-1), dim=-1)


def _sort_by_bucket(ids: torch.Tensor, T: int):
    """(order, inverse) of the stable sort of positions by bucket."""
    key = ids * (T + 1) + torch.arange(T, device=ids.device)
    order = torch.argsort(key, dim=-1)
    return order, torch.argsort(order, dim=-1)


def _gather_t(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 2, order[..., None].expand(*order.shape, x.shape[-1]))


def reformer_lsh_attention(
    q: torch.Tensor,
    v: torch.Tensor,
    *,
    bucket_size: int = 64,
    n_hashes: int = 4,
    causal: bool = False,
    mask_1d: Optional[torch.Tensor] = None,
    rotations: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Shared-QK LSH attention (Reformer): hash q, sort, attend within
    chunks of `bucket_size` (plus the previous chunk), average the rounds.
    `bucket_size` halves until it fits T. `rotations`: one (D, n_buckets/2)
    draw per round (`lsh_rotations`; None: seed 0's). `mask_1d` (N, T): 1 on
    tokens, whose padding goes to an extra last bucket."""
    N, H, T, D = q.shape
    bucket_size, n_buckets = lsh_buckets(T, bucket_size)
    if rotations is None:
        rotations = lsh_rotations(D, n_buckets, n_hashes, device=q.device)
    qn = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-6)
    C = bucket_size
    nc = T // C
    pos_t = torch.arange(T, device=q.device).expand(N, H, T)
    out = None
    for h_i in range(n_hashes):
        ids = _bucket_ids(qn, rotations[h_i])
        if mask_1d is not None:
            ids = torch.where(mask_1d[:, None, :] > 0, ids, torch.full_like(ids, n_buckets))
        order, inv = _sort_by_bucket(ids, T)
        qs = _gather_t(q, order).reshape(N, H, nc, C, D)
        vs = _gather_t(v, order).reshape(N, H, nc, C, D)
        pos_c = torch.gather(pos_t, -1, order).reshape(N, H, nc, C)
        # the own chunk and the previous one (the reformer's look-back)
        ks = torch.cat([torch.roll(qs, 1, dims=2), qs], dim=3)
        vv = torch.cat([torch.roll(vs, 1, dims=2), vs], dim=3)
        kpos = torch.cat([torch.roll(pos_c, 1, dims=2), pos_c], dim=3)
        scores = torch.einsum("nhctd,nhcsd->nhcts", qs, ks) / math.sqrt(D)
        # no attention to the same position; causal by position
        same = pos_c[..., :, None] == kpos[..., None, :]
        scores = scores.masked_fill(same, -1e5)
        if causal:
            scores = scores.masked_fill(kpos[..., None, :] > pos_c[..., :, None], -1e9)
        probs = torch.softmax(scores.float(), -1)
        o = torch.einsum("nhcts,nhcsd->nhctd", probs, vv.float()).reshape(N, H, T, D)
        o = _gather_t(o, inv)
        out = o if out is None else out + o
    return (out / n_hashes).to(q.dtype)


def scatterbrain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    proj: torch.Tensor,
    *,
    bucket_size: int = 64,
    causal: bool = False,
    rotation: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scatterbrain: FAVOR+ low-rank attention plus a sparse correction on
    LSH-matched pairs (the estimate phi(q)phi(k)ᵀ replaced by the exact
    exp(q·kᵀ/sqrt(D)) inside each chunk), normalised together.
    `rotation`: the hash's (D, n_buckets/2) draw (None: seed 0's)."""
    N, H, T, D = q.shape
    qp = softmax_kernel_features(q, proj, is_query=True)  # (N, H, T, M)
    kp = softmax_kernel_features(k, proj, is_query=False)
    v32 = v.float()

    # the low-rank global numerator and denominator
    ctx = torch.einsum("nhsm,nhsd->nhmd", kp, v32)
    num_lr = torch.einsum("nhtm,nhmd->nhtd", qp, ctx)
    den_lr = torch.einsum("nhtm,nhm->nht", qp, kp.sum(2))

    # LSH chunks (shared-QK hashing on q, as the reformer)
    n_buckets = max(2, T // bucket_size)
    n_buckets += n_buckets % 2
    if rotation is None:
        rotation = lsh_rotations(D, n_buckets, 1, device=q.device)[0]
    qn = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-6)
    order, inv = _sort_by_bucket(_bucket_ids(qn, rotation), T)
    C = bucket_size
    nc = T // C
    qs = _gather_t(q, order).reshape(N, H, nc, C, D)
    ks = _gather_t(k, order).reshape(N, H, nc, C, D)
    vs = _gather_t(v32, order).reshape(N, H, nc, C, D)
    qps = _gather_t(qp, order).reshape(N, H, nc, C, -1)
    kps = _gather_t(kp, order).reshape(N, H, nc, C, -1)
    pos = torch.gather(torch.arange(T, device=q.device).expand(N, H, T), -1,
                       order).reshape(N, H, nc, C)

    scale = 1.0 / math.sqrt(D)
    exact = torch.exp(torch.einsum("nhctd,nhcsd->nhcts", qs, ks).float() * scale - scale * 0)
    approx = torch.einsum("nhctm,nhcsm->nhcts", qps, kps)
    if causal:
        cmask = pos[..., :, None] >= pos[..., None, :]
        exact = torch.where(cmask, exact, torch.zeros_like(exact))
        approx = torch.where(cmask, approx, torch.zeros_like(approx))
    corr = exact - approx
    num_sp = torch.einsum("nhcts,nhcsd->nhctd", corr, vs).reshape(N, H, T, D)
    den_sp = corr.sum(-1).reshape(N, H, T)
    num_sp = _gather_t(num_sp, inv)
    den_sp = torch.gather(den_sp, 2, inv)
    den = torch.clamp(den_lr + den_sp, min=1e-6)
    return ((num_lr + num_sp) / den[..., None]).to(q.dtype)


def _logsumexp_norm(log_p: torch.Tensor, dim: int) -> torch.Tensor:
    return log_p - torch.logsumexp(log_p, dim=dim, keepdim=True)


def sinkhorn_block_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    block_size: int = 64,
    sinkhorn_iters: int = 5,
    temperature: float = 0.75,
    mask_1d: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sparse Sinkhorn attention, learn-free, on block-mean keys: a
    Sinkhorn-normalised soft permutation matches each query block to key
    blocks, and a block attends to [own block ‖ matched block]. `mask_1d`
    (N, T): 1 on tokens; padded keys of the own block are masked."""
    N, H, T, D = q.shape
    B = block_size
    nb = T // B
    qb = q.reshape(N, H, nb, B, D)
    kb = k.reshape(N, H, nb, B, D)
    vb = v.reshape(N, H, nb, B, D)
    logits = torch.einsum("nhid,nhjd->nhij", qb.mean(3), kb.mean(3)) / temperature
    log_p = logits.float()
    for _ in range(sinkhorn_iters):
        log_p = _logsumexp_norm(log_p, -1)
        log_p = _logsumexp_norm(log_p, -2)
    p = torch.exp(log_p)
    k_perm = torch.einsum("nhij,nhjsd->nhisd", p, kb.float())
    v_perm = torch.einsum("nhij,nhjsd->nhisd", p, vb.float())
    ks = torch.cat([kb.float(), k_perm], dim=3)
    vs = torch.cat([vb.float(), v_perm], dim=3)
    scores = torch.einsum("nhitd,nhisd->nhits", qb.float(), ks) / math.sqrt(D)
    if mask_1d is not None:
        own = (mask_1d.reshape(N, 1, nb, B) > 0)[..., None, :]
        scores = torch.cat([scores[..., :B].masked_fill(~own, -1e9), scores[..., B:]], dim=-1)
    probs = torch.softmax(scores, -1)
    out = torch.einsum("nhits,nhisd->nhitd", probs, vs)
    return out.reshape(N, H, T, D).to(q.dtype)


def sinkhorn_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    block_size: int = 64,
    match_iters: int = 3,
    temperature: float = 0.75,
) -> torch.Tensor:
    """Causal sparse-Sinkhorn attention: query block i attends causally
    within its own block plus one softly matched strictly earlier block,
    the match row-normalised only (a column normalisation would couple a
    row to future queries); block 0 attends to itself only. The block's
    representative is its first query. T is zero-padded to whole blocks."""
    N, H, T, D = q.shape
    B = block_size
    pad = (-T) % B
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
    Tp = T + pad
    nb = Tp // B
    qb = q.reshape(N, H, nb, B, D)
    kb = k.reshape(N, H, nb, B, D)
    vb = v.reshape(N, H, nb, B, D)
    logits = torch.einsum("nhid,nhjd->nhij", qb[:, :, :, 0], kb.mean(3)).float() / temperature
    ids = torch.arange(nb, device=q.device)
    past = ids[None, :] < ids[:, None]  # strictly earlier blocks
    log_p = logits.masked_fill(~past, -1e9)
    for _ in range(match_iters):
        log_p = _logsumexp_norm(log_p, -1)
    p = torch.exp(log_p) * past
    k_perm = torch.einsum("nhij,nhjsd->nhisd", p, kb.float())
    v_perm = torch.einsum("nhij,nhjsd->nhisd", p, vb.float())

    scores_own = torch.einsum("nhitd,nhisd->nhits", qb.float(), kb.float()) / math.sqrt(D)
    within = torch.arange(B, device=q.device)
    within = within[:, None] >= within[None, :]
    scores_own = scores_own.masked_fill(~within, -1e9)
    scores_match = torch.einsum("nhitd,nhisd->nhits", qb.float(), k_perm) / math.sqrt(D)
    scores_match = scores_match.masked_fill((ids == 0)[:, None, None], -1e9)

    probs = torch.softmax(torch.cat([scores_own, scores_match], dim=-1), -1)
    vs = torch.cat([vb.float(), v_perm], dim=3)
    out = torch.einsum("nhits,nhisd->nhitd", probs, vs)
    return out.reshape(N, H, Tp, D)[:, :, :T].to(q.dtype)
