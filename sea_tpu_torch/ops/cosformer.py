"""Cosformer attention (cos-reweighted linear attention), PyTorch port.

Port of `sea_tpu/ops/cosformer.py`, used both as a baseline operator (the
attention sweep of `sea_tpu_torch.benchmarks`) and as SEA's cosformer
estimator backend (`models/attention.py`):

  features:   q' = [relu(q) sin(pi i / 2m), relu(q) cos(pi i / 2m)]
              k' likewise (i = 1-based position, m = max(L, S));
  causal:     out_t = (q'_t · sum_{s<=t} k'_s v_s^T) / max(q'_t · s_t, eps)
  non-causal: out = q'(K'^T V) / max(q'(K'^T 1), eps)

The causal prefix runs in chunks: a running (M, Dv) state carries the flow
between chunks and a small causal-masked dense product covers each chunk,
the arithmetic of the JAX scan. Plain PyTorch, float32; no kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _cos_features(x: torch.Tensor, m: int) -> torch.Tensor:
    """x: (B, T, D) post-activation; returns (B, T, 2D)."""
    T = x.shape[-2]
    idx = (torch.arange(1, T + 1, dtype=torch.float32, device=x.device)
           * (math.pi / 2.0) / m)[None, :, None]
    return torch.cat([x * torch.sin(idx), x * torch.cos(idx)], dim=-1)


def cosformer_causal(qp: torch.Tensor, kp: torch.Tensor, v: torch.Tensor,
                     chunk: int = 128, eps: float = 1e-6) -> torch.Tensor:
    """Chunked causal linear attention with a clamped denominator
    (reference `cosformer.py:115-131`). Shapes (B, T, M) x (B, T, Dv); T is
    zero-padded to a whole chunk and the padding sliced off. Computed in
    float32 whatever the inputs' dtype."""
    qp, kp, v = qp.float(), kp.float(), v.float()
    B, T, M = qp.shape
    Dv = v.shape[-1]
    pad = (-T) % chunk
    if pad:
        qp, kp, v = (F.pad(x, (0, 0, 0, pad)) for x in (qp, kp, v))
    nc = (T + pad) // chunk
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32, device=qp.device))
    S = torch.zeros((B, M, Dv), dtype=torch.float32, device=qp.device)
    z = torch.zeros((B, M), dtype=torch.float32, device=qp.device)
    outs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        q_i, k_i, v_i = qp[:, sl], kp[:, sl], v[:, sl]
        a = torch.einsum("btm,bsm->bts", q_i, k_i) * tri
        num = torch.einsum("bts,bsd->btd", a, v_i) + torch.einsum("btm,bmd->btd", q_i, S)
        den = a.sum(-1) + torch.einsum("btm,bm->bt", q_i, z)
        outs.append(num / torch.clamp(den, min=eps)[..., None])
        S = S + torch.einsum("bsm,bsd->bmd", k_i, v_i)
        z = z + k_i.sum(-2)
    return torch.cat(outs, dim=1)[:, :T]


def cosformer_noncausal(qp: torch.Tensor, kp: torch.Tensor, v: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """q'(K'^T V) / max(q'(K'^T 1), eps); shapes as `cosformer_causal`,
    float32."""
    qp, kp, v = qp.float(), kp.float(), v.float()
    kv = torch.einsum("bsm,bsd->bmd", kp, v)
    z = torch.einsum("btm,bm->bt", qp, kp.sum(1))
    return torch.einsum("btm,bmd->btd", qp, kv) / torch.clamp(z, min=eps)[..., None]


class CosformerAttention(nn.Module):
    """Reference-parity module: embed_dim in, a vdim value stream, per-head
    cos features, relu activation, optional out-projection (SEA's backend
    has none). Linear weights follow `init_random_`'s scheme when built with
    a seed by a parent, or come from `state_dict_from_jax`."""

    def __init__(self, embed_dim: int, num_heads: int, vdim: Optional[int] = None,
                 has_outproj: bool = True, causal: bool = False, *, device="cuda"):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.vdim = vdim if vdim is not None else embed_dim
        self.has_outproj, self.causal = has_outproj, causal
        self.q_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.k_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.v_proj = nn.Linear(self.vdim, self.vdim, device=device)
        if has_outproj:
            self.out_proj = nn.Linear(self.vdim, self.vdim, device=device)

    def forward(self, query: torch.Tensor, key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
        """query (L, N, E); key and value (S, N, E / vdim): the reference's
        sequence-first layout. Returns (L, N, vdim) in query's dtype."""
        key = query if key is None else key
        value = query if value is None else value
        H = self.num_heads
        hd, vhd = self.embed_dim // H, self.vdim // H
        L, N, _ = query.shape
        S = key.shape[0]

        q = torch.relu(self.q_proj(query))
        k = torch.relu(self.k_proj(key))
        v = self.v_proj(value)

        def heads(x, d):  # (T, N, H·d) -> (N·H, T, d)
            return x.reshape(x.shape[0], N * H, d).transpose(0, 1).float()

        q, k, v = heads(q, hd), heads(k, hd), heads(v, vhd)
        m = max(L, S)
        q_, k_ = _cos_features(q, m), _cos_features(k, m)
        if self.causal:
            out = cosformer_causal(q_, k_, v, eps=eps)
        else:
            out = cosformer_noncausal(q_, k_, v, eps=eps)
        out = out.transpose(0, 1).reshape(L, N, H * vhd)
        if self.has_outproj:
            out = self.out_proj(out)
        return out.to(query.dtype)
