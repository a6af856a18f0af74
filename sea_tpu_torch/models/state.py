"""Autoregressive decode cache for SEA attention (PyTorch port of
`sea_tpu/models/state.py`).

One explicit NamedTuple of fixed-shape tensors threaded through the decode
loop:

  * the FAVOR+ prefix state, the running (M, Dv) matrix S and (M,) vector z
    of the causal linear attention, carried in float32 whatever the compute
    type;
  * a sliding window of the last `CNN_WINDOW` (24) predictor rows that feed
    the causal CNN, re-run every step: 24 rows cover the dilated stack's
    receptive field (2 convs, k=3, dilation 2: 9 rows), so windowing is
    exact;
  * the running sum of v (float32) and its length, for the average context;
  * a fixed-capacity K/V cache and the number of tokens already cached.

The window and the K/V cache take the type `init_decode_state` is given
(the model's type: bfloat16 for a model cast to bfloat16), the FAVOR+ sums
and the running sum of v stay float32.

The counters (`cnn_filled`, `cumavg_len`, `length`) are () tensors when all
rows decode in lockstep and (N,) per-slot tensors in the serving engine.
Every function here is functional: it returns new tensors and leaves its
inputs as they were.

Also the int8 quantisation of the serving engine's paged K/V pools
(`quantize_kv`, `dequantize_kv`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .modules import promote

CNN_WINDOW = 24


class SeaDecodeState(NamedTuple):
    # FAVOR+ prefix state
    performer_S: torch.Tensor  # (N, H, M, Dv) float32
    performer_z: torch.Tensor  # (N, H, M) float32
    # rolling window of dec_row outputs feeding the causal CNN, newest last
    cnn_window: torch.Tensor  # (N, C, CNN_WINDOW, T_M // down)
    cnn_filled: torch.Tensor  # () or (N,) int32, rows valid at the window's tail
    # running sum of v
    cumavg_sum: torch.Tensor  # (N, H, 1, D) float32
    cumavg_len: torch.Tensor  # () or (N,) int32
    # K/V cache
    k_cache: torch.Tensor  # (N, H, max_len, D)
    v_cache: torch.Tensor  # (N, H, max_len, D)
    length: torch.Tensor  # () or (N,) int32, tokens already cached


def init_decode_state(
    batch: int,
    num_heads: int,
    head_dim: int,
    nb_features: int,
    predictor_length: int,
    dec_row_splits: int,
    dec_row_down_scale: int,
    max_len: int,
    dtype=torch.float32,
    *,
    device="cuda",
) -> SeaDecodeState:
    """An empty state on `device`: zero sums, an empty window and cache."""
    Dv = head_dim * 2  # [identity ‖ v] performer value width
    C = dec_row_splits * num_heads
    Wd = predictor_length // dec_row_down_scale

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return SeaDecodeState(
        performer_S=zeros((batch, num_heads, nb_features, Dv), torch.float32),
        performer_z=zeros((batch, num_heads, nb_features), torch.float32),
        cnn_window=zeros((batch, C, CNN_WINDOW, Wd), dtype),
        cnn_filled=zeros((), torch.int32),
        cumavg_sum=zeros((batch, num_heads, 1, head_dim), torch.float32),
        cumavg_len=zeros((), torch.int32),
        k_cache=zeros((batch, num_heads, max_len, head_dim), dtype),
        v_cache=zeros((batch, num_heads, max_len, head_dim), dtype),
        length=zeros((), torch.int32),
    )


def performer_decode_step(
    state_S: torch.Tensor,
    state_z: torch.Tensor,
    qp: torch.Tensor,  # (N, H, 1, M) featurized query
    kp: torch.Tensor,  # (N, H, 1, M) featurized key
    v: torch.Tensor,  # (N, H, 1, Dv)
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One prefix step: S += k' vᵀ, z += k', out = (q'·S) / (q'·(z + eps)).
    Returns (out, S, z)."""
    S = state_S + torch.einsum("nhtm,nhtd->nhmd", kp, v.float())
    z = state_z + kp[:, :, 0, :]
    num = torch.einsum("nhtm,nhmd->nhtd", qp, S)
    den = torch.einsum("nhtm,nhm->nht", qp, z) + eps * qp.sum(dim=-1)
    den = torch.where(den <= 0, torch.ones_like(den), den)
    return num / den[..., None], S, z


def cnn_window_push(
    window: torch.Tensor, filled: torch.Tensor, row: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift the window up by one row and append `row` (N, C, 1, Wd); the
    result takes the promoted type of the two, as JAX's concatenation does
    (a bfloat16 window and a float32 row give a float32 window)."""
    dtype = promote(window, row)
    window = torch.cat([window[:, :, 1:, :].to(dtype), row.to(dtype)], dim=2)
    return window, torch.clamp(filled + 1, max=window.shape[2])


def cumavg_step(
    cum_sum: torch.Tensor, cum_len: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Running mean of v: returns (mean in v's dtype, new sum, new length).
    `cum_len` is () (lockstep) or (N,) (per slot) and broadcasts against
    `cum_sum` (N, H, 1, D)."""
    s = cum_sum + v.float()
    n = cum_len + 1
    n_b = n.float().reshape(tuple(n.shape) + (1,) * (s.dim() - n.dim()))
    return (s / n_b).to(v.dtype), s, n


def _row_mask(rows: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return rows.reshape((rows.shape[0],) + (1,) * (x.dim() - 1))


def reset_state_rows(state: SeaDecodeState, rows: torch.Tensor) -> SeaDecodeState:
    """Zero the rows selected by the bool mask `rows` (N,) of every field
    with a leading (N,) axis (the serving engine recycling a slot); ()
    fields (lockstep counters) are left as they are."""
    n = rows.shape[0]

    def reset(x):
        if x.dim() >= 1 and x.shape[0] == n:
            return torch.where(_row_mask(rows, x), torch.zeros_like(x), x)
        return x

    return SeaDecodeState(*(reset(x) for x in state))


def select_state_rows(
    state_new: SeaDecodeState, state_old: SeaDecodeState, rows: torch.Tensor
) -> SeaDecodeState:
    """Per-row select: rows where `rows` (N,) is True take `state_new`, the
    others keep `state_old` (the serving engine freezing the slots it did
    not schedule). () fields take `state_new`."""
    n = rows.shape[0]

    def sel(a, b):
        if a.dim() >= 1 and a.shape[0] == n:
            return torch.where(_row_mask(rows, a), a, b)
        return a

    return SeaDecodeState(*(sel(a, b) for a, b in zip(state_new, state_old)))


# ----------------------------------------------------------------------
# int8 K/V pools: int8 values and a float32 scale per (token, head), about
# 8.25 bytes per pair of elements against 32 for float32 pools


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation over the trailing (head_dim) axis:
    (q int8 in [-127, 127], scale float32 of x's shape without its last
    axis), x ≈ q · scale[..., None]. Rounds half to even, as JAX does."""
    scale = x.abs().amax(dim=-1) / torch.full((), 127.0, dtype=x.dtype, device=x.device)
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale[..., None].to(dtype)


# the per-head leaves of a decode state, each with the heads on dim 1 (the
# CNN window's splits·H channels head-major): what a head-sharded serving
# engine splits over its positions
HEAD_FIELDS = ("performer_S", "performer_z", "cnn_window", "cumavg_sum", "k_cache", "v_cache")


def head_shard(state: SeaDecodeState, n: int, p: int) -> SeaDecodeState:
    """Position p's share of `state` over n positions: its 1/n of the heads
    in every per-head leaf, the counters as they are."""
    return state._replace(**{f: getattr(state, f).chunk(n, 1)[p].clone() for f in HEAD_FIELDS})
