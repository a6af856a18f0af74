"""Grouped top-k selection of the compressed mask (PyTorch port).

Port of the benchmark-path half of `sea_tpu/ops/masks.py`: the mask fill
constant, the per-row budget, the grouped top-k, and the non-causal
`resize_from_m_to_t` without jitter or undersampling, as `resize_noncausal`
(the BERT benchmark path's average-pool weights). The causal resize, the jitter and the
undersampling keep-predicate belong to the dense train path and are not
ported yet.

Two numerical rules keep the port bit-exact with the JAX package:

  * rounding is `floor(x + 0.5)` (half away from zero for x >= 0), never
    `torch.round`, which rounds half to even;
  * ranks come from a stable sort of `-t` plus a scatter, never
    `torch.topk`, whose order among ties is unspecified. Tie order is part
    of the semantics: equal estimates are kept by ascending index.
"""

from __future__ import annotations

from typing import Optional

import torch


def fp_min_for(dtype: torch.dtype) -> float:
    """Mask fill constant: half the float16 minimum under 16-bit types,
    half the float32 minimum under float32."""
    if dtype in (torch.float16, torch.bfloat16):
        return float(torch.finfo(torch.float16).min) / 2
    if dtype == torch.float32:
        return float(torch.finfo(torch.float32).min) / 2
    raise ValueError(f"unsupported dtype {dtype}")


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Half away from zero for x >= 0 (all inputs here are)."""
    return torch.floor(x + 0.5)


def resize_noncausal(
    x: torch.Tensor,
    masked_fill_value: float,
    attention_mask: torch.Tensor,
    target_width: Optional[int] = None,
) -> torch.Tensor:
    """Nearest-neighbour width-resize of a compressed (N, H, T1, T_M) map to
    (N, H, T1, T2), padding-aware: the non-causal `resize_from_m_to_t`
    without jitter or undersampling.

    attention_mask: (N, 1, 1, T2) additive, 0 to keep and <= FP_MIN at
    padding. Column c of example n reads pixel
    floor((cs_c − 1 + 0.5) / L · T_M − 1e-4) with cs the running count of
    kept columns and L their total; a padded column reads the fill value
    (index T_M). The map is the same for every row; the resize is a gather,
    so it is exact whatever the matmul precision."""
    N, H, T1, T_M = x.shape
    T2 = target_width if target_width is not None else T1
    if tuple(attention_mask.shape) != (N, 1, 1, T2):
        raise ValueError(f"attention_mask must be (N, 1, 1, T2) = {(N, 1, 1, T2)}, "
                         f"got {tuple(attention_mask.shape)}")
    mask = (attention_mask[:, 0, 0, :] > -1).to(torch.float32)  # (N, T2)
    mask_cs = torch.cumsum(mask, dim=-1)
    token_length = mask_cs[:, -1:]
    # `/ token_length` divides by a tensor: a true division, bit for bit
    # the JAX package's index map
    idx = (
        torch.floor(((mask_cs - 1) + 0.5) / token_length * T_M - 1e-4).to(torch.int64)
        + ((1 - mask) * T_M).to(torch.int64)
    )
    idx = torch.clamp(idx, 0, T_M)  # (N, T2)
    grid_input = torch.cat(
        [x, torch.full((N, H, T1, 1), masked_fill_value, dtype=x.dtype, device=x.device)],
        dim=-1,
    )
    return torch.gather(grid_input, -1, idx[:, None, None, :].expand(N, H, T1, T2))


def per_item_top_k(
    cfg_k: float,
    k_oversample: float,
    k_flatten_dim: str,
    num_heads: int,
    t_m: int,
    token_length: Optional[torch.Tensor],
    causal_token_length: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Per-row retained-entry budget, broadcastable against the flattened
    score tensor:
      'causal_batch' -> (N, T_DST, 1) causal, (N, 1, 1) otherwise
      'batch'        -> (N, 1)
      'head'         -> (N, 1, 1)
      'query'        -> (N, 1, 1, 1)
    """
    H, T_M = num_heads, t_m
    k_eff = cfg_k * k_oversample

    def k_over(length: torch.Tensor) -> torch.Tensor:
        # a true division: `scalar / tensor` would go through reciprocal()
        # and can miss the float32 quotient by one ulp
        num = torch.full_like(length, k_eff * T_M, dtype=torch.float32)
        return num / length.to(torch.float32)

    if k_flatten_dim == "batch":
        assert not causal
        out = token_length * H * k_over(token_length)
        out = out.reshape(out.shape[0], 1)
    elif k_flatten_dim == "head":
        assert not causal
        out = (token_length * k_over(token_length)).reshape(-1, 1, 1)
    elif k_flatten_dim == "causal_batch":
        if not causal:
            out = (H * k_over(token_length)).reshape(-1, 1, 1)
        else:
            assert causal_token_length is not None
            out = H * k_over(causal_token_length)
    elif k_flatten_dim == "query":
        assert not causal
        out = k_over(token_length).reshape(-1, 1, 1, 1)
    else:
        raise ValueError(k_flatten_dim)
    out = round_half_away(out)
    return torch.clamp(out, min=1.0)


def _ranks_desc(t: torch.Tensor) -> torch.Tensor:
    """Dense descending ranks along the last axis: the largest value gets
    rank 0, ties rank by ascending index."""
    # `+ 0.0` turns -0.0 into +0.0: a radix sort on the card would otherwise
    # order the two zeros apart, where the comparison sort ties them
    _, order = torch.sort(-t + 0.0, dim=-1, stable=True)
    arange = torch.arange(t.shape[-1], device=t.device, dtype=torch.int64)
    arange = arange.expand(t.shape).contiguous()
    return torch.empty_like(order).scatter_(-1, order, arange)


def topk_mask(
    estimated_attention_probs: torch.Tensor,
    dst_alive: torch.Tensor,
    per_item_k: torch.Tensor,
    k_flatten_dim: str,
    benchmarking: bool,
    fp_min: float,
) -> torch.Tensor:
    """Grouped top-k -> compressed mask.

    Args:
      estimated_attention_probs: (N, H, T_DST, T_M) post-softmax estimates,
        already zeroed at padded query rows.
      dst_alive: (N, 1, T_DST, 1) boolean, False at padded query rows.
      per_item_k: broadcastable per-row budget from `per_item_top_k`.
      benchmarking: True -> binary {0,1} mask; False -> additive {0, FP_MIN}.

    Returns the (N, H, T_DST, T_M) mask.
    """
    N, H, T_DST, T_M = estimated_attention_probs.shape
    probs = estimated_attention_probs

    if k_flatten_dim == "causal_batch":
        t = probs.permute(0, 2, 1, 3).reshape(N, T_DST, H * T_M)
    elif k_flatten_dim == "batch":
        t = probs.reshape(N, H * T_DST * T_M)
    elif k_flatten_dim == "head":
        t = probs.reshape(N, H, T_DST * T_M)
    elif k_flatten_dim == "query":
        t = probs
    else:
        raise ValueError(k_flatten_dim)

    ranks = _ranks_desc(t)
    if benchmarking:
        mask = (ranks < per_item_k).to(probs.dtype)
    else:
        mask = (ranks >= per_item_k).to(probs.dtype) * fp_min

    fill = 0.0 if benchmarking else fp_min
    if k_flatten_dim == "causal_batch":
        mask = mask.reshape(N, T_DST, H, T_M).permute(0, 2, 1, 3)
        mask = torch.where(dst_alive, mask, torch.full_like(mask, fill))
    elif k_flatten_dim == "query":
        mask = torch.where(dst_alive, mask, torch.full_like(mask, fill))
    return mask.reshape(N, H, T_DST, T_M)
