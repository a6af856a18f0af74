"""Compressed-mask resize and grouped top-k selection (PyTorch port).

Port of `sea_tpu/ops/masks.py`: the mask fill constant, the per-row budget,
the grouped top-k (`topk_mask`, `causal_topk_masking`) and
`resize_from_m_to_t`, causal and non-causal, with the training jitter and
the undersampling keep-predicate. The resize is one index computation
(`resize_index`) and one gather (`resize_with_index`); the dense train path
computes the index once per forward and gathers its three maps through it.
The JAX package's blocked one-hot matmuls are a TPU speed device with the
same values; a gather is exact at any matmul precision (a one-hot matmul is
exact only without TF32).

Two numerical rules keep the port bit-exact with the JAX package:

  * rounding is `floor(x + 0.5)` (half away from zero for x >= 0), never
    `torch.round`, which rounds half to even;
  * ranks come from a stable sort of `-t` plus a scatter, never
    `torch.topk`, whose order among ties is unspecified. Tie order is part
    of the semantics: equal estimates are kept by ascending index.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .kernels.block_sparse import _keep_dense


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


class ResizeIndex(NamedTuple):
    """The column map of `resize_from_m_to_t`: `idx` (N, 1, T1 or 1, T2)
    int64, the compressed pixel each column reads (T_M at padding, the fill
    value's column), and `token_length` (N, 1, T1 or 1, 1) float32, each
    row's count of kept columns. Rows are 1 when the mask is (N, 1, 1, T2)
    (non-causal: the map is the same for every row)."""

    idx: torch.Tensor
    token_length: torch.Tensor


def resize_jitter_draws(
    shape, generator: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training jitter's two draws, on the generator's device: U(0, 1)
    noise of the mask's shape (N, 1, T1, T2) and one U(0, 1) gate. The
    resize maps them to U(-0.75, 0.75) and to p = 0.1 itself, so that a
    test can pass in the JAX package's `jax.random.uniform` draws."""
    dev = generator.device
    noise = torch.rand(tuple(shape), generator=generator, device=dev, dtype=torch.float32)
    gate = torch.rand((), generator=generator, device=dev, dtype=torch.float32)
    return noise, gate


def resize_index(
    attention_mask: torch.Tensor,
    t_m: int,
    jitter: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> ResizeIndex:
    """Column map of the padding-aware nearest resize from T_M to T2.

    attention_mask: additive, 0 to keep and <= FP_MIN at padding or past
    the causal edge; (N, 1, T1, T2) causal, (N, 1, 1, T2) non-causal.
    Column c of a row reads pixel floor((cs_c − 1 + 0.5) / L · T_M − 1e-4),
    cs being the running count of kept columns and L their total; a dropped
    column reads index T_M. All divisions are by tensors: a true division,
    bit for bit the JAX package's index map.

    jitter: `resize_jitter_draws`' (noise, gate). With probability 0.1 (gate
    < 0.1) the running count moves by U(-0.75, 0.75), clamped to
    [1, argmax(cs)]: the clamp's upper end is the *index* of the row's
    largest count, a reference quirk kept as it is."""
    mask = (attention_mask > -1).to(torch.float32)
    mask_cs = torch.cumsum(mask, dim=-1)
    token_length = mask_cs[..., -1:]
    if jitter is not None:
        noise, gate = jitter
        noise = noise.to(mask_cs.device) * 1.5 - 0.75
        hi = torch.argmax(mask_cs, dim=-1, keepdim=True).to(mask_cs.dtype)
        jittered = torch.minimum(torch.maximum(mask_cs + noise, torch.ones_like(mask_cs)), hi)
        mask_cs = torch.where(gate.to(mask_cs.device) < 0.1, jittered, mask_cs)
    idx = (
        torch.floor(((mask_cs - 1) + 0.5) / token_length * t_m - 1e-4).to(torch.int64)
        + ((1 - mask) * t_m).to(torch.int64)
    )
    return ResizeIndex(torch.clamp(idx, 0, t_m), token_length)


def resize_with_index(
    x: torch.Tensor,
    masked_fill_value: float,
    index: ResizeIndex,
    k: Optional[float] = None,
    oversampled: Optional[float] = None,
) -> torch.Tensor:
    """Gather (N, H, T1, T_M) `x` through `index` to (N, H, T1, T2), the
    dropped columns reading `masked_fill_value`. A gather is exact whatever
    the matmul precision (the JAX package's one-hot matmuls, a TPU speed
    device, give the same values).

    k / oversampled: when oversampled is not 1, also the undersampling
    keep-predicate: column c of a row of L kept columns survives iff
    frac = (c + 1) / L · max(round(L / oversampled), 1) lies within
    0.5 / oys + 1e-4 of an integer, oys = clip(L, round(k),
    round(k · oversampled)) / k (`round` half away from zero on tensors,
    Python's `round` on the two bounds, as the JAX package does): the
    kernels' own predicate, `block_sparse._keep_dense`."""
    N, H, T1, T_M = x.shape
    idx = index.idx
    T2 = idx.shape[-1]
    grid_input = torch.cat(
        [x, torch.full((N, H, T1, 1), masked_fill_value, dtype=x.dtype, device=x.device)],
        dim=-1,
    )
    output = torch.gather(grid_input, -1, idx.expand(N, H, T1, T2))
    if oversampled is not None and oversampled != 1.0:
        assert k is not None
        keep = _keep_dense(index.token_length, T2, oversampled, k)
        output = torch.where(keep, output, torch.full_like(output, masked_fill_value))
    return output


def resize_from_m_to_t(
    x: torch.Tensor,
    masked_fill_value: float,
    attention_mask: torch.Tensor,
    target_width: Optional[int] = None,
    is_causal: bool = True,
    k: Optional[float] = None,
    oversampled: Optional[float] = None,
    jitter: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Nearest-neighbour width-resize of a compressed (N, H, T1, T_M) map to
    (N, H, T1, T2), padding-aware: `resize_index` then `resize_with_index`.

    attention_mask: (N, 1, T1, T2) when causal, (N, 1, 1, T2) when not;
    target_width: T2 (defaults to T1); jitter: the training jitter's draws
    (`resize_jitter_draws`); k / oversampled: the undersampling
    keep-predicate."""
    N, H, T1, T_M = x.shape
    T2 = target_width if target_width is not None else T1
    want = (N, 1, T1, T2) if is_causal else (N, 1, 1, T2)
    if tuple(attention_mask.shape) != want:
        raise ValueError(f"attention_mask must be {want}, got {tuple(attention_mask.shape)}")
    index = resize_index(attention_mask, T_M, jitter)
    return resize_with_index(x, masked_fill_value, index, k, oversampled)


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


def causal_topk_masking(
    estimated_probs: torch.Tensor,
    k: int,
    attention_mask: torch.Tensor,
    dst_attention_mask: torch.Tensor,
    causal_attention_mask: torch.Tensor,
    not_padded: bool = True,
    k_oversample: float = 1.0,
    benchmarking: bool = False,
) -> torch.Tensor:
    """The standalone grouped top-k over (N, T_DST, H·T_M) with the causal
    budget round(H·k·k_oversample·T_M / (r + 1)) per row r, padded query
    rows (dst_attention_mask (N, 1, T_DST, 1)) zeroed first and filled
    after. `attention_mask`, `causal_attention_mask` and `not_padded` are
    read by neither package; they keep the reference op's signature."""
    N, H, T_DST, T_M = estimated_probs.shape
    causal_token_length = torch.arange(
        1, T_DST + 1, dtype=torch.float32, device=estimated_probs.device
    ).reshape(1, T_DST, 1).expand(N, T_DST, 1)
    dst_alive = dst_attention_mask > -1
    probs = estimated_probs * dst_alive.to(estimated_probs.dtype)
    budget = per_item_top_k(
        cfg_k=k,
        k_oversample=k_oversample,
        k_flatten_dim="causal_batch",
        num_heads=H,
        t_m=T_M,
        token_length=None,
        causal_token_length=causal_token_length,
        causal=True,
    )
    return topk_mask(
        probs, dst_alive, budget, "causal_batch", benchmarking,
        fp_min_for(estimated_probs.dtype),
    )
