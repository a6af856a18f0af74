"""ToMe token merging (PyTorch port of `sea_tpu/ops/tome.py`): sort the
non-CLS tokens by significance (the similarity map's column mean), keep the
top `preserve_ratio` of them, and merge the first `merge_ratio` of the rest
(the sources) into their most similar remaining token (the destinations) by
a scatter-mean; `tome_unmerge` copies each destination back to its sources
and undoes the sort. Every count is a function of (T, the ratios) alone.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class TomeState(NamedTuple):
    sort_idx: torch.Tensor  # (N, T-1) significance order of the non-CLS tokens
    node_idx: torch.Tensor  # (N, n_src) each source's destination
    n_preserve: int
    n_src: int
    n_dst: int


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (N, T, E) at rows idx (N, R) -> (N, R, E)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def tome_merge(x: torch.Tensor, sim: torch.Tensor, preserve_ratio: float = 0.5,
               merge_ratio: float = 0.5) -> Tuple[torch.Tensor, TomeState]:
    """x (N, T, E) hidden states (token 0 the CLS), sim (N, T, T) a
    similarity or probability map. Returns (merged (N, 1 + n_preserve +
    n_dst, E), state)."""
    N, T, E = x.shape
    n_preserve = round((T - 1) * preserve_ratio)
    n_tome = T - 1 - n_preserve
    if n_tome <= 0:
        raise ValueError("nothing to merge; lower preserve_ratio")
    order = torch.argsort(-sim.mean(1)[:, 1:], dim=-1, stable=True)  # (N, T-1)
    x_sorted = _take_rows(x[:, 1:], order)
    x_preserve, x_tome = x_sorted[:, :n_preserve], x_sorted[:, n_preserve:]
    sim_s = torch.gather(sim[:, 1:, 1:], 1, order[:, :, None].expand(N, T - 1, T - 1))
    sim_s = torch.gather(sim_s, 2, order[:, None, :].expand(N, T - 1, T - 1))
    sim_tome = sim_s[:, n_preserve:, n_preserve:]

    n_src = math.floor(merge_ratio * n_tome)
    n_dst = max(1, n_tome - n_src)
    n_src = n_tome - n_dst
    if n_src == 0:
        merged = torch.cat([x[:, :1], x_preserve, x_tome], dim=1)
        node_idx = torch.zeros((N, 0), dtype=torch.long, device=x.device)
        return merged, TomeState(order, node_idx, n_preserve, 0, n_dst)
    src, dst = x_tome[:, :n_src], x_tome[:, n_src:]
    scores = sim_tome[:, :n_src, n_src:] + sim_tome[:, n_src:, :n_src].transpose(-1, -2)
    node_idx = torch.argmax(scores, dim=-1)  # (N, n_src), into the destinations
    # scatter-mean, each destination counting itself once
    sums = dst.scatter_add(1, node_idx[..., None].expand(N, n_src, E), src)
    counts = torch.ones((N, n_dst), dtype=dst.dtype, device=x.device).scatter_add(
        1, node_idx, torch.ones((N, n_src), dtype=dst.dtype, device=x.device))
    merged = torch.cat([x[:, :1], x_preserve, sums / counts[..., None]], dim=1)
    return merged, TomeState(order, node_idx, n_preserve, n_src, n_dst)


def tome_unmerge(x: torch.Tensor, state: TomeState) -> torch.Tensor:
    """Invert the merge: each destination copied back to its sources, then
    the significance sort undone. x (N, 1 + n_preserve + n_dst, E) ->
    (N, T, E)."""
    N, _, E = x.shape
    x_sorted = x[:, 1:]
    x_preserve, dst = x_sorted[:, :state.n_preserve], x_sorted[:, state.n_preserve:]
    tome = torch.cat([_take_rows(dst, state.node_idx), dst], dim=1) if state.n_src else dst
    full = torch.cat([x_preserve, tome], dim=1)
    idx = state.sort_idx
    unsorted = torch.zeros((N, idx.shape[1], E), dtype=x.dtype, device=x.device).scatter(
        1, idx[..., None].expand(*idx.shape, E), full)
    return torch.cat([x[:, :1], unsorted], dim=1)
