"""Fused block-sparse SEA attention (PyTorch port, Hopper kernels).

Port of `sea_tpu/ops/kernels/block_sparse.py`: the forward
`sea_block_sparse_attention`, causal (Pallas kernel `_causal_kernel_flat`,
and by `impl=` its variants `_causal_kernel_flat_wr`,
`_causal_kernel_flat_fori` and `_causal_kernel` 'subtile') and padded
bidirectional (`_kernel`), and the differentiable causal
`fused_sparse_attention` (`_causal_kernel_fwd_stats`, `_causal_kernel_dq`,
`_causal_kernel_dkv`). The forward computes, for every (batch·head, query
row r):

    out[r] = scaler[r] · softmax over alive s of (q_r · k_s) · v_s

Column s of row r is alive iff s < w_r and the compressed (T_M-wide) mask
has bit pixel(r, s) = clip(floor((s + 0.5) / w_r · T_M − 1e-4), 0, T_M − 1)
(the dense-resize floor rule). Causal rows have width w_r = r + 1; the
padded bidirectional path gives every row of example n the width
lengths[n], its token count (right padding), and T_SRC without `lengths`.
Rows with no alive column give 0. With `oversample != 1` (causal only) the
train path's undersampling keep-predicate also applies, and `row_base`
shifts each q-block's rows to global positions.

Layout of this module:

  * prep, plain PyTorch on the tensors' device (it was XLA-side in JAX):
    `pack_compressed_bits`, `_pixel_starts`, `_causal_activity`,
    `_length_activity`, `_compact_lists`, `tile_activity_lists`, and for the
    impl variants `_tile_word_ranges`, `tile_activity_sub` and `impl_tiles`.
    The tile lists are a conservative superset of the (q-block, k-block)
    tiles with an alive column; the kernel still applies the element
    predicate on every tile;
  * oracles: `element_mask_int8`, `mask_nnz`, `dense_reference`. The last
    is also the kernel's plain version, which the wrapper runs for tensors
    on the CPU; for the impl variants, `alive_from_operands` (the element
    mask a variant sees on its operands) and `impl_reference` (the softmax
    over it, their plain version);
  * the wrapper `sea_block_sparse_attention`, which on a CUDA tensor
    launches one of the hand-written kernels in `csrc/block_sparse_causal.cu`
    (K1 causal, `launch_causal_flat`; by `impl`, K9a-c through the wrappers
    of `IMPL_KERNELS`; K5 padded bidirectional, `bidir_forward`) or raises, and `alive_mask`, which
    launches a kernel's element predicate alone (with `impl`, the variant's
    restricted one on its own tile lists) so that the card can check it bit
    for bit;
  * the differentiable path: `kernel_operands(..., differentiable=True)`
    (the port of `_diff_prep`, with the transposed tile lists), the plain
    versions `fwd_with_stats_reference`, `dq_reference` and `dkv_reference`,
    the kernel wrappers `causal_fwd_stats` (K2, `csrc/block_sparse_causal.cu`),
    `causal_dq` (K3) and `causal_dkv` (K4, both `csrc/block_sparse_diff.cu`),
    and `FusedSparseAttention` / `fused_sparse_attention`, whose backward
    computes `backward_terms` in plain PyTorch and then launches K3 and K4.
    The logsumexp and delta stay (N, H, T): the TPU's 128-lane broadcast of
    them is dropped;
  * the ring's windowed kernels (`fwd_stats_window`, `dq_window`,
    `dkv_window` in JAX): `window_operands` (the port of `_ring_shared_prep`
    with every window's tile lists built in one batched `_compact_lists`
    call), the plain versions `fwd_stats_window_reference`,
    `dq_window_reference` and `dkv_window_reference`, and the wrappers
    `fwd_stats_window` (K6, `csrc/block_sparse_causal.cu`), `dq_window` (K7)
    and `dkv_window` (K8, both `csrc/block_sparse_diff.cu`). A window is the
    K/V of S consecutive global columns col0 .. col0 + CH − 1; its pixel and
    causal math use global columns. `parallel/sharded_attention.py` merges
    the windows.

Each wrapper counts its kernel launches in a `launches` attribute; K1-K4's
and K6-K8's also count those of their bfloat16 instance in `bf16_launches`.
The kernels take the head widths of `HEAD_DIMS`: 64 and 80 (OPT-2.7b) on the
causal forward and the differentiable path, 64 elsewhere.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

NEG_INF = -1e30
KERNEL_TILE = 64  # rows and columns of the CUDA kernel's tile
MAX_WORDS = 16  # packed mask words per row the kernel holds (T_M <= 512)
# the head widths each route's kernels are built for: the causal forward
# (K1) and the differentiable path (K2-K4); the padded bidirectional forward
# (K5), the impl variants (K9a-c) and the ring's windows (K6-K8). Any other
# width is ROADMAP queue 2 item 6.
HEAD_DIMS = {"causal": (64, 80), "bidirectional": (64,), "impl": (64,), "window": (64,)}
KERNEL_DTYPES = (torch.float32, torch.bfloat16)  # q, k, v and the outputs
SUB_BLOCK = 128  # 'subtile' piece width, min(SUB_BLOCK, block_k) (the JAX default)


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b as a true IEEE division. Dividing a CUDA tensor by a Python
    number multiplies by the reciprocal instead, which can miss the quotient
    by one ulp and move a pixel boundary."""
    if not torch.is_tensor(b):
        b = torch.full_like(a, float(b))
    return a / b


# ---------------------------------------------------------------------------
# Prep — everything O(T · T_M), no dense T x T tensors.
# ---------------------------------------------------------------------------


def pack_compressed_bits(mask_m: torch.Tensor) -> torch.Tensor:
    """(N, H, T_DST, T_M) binary mask -> (N, H, T_DST, ceil(T_M/32)) int32
    holding the uint32 bit patterns (bit b of word w is pixel 32·w + b;
    zero-padded to a whole word)."""
    N, H, T, T_M = mask_m.shape
    pad = (-T_M) % 32
    m = (mask_m > 0).to(torch.int64)
    if pad:
        m = F.pad(m, (0, pad))
    bit_w = torch.ones(32, dtype=torch.int64, device=m.device) << torch.arange(
        32, device=m.device
    )
    words = (m.reshape(N, H, T, (T_M + pad) // 32, 32) * bit_w).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def _pixel_starts(widths: torch.Tensor, t_m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive run starts / exclusive ends of each compressed pixel under
    the dense-resize floor rule. widths: (R,) float; returns (vs, ve), each
    (R, T_M) int32 columns clipped to [0, w)."""
    b = torch.arange(t_m + 1, dtype=torch.float32, device=widths.device)[None, :]
    w = widths[:, None]
    bounds = torch.ceil(_div((b + 1e-4) * w, t_m) - 0.5).to(torch.int32)
    bounds = torch.minimum(torch.clamp(bounds, min=0), w.to(torch.int32))
    return bounds[:, :-1], bounds[:, 1:]


def _causal_activity(
    mask_m: torch.Tensor,
    t_src: int,
    block_q: int,
    block_k: int,
    row_widths: Optional[torch.Tensor] = None,
    row_chunk: int = 512,
) -> torch.Tensor:
    """(N, H, NQ, NKB) bool: the q-block x k-block tile has an alive column
    (conservative superset from compressed-domain interval overlap)."""
    N, H, T_DST, T_M = mask_m.shape
    NQ, NKB = T_DST // block_q, t_src // block_k
    dev = mask_m.device
    m = (mask_m > 0).reshape(N * H, T_DST, T_M).to(torch.float32)

    if row_widths is not None:
        widths = row_widths.to(torch.float32)
    else:
        widths = torch.arange(T_DST, dtype=torch.float32, device=dev) + 1.0
    vs, ve = _pixel_starts(widths, T_M)
    lo_blk = torch.clamp(vs - 1, min=0) // block_k
    hi_blk = torch.minimum(ve, widths.to(torch.int32)[:, None] - 1) // block_k
    nonempty = ve > vs

    j_ids = torch.arange(NKB, dtype=torch.int32, device=dev)
    act = torch.empty((N * H, T_DST, NKB), dtype=torch.bool, device=dev)
    for r0 in range(0, T_DST, row_chunk):
        sl = slice(r0, min(r0 + row_chunk, T_DST))
        inside = (
            (j_ids[None, None, :] >= lo_blk[sl, :, None])
            & (j_ids[None, None, :] <= hi_blk[sl, :, None])
            & nonempty[sl, :, None]
        )  # (RC, T_M, NKB)
        act[:, sl] = torch.einsum(
            "nrb,rbj->nrj", m[:, sl], inside.to(torch.float32)
        ) > 0
    return act.reshape(N, H, NQ, block_q, NKB).any(dim=3)


def _length_activity(
    mask_m: torch.Tensor, t_src: int, block_q: int, block_k: int,
    lengths: torch.Tensor,
) -> torch.Tensor:
    """(N, H, NQ, NKB) bool for the padded bidirectional path: every row of
    example n has width lengths[n]. Unchunked: the pixel runs depend on the
    example only, so the work is (N, T_M, NKB) plus one product."""
    N, H, T_DST, T_M = mask_m.shape
    NQ, NKB = T_DST // block_q, t_src // block_k
    vs, ve = _pixel_starts(lengths.to(torch.float32), T_M)  # (N, T_M)
    lo = torch.clamp(vs - 1, min=0) // block_k
    hi = torch.minimum(ve, lengths.to(torch.int32)[:, None] - 1) // block_k
    j_ids = torch.arange(NKB, dtype=torch.int32, device=mask_m.device)
    inside = (
        (j_ids[None, None, :] >= lo[:, :, None])
        & (j_ids[None, None, :] <= hi[:, :, None])
        & (ve > vs)[:, :, None]
    )  # (N, T_M, NKB)
    act = torch.einsum(
        "nhrb,nbj->nhrj", (mask_m > 0).to(torch.float32), inside.to(torch.float32)
    ) > 0
    return act.reshape(N, H, NQ, block_q, NKB).any(dim=3)


def _compact_lists(act: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """act (..., NKB) bool -> (counts, idx): the active indices ascending,
    padded by repeating the last active one."""
    NKB = act.shape[-1]
    counts = act.sum(-1).to(torch.int32)
    order = torch.sort(
        torch.where(act, 0, 1).to(torch.int32), dim=-1, stable=True
    ).indices.to(torch.int32)
    ar = torch.arange(NKB, dtype=torch.int32, device=act.device)
    within = ar < torch.clamp(counts, min=1)[..., None]
    idx = torch.where(within, order, torch.zeros_like(order))
    last = torch.gather(idx, -1, torch.clamp(counts - 1, min=0)[..., None].long())
    idx = torch.where(within, idx, last)
    return counts, idx


def tile_activity_sub(
    mask_m: torch.Tensor,
    t_src: int,
    block_q: int,
    block_ko: int,
    sub: int,
    row_widths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal activity at `sub` granularity grouped under `block_ko` outer
    k-blocks (impl 'subtile'). Returns (counts (N, H, NQ), idx (N, H, NQ,
    NKO), submask (N, H, NQ, NKO) int32 bitmask of the active sub-pieces,
    aligned with idx; bit 31 wraps to the sign, as in the JAX package)."""
    spb = block_ko // sub
    act = _causal_activity(mask_m, t_src, block_q, sub, row_widths)  # (..., NKBi)
    N, H, NQ, NKBi = act.shape
    grouped = act.reshape(N, H, NQ, NKBi // spb, spb)
    weights = torch.ones(spb, dtype=torch.int64, device=act.device) << torch.arange(
        spb, device=act.device)
    bits = (grouped.to(torch.int64) * weights).sum(-1)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)
    counts, idx = _compact_lists(grouped.any(-1))
    submask = torch.gather(bits, -1, idx.long())
    return counts, idx, submask


def _tile_word_ranges(
    idx: torch.Tensor,  # (..., NQ, NKB) active k-block list
    t_m: int,
    n_words: int,
    block_q: int,
    block_k: int,
    row_widths: Optional[torch.Tensor] = None,  # (T_DST,) causal widths
) -> torch.Tensor:
    """Packed per-tile word ranges wlo | whi << 8 | exact << 16, aligned with
    `idx` (impls 'flat_wr' and 'flat_fori'). The JAX package's corner
    evaluation of the TPU kernel's pixel expression (c·a + (a/2 − 1e-4),
    a = T_M/w; monotone in the column and the width), padded by one pixel
    each side: that padding also covers the few-ulp gap to the division form
    the port's kernels use. `exact`: no pixel was clipped into whi from above
    (a tile across the causal edge has pixels past T_M and is never exact)."""
    NQ = idx.shape[-2]
    dev = idx.device
    if row_widths is None:
        widths = torch.arange(NQ * block_q, dtype=torch.float32, device=dev) + 1.0
    else:
        widths = row_widths.to(device=dev, dtype=torch.float32)
    w_rows = widths.reshape(NQ, block_q)
    w_min = w_rows.min(dim=1).values[:, None]  # (NQ, 1) narrowest row of the block
    w_max = w_rows.max(dim=1).values[:, None]

    c0 = (idx * block_k).to(torch.float32)
    c1 = c0 + float(block_k) - 1.0

    def pix(c, w):
        a = _div(torch.ones_like(w), w) * float(t_m)
        return (c * a + (a * 0.5 - 1e-4)).to(torch.int32)  # truncation, as astype

    lo = pix(c0, w_max)
    hi = pix(c1, w_min)
    wlo = torch.clamp((lo - 1) >> 5, 0, n_words - 1)
    whi = torch.clamp((hi + 1) >> 5, 0, n_words - 1)
    exact = ((hi + 1) >> 5) == whi
    return (wlo | (whi << 8) | (exact.to(torch.int32) << 16)).to(torch.int32)


def tile_activity_lists(
    mask_m: torch.Tensor,
    t_src: int,
    is_causal: bool,
    block_q: int,
    block_k: int,
    row_chunk: int = 512,
    lengths: Optional[torch.Tensor] = None,  # (N,) non-causal token lengths
    row_widths: Optional[torch.Tensor] = None,  # (T_DST,) causal widths override
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (n, h, q-block): ascending list of active k-block indices from
    compressed-domain interval overlap (a conservative superset: run bounds
    are padded by one column against boundary rounding).

    Returns (counts (N, H, NQ) int32, idx (N, H, NQ, NKB) int32)."""
    T_DST = mask_m.shape[2]
    if not is_causal and lengths is not None:
        return _compact_lists(_length_activity(mask_m, t_src, block_q, block_k, lengths))
    if not is_causal:
        row_widths = torch.full((T_DST,), float(t_src), device=mask_m.device)
    act = _causal_activity(mask_m, t_src, block_q, block_k, row_widths, row_chunk)
    return _compact_lists(act)


# ---------------------------------------------------------------------------
# Oracles and the kernel's plain version
# ---------------------------------------------------------------------------


def _pixels(s_idx: torch.Tensor, w: torch.Tensor, t_m: int) -> torch.Tensor:
    """pixel = floor((s + 0.5) / w · T_M − 1e-4), clipped to [0, T_M)."""
    pixel = torch.floor((s_idx + 0.5) / w * t_m - 1e-4).to(torch.int64)
    return torch.clamp(pixel, 0, t_m - 1)


def element_mask_int8(
    mask_m: torch.Tensor,
    t_src: int,
    is_causal: bool,
    row_chunk: int = 256,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Materialised (N, H, T_DST, T_SRC) int8 alive mask (dense-resize rule
    plus causality; or, non-causal with `lengths` (N,), example n's width
    lengths[n] and s < lengths[n]). O(T²): for tests and checks only."""
    N, H, T_DST, T_M = mask_m.shape
    dev = mask_m.device
    m = mask_m > 0
    s_idx = torch.arange(t_src, dtype=torch.float32, device=dev)[None, :]
    out = torch.empty((N, H, T_DST, t_src), dtype=torch.int8, device=dev)
    for r0 in range(0, T_DST, row_chunk):
        rows = torch.arange(r0, min(r0 + row_chunk, T_DST), device=dev)
        if is_causal:
            w = (rows + 1).to(torch.float32)[:, None]
        elif lengths is not None:
            w = lengths.to(device=dev, dtype=torch.float32).reshape(N, 1, 1, 1)
        else:
            w = torch.full((rows.numel(), 1), float(t_src), device=dev)
        pixel = _pixels(s_idx, w, T_M).expand(N, H, rows.numel(), t_src)
        # s < w: s <= r when causal; no-op at the full width
        alive = torch.gather(m[:, :, rows], -1, pixel) & (s_idx < w)
        out[:, :, rows] = alive.to(torch.int8)
    return out


def mask_nnz(mask_m: torch.Tensor, t_src: int, is_causal: bool,
             lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Realized element-mask nnz, computed in the compressed domain: the sum
    over alive pixels of their run length (non-causal `lengths` (N,): runs
    of example n's width)."""
    T_DST, T_M = mask_m.shape[2], mask_m.shape[3]
    if lengths is not None and not is_causal:
        vs, ve = _pixel_starts(lengths.to(device=mask_m.device, dtype=torch.float32), T_M)
        run = torch.clamp(ve - vs, min=0).to(torch.int64)[:, None, None, :]
    else:
        rows = torch.arange(T_DST, dtype=torch.float32, device=mask_m.device)
        widths = rows + 1.0 if is_causal else torch.full_like(rows, float(t_src))
        vs, ve = _pixel_starts(widths, T_M)
        run = torch.clamp(ve - vs, min=0).to(torch.int64)[None, None]
    return ((mask_m > 0).to(torch.int64) * run).sum()


def _dense_widths(t_dst: int, t_src: int, is_causal: bool,
                  row_widths: Optional[torch.Tensor], device,
                  lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float32 width of each row: (N, 1, 1, 1) `lengths` (non-causal only),
    else (T_DST, 1): `row_widths` if given, else r + 1 (causal) or T_SRC."""
    if lengths is not None and not is_causal:
        return lengths.to(device=device, dtype=torch.float32).reshape(-1, 1, 1, 1)
    if row_widths is not None:
        return row_widths.to(device=device, dtype=torch.float32).reshape(t_dst, 1)
    if is_causal:
        return torch.arange(1, t_dst + 1, dtype=torch.float32, device=device)[:, None]
    return torch.full((t_dst, 1), float(t_src), device=device)


def _alive_dense(mask_m: torch.Tensor, t_src: int, w: torch.Tensor,
                 col0: int = 0) -> torch.Tensor:
    """(N, H, T_DST, T_SRC) bool element mask of the dense-resize rule for
    the row widths `w` of `_dense_widths`; every row keeps s < w only (s <= r
    when causal, s < lengths[n] with lengths, nothing dropped at T_SRC).
    `col0` shifts the columns to the global ids col0 .. col0 + T_SRC − 1 (a
    K/V window of the ring)."""
    N, H, T_DST, T_M = mask_m.shape
    s_idx = torch.arange(col0, col0 + t_src, dtype=torch.float32,
                         device=mask_m.device)[None, :]
    pixel = _pixels(s_idx, w, T_M).expand(N, H, T_DST, t_src)
    return torch.gather(mask_m > 0, -1, pixel) & (s_idx < w)


def dense_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask_m: torch.Tensor,
    row_scaler: Optional[torch.Tensor] = None,
    *,
    is_causal: bool = True,
    lengths: Optional[torch.Tensor] = None,
    oversample: float = 1.0,
    k_cfg: float = 64.0,
    row_widths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version of the kernels (K1 causal, K5 non-causal):
    dense-resize element mask, per-row masked softmax, optional
    undersampling keep-predicate, row scaler. O(T²) memory. `row_widths`
    (T_DST,) overrides each row's causal width (default r + 1), as
    `row_base` does in the kernel; non-causal `lengths` (N,) gives example
    n's rows the width lengths[n] and keeps s < lengths[n] only."""
    T_SRC = k.shape[2]
    w = _dense_widths(q.shape[2], T_SRC, is_causal, row_widths, q.device, lengths)
    alive = _alive_dense(mask_m, T_SRC, w)
    if oversample != 1.0:
        alive = alive & _keep_dense(w, T_SRC, oversample, k_cfg)
    out, _, _ = _softmax_pv(q, k, v, alive, row_scaler)
    return out.to(q.dtype)


def _dense_tiles(counts: torch.Tensor, idx: torch.Tensor, aux: torch.Tensor,
                 fill: int) -> torch.Tensor:
    """(..., NQ, NKB) int32: each listed tile's `aux` entry (its word range
    or piece bitmask) at its k-block, `fill` where a tile is not listed."""
    NKB = idx.shape[-1]
    # one spare column takes the list's padding slots, then is dropped
    dense = torch.full((*idx.shape[:-1], NKB + 1), fill, dtype=torch.int32,
                       device=idx.device)
    listed = torch.arange(NKB, device=idx.device) < counts[..., None]
    dense.scatter_(-1, torch.where(listed, idx, NKB).long(), aux.to(torch.int32))
    return dense[..., :NKB]


def _restricted_alive(mbits, counts, idx, aux, row_widths, t_src: int, t_m: int,
                      block_q: int, block_k: int, sub: int, impl: str) -> torch.Tensor:
    """(NH, T_DST, T_SRC) bool, the body of `alive_from_operands`: mbits
    (NH, T_DST, n_words), counts (NH, NQ), idx and aux (NH, NQ, NKB),
    row_widths (T_DST,) float32."""
    NH, T_DST, _ = mbits.shape
    dev = mbits.device
    w = row_widths.to(device=dev, dtype=torch.float32)[:, None]
    s_idx = torch.arange(t_src, dtype=torch.float32, device=dev)[None, :]
    pix = _pixels(s_idx, w, t_m)  # (T_DST, T_SRC)
    wi = (pix >> 5).to(torch.int32)
    words = torch.gather(mbits, -1, (pix >> 5).expand(NH, T_DST, t_src))
    alive = ((words >> (pix & 31).to(torch.int32)) & 1).bool() & (s_idx < w)
    # each element's tile: rows by q-block, columns by k-block
    qb = torch.arange(T_DST, device=dev) // block_q
    kb = torch.arange(t_src, device=dev) // block_k

    def per_element(dense):
        return dense[:, qb][:, :, kb]  # (NH, T_DST, T_SRC)

    if impl == "flat":
        keep = per_element(_dense_tiles(counts, idx, torch.ones_like(idx), 0)) > 0
    elif impl in ("flat_wr", "flat_fori"):
        wr = per_element(_dense_tiles(counts, idx, aux, -1))
        keep = (wr >= 0) & (wi >= (wr & 0xFF)) & (wi <= ((wr >> 8) & 0xFF))
    elif impl == "subtile":
        piece = ((torch.arange(t_src, device=dev) % block_k) // sub).to(torch.int32)
        # an arithmetic shift: bit 31 still lands in bit 0
        keep = ((per_element(_dense_tiles(counts, idx, aux, 0)) >> piece) & 1).bool()
    else:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    return alive & keep


def alive_from_operands(ops: "KernelOperands", impl: str) -> torch.Tensor:
    """(N, H, T_DST, T_SRC) bool: the element mask that impl `impl`'s kernel
    sees on these operands: the oracle's bits, read from the packed words
    `mbits` at the oracle's pixel, causal, on listed tiles only; then
    'flat_wr' and 'flat_fori' keep a column only if its word lies in its
    tile's range, and 'subtile' only if its piece is active. A list, range or
    piece mask that dropped an alive element makes this differ from
    `element_mask_int8`."""
    N, H, T_DST, _ = ops.shape
    alive = _restricted_alive(ops.mbits, ops.counts, ops.idx, ops.tile_aux,
                              _row_widths(ops.row_base, ops.block_q), ops.k.shape[1],
                              ops.t_m, ops.block_q, ops.block_k, ops.sub, impl)
    return alive.reshape(N, H, T_DST, -1)


def _row_widths(row_base: torch.Tensor, block_q: int) -> torch.Tensor:
    """(T_DST,) float32 causal width of each row of the q-blocks based at
    `row_base` (NQ,): base + local row + 1."""
    local = torch.arange(block_q, dtype=torch.int32, device=row_base.device)
    return (row_base[:, None] + local[None, :] + 1).reshape(-1).to(torch.float32)


def impl_reference(ops: "KernelOperands", impl: str) -> torch.Tensor:
    """The plain version of impl `impl`'s kernel on its operands: the
    softmax of `dense_reference` over `alive_from_operands`, with the
    undersampling keep-predicate and the row scaler. (N, H, T_DST, D) in
    q's dtype."""
    shape = ops.shape
    q, k, v = (x.reshape(shape[0], shape[1], -1, shape[3]) for x in (ops.q, ops.k, ops.v))
    alive = alive_from_operands(ops, impl)
    w = _row_widths(ops.row_base, ops.block_q)[:, None]
    if ops.oversample != 1.0:
        alive = alive & _keep_dense(w, k.shape[2], ops.oversample, ops.k_cfg)
    out, _, _ = _softmax_pv(q, k, v, alive, ops.scaler.reshape(shape[:3]))
    return out.to(q.dtype)


def _keep_dense(w: torch.Tensor, t_src: int, oversample: float, k_cfg: float):
    """The undersampling keep-predicate (the train path's, reference
    `resize_m_to_t.py:54-71`) for row widths `w` over t_src columns."""
    s_idx = torch.arange(t_src, dtype=torch.float32, device=w.device)[None, :]
    ps = torch.clamp(torch.floor(_div(w, oversample) + 0.5), min=1.0)
    oys = _div(torch.clamp(w, round(k_cfg), round(k_cfg * oversample)), k_cfg)
    frac = (s_idx + 1) / w * ps
    thr = _div(torch.ones_like(oys), oys) * 0.5 + 1e-4
    return torch.abs(frac - torch.floor(frac + 0.5)) <= thr


def _softmax_pv(q, k, v, alive, scaler):
    """Per-row softmax of q·kᵀ over `alive`, times v and the row scaler (if
    any), in float32; also the row max m and row sum l, each (..., 1)."""
    scores = torch.einsum("nhtd,nhsd->nhts", q.float(), k.float())
    scores = torch.where(alive, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(-1, keepdim=True)
    p = torch.where(alive, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(-1, keepdim=True)
    p = p / torch.where(l > 0, l, torch.ones_like(l))
    out = torch.einsum("nhts,nhsd->nhtd", p, v.float())
    if scaler is not None:
        out = out * scaler.float()[..., None]
    return out, m, l


# ---------------------------------------------------------------------------
# The kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _bound(name: str, argtypes: dict) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu` with its C functions' signatures set
    (every function returns a CUDA error code)."""
    lib = _build.load(name)
    if not getattr(lib, "_sea_bound", False):
        for fn, args in argtypes.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = _I
        lib._sea_bound = True
    return lib


def _lib() -> ctypes.CDLL:
    return _bound("block_sparse_causal", {
        "sea_causal_flat_forward": [_P] * 9 + [_I] * 10 + [_F] * 4 + [_I, _P],
        "sea_causal_fwd_stats": [_P] * 10 + [_I] * 11 + [_P],
        "sea_window_fwd_stats": [_P] * 9 + [_I] * 12 + [_P],
        "sea_bidir_forward": [_P] * 9 + [_I] * 10 + [_I, _P],
        "sea_alive_mask": [_P, _P] + [_I] * 5 + [_P],
        "sea_bidir_alive_mask": [_P, _P, _P] + [_I] * 5 + [_P],
        **dict.fromkeys((v.entry for v in IMPL_KERNELS.values()), [_P] * 10 + [_I] * 11 + [_F] * 4 + [_I, _P]),
        "sea_impl_alive_mask": [_P] * 3 + [_I] * 9 + [_P],
        "sea_quot_check": [_I, _P, _P],
    })


def _diff_lib() -> ctypes.CDLL:
    return _bound("block_sparse_diff", {
        "sea_causal_dq": [_P] * 11 + [_I] * 11 + [_P],
        "sea_causal_dkv": [_P] * 12 + [_I] * 11 + [_P],
        "sea_window_dq": [_P] * 11 + [_I] * 12 + [_P],
        "sea_window_dkv": [_P] * 12 + [_I] * 12 + [_P],
    })


def _count(wrapper, q: torch.Tensor):
    """One launch of `wrapper`'s kernel: `launches` counts every launch,
    `bf16_launches` those of its bfloat16 instance (K1-K4 and K6-K8 have
    both)."""
    wrapper.launches += 1
    wrapper.bf16_launches += int(q.dtype == torch.bfloat16)


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _check_head_dim(D: int, route: str, what: str = "kernel"):
    widths = HEAD_DIMS[route]
    if D not in widths:
        raise ValueError(f"{what}: the {route} kernels take head_dim "
                         f"{' or '.join(map(str, widths))}, got {D} (other head widths: "
                         "ROADMAP queue 2 item 6)")


def _require_cuda(t: torch.Tensor, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors must be on the CPU (plain version) "
                         f"or on a CUDA device (kernel), got {t.device}")


class KernelInputs(NamedTuple):
    """The wrapper's inputs, padded to a multiple of 128 rows, with the
    q-block geometry and the non-causal lengths resolved."""

    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    mask_m: torch.Tensor
    scaler: torch.Tensor  # (N, H, T_DST) in q's dtype
    row_base: torch.Tensor  # (NQ,) int32 global base row of each q-block
    row_widths: Optional[torch.Tensor]  # (T_DST,) causal widths, row_base only
    block_q: int
    block_k: int
    t_dst0: int  # rows before padding
    is_causal: bool = True
    lengths: Optional[torch.Tensor] = None  # (N,) int32 widths, non-causal only


class KernelOperands(NamedTuple):
    """Everything a kernel launch reads besides the backward's per-call
    tensors (dou, lse, delta), laid out as the kernels take it."""

    q: torch.Tensor  # (NH, T_DST, D)
    k: torch.Tensor  # (NH, T_SRC, D)
    v: torch.Tensor
    mbits: torch.Tensor  # (NH, T_DST, n_words) int32 bit patterns
    scaler: torch.Tensor  # (NH, T_DST) float32
    counts: torch.Tensor  # (NH, NQ) int32: active k-blocks per q-block
    idx: torch.Tensor  # (NH, NQ, NKB) int32
    counts_t: Optional[torch.Tensor]  # (NH, NKB) int32: active q-blocks per k-block
    idx_t: Optional[torch.Tensor]  # (NH, NKB, NQ) int32; both differentiable path only
    row_base: torch.Tensor  # (NQ,) int32
    lengths: Optional[torch.Tensor]  # (NH,) int32 row widths, non-causal only
    shape: Tuple[int, int, int, int]  # (N, H, T_DST, D)
    t_m: int
    block_q: int
    block_k: int
    oversample: float
    k_cfg: float
    # impls 'flat_wr'/'flat_fori': each listed tile's word range; 'subtile':
    # its bitmask of active `sub`-wide pieces; (NH, NQ, NKB) int32 beside idx
    tile_aux: Optional[torch.Tensor] = None
    impl: str = "flat"
    sub: int = 0  # 'subtile' only: the piece width


# the fields of KernelOperands that hold tensors
OPERAND_TENSORS = ("q", "k", "v", "mbits", "scaler", "counts", "idx", "counts_t",
                   "idx_t", "row_base", "lengths", "tile_aux")


def prepare_inputs(
    q, k, v, mask_m, row_scaler=None, *, is_causal=True, lengths=None, row_base=None,
    block_q=None, block_k=None,
) -> KernelInputs:
    """Pad T to a multiple of 128 (padded rows have empty masks) and resolve
    the q-block geometry, the row bases and the scaler; non-causal, also the
    per-example widths (`lengths`, default the unpadded T_SRC)."""
    N, H, T_DST0, D = q.shape
    T_SRC0 = k.shape[2]
    T_DST = -(-T_DST0 // 128) * 128
    T_SRC = -(-T_SRC0 // 128) * 128
    if is_causal and lengths is not None:
        raise ValueError("lengths are the non-causal path's widths")
    if not is_causal and row_base is not None:
        raise ValueError("row_base is causal only")
    if T_DST != T_DST0 or T_SRC != T_SRC0:
        if row_base is not None:
            raise ValueError("row_base requires pre-padded shards")
        q = F.pad(q, (0, 0, 0, T_DST - T_DST0))
        k = F.pad(k, (0, 0, 0, T_SRC - T_SRC0))
        v = F.pad(v, (0, 0, 0, T_SRC - T_SRC0))
        mask_m = F.pad(mask_m, (0, 0, 0, T_DST - T_DST0))
        if row_scaler is not None:
            row_scaler = F.pad(row_scaler, (0, T_DST - T_DST0))

    block_q = block_q or KERNEL_TILE
    block_k = block_k or KERNEL_TILE
    if T_DST % block_q or T_SRC % block_k:
        raise ValueError(f"T ({T_DST}, {T_SRC}) must be a multiple of the "
                         f"blocks ({block_q}, {block_k})")
    NQ = T_DST // block_q
    if row_base is None:
        row_base_arr = torch.arange(NQ, dtype=torch.int32, device=q.device) * block_q
        row_widths = None
    else:
        row_base_arr = row_base.to(device=q.device, dtype=torch.int32)
        rw = row_base_arr[:, None] + torch.arange(
            block_q, dtype=torch.int32, device=q.device
        )[None, :]
        row_widths = (rw + 1).reshape(-1).to(torch.float32)
    if row_scaler is None:
        row_scaler = torch.ones((N, H, T_DST), dtype=q.dtype, device=q.device)
    if not is_causal:
        if lengths is None:
            lengths = torch.full((N,), T_SRC0, dtype=torch.int32)
        lengths = lengths.to(device=q.device, dtype=torch.int32)
        if lengths.shape != (N,):
            raise ValueError(f"lengths must be ({N},), got {tuple(lengths.shape)}")
    return KernelInputs(
        q, k, v, mask_m, row_scaler.to(q.dtype), row_base_arr, row_widths,
        block_q, block_k, T_DST0, is_causal, lengths,
    )


def impl_tiles(mask_m: torch.Tensor, t_src: int, impl: str, block_q: int, block_k: int,
               sub: int = 0, row_widths: Optional[torch.Tensor] = None):
    """The causal tile lists of impl `impl`: (counts (N, H, NQ), idx (N, H,
    NQ, NKB), aux) with aux None for 'flat', each listed tile's word range
    for 'flat_wr'/'flat_fori' (`_tile_word_ranges`), and for 'subtile' the
    outer lists at `block_k` with their active `sub`-wide pieces
    (`tile_activity_sub`)."""
    check_impl(impl, block_k, sub)
    if impl == "subtile":
        return tile_activity_sub(mask_m, t_src, block_q, block_k, sub, row_widths)
    counts, idx = _compact_lists(
        _causal_activity(mask_m, t_src, block_q, block_k, row_widths))
    if impl == "flat":
        return counts, idx, None
    n_words = (mask_m.shape[-1] + 31) // 32
    return counts, idx, _tile_word_ranges(idx, mask_m.shape[-1], n_words, block_q,
                                          block_k, row_widths)


def check_impl(impl: str, block_k: int, sub: int = 0):
    """Refuse an unknown impl, and for 'subtile' a piece width the kernel
    does not take: a multiple of the 64-column sub-tile, dividing block_k,
    at most 32 pieces a block (one int32 bitmask)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    if impl == "subtile" and (sub <= 0 or sub % KERNEL_TILE or block_k % sub
                              or block_k // sub > 32):
        raise ValueError(f"subtile: sub {sub} must be a multiple of {KERNEL_TILE} "
                         f"dividing block_k {block_k} at most 32 times")


def kernel_operands(x: KernelInputs, oversample: float = 1.0, k_cfg: float = 64.0,
                    *, differentiable: bool = False, impl: str = "flat",
                    sub: int = 0) -> KernelOperands:
    """Check what the kernels take, then build their operands on the inputs'
    device: the packed mask bits and the tile lists (per-example widths on
    the non-causal path). `differentiable` builds those of the causal
    differentiable path (the port of `_diff_prep`): causal only, plus the
    transposed (per-k-block) lists that the dk/dv kernel walks. Both take
    float32 or bfloat16. `impl` (causal forward only) builds the lists of
    K9a-c beside: `impl_tiles`."""
    q, k, v, mask_m = x.q, x.k, x.v, x.mask_m
    N, H, T_DST, D = q.shape
    T_SRC = k.shape[2]
    T_M = mask_m.shape[-1]
    n_words = (T_M + 31) // 32
    NH = N * H
    NQ, NKB = T_DST // x.block_q, T_SRC // x.block_k
    if differentiable and not x.is_causal:
        raise ValueError("the differentiable path is causal only")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"kernel takes {' or '.join(map(str, KERNEL_DTYPES))}, got {q.dtype}")
    for other in (k, v, mask_m, x.scaler):
        if other.device != q.device:
            raise ValueError("all inputs must be on one device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    _check_head_dim(D, "bidirectional" if not x.is_causal else
                    "impl" if impl != "flat" else "causal")
    if n_words > MAX_WORDS:
        raise ValueError(f"kernel takes T_M <= {32 * MAX_WORDS}, got {T_M}")
    if x.block_q % KERNEL_TILE or x.block_k % KERNEL_TILE:
        raise ValueError(f"block_q and block_k must be multiples of {KERNEL_TILE}")
    if impl != "flat" and (differentiable or not x.is_causal):
        raise ValueError(f"impl {impl!r} is the causal forward's only")

    aux = None
    if x.is_causal and not differentiable:
        counts, idx, aux = impl_tiles(mask_m, T_SRC, impl, x.block_q, x.block_k, sub,
                                      x.row_widths)
    else:
        act = (_causal_activity(mask_m, T_SRC, x.block_q, x.block_k, x.row_widths)
               if x.is_causal else
               _length_activity(mask_m, T_SRC, x.block_q, x.block_k, x.lengths))
        counts, idx = _compact_lists(act)
    counts_t = idx_t = None
    if differentiable:
        counts_t, idx_t = _compact_lists(act.transpose(-1, -2))
        counts_t = counts_t.reshape(NH, NKB).contiguous()
        idx_t = idx_t.reshape(NH, NKB, NQ).contiguous()
    return KernelOperands(
        q=q.reshape(NH, T_DST, D).contiguous(),
        k=k.reshape(NH, T_SRC, D).contiguous(),
        v=v.reshape(NH, T_SRC, D).contiguous(),
        mbits=pack_compressed_bits(mask_m).reshape(NH, T_DST, n_words).contiguous(),
        scaler=x.scaler.float().reshape(NH, T_DST).contiguous(),
        counts=counts.reshape(NH, NQ).contiguous(),
        idx=idx.reshape(NH, NQ, NKB).contiguous(),
        counts_t=counts_t,
        idx_t=idx_t,
        row_base=x.row_base.contiguous(),
        lengths=None if x.is_causal else x.lengths.repeat_interleave(H).contiguous(),
        shape=(N, H, T_DST, D),
        t_m=T_M,
        block_q=x.block_q,
        block_k=x.block_k,
        oversample=float(oversample),
        k_cfg=float(k_cfg),
        tile_aux=None if aux is None else aux.reshape(NH, NQ, NKB).contiguous(),
        impl=impl,
        sub=sub if impl == "subtile" else 0,
    )


def _geometry(ops: KernelOperands):
    """The ints every entry point takes after its pointers."""
    N, H, T_DST, D = ops.shape
    return (N * H, T_DST, ops.k.shape[1], D, ops.t_m, ops.mbits.shape[-1],
            ops.block_q, ops.block_k, ops.idx.shape[1], ops.idx.shape[2])


def launch_causal_flat(ops: KernelOperands) -> torch.Tensor:
    """One launch of the causal kernel on the current stream; (N, H, T, D)."""
    _require_cuda(ops.q, "sea_block_sparse_attention")
    out = torch.empty_like(ops.q)
    lib = _lib()
    with torch.cuda.device(ops.q.device):
        stream = torch.cuda.current_stream(ops.q.device).cuda_stream
        err = lib.sea_causal_flat_forward(
            ops.q.data_ptr(), ops.k.data_ptr(), ops.v.data_ptr(),
            ops.mbits.data_ptr(), ops.scaler.data_ptr(), ops.counts.data_ptr(),
            ops.idx.data_ptr(), ops.row_base.data_ptr(), out.data_ptr(),
            *_geometry(ops), ops.oversample, ops.k_cfg,
            float(round(ops.k_cfg)), float(round(ops.k_cfg * ops.oversample)),
            int(ops.q.dtype == torch.bfloat16), stream,
        )
    _check(err, "sea_causal_flat_forward")
    _count(sea_block_sparse_attention, ops.q)
    return out.reshape(ops.shape)


def _launch_impl(ops: KernelOperands, impl: str) -> torch.Tensor:
    """One launch of impl `impl`'s kernel (K9a-c) on the current stream;
    (N, H, T, D)."""
    _require_cuda(ops.q, "sea_block_sparse_attention")
    if ops.impl != impl:
        raise ValueError(f"operands built for impl {ops.impl!r}, not {impl!r}")
    out = torch.empty_like(ops.q)
    lib = _lib()
    entry = IMPL_KERNELS[impl].entry
    with torch.cuda.device(ops.q.device):
        stream = torch.cuda.current_stream(ops.q.device).cuda_stream
        err = getattr(lib, entry)(
            ops.q.data_ptr(), ops.k.data_ptr(), ops.v.data_ptr(),
            ops.mbits.data_ptr(), ops.scaler.data_ptr(), ops.counts.data_ptr(),
            ops.idx.data_ptr(), ops.tile_aux.data_ptr(), ops.row_base.data_ptr(),
            out.data_ptr(), *_geometry(ops), ops.sub, ops.oversample, ops.k_cfg,
            float(round(ops.k_cfg)), float(round(ops.k_cfg * ops.oversample)),
            int(ops.q.dtype == torch.bfloat16), stream,
        )
    _check(err, entry)
    return out.reshape(ops.shape)


class ImplKernel(NamedTuple):
    """A causal variant's kernel: its C entry point, its number in the CUDA
    source's `Impl` enum, and its wrapper, which launches it once on
    operands built with its impl and counts that in `launches`."""
    entry: str
    enum: int
    wrapper: Callable[[KernelOperands], torch.Tensor]


def _impl_kernel(impl: str, entry: str, enum: int, kid: str) -> ImplKernel:
    def wrapper(ops: KernelOperands) -> torch.Tensor:
        out = _launch_impl(ops, impl)
        wrapper.launches += 1
        return out

    wrapper.__doc__ = f"{kid}, impl {impl!r}: one launch on operands built with that impl."
    wrapper.launches = 0
    return ImplKernel(entry, enum, wrapper)


# the causal forward's variants K9a-c by impl ('flat', K1, is
# `launch_causal_flat`, whose launches `sea_block_sparse_attention` counts)
IMPL_KERNELS = {
    "flat_wr": _impl_kernel("flat_wr", "sea_causal_word_range_forward", 1, "K9a"),
    "flat_fori": _impl_kernel("flat_fori", "sea_causal_word_loop_forward", 2, "K9b"),
    "subtile": _impl_kernel("subtile", "sea_causal_subtile_forward", 3, "K9c"),
}
# the causal forward's impls (the JAX package's `impl=`): K1, K9a, K9b, K9c
IMPLS = ("flat", *IMPL_KERNELS)


def _auto_block(t: int) -> int:
    """The JAX package's default block: the largest of 512, 256 and 128
    that divides t (t itself if none does)."""
    for b in (512, 256, 128):
        if t % b == 0:
            return b
    return t


def impl_blocks(impl: str, t_dst: int, t_src: int, block_q: Optional[int] = None,
                block_k: Optional[int] = None) -> Tuple[Optional[int], Optional[int], int]:
    """(block_q, block_k, sub) that impl `impl` runs at: 'subtile' takes the
    JAX package's outer blocks where none is given (`_auto_block` of the
    128-padded lengths) and pieces of min(SUB_BLOCK, block_k); the others
    keep the blocks given (None: the 64 x 64 default) and no pieces."""
    if impl != "subtile":
        return block_q, block_k, 0
    block_q = block_q or _auto_block(-(-t_dst // 128) * 128)
    block_k = block_k or _auto_block(-(-t_src // 128) * 128)
    return block_q, block_k, min(SUB_BLOCK, block_k)


def bidir_forward(ops: KernelOperands) -> torch.Tensor:
    """One launch of the padded bidirectional kernel (K5) on the current
    stream; (N, H, T, D). It counts its own launches."""
    _require_cuda(ops.q, "sea_block_sparse_attention")
    if ops.lengths is None:
        raise ValueError("bidir_forward: operands of the causal path")
    out = torch.empty_like(ops.q)
    lib = _lib()
    with torch.cuda.device(ops.q.device):
        stream = torch.cuda.current_stream(ops.q.device).cuda_stream
        err = lib.sea_bidir_forward(
            ops.q.data_ptr(), ops.k.data_ptr(), ops.v.data_ptr(),
            ops.mbits.data_ptr(), ops.scaler.data_ptr(), ops.counts.data_ptr(),
            ops.idx.data_ptr(), ops.lengths.data_ptr(), out.data_ptr(),
            *_geometry(ops), int(ops.q.dtype == torch.bfloat16), stream,
        )
    _check(err, "sea_bidir_forward")
    bidir_forward.launches += 1
    return out.reshape(ops.shape)


bidir_forward.launches = 0


def sea_block_sparse_attention(
    q: torch.Tensor,  # (N, H, T_DST, D) — pre-scaled
    k: torch.Tensor,  # (N, H, T_SRC, D)
    v: torch.Tensor,  # (N, H, T_SRC, D)
    mask_m: torch.Tensor,  # (N, H, T_DST, T_M) binary compressed mask
    row_scaler: Optional[torch.Tensor] = None,  # (N, H, T_DST) sigmoid scaler
    *,
    is_causal: bool = True,
    lengths: Optional[torch.Tensor] = None,  # (N,) token lengths (non-causal)
    row_base: Optional[torch.Tensor] = None,  # (NQ,) global base row per q-block
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    oversample: float = 1.0,
    k_cfg: float = 64.0,
    impl: str = "flat",  # 'flat' | 'flat_wr' | 'flat_fori' | 'subtile' (causal only)
) -> torch.Tensor:
    """Fused sparse attention: softmax(mask(q·kᵀ))·v·scaler, per (row, head),
    over alive columns only; rows with no alive column give zeros.

    Sequence lengths are zero-padded to a multiple of 128 (padded rows have
    empty masks and are sliced off). Non-causal, example n's rows have the
    width lengths[n] (right padding), the unpadded T_SRC without `lengths`;
    `oversample` is causal only. On CPU tensors this runs the plain version
    (`dense_reference`, or `impl_reference` for the impls but 'flat'); on
    CUDA tensors it launches the kernel: causal, by `impl`, K1 ('flat',
    the default), K9a ('flat_wr'), K9b ('flat_fori') or K9c ('subtile');
    non-causal, K5 whatever `impl` says, as the JAX package runs its one
    non-causal kernel. All compute the same function. The tile lists are
    64 x 64 by default; 'subtile' takes the JAX package's default outer
    blocks (the largest of 512, 256, 128 dividing T) and pieces of
    min(SUB_BLOCK, block_k) columns (`impl_blocks`)."""
    if not is_causal and oversample != 1.0:
        raise ValueError("oversample is causal only")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    sub = 0
    if is_causal:
        block_q, block_k, sub = impl_blocks(impl, q.shape[2], k.shape[2], block_q, block_k)
    x = prepare_inputs(
        q, k, v, mask_m, row_scaler, is_causal=is_causal, lengths=lengths,
        row_base=row_base, block_q=block_q, block_k=block_k,
    )
    if not is_causal:
        impl = "flat"
    if x.q.device.type == "cpu" and impl == "flat":
        out = dense_reference(
            x.q, x.k, x.v, x.mask_m, x.scaler, is_causal=is_causal, lengths=x.lengths,
            oversample=oversample, k_cfg=k_cfg, row_widths=x.row_widths,
        )
    elif not is_causal:
        out = bidir_forward(kernel_operands(x))
    else:
        ops = kernel_operands(x, oversample, k_cfg, impl=impl, sub=sub)
        if x.q.device.type == "cpu":
            out = impl_reference(ops, impl)
        elif impl == "flat":
            out = launch_causal_flat(ops)
        else:
            out = IMPL_KERNELS[impl].wrapper(ops)
    return out[:, :, : x.t_dst0]


sea_block_sparse_attention.launches = 0
sea_block_sparse_attention.bf16_launches = 0


def alive_mask(mask_m: torch.Tensor, t_src: int, *, is_causal: bool = True,
               lengths: Optional[torch.Tensor] = None, impl: str = "flat",
               block_q: Optional[int] = None, block_k: Optional[int] = None
               ) -> torch.Tensor:
    """(N, H, T_DST, T_SRC) int8 alive mask from a kernel's own element
    predicate (`alive_elem` of K1 causal, `alive_elem_len` of K5 non-causal,
    with `lengths` (N,), default T_SRC), for a bit-for-bit check against
    `element_mask_int8`. CPU tensors take the oracle. A causal `impl` but
    'flat' takes the restricted predicate of K9a-c on that impl's tile
    lists at the wrapper's default blocks (or those given), on the tiles the
    lists hold only; its plain version on CPU tensors."""
    N, H, T_DST, T_M = mask_m.shape
    if not is_causal and lengths is None:
        lengths = torch.full((N,), t_src, dtype=torch.int32)
    n_words = (T_M + 31) // 32
    if is_causal and impl != "flat":
        return _impl_alive_mask(mask_m, t_src, impl, block_q, block_k)
    if mask_m.device.type == "cpu":
        return element_mask_int8(mask_m, t_src, is_causal, lengths=lengths)
    _require_cuda(mask_m, "alive_mask")
    mbits = pack_compressed_bits(mask_m).reshape(N * H, T_DST, n_words).contiguous()
    out = torch.empty((N * H, T_DST, t_src), dtype=torch.int8, device=mask_m.device)
    lib = _lib()
    geometry = (N * H, T_DST, t_src, T_M, n_words)
    with torch.cuda.device(mask_m.device):
        stream = torch.cuda.current_stream(mask_m.device).cuda_stream
        if is_causal:
            err = lib.sea_alive_mask(mbits.data_ptr(), out.data_ptr(), *geometry, stream)
        else:
            lengths_nh = lengths.to(device=mask_m.device, dtype=torch.int32)
            lengths_nh = lengths_nh.repeat_interleave(H).contiguous()
            err = lib.sea_bidir_alive_mask(
                mbits.data_ptr(), lengths_nh.data_ptr(), out.data_ptr(), *geometry, stream,
            )
    _check(err, "sea_alive_mask")
    alive_mask.launches += 1
    return out.reshape(N, H, T_DST, t_src)


alive_mask.launches = 0


def quotient_mismatches(w_max: int, device) -> int:
    """How many of the forward kernels' pixel and keep quotients, taken from
    a row's reciprocal, differ from IEEE division's: x = s + 0.5 and s + 1
    over every 0 <= s < w <= w_max (CUDA only)."""
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    _require_cuda(bad, "quotient_mismatches")
    with torch.cuda.device(bad.device):
        stream = torch.cuda.current_stream(bad.device).cuda_stream
        err = _lib().sea_quot_check(w_max, bad.data_ptr(), stream)
    _check(err, "sea_quot_check")
    return int(bad)


def _impl_alive_mask(mask_m, t_src, impl, block_q, block_k):
    """`alive_mask` for impl 'flat_wr', 'flat_fori' or 'subtile'."""
    N, H, T_DST, T_M = mask_m.shape
    block_q, block_k, sub = impl_blocks(impl, T_DST, t_src, block_q, block_k)
    block_q, block_k = block_q or KERNEL_TILE, block_k or KERNEL_TILE
    if T_DST % block_q or t_src % block_k:
        raise ValueError(f"T ({T_DST}, {t_src}) must be whole blocks ({block_q}, {block_k})")
    NH, NQ, NKB = N * H, T_DST // block_q, t_src // block_k
    counts, idx, aux = impl_tiles(mask_m, t_src, impl, block_q, block_k, sub)
    counts, idx, aux = counts.reshape(NH, NQ), idx.reshape(NH, NQ, NKB), aux.reshape(NH, NQ, NKB)
    mbits = pack_compressed_bits(mask_m).reshape(NH, T_DST, -1).contiguous()
    if mask_m.device.type == "cpu":
        widths = torch.arange(1, T_DST + 1, dtype=torch.float32)
        alive = _restricted_alive(mbits, counts, idx, aux, widths, t_src, T_M,
                                  block_q, block_k, sub, impl)
        return alive.to(torch.int8).reshape(N, H, T_DST, t_src)
    _require_cuda(mask_m, "alive_mask")
    tiles = _dense_tiles(counts, idx, aux, 0 if impl == "subtile" else -1).contiguous()
    out = torch.empty((NH, T_DST, t_src), dtype=torch.int8, device=mask_m.device)
    with torch.cuda.device(mask_m.device):
        stream = torch.cuda.current_stream(mask_m.device).cuda_stream
        err = _lib().sea_impl_alive_mask(
            mbits.data_ptr(), tiles.data_ptr(), out.data_ptr(), IMPL_KERNELS[impl].enum, NH,
            T_DST, t_src, T_M, mbits.shape[-1], block_q, block_k, sub, stream,
        )
    _check(err, "sea_impl_alive_mask")
    alive_mask.launches += 1
    return out.reshape(N, H, T_DST, t_src)


# ---------------------------------------------------------------------------
# Differentiable fused attention: forward with stats (K2), dq (K3), dk/dv (K4)
# ---------------------------------------------------------------------------


def fwd_with_stats_reference(
    q, k, v, mask_m, scaler, *, row_widths: Optional[torch.Tensor] = None,
    col0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the forward-with-stats kernel: the causal output
    of `dense_reference` (no undersampling) and the per-row logsumexp over
    alive columns, (N, H, T_DST) float32, +inf on rows with no alive column.
    `col0`: k and v are the global columns col0 .. col0 + T_SRC − 1."""
    T_SRC = k.shape[2]
    w = _dense_widths(q.shape[2], T_SRC, True, row_widths, q.device)
    out, m, l = _softmax_pv(q, k, v, _alive_dense(mask_m, T_SRC, w, col0), scaler)
    # m is finite (NEG_INF) on empty rows, where l = 0 and lse is +inf
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, float("inf")))
    return out.to(q.dtype), lse[..., 0]


def _grad_terms(q, k, v, mask_m, dou, lse, delta, row_widths, col0=0):
    """Dense p = exp(s − lse) (0 off the mask) and ds = p·(dp − delta)."""
    T_SRC = k.shape[2]
    w = _dense_widths(q.shape[2], T_SRC, True, row_widths, q.device)
    alive = _alive_dense(mask_m, T_SRC, w, col0)
    scores = torch.einsum("nhtd,nhsd->nhts", q.float(), k.float())
    p = torch.where(alive, torch.exp(scores - lse[..., None]), torch.zeros_like(scores))
    dp = torch.einsum("nhtd,nhsd->nhts", dou.float(), v.float())
    return p, p * (dp - delta[..., None])


def dq_reference(q, k, v, mask_m, dou, lse, delta, *,
                 row_widths: Optional[torch.Tensor] = None, col0: int = 0) -> torch.Tensor:
    """The plain version of the dq kernel: dq = ds·k over the element mask,
    with p = exp(s − lse), dp = dou·vᵀ and ds = p·(dp − delta)."""
    _, ds = _grad_terms(q, k, v, mask_m, dou, lse, delta, row_widths, col0)
    return torch.einsum("nhts,nhsd->nhtd", ds, k.float()).to(q.dtype)


def dkv_reference(q, k, v, mask_m, dou, lse, delta, *,
                  row_widths: Optional[torch.Tensor] = None, col0: int = 0,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the dk/dv kernel: dk = dsᵀ·q and dv = pᵀ·dou
    over the element mask (terms as in `dq_reference`)."""
    p, ds = _grad_terms(q, k, v, mask_m, dou, lse, delta, row_widths, col0)
    dk = torch.einsum("nhts,nhtd->nhsd", ds, q.float())
    dv = torch.einsum("nhts,nhtd->nhsd", p, dou.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def backward_terms(do, o, scaler, dtype):
    """What the backward computes outside the kernels, in the JAX package's
    expressions: dscaler = Σ_d do·o/scaler, dou = do·scaler and
    delta = Σ_d dou·o/scaler (a zero scaler divides by 1 instead)."""
    do_f = do.float()
    scale_f = scaler.float()[..., None]
    safe_scale = torch.where(scale_f != 0, scale_f, torch.ones_like(scale_f))
    o_unscaled = o.float() / safe_scale
    dscaler = (do_f * o_unscaled).sum(-1).to(scaler.dtype)
    dou = (do_f * scale_f).to(dtype)
    delta = (dou.float() * o_unscaled).sum(-1)
    return dscaler, dou, delta


def _require_diff(ops: KernelOperands, what: str, dou=None, *stats: torch.Tensor):
    """The differentiable path's kernels launch on a CUDA device on
    operands built with `differentiable=True`, float32 or bfloat16; the
    backward's per-call tensors sit with them, `dou` in q's type and the
    row statistics (lse, delta) float32."""
    _require_cuda(ops.q, what)
    if ops.idx_t is None:
        raise ValueError(f"{what}: operands built without differentiable=True")
    want = [(t, ops.q.dtype) for t in (ops.q,) + (() if dou is None else (dou,))]
    for t, dtype in want + [(t, torch.float32) for t in stats]:
        if t.device != ops.q.device or t.dtype != dtype:
            raise ValueError(f"{what}: {dtype} on {ops.q.device} wanted, "
                             f"got {t.dtype} on {t.device}")


def _flat(t: torch.Tensor, nh: int) -> torch.Tensor:
    """(N, H, T, ...) -> (NH, T, ...) contiguous."""
    return t.reshape(nh, *t.shape[2:]).contiguous()


def causal_fwd_stats(ops: KernelOperands) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward-with-stats kernel (K2) on the current
    stream: (o (N, H, T, D) in q's type, lse (N, H, T) float32)."""
    N, H, T_DST, D = ops.shape
    _require_diff(ops, "causal_fwd_stats")
    out = torch.empty_like(ops.q)
    lse = torch.empty((N * H, T_DST), dtype=torch.float32, device=ops.q.device)
    lib = _lib()
    with torch.cuda.device(ops.q.device):
        stream = torch.cuda.current_stream(ops.q.device).cuda_stream
        err = lib.sea_causal_fwd_stats(
            ops.q.data_ptr(), ops.k.data_ptr(), ops.v.data_ptr(),
            ops.mbits.data_ptr(), ops.scaler.data_ptr(), ops.counts.data_ptr(),
            ops.idx.data_ptr(), ops.row_base.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *_geometry(ops), int(ops.q.dtype == torch.bfloat16), stream,
        )
    _check(err, "sea_causal_fwd_stats")
    _count(causal_fwd_stats, ops.q)
    return out.reshape(N, H, T_DST, D), lse.reshape(N, H, T_DST)


causal_fwd_stats.launches = 0
causal_fwd_stats.bf16_launches = 0


def causal_dq(ops: KernelOperands, dou, lse, delta) -> torch.Tensor:
    """One launch of the dq kernel (K3) on the current stream: (N, H, T, D)
    in q's type."""
    N, H, T_DST, D = ops.shape
    dou, lse, delta = (_flat(x, N * H) for x in (dou, lse, delta))
    _require_diff(ops, "causal_dq", dou, lse, delta)
    dq = torch.empty_like(ops.q)
    lib = _diff_lib()
    with torch.cuda.device(ops.q.device):
        stream = torch.cuda.current_stream(ops.q.device).cuda_stream
        err = lib.sea_causal_dq(
            ops.q.data_ptr(), ops.k.data_ptr(), ops.v.data_ptr(),
            ops.mbits.data_ptr(), dou.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), ops.counts.data_ptr(), ops.idx.data_ptr(),
            ops.row_base.data_ptr(), dq.data_ptr(), *_geometry(ops),
            int(ops.q.dtype == torch.bfloat16), stream,
        )
    _check(err, "sea_causal_dq")
    _count(causal_dq, ops.q)
    return dq.reshape(N, H, T_DST, D)


causal_dq.launches = 0
causal_dq.bf16_launches = 0


def causal_dkv(ops: KernelOperands, dou, lse, delta
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the dk/dv kernel (K4) on the current stream:
    (dk, dv), each (N, H, T_SRC, D) in q's type."""
    N, H, _, D = ops.shape
    dou, lse, delta = (_flat(x, N * H) for x in (dou, lse, delta))
    _require_diff(ops, "causal_dkv", dou, lse, delta)
    dk = torch.empty_like(ops.k)
    dv = torch.empty_like(ops.v)
    lib = _diff_lib()
    with torch.cuda.device(ops.q.device):
        stream = torch.cuda.current_stream(ops.q.device).cuda_stream
        err = lib.sea_causal_dkv(
            ops.q.data_ptr(), ops.k.data_ptr(), ops.v.data_ptr(),
            ops.mbits.data_ptr(), dou.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), ops.counts_t.data_ptr(), ops.idx_t.data_ptr(),
            ops.row_base.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_geometry(ops), int(ops.q.dtype == torch.bfloat16), stream,
        )
    _check(err, "sea_causal_dkv")
    _count(causal_dkv, ops.q)
    T_SRC = ops.k.shape[1]
    return dk.reshape(N, H, T_SRC, D), dv.reshape(N, H, T_SRC, D)


causal_dkv.launches = 0
causal_dkv.bf16_launches = 0


def fused_forward(q, k, v, mask_m, scaler, row_base, row_widths, block_q, block_k):
    """The forward of `FusedSparseAttention` on pre-padded inputs: the
    forward-with-stats kernel (K2) on CUDA tensors, its plain version on CPU
    tensors. Returns (o, meta, saved): what `fused_backward` needs, split
    into the tensors to save (`saved`, for `save_for_backward`) and the rest
    (`meta`). On the card `saved` holds the kernels' operands (the flattened
    q, k, v, the mask bits, the scaler and the tile lists) in place of the
    inputs they were made from."""
    if q.device.type == "cpu":
        o, lse = fwd_with_stats_reference(q, k, v, mask_m, scaler, row_widths=row_widths)
        return o, (None, row_widths), (q, k, v, mask_m, scaler, o, lse)
    x = KernelInputs(q, k, v, mask_m, scaler, row_base, row_widths, block_q,
                     block_k, q.shape[2])
    ops = kernel_operands(x, differentiable=True)
    o, lse = causal_fwd_stats(ops)
    meta = (ops._replace(**dict.fromkeys(OPERAND_TENSORS)), None)
    return o, meta, (*(getattr(ops, f) for f in OPERAND_TENSORS), o, lse)


def fused_backward(meta, saved, do):
    """The backward of `FusedSparseAttention` from `fused_forward`'s `meta`
    and `saved`: `backward_terms` in plain PyTorch, then the dq (K3) and dk/dv
    (K4) kernels, or their plain versions on the CPU. Returns (dq, dk, dv,
    dscaler)."""
    ops, row_widths = meta
    *saved, o, lse = saved
    if ops is None:
        q, k, v, mask_m, scaler = saved
        dscaler, dou, delta = backward_terms(do, o, scaler, q.dtype)
        dq = dq_reference(q, k, v, mask_m, dou, lse, delta, row_widths=row_widths)
        dk, dv = dkv_reference(q, k, v, mask_m, dou, lse, delta, row_widths=row_widths)
        return dq, dk, dv, dscaler
    ops = ops._replace(**dict(zip(OPERAND_TENSORS, saved)))
    # the operands' scaler is float32; the input's, and its gradient, q's type
    scaler = ops.scaler.reshape(ops.shape[:3])
    dscaler, dou, delta = backward_terms(do, o, scaler, ops.q.dtype)
    dq = causal_dq(ops, dou, lse, delta)
    dk, dv = causal_dkv(ops, dou, lse, delta)
    return dq, dk, dv, dscaler.to(ops.q.dtype)


class FusedSparseAttention(torch.autograd.Function):
    """The port of the JAX package's `fused_sparse_attention` custom_vjp on
    pre-padded inputs. Forward: the forward-with-stats kernel. Backward:
    `backward_terms` in plain PyTorch, then the dq and dk/dv kernels. The
    mask, the row bases and the widths get no gradient. CPU tensors take the
    plain versions at every step; CUDA tensors launch the kernels
    (`fused_forward`, `fused_backward`)."""

    @staticmethod
    def forward(ctx, q, k, v, mask_m, scaler, row_base, row_widths, block_q, block_k):
        o, ctx.meta, saved = fused_forward(
            q, k, v, mask_m, scaler, row_base, row_widths, block_q, block_k)
        ctx.save_for_backward(*saved)
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv, dscaler = fused_backward(ctx.meta, ctx.saved_tensors, do)
        return dq, dk, dv, None, dscaler, None, None, None, None


def fused_sparse_attention(
    q: torch.Tensor,  # (N, H, T_DST, D) — pre-scaled
    k: torch.Tensor,  # (N, H, T_SRC, D)
    v: torch.Tensor,  # (N, H, T_SRC, D)
    mask_m: torch.Tensor,  # (N, H, T_DST, T_M) binary compressed mask
    row_scaler: torch.Tensor,  # (N, H, T_DST); pass ones when unused
    row_base: Optional[torch.Tensor] = None,  # (NQ,) global base row per q-block
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Differentiable fused causal sparse attention: the output of
    `sea_block_sparse_attention(..., is_causal=True)` (without the
    undersampling predicate), with flash-style recompute gradients for q, k,
    v and the row scaler. Lengths are zero-padded to a multiple of 128 as in
    the forward wrapper (the padding is differentiable and sliced off); the
    tile lists use `block_q` x `block_k` blocks (default 64), which do not
    change the result."""
    x = prepare_inputs(
        q, k, v, mask_m, row_scaler, row_base=row_base, block_q=block_q,
        block_k=block_k,
    )
    o = FusedSparseAttention.apply(
        x.q, x.k, x.v, x.mask_m, x.scaler, x.row_base, x.row_widths, x.block_q,
        x.block_k,
    )
    return o[:, :, : x.t_dst0]


# ---------------------------------------------------------------------------
# The ring's windowed kernels: forward with stats (K6), dq (K7), dk/dv (K8)
# ---------------------------------------------------------------------------


def fwd_stats_window_reference(q, k_win, v_win, mask_m, col0: int, *,
                               row_widths: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K6: `fwd_with_stats_reference` over one K/V
    window, the global columns col0 .. col0 + CH − 1 of a causal sequence,
    with the scaler one. Returns the window-normalised output (N, H, T_DST,
    D) and the window's logsumexp (N, H, T_DST), +inf on rows with nothing
    alive in the window (whose output is 0)."""
    return fwd_with_stats_reference(q, k_win, v_win, mask_m, None,
                                    row_widths=row_widths, col0=col0)


def dq_window_reference(q, k_win, v_win, mask_m, dou, lse, delta, col0: int, *,
                        row_widths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of K7: `dq_reference` over one K/V window (global
    columns col0 .. col0 + CH − 1). lse and delta are the rows' totals over
    every window, so the windows' contributions sum to the whole dq."""
    return dq_reference(q, k_win, v_win, mask_m, dou, lse, delta,
                        row_widths=row_widths, col0=col0)


def dkv_window_reference(q, k_win, v_win, mask_m, dou, lse, delta, col0: int, *,
                         row_widths: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K8: `dkv_reference` over one K/V window, the
    window's dk and dv (N, H, CH, D) from the given query rows."""
    return dkv_reference(q, k_win, v_win, mask_m, dou, lse, delta,
                         row_widths=row_widths, col0=col0)


class WindowOperands(NamedTuple):
    """One sequence shard's operands of the windowed kernels: its query rows
    (global ids `row_widths` − 1), their mask, and the tile lists of every
    K/V window. Window w holds the global columns w·CH .. (w + 1)·CH − 1."""

    q: torch.Tensor  # (NH, TL, D) float32 or bfloat16
    mask_m: Optional[torch.Tensor]  # (N, H, TL, T_M), CPU only: the plain versions' mask
    mbits: torch.Tensor  # (NH, TL, n_words) int32 bit patterns
    row_base: torch.Tensor  # (NQ,) int32 global base row of each q-block
    row_widths: torch.Tensor  # (TL,) float32 causal width (global row + 1)
    counts: torch.Tensor  # (S, NH, NQ) int32: active k-blocks per q-block and window
    idx: torch.Tensor  # (S, NH, NQ, NKW) int32 GLOBAL k-block ids
    counts_t: torch.Tensor  # (S, NH, NKW) int32: active q-blocks per window k-block
    idx_t: torch.Tensor  # (S, NH, NKW, NQ) int32 LOCAL q-block ids
    shape: Tuple[int, int, int, int]  # (N, H, TL, D)
    t_m: int
    block_q: int
    block_k: int
    window: int  # CH, the columns of one window


def window_operands(q, mask_m, rows, t_src: int, n_windows: int,
                    block_q: int, block_k: int) -> WindowOperands:
    """The port of the ring's `_ring_shared_prep` for one shard: q (N, H,
    TL, D) and mask_m (N, H, TL, T_M) hold the shard's query rows, whose
    global ids are `rows` (TL,) in whole blocks of `block_q`; the source
    has `t_src` columns in `n_windows` windows. The tile activity is built
    once over all t_src columns with the rows' global widths, and every
    window's lists, forward and transposed, come out of one batched
    `_compact_lists` call each (the forward lists with global k-block ids,
    the transposed ones with local q-block ids). The mask itself is kept
    for CPU tensors only, whose wrappers take the plain versions; on the
    card the kernels read its packed bits."""
    N, H, TL, D = q.shape
    T_M = mask_m.shape[-1]
    NH, NQ = N * H, TL // block_q
    CH = t_src // n_windows
    NKW = CH // block_k
    if block_q % KERNEL_TILE or block_k % KERNEL_TILE or TL % block_q \
            or t_src % n_windows or CH % block_k:
        raise ValueError(f"rows {TL} and windows {CH} must be whole blocks "
                         f"({block_q}, {block_k}), multiples of {KERNEL_TILE}")
    rows = rows.to(device=q.device, dtype=torch.int32)
    row_widths = (rows + 1).to(torch.float32)
    act = _causal_activity(mask_m, t_src, block_q, block_k, row_widths=row_widths)
    act = act.reshape(NH, NQ, n_windows, NKW)
    counts, idx = _compact_lists(act.permute(2, 0, 1, 3))
    first = torch.arange(n_windows, dtype=torch.int32, device=q.device) * NKW
    counts_t, idx_t = _compact_lists(act.permute(2, 0, 3, 1))
    return WindowOperands(
        q=q.reshape(NH, TL, D).contiguous(),
        mask_m=mask_m if q.device.type == "cpu" else None,
        mbits=pack_compressed_bits(mask_m).reshape(NH, TL, -1).contiguous(),
        row_base=rows[::block_q].contiguous(),
        row_widths=row_widths,
        counts=counts.contiguous(),
        idx=(idx + first[:, None, None, None]).contiguous(),
        counts_t=counts_t.contiguous(),
        idx_t=idx_t.contiguous(),
        shape=(N, H, TL, D),
        t_m=T_M,
        block_q=block_q,
        block_k=block_k,
        window=CH,
    )


def _window_args(ops: WindowOperands, w: int, k_win, v_win, what: str, dou=None, *stats):
    """Check one window launch's tensors: q, k, v (and dou) contiguous
    float32 or bfloat16 of one type on one device, the per-call row
    statistics (lse, delta) float32. Returns the ints every window entry
    point takes after its pointers, the last `is_bf16`."""
    N, H, TL, D = ops.shape
    _check_head_dim(D, "window", what)
    _require_cuda(ops.q, what)
    if ops.mbits.shape[-1] > MAX_WORDS:
        raise ValueError(f"{what}: kernel takes T_M <= {32 * MAX_WORDS}, got {ops.t_m}")
    if ops.q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{what}: kernel takes {' or '.join(map(str, KERNEL_DTYPES))}, "
                         f"got {ops.q.dtype}")
    typed = (ops.q, k_win, v_win) + (() if dou is None else (dou,))
    for x, dtype in [(x, ops.q.dtype) for x in typed] + [(x, torch.float32) for x in stats]:
        if x.device != ops.q.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{what}: contiguous {dtype} wanted on {ops.q.device}, got "
                             f"{x.dtype} on {x.device}")
    if k_win.shape != (N, H, ops.window, D) or v_win.shape != k_win.shape:
        raise ValueError(f"{what}: k and v must be ({N}, {H}, {ops.window}, {D})")
    if not 0 <= w < ops.counts.shape[0]:
        raise ValueError(f"{what}: window {w} of {ops.counts.shape[0]}")
    return (N * H, TL, ops.window, D, ops.t_m, ops.mbits.shape[-1], ops.block_q,
            ops.block_k, TL // ops.block_q, ops.window // ops.block_k,
            w * ops.window, int(ops.q.dtype == torch.bfloat16))


def fwd_stats_window(ops: WindowOperands, w: int, k_win, v_win
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 over window `w` (k_win, v_win (N, H, CH, D) its columns): the
    window-normalised output (N, H, TL, D) in q's type and logsumexp (N, H,
    TL) float32.
    One launch on the current stream for CUDA tensors; the plain version for
    CPU tensors."""
    N, H, TL, D = ops.shape
    if ops.q.device.type == "cpu":
        return fwd_stats_window_reference(
            ops.q.reshape(ops.shape), k_win, v_win, ops.mask_m, w * ops.window,
            row_widths=ops.row_widths)
    geometry = _window_args(ops, w, k_win, v_win, "fwd_stats_window")
    out = torch.empty_like(ops.q)
    lse = torch.empty((N * H, TL), dtype=torch.float32, device=ops.q.device)
    lib = _lib()
    with torch.cuda.device(ops.q.device):
        stream = torch.cuda.current_stream(ops.q.device).cuda_stream
        err = lib.sea_window_fwd_stats(
            ops.q.data_ptr(), k_win.data_ptr(), v_win.data_ptr(), ops.mbits.data_ptr(),
            ops.counts[w].data_ptr(), ops.idx[w].data_ptr(), ops.row_base.data_ptr(),
            out.data_ptr(), lse.data_ptr(), *geometry, stream,
        )
    _check(err, "sea_window_fwd_stats")
    _count(fwd_stats_window, ops.q)
    return out.reshape(ops.shape), lse.reshape(N, H, TL)


fwd_stats_window.launches = 0
fwd_stats_window.bf16_launches = 0


def dq_window(ops: WindowOperands, w: int, k_win, v_win, dou, lse, delta) -> torch.Tensor:
    """K7: window `w`'s contribution to dq (N, H, TL, D) in q's type, given
    dou (N, H, TL, D) in q's type and the rows' total lse and delta (N, H,
    TL) float32."""
    N, H, TL, D = ops.shape
    if ops.q.device.type == "cpu":
        return dq_window_reference(
            ops.q.reshape(ops.shape), k_win, v_win, ops.mask_m, dou, lse, delta,
            w * ops.window, row_widths=ops.row_widths)
    dou, lse, delta = (_flat(x, N * H) for x in (dou, lse, delta))
    geometry = _window_args(ops, w, k_win, v_win, "dq_window", dou, lse, delta)
    dq = torch.empty_like(ops.q)
    lib = _diff_lib()
    with torch.cuda.device(ops.q.device):
        stream = torch.cuda.current_stream(ops.q.device).cuda_stream
        err = lib.sea_window_dq(
            ops.q.data_ptr(), k_win.data_ptr(), v_win.data_ptr(), ops.mbits.data_ptr(),
            dou.data_ptr(), lse.data_ptr(), delta.data_ptr(), ops.counts[w].data_ptr(),
            ops.idx[w].data_ptr(), ops.row_base.data_ptr(), dq.data_ptr(), *geometry,
            stream,
        )
    _check(err, "sea_window_dq")
    _count(dq_window, ops.q)
    return dq.reshape(ops.shape)


dq_window.launches = 0
dq_window.bf16_launches = 0


def dkv_window(ops: WindowOperands, w: int, k_win, v_win, dou, lse, delta
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: window `w`'s dk and dv (N, H, CH, D), in q's type, from the
    shard's query rows, over the window's transposed tile lists."""
    N, H, TL, D = ops.shape
    if ops.q.device.type == "cpu":
        return dkv_window_reference(
            ops.q.reshape(ops.shape), k_win, v_win, ops.mask_m, dou, lse, delta,
            w * ops.window, row_widths=ops.row_widths)
    dou, lse, delta = (_flat(x, N * H) for x in (dou, lse, delta))
    geometry = _window_args(ops, w, k_win, v_win, "dkv_window", dou, lse, delta)
    dk = torch.empty_like(k_win)
    dv = torch.empty_like(v_win)
    lib = _diff_lib()
    with torch.cuda.device(ops.q.device):
        stream = torch.cuda.current_stream(ops.q.device).cuda_stream
        err = lib.sea_window_dkv(
            ops.q.data_ptr(), k_win.data_ptr(), v_win.data_ptr(), ops.mbits.data_ptr(),
            dou.data_ptr(), lse.data_ptr(), delta.data_ptr(), ops.counts_t[w].data_ptr(),
            ops.idx_t[w].data_ptr(), ops.row_base.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *geometry, stream,
        )
    _check(err, "sea_window_dkv")
    _count(dkv_window, ops.q)
    return dk, dv


dkv_window.launches = 0
dkv_window.bf16_launches = 0
