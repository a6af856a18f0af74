"""Fused causal block-sparse SEA attention (PyTorch port, Hopper kernels).

Port of the causal paths of `sea_tpu/ops/kernels/block_sparse.py`: the
forward `sea_block_sparse_attention` (Pallas kernel `_causal_kernel_flat`)
and the differentiable `fused_sparse_attention` (`_causal_kernel_fwd_stats`,
`_causal_kernel_dq`, `_causal_kernel_dkv`). The forward computes, for every
(batch·head, query row r):

    out[r] = scaler[r] · softmax over alive s of (q_r · k_s) · v_s

Column s of row r is alive iff the compressed (T_M-wide) mask has bit
pixel(r, s) = floor((s + 0.5) / w_r · T_M − 1e-4), w_r = r + 1 (the
dense-resize floor rule), and s <= r. Rows with no alive column give 0. With
`oversample != 1` the train path's undersampling keep-predicate also applies,
and `row_base` shifts each q-block's rows to global positions.

Layout of this module:

  * prep, plain PyTorch on the tensors' device (it was XLA-side in JAX):
    `pack_compressed_bits`, `_pixel_starts`, `_causal_activity`,
    `_compact_lists`, `tile_activity_lists`. The tile lists are a
    conservative superset of the (q-block, k-block) tiles with an alive
    column; the kernel still applies the element predicate on every tile;
  * oracles: `element_mask_int8`, `mask_nnz`, `dense_reference`. The last
    is also the kernel's plain version, which the wrapper runs for tensors
    on the CPU;
  * the wrapper `sea_block_sparse_attention`, which on a CUDA tensor
    launches the hand-written kernel in `csrc/block_sparse_causal.cu` or
    raises, and `alive_mask`, which launches the kernel's element predicate
    alone so that the card can check it bit for bit;
  * the differentiable path: `kernel_operands(..., differentiable=True)`
    (the port of `_diff_prep`, with the transposed tile lists), the plain
    versions `fwd_with_stats_reference`, `dq_reference` and `dkv_reference`,
    the kernel wrappers `causal_fwd_stats` (K2, `csrc/block_sparse_causal.cu`),
    `causal_dq` (K3) and `causal_dkv` (K4, both `csrc/block_sparse_diff.cu`),
    and `FusedSparseAttention` / `fused_sparse_attention`, whose backward
    computes `backward_terms` in plain PyTorch and then launches K3 and K4.
    The logsumexp and delta stay (N, H, T): the TPU's 128-lane broadcast of
    them is dropped.

Each wrapper counts its kernel launches in a `launches` attribute.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

NEG_INF = -1e30
KERNEL_TILE = 64  # rows and columns of the CUDA kernel's tile
MAX_WORDS = 16  # packed mask words per row the kernel holds (T_M <= 512)
HEAD_DIM = 64  # the head width the kernel is compiled for


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


def tile_activity_lists(
    mask_m: torch.Tensor,
    t_src: int,
    is_causal: bool,
    block_q: int,
    block_k: int,
    row_chunk: int = 512,
    row_widths: Optional[torch.Tensor] = None,  # (T_DST,) causal widths override
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (n, h, q-block): ascending list of active k-block indices from
    compressed-domain interval overlap (a conservative superset: run bounds
    are padded by one column against boundary rounding).

    Returns (counts (N, H, NQ) int32, idx (N, H, NQ, NKB) int32)."""
    T_DST = mask_m.shape[2]
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
) -> torch.Tensor:
    """Materialised (N, H, T_DST, T_SRC) int8 alive mask (dense-resize rule
    plus causality). O(T²): for tests and checks only."""
    N, H, T_DST, T_M = mask_m.shape
    dev = mask_m.device
    m = (mask_m > 0).reshape(N * H, T_DST, T_M)
    s_idx = torch.arange(t_src, dtype=torch.float32, device=dev)[None, :]
    out = torch.empty((N * H, T_DST, t_src), dtype=torch.int8, device=dev)
    for r0 in range(0, T_DST, row_chunk):
        rows = torch.arange(r0, min(r0 + row_chunk, T_DST), device=dev)
        if is_causal:
            w = (rows + 1).to(torch.float32)[:, None]
        else:
            w = torch.full((rows.numel(), 1), float(t_src), device=dev)
        pixel = _pixels(s_idx, w, T_M)  # (RC, T_SRC)
        alive = torch.gather(
            m[:, rows], -1, pixel[None].expand(N * H, -1, -1)
        )
        if is_causal:
            alive = alive & (s_idx <= rows[:, None].to(torch.float32))[None]
        out[:, rows] = alive.to(torch.int8)
    return out.reshape(N, H, T_DST, t_src)


def mask_nnz(mask_m: torch.Tensor, t_src: int, is_causal: bool) -> torch.Tensor:
    """Realized element-mask nnz, computed in the compressed domain: the sum
    over alive pixels of their run length."""
    T_DST, T_M = mask_m.shape[2], mask_m.shape[3]
    rows = torch.arange(T_DST, dtype=torch.float32, device=mask_m.device)
    widths = rows + 1.0 if is_causal else torch.full_like(rows, float(t_src))
    vs, ve = _pixel_starts(widths, T_M)
    run = torch.clamp(ve - vs, min=0).to(torch.int64)
    return ((mask_m > 0).to(torch.int64) * run[None, None]).sum()


def _dense_widths(t_dst: int, t_src: int, is_causal: bool,
                  row_widths: Optional[torch.Tensor], device) -> torch.Tensor:
    """(T_DST, 1) float32 width of each row: `row_widths` if given, else
    r + 1 (causal) or T_SRC."""
    if row_widths is not None:
        return row_widths.to(device=device, dtype=torch.float32).reshape(t_dst, 1)
    if is_causal:
        return torch.arange(1, t_dst + 1, dtype=torch.float32, device=device)[:, None]
    return torch.full((t_dst, 1), float(t_src), device=device)


def _alive_dense(mask_m: torch.Tensor, t_src: int, is_causal: bool,
                 w: torch.Tensor) -> torch.Tensor:
    """(N, H, T_DST, T_SRC) bool element mask of the dense-resize rule for
    row widths `w` (T_DST, 1); causal rows also keep s < w only."""
    N, H, T_DST, T_M = mask_m.shape
    s_idx = torch.arange(t_src, dtype=torch.float32, device=mask_m.device)[None, :]
    pixel = _pixels(s_idx, w, T_M)  # (T_DST, T_SRC)
    alive = torch.gather(mask_m > 0, -1, pixel.expand(N, H, T_DST, t_src))
    if is_causal:
        alive = alive & (s_idx < w)
    return alive


def dense_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask_m: torch.Tensor,
    row_scaler: Optional[torch.Tensor] = None,
    *,
    is_causal: bool = True,
    oversample: float = 1.0,
    k_cfg: float = 64.0,
    row_widths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: dense-resize element mask,
    per-row masked softmax, optional undersampling keep-predicate, row
    scaler. O(T²) memory. `row_widths` (T_DST,) overrides each row's causal
    width (default r + 1), as `row_base` does in the kernel."""
    T_SRC = k.shape[2]
    s_idx = torch.arange(T_SRC, dtype=torch.float32, device=q.device)[None, :]
    w = _dense_widths(q.shape[2], T_SRC, is_causal, row_widths, q.device)
    alive = _alive_dense(mask_m, T_SRC, is_causal, w)
    if oversample != 1.0:
        ps = torch.clamp(torch.floor(_div(w, oversample) + 0.5), min=1.0)
        oys = _div(torch.clamp(w, round(k_cfg), round(k_cfg * oversample)), k_cfg)
        frac = (s_idx + 1) / w * ps
        thr = _div(torch.ones_like(oys), oys) * 0.5 + 1e-4
        alive = alive & (torch.abs(frac - torch.floor(frac + 0.5)) <= thr)
    out, _, _ = _softmax_pv(q, k, v, alive, row_scaler)
    return out.to(q.dtype)


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
        "sea_causal_fwd_stats": [_P] * 10 + [_I] * 10 + [_P],
        "sea_alive_mask": [_P, _P] + [_I] * 5 + [_P],
    })


def _diff_lib() -> ctypes.CDLL:
    return _bound("block_sparse_diff", {
        "sea_causal_dq": [_P] * 11 + [_I] * 10 + [_P],
        "sea_causal_dkv": [_P] * 12 + [_I] * 10 + [_P],
    })


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _require_cuda(t: torch.Tensor, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors must be on the CPU (plain version) "
                         f"or on a CUDA device (kernel), got {t.device}")


class CausalInputs(NamedTuple):
    """The wrapper's inputs, padded to a multiple of 128 rows, with the
    q-block geometry resolved."""

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
    shape: Tuple[int, int, int, int]  # (N, H, T_DST, D)
    t_m: int
    block_q: int
    block_k: int
    oversample: float
    k_cfg: float


# the fields of KernelOperands that hold tensors
OPERAND_TENSORS = ("q", "k", "v", "mbits", "scaler", "counts", "idx", "counts_t",
                   "idx_t", "row_base")


def prepare_inputs(
    q, k, v, mask_m, row_scaler=None, *, row_base=None, block_q=None, block_k=None,
) -> CausalInputs:
    """Pad T to a multiple of 128 (padded rows have empty masks) and resolve
    the q-block geometry, the row bases and the scaler."""
    N, H, T_DST0, D = q.shape
    T_SRC0 = k.shape[2]
    T_DST = -(-T_DST0 // 128) * 128
    T_SRC = -(-T_SRC0 // 128) * 128
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
    return CausalInputs(
        q, k, v, mask_m, row_scaler.to(q.dtype), row_base_arr, row_widths,
        block_q, block_k, T_DST0,
    )


def kernel_operands(x: CausalInputs, oversample: float = 1.0, k_cfg: float = 64.0,
                    *, differentiable: bool = False) -> KernelOperands:
    """Check what the kernels take, then build their operands on the inputs'
    device: the packed mask bits and the tile lists. `differentiable` builds
    those of the differentiable path (the port of `_diff_prep`): float32
    only, plus the transposed (per-k-block) lists that the dk/dv kernel
    walks."""
    q, k, v, mask_m = x.q, x.k, x.v, x.mask_m
    N, H, T_DST, D = q.shape
    T_SRC = k.shape[2]
    T_M = mask_m.shape[-1]
    n_words = (T_M + 31) // 32
    NH = N * H
    NQ, NKB = T_DST // x.block_q, T_SRC // x.block_k
    dtypes = (torch.float32,) if differentiable else (torch.float32, torch.bfloat16)
    if q.dtype not in dtypes:
        raise ValueError(f"kernel takes {' or '.join(map(str, dtypes))}, got {q.dtype}")
    for other in (k, v, mask_m, x.scaler):
        if other.device != q.device:
            raise ValueError("all inputs must be on one device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    if D != HEAD_DIM:
        raise ValueError(f"kernel takes head_dim {HEAD_DIM}, got {D}")
    if n_words > MAX_WORDS:
        raise ValueError(f"kernel takes T_M <= {32 * MAX_WORDS}, got {T_M}")
    if x.block_q % KERNEL_TILE or x.block_k % KERNEL_TILE:
        raise ValueError(f"block_q and block_k must be multiples of {KERNEL_TILE}")

    act = _causal_activity(mask_m, T_SRC, x.block_q, x.block_k, x.row_widths)
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
        shape=(N, H, T_DST, D),
        t_m=T_M,
        block_q=x.block_q,
        block_k=x.block_k,
        oversample=float(oversample),
        k_cfg=float(k_cfg),
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
    sea_block_sparse_attention.launches += 1
    return out.reshape(ops.shape)


def sea_block_sparse_attention(
    q: torch.Tensor,  # (N, H, T_DST, D) — pre-scaled
    k: torch.Tensor,  # (N, H, T_SRC, D)
    v: torch.Tensor,  # (N, H, T_SRC, D)
    mask_m: torch.Tensor,  # (N, H, T_DST, T_M) binary compressed mask
    row_scaler: Optional[torch.Tensor] = None,  # (N, H, T_DST) sigmoid scaler
    *,
    is_causal: bool = True,
    row_base: Optional[torch.Tensor] = None,  # (NQ,) global base row per q-block
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    oversample: float = 1.0,
    k_cfg: float = 64.0,
) -> torch.Tensor:
    """Fused sparse attention: softmax(mask(q·kᵀ))·v·scaler, per (row, head),
    over alive columns only; rows with no alive column give zeros.

    Sequence lengths are zero-padded to a multiple of 128 (padded rows have
    empty masks and are sliced off). On CPU tensors this runs the plain
    version (`dense_reference`); on CUDA tensors it launches the kernel."""
    if not is_causal:
        raise NotImplementedError(
            "the non-causal (padded bidirectional) kernel is not ported yet"
        )
    x = prepare_inputs(
        q, k, v, mask_m, row_scaler, row_base=row_base, block_q=block_q,
        block_k=block_k,
    )
    if x.q.device.type == "cpu":
        out = dense_reference(
            x.q, x.k, x.v, x.mask_m, x.scaler, is_causal=True,
            oversample=oversample, k_cfg=k_cfg, row_widths=x.row_widths,
        )
    else:
        out = launch_causal_flat(kernel_operands(x, oversample, k_cfg))
    return out[:, :, : x.t_dst0]


sea_block_sparse_attention.launches = 0


def alive_mask(mask_m: torch.Tensor, t_src: int) -> torch.Tensor:
    """(N, H, T_DST, T_SRC) int8 causal alive mask from the kernel's own
    element predicate (`alive_elem` in the CUDA source), for a bit-for-bit
    check against `element_mask_int8`. CPU tensors take the oracle."""
    if mask_m.device.type == "cpu":
        return element_mask_int8(mask_m, t_src, True)
    _require_cuda(mask_m, "alive_mask")
    N, H, T_DST, T_M = mask_m.shape
    n_words = (T_M + 31) // 32
    mbits = pack_compressed_bits(mask_m).reshape(N * H, T_DST, n_words).contiguous()
    out = torch.empty((N * H, T_DST, t_src), dtype=torch.int8, device=mask_m.device)
    lib = _lib()
    with torch.cuda.device(mask_m.device):
        stream = torch.cuda.current_stream(mask_m.device).cuda_stream
        err = lib.sea_alive_mask(
            mbits.data_ptr(), out.data_ptr(), N * H, T_DST, t_src, T_M, n_words,
            stream,
        )
    _check(err, "sea_alive_mask")
    alive_mask.launches += 1
    return out.reshape(N, H, T_DST, t_src)


alive_mask.launches = 0


# ---------------------------------------------------------------------------
# Differentiable fused attention: forward with stats (K2), dq (K3), dk/dv (K4)
# ---------------------------------------------------------------------------


def fwd_with_stats_reference(
    q, k, v, mask_m, scaler, *, row_widths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the forward-with-stats kernel: the causal output
    of `dense_reference` (no undersampling) and the per-row logsumexp over
    alive columns, (N, H, T_DST) float32, +inf on rows with no alive column."""
    T_SRC = k.shape[2]
    w = _dense_widths(q.shape[2], T_SRC, True, row_widths, q.device)
    out, m, l = _softmax_pv(q, k, v, _alive_dense(mask_m, T_SRC, True, w), scaler)
    # m is finite (NEG_INF) on empty rows, where l = 0 and lse is +inf
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, float("inf")))
    return out.to(q.dtype), lse[..., 0]


def _grad_terms(q, k, v, mask_m, dou, lse, delta, row_widths):
    """Dense p = exp(s − lse) (0 off the mask) and ds = p·(dp − delta)."""
    T_SRC = k.shape[2]
    w = _dense_widths(q.shape[2], T_SRC, True, row_widths, q.device)
    alive = _alive_dense(mask_m, T_SRC, True, w)
    scores = torch.einsum("nhtd,nhsd->nhts", q.float(), k.float())
    p = torch.where(alive, torch.exp(scores - lse[..., None]), torch.zeros_like(scores))
    dp = torch.einsum("nhtd,nhsd->nhts", dou.float(), v.float())
    return p, p * (dp - delta[..., None])


def dq_reference(q, k, v, mask_m, dou, lse, delta, *,
                 row_widths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of the dq kernel: dq = ds·k over the element mask,
    with p = exp(s − lse), dp = dou·vᵀ and ds = p·(dp − delta)."""
    _, ds = _grad_terms(q, k, v, mask_m, dou, lse, delta, row_widths)
    return torch.einsum("nhts,nhsd->nhtd", ds, k.float()).to(q.dtype)


def dkv_reference(q, k, v, mask_m, dou, lse, delta, *,
                  row_widths: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the dk/dv kernel: dk = dsᵀ·q and dv = pᵀ·dou
    over the element mask (terms as in `dq_reference`)."""
    p, ds = _grad_terms(q, k, v, mask_m, dou, lse, delta, row_widths)
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


def _require_f32(ops: KernelOperands, what: str, *per_call: torch.Tensor):
    """The differentiable path's kernels launch on a CUDA device and take
    float32 only; the per-call tensors must sit with the operands."""
    _require_cuda(ops.q, what)
    for t in (ops.q, *per_call):
        if t.device != ops.q.device or t.dtype != torch.float32:
            raise ValueError(f"{what}: float32 tensors on {ops.q.device} only, "
                             f"got {t.dtype} on {t.device}")
    if ops.idx_t is None:
        raise ValueError(f"{what}: operands built without differentiable=True")


def _flat(t: torch.Tensor, nh: int) -> torch.Tensor:
    """(N, H, T, ...) -> (NH, T, ...) contiguous."""
    return t.reshape(nh, *t.shape[2:]).contiguous()


def causal_fwd_stats(ops: KernelOperands) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward-with-stats kernel (K2) on the current
    stream: (o (N, H, T, D) float32, lse (N, H, T) float32)."""
    N, H, T_DST, D = ops.shape
    _require_f32(ops, "causal_fwd_stats")
    out = torch.empty_like(ops.q)
    lse = torch.empty((N * H, T_DST), dtype=torch.float32, device=ops.q.device)
    lib = _lib()
    with torch.cuda.device(ops.q.device):
        stream = torch.cuda.current_stream(ops.q.device).cuda_stream
        err = lib.sea_causal_fwd_stats(
            ops.q.data_ptr(), ops.k.data_ptr(), ops.v.data_ptr(),
            ops.mbits.data_ptr(), ops.scaler.data_ptr(), ops.counts.data_ptr(),
            ops.idx.data_ptr(), ops.row_base.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *_geometry(ops), stream,
        )
    _check(err, "sea_causal_fwd_stats")
    causal_fwd_stats.launches += 1
    return out.reshape(N, H, T_DST, D), lse.reshape(N, H, T_DST)


causal_fwd_stats.launches = 0


def causal_dq(ops: KernelOperands, dou, lse, delta) -> torch.Tensor:
    """One launch of the dq kernel (K3) on the current stream: (N, H, T, D)."""
    N, H, T_DST, D = ops.shape
    dou, lse, delta = (_flat(x, N * H) for x in (dou, lse, delta))
    _require_f32(ops, "causal_dq", dou, lse, delta)
    dq = torch.empty_like(ops.q)
    lib = _diff_lib()
    with torch.cuda.device(ops.q.device):
        stream = torch.cuda.current_stream(ops.q.device).cuda_stream
        err = lib.sea_causal_dq(
            ops.q.data_ptr(), ops.k.data_ptr(), ops.v.data_ptr(),
            ops.mbits.data_ptr(), dou.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), ops.counts.data_ptr(), ops.idx.data_ptr(),
            ops.row_base.data_ptr(), dq.data_ptr(), *_geometry(ops), stream,
        )
    _check(err, "sea_causal_dq")
    causal_dq.launches += 1
    return dq.reshape(N, H, T_DST, D)


causal_dq.launches = 0


def causal_dkv(ops: KernelOperands, dou, lse, delta
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the dk/dv kernel (K4) on the current stream:
    (dk, dv), each (N, H, T_SRC, D)."""
    N, H, _, D = ops.shape
    dou, lse, delta = (_flat(x, N * H) for x in (dou, lse, delta))
    _require_f32(ops, "causal_dkv", dou, lse, delta)
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
            *_geometry(ops), stream,
        )
    _check(err, "sea_causal_dkv")
    causal_dkv.launches += 1
    T_SRC = ops.k.shape[1]
    return dk.reshape(N, H, T_SRC, D), dv.reshape(N, H, T_SRC, D)


causal_dkv.launches = 0


class FusedSparseAttention(torch.autograd.Function):
    """The port of the JAX package's `fused_sparse_attention` custom_vjp on
    pre-padded inputs. Forward: the forward-with-stats kernel. Backward:
    `backward_terms` in plain PyTorch, then the dq and dk/dv kernels. The
    mask, the row bases and the widths get no gradient. CPU tensors take the
    plain versions at every step; CUDA tensors launch the kernels.

    On the card the backward reads the kernels' operands (the flattened
    q, k, v, the mask bits, the scaler and the tile lists), saved through
    `save_for_backward` in place of the inputs they were made from."""

    @staticmethod
    def forward(ctx, q, k, v, mask_m, scaler, row_base, row_widths, block_q, block_k):
        if q.device.type == "cpu":
            o, lse = fwd_with_stats_reference(q, k, v, mask_m, scaler, row_widths=row_widths)
            ctx.ops, ctx.row_widths = None, row_widths
            ctx.save_for_backward(q, k, v, mask_m, scaler, o, lse)
            return o
        x = CausalInputs(q, k, v, mask_m, scaler, row_base, row_widths, block_q,
                         block_k, q.shape[2])
        ops = kernel_operands(x, differentiable=True)
        o, lse = causal_fwd_stats(ops)
        ctx.ops = ops._replace(**dict.fromkeys(OPERAND_TENSORS))
        ctx.save_for_backward(*(getattr(ops, f) for f in OPERAND_TENSORS), o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        *saved, o, lse = ctx.saved_tensors
        if ctx.ops is None:
            q, k, v, mask_m, scaler = saved
            dscaler, dou, delta = backward_terms(do, o, scaler, q.dtype)
            dq = dq_reference(q, k, v, mask_m, dou, lse, delta, row_widths=ctx.row_widths)
            dk, dv = dkv_reference(q, k, v, mask_m, dou, lse, delta,
                                   row_widths=ctx.row_widths)
        else:
            ops = ctx.ops._replace(**dict(zip(OPERAND_TENSORS, saved)))
            scaler = ops.scaler.reshape(ops.shape[:3])
            dscaler, dou, delta = backward_terms(do, o, scaler, torch.float32)
            dq = causal_dq(ops, dou, lse, delta)
            dk, dv = causal_dkv(ops, dou, lse, delta)
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
