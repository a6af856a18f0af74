"""Uniform flat-CSR sparse mask and its linear algebra (PyTorch port of
`sea_tpu/ops/flat_csr.py`).

The layout keeps the reference's column encoding: each query row holds
flat columns c = head · T_SRC + source position, head-major within the
row. A row has a fixed count of slots, `max_nnz` (Z); unused slots hold the
column -1. The benchmark path with `use_pallas=False` runs the four steps
below on it (`models/attention.py`): the masked product of scores, the
per-(row, head) softmax, the row scaler, and the sparse product with V. It
is a parity and debug path, plain PyTorch, as the JAX package's is plain
jnp: nothing falls back to it when a kernel cannot run.

The mask's pixels expand by round-half-away-from-zero (`masks.
round_half_away`), the reference's Triton expansion, not the fused
kernels' floor: the two paths pick different columns by design.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .masks import round_half_away


@dataclasses.dataclass(frozen=True)
class UniformCsr:
    """Fixed-budget flat CSR mask.

    cols:   (N, T_DST, Z) int32, flat column head · t_src + source position,
            -1 for an empty slot; head-major within each row.
    values: (N, T_DST, Z), 1.0 at creation; the pipeline rewrites them
            (scores, then probabilities, then scaled probabilities).
    """

    cols: torch.Tensor
    values: torch.Tensor
    num_heads: int
    t_src: int

    def replace(self, **kw) -> "UniformCsr":
        return dataclasses.replace(self, **kw)

    @property
    def valid(self) -> torch.Tensor:
        return self.cols >= 0

    @property
    def head_ids(self) -> torch.Tensor:
        return torch.where(self.valid, self.cols // self.t_src, 0).long()

    @property
    def src_ids(self) -> torch.Tensor:
        return torch.where(self.valid, self.cols % self.t_src, 0).long()

    @property
    def nnz_per_row(self) -> torch.Tensor:
        return self.valid.sum(-1)


def default_max_nnz(num_heads: int, k: int, t_m: int, t_src: int) -> int:
    """The worst case over row widths, rounded up to 128 slots."""
    raw = num_heads * max(math.ceil(math.sqrt(k * t_m)) + 1, 2 * k + math.ceil(t_src / t_m) + 1)
    return ((raw + 127) // 128) * 128


def resize_from_m_to_t_csr(
    compressed_mask: torch.Tensor,
    k: int,
    target_width: int,
    is_causal: bool = True,
    max_nnz: Optional[int] = None,
) -> UniformCsr:
    """A binary compressed mask (N, H, T_DST, T_M) expanded to a uniform
    flat CSR of width `target_width`:

      * row r's width is r + 1 (causal; the last T_DST rows of T_SRC) or
        T_SRC;
      * pixel b covers the run [round(b·s), round((b+1)·s)) with s = width /
        T_M, rounded half away from zero;
      * a run keeps at most `k` entries: columns descending from its end,
        the j-th at end − 1 − trunc(j · run / kept), in float32;
      * pixels are scanned in (T_DST, H, T_M) order, so a row's heads stay
        contiguous.

    A row with more than `max_nnz` entries is truncated (the default bound,
    `default_max_nnz`, makes that unreachable for the canonical configs)."""
    N, H, T_DST, T_M = compressed_mask.shape
    T_SRC = target_width
    device = compressed_mask.device
    Z = max_nnz if max_nnz is not None else default_max_nnz(H, k, T_M, T_SRC)

    x = (compressed_mask.permute(0, 2, 1, 3) > 0).to(torch.int32)  # (N, T_DST, H, T_M)
    if is_causal:
        widths = torch.arange(1, T_SRC + 1, dtype=torch.float32, device=device)[-T_DST:]
    else:
        widths = torch.full((T_DST,), float(T_SRC), dtype=torch.float32, device=device)
    # a true division by a tensor (a CUDA division by a Python number
    # multiplies by its reciprocal)
    scales = widths / torch.full_like(widths, float(T_M))
    b = torch.arange(T_M, dtype=torch.float32, device=device).reshape(1, T_M)
    v_starts = round_half_away(b * scales[:, None]).to(torch.int32)  # (T_DST, T_M)
    v_ends = round_half_away((b + 1) * scales[:, None]).to(torch.int32)
    run_len = torch.clamp(v_ends - v_starts, max=k)

    counts = (run_len[None, :, None, :] * x).reshape(N, T_DST, H * T_M)
    cum = torch.cumsum(counts, dim=-1, dtype=torch.int32)  # inclusive
    nnz = torch.clamp(cum[..., -1], max=Z)  # (N, T_DST)

    # slot z's pixel: the first p with cum[p] > z
    slots = torch.arange(Z, dtype=torch.int32, device=device)
    p = torch.searchsorted(cum, slots.expand(N, T_DST, Z).contiguous(), right=True)
    p = torch.clamp(p, max=H * T_M - 1)

    excl = cum - counts
    offset = torch.gather(excl, -1, p)
    j = (slots - offset).float()
    h_idx = p // T_M
    b_idx = p % T_M
    vs_p = torch.gather(v_starts.expand(N, T_DST, T_M), -1, b_idx)
    ve_p = torch.gather(v_ends.expand(N, T_DST, T_M), -1, b_idx)
    clen = torch.clamp(torch.gather(counts, -1, p), min=1)
    stride_step = (j * (ve_p - vs_p).float() / clen.float()).to(torch.int32)
    flat_col = h_idx * T_SRC + (ve_p - 1 - stride_step)

    valid = slots < nnz[..., None]
    cols = torch.where(valid, flat_col, -1).to(torch.int32)
    return UniformCsr(cols=cols, values=valid.to(compressed_mask.dtype), num_heads=H, t_src=T_SRC)


# ---------------------------------------------------------------------------
# the sparse linear algebra over UniformCsr


def _gather_nhsd(table: torch.Tensor, csr: UniformCsr) -> torch.Tensor:
    """Rows of (N, H, T_SRC, D) by flat column -> (N, T_DST, Z, D)."""
    N, H, T_SRC, D = table.shape
    flat = table.reshape(N, H * T_SRC, D)
    idx = torch.where(csr.valid, csr.cols, 0).long()
    _, T_DST, Z = idx.shape
    g = torch.gather(flat, 1, idx.reshape(N, T_DST * Z, 1).expand(N, T_DST * Z, D))
    return g.reshape(N, T_DST, Z, D)


def _row_ids(csr: UniformCsr) -> torch.Tensor:
    """Each slot's (row, head) segment as one index into N · T_DST · H."""
    N, T_DST, Z = csr.cols.shape
    rows = torch.arange(N * T_DST, device=csr.cols.device).reshape(N, T_DST, 1)
    return rows * csr.num_heads + csr.head_ids


def flat_csr_masked_bmm(a: torch.Tensor, b: torch.Tensor, csr: UniformCsr) -> UniformCsr:
    """Masked SDDMM: values[n, r, z] = a[n, h, r] · b[n, h, c] for slot z's
    head h and column c, in float32, times the slot's value, in a's type.
    No 1/sqrt(D): OPT's q comes scaled from its projection."""
    b_g = _gather_nhsd(b, csr)  # (N, T_DST, Z, D)
    a_rh = a.permute(0, 2, 1, 3)  # (N, T_DST, H, D)
    D = a.shape[-1]
    head = csr.head_ids
    a_g = torch.gather(a_rh, 2, head[..., None].expand(*head.shape, D))
    vals = (a_g.float() * b_g.float()).sum(-1)
    vals = (vals * csr.values.float()).to(a.dtype)
    return csr.replace(values=torch.where(csr.valid, vals, torch.zeros_like(vals)))


def flat_csr_softmax(csr: UniformCsr) -> UniformCsr:
    """Softmax over each (row, head) segment of the values, in float32;
    empty segments give zeros."""
    vals = csr.values.float()
    valid = csr.valid
    N, T_DST, Z = vals.shape
    seg = _row_ids(csr).reshape(-1)
    masked = torch.where(valid, vals, torch.full_like(vals, -math.inf)).reshape(-1)
    seg_max = torch.full((N * T_DST * csr.num_heads,), -math.inf, device=vals.device)
    seg_max = seg_max.scatter_reduce(0, seg, masked, reduce="amax", include_self=True)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    e = torch.where(valid, torch.exp(vals - seg_max[seg].reshape(N, T_DST, Z)),
                    torch.zeros_like(vals))
    seg_sum = torch.zeros_like(seg_max).index_add_(0, seg, e.reshape(-1))
    s = seg_sum[seg].reshape(N, T_DST, Z)
    out = torch.where(valid, e / torch.clamp(s, min=1e-30), torch.zeros_like(e))
    return csr.replace(values=out.to(csr.values.dtype))


def flat_csr_elmul(csr: UniformCsr, row_scaler: torch.Tensor) -> UniformCsr:
    """Values times a per-(row, head) scalar, row_scaler (N, H, T_DST) (the
    sigmoid row scaler)."""
    s_rh = row_scaler.permute(0, 2, 1)  # (N, T_DST, H)
    s = torch.gather(s_rh, 2, csr.head_ids)
    vals = csr.values * s.to(csr.values.dtype)
    return csr.replace(values=torch.where(csr.valid, vals, torch.zeros_like(vals)))


def flat_csr_sdbmm(csr: UniformCsr, v: torch.Tensor) -> torch.Tensor:
    """SpMM: out[n, h, r] = Σ_z values[z] · v[n, h, src(z)] over row r's
    head-h slots, accumulated in float32, in v's type."""
    N, H, T_SRC, D = v.shape
    v_g = _gather_nhsd(v, csr).float()
    vals = torch.where(csr.valid, csr.values, torch.zeros_like(csr.values)).float()
    T_DST = vals.shape[1]
    out = torch.zeros((N * T_DST * H, D), dtype=torch.float32, device=v.device)
    out.index_add_(0, _row_ids(csr).reshape(-1), (vals[..., None] * v_g).reshape(-1, D))
    return out.reshape(N, T_DST, H, D).permute(0, 2, 1, 3).to(v.dtype)


def flat_csr_to_dense(csr: UniformCsr) -> torch.Tensor:
    """The dense (N, H, T_DST, T_SRC) matrix of the values."""
    N, T_DST, Z = csr.cols.shape
    H, T_SRC = csr.num_heads, csr.t_src
    vals = torch.where(csr.valid, csr.values, torch.zeros_like(csr.values))
    rows = torch.arange(N * T_DST, device=vals.device).reshape(N, T_DST, 1)
    idx = ((rows // T_DST * H + csr.head_ids) * T_DST + rows % T_DST) * T_SRC + csr.src_ids
    dense = torch.zeros(N * H * T_DST * T_SRC, dtype=vals.dtype, device=vals.device)
    dense.index_add_(0, idx.reshape(-1), vals.reshape(-1))
    return dense.reshape(N, H, T_DST, T_SRC)
