"""The float32 forward body's arithmetic on the CPU
(csrc/block_sparse_causal.cu: `causal_tf32_wgmma_kernel`).

The body keeps float32 accuracy on TF32 wgmmas by splitting every operand
into hi + lo, each rounded as cvt.rna rounds it (`sea::to_tf32_rna`, on the
float's bits), and summing a·b = a_lo·b_hi + a_hi·b_lo + a_hi·b_hi per
8-wide k-step. S = Q·Kᵀ reads Q and K as they stand; P·V takes P from the S
accumulators as the A operand, whose fragment holds a thread's columns 2·t4
and 2·t4 + 1 of a k-step at k = t4 and t4 + 4, so each V sub-tile is written
into shared memory as Vᵀ with the keys of each group of 8 in the same order
(`sea::key_at`, `tf::transpose_tile`). The plain
model below repeats that arithmetic step for step (the split, the three
products in the body's k-order, the online softmax over the alive words, P
read through its fragment's column order against Vᵀ's key order, read from
the CUDA source) and holds it to the plain K1 within the float32
gate; the same model with one TF32 product a k-step, or with Vᵀ's keys in
their natural order, misses it."""

import re

import numpy as np
import pytest
import torch

from sea_tpu_torch.ops.kernels import _build
from sea_tpu_torch.ops.kernels import block_sparse as bs

H, T, T_M = 2, 256, 64
F32_TOL = 1e-5  # chip_smoke's float32 gate
LOG2E = 1.4426950408889634
SUB = 64  # the body's sub-tile of key columns


def to_tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 as cvt.rna (to nearest, ties away from
    zero): half of TF32's last place added to the bits, the 13 dropped bits
    cleared."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return ((bits + 0x1000) & 0xFFFFE000).to(torch.uint32).view(torch.float32).reshape(x.shape)


def split(x: torch.Tensor):
    hi = to_tf32_rna(x)
    return hi, to_tf32_rna(x - hi)


def key_at() -> list:
    """Vᵀ's key order within a group of 8 (`sea::key_at`), read from the
    CUDA source and evaluated for each k-position p."""
    text = (_build.CSRC / "sea_mma.cuh").read_text()
    cond, then, other = re.search(
        r"int key_at\(int p\) \{ return (.+?) \? (.+?) : (.+?); \}", text).groups()
    return [eval(then if eval(cond, {"p": p}) else other, {"p": p}) for p in range(8)]


# the S-accumulator column (of a k-step's 8) that P's A fragment holds at
# k-position p: k = t4 holds column 2·t4, k = t4 + 4 column 2·t4 + 1
FRAGMENT_COLUMN = [2 * p if p < 4 else 2 * (p - 4) + 1 for p in range(8)]


def tf32_product(a_hi, a_lo, b_hi, b_lo, acc, terms=3):
    """acc + a·b over the k-steps of 8 in order, each step's a_lo·b_hi,
    a_hi·b_lo and a_hi·b_hi (with `terms` 1, a_hi·b_hi alone) added to the
    float32 accumulator one at a time (TF32 products are exact in float64)."""
    pairs = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)][3 - terms:]
    for kk in range(a_hi.shape[1] // 8):
        ks = slice(8 * kk, 8 * kk + 8)
        for a, b in pairs:
            acc = (acc.double() + a[:, ks].double() @ b[ks].double()).float()
    return acc


def body_model(ops, terms=3, keys=None):
    """(NH, T, D) float32: the body on K1's operands, a row's sub-tiles in
    increasing order, a sub-tile not listed for its q-block (or wholly dead)
    leaving its state as it was."""
    keys = key_at() if keys is None else keys
    NH, T_DST, D = ops.q.shape
    t_src = ops.k.shape[1]
    alive = bs.words_to_mask(bs.kernel_alive_words(ops).reshape(NH * T_DST, -1), t_src)
    alive = alive.reshape(NH, T_DST, t_src)
    out = torch.empty((NH, T_DST, D))
    for bh in range(NH):
        q_hi, q_lo = split(ops.q[bh].float())
        k_hi, k_lo = split(ops.k[bh].float())
        v = ops.v[bh].float()
        m = torch.full((T_DST,), -1.0e30)
        l = torch.zeros(T_DST)
        acc = torch.zeros((T_DST, D))
        for c0 in range(0, t_src, SUB):
            cols = slice(c0, c0 + SUB)
            s = tf32_product(q_hi, q_lo, k_hi[cols].T, k_lo[cols].T, torch.zeros((T_DST, SUB)),
                             terms)
            a = alive[bh, :, cols]
            s = torch.where(a, s, torch.tensor(float("-inf")))
            m_new = torch.maximum(m, s.amax(1))
            corr = torch.exp2((m - m_new) * LOG2E)
            p = torch.exp2(s * LOG2E - (m_new * LOG2E)[:, None])
            l = l * corr + p.sum(1)
            acc = acc * corr[:, None]
            m = m_new
            # P's fragment columns against Vᵀ's keys, a group of 8 at a time
            frag = torch.tensor([8 * (c // 8) + FRAGMENT_COLUMN[c % 8] for c in range(SUB)])
            vkeys = torch.tensor([c0 + 8 * (c // 8) + keys[c % 8] for c in range(SUB)])
            p_hi, p_lo = split(p[:, frag])
            v_hi, v_lo = split(v[vkeys])
            acc = tf32_product(p_hi, p_lo, v_hi, v_lo, acc, terms)
        safe = torch.where(l > 0, l, torch.ones_like(l))
        out[bh] = acc / safe[:, None] * ops.scaler[bh][:, None]
    return out


def operands(D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, H, T, D)).astype(np.float32) * 0.2
    k = rng.standard_normal((1, H, T, D)).astype(np.float32) * 0.2
    v = rng.standard_normal((1, H, T, D)).astype(np.float32)
    sc = rng.uniform(0.1, 1.0, (1, H, T)).astype(np.float32)
    flat = np.zeros((T, H * T_M), np.float32)
    for r in range(T):
        budget = min(max(round(H * 8 * T_M / (r + 1)), 1), H * T_M)
        flat[r, rng.choice(H * T_M, size=budget, replace=False)] = 1.0
    mask = flat.reshape(T, H, T_M).transpose(1, 0, 2)[None].copy()
    q, k, v, sc, mask = (torch.from_numpy(x) for x in (q, k, v, sc, mask))
    return q, k, v, sc, mask


def test_split_is_cvt_rna():
    """hi and lo carry 10 fraction bits each (the low 13 of the float
    cleared) and hi + lo is x to about 2^-22 of it; ties round away from
    zero."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    assert bool(((hi.double() + lo.double() - x.double()).abs()
                 <= 2.0 ** -21 * x.double().abs()).all())
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])  # halfway between TF32s
    assert to_tf32_rna(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


def test_key_order_matches_the_fragment():
    """Vᵀ's key order is the order in which P's fragment holds its
    columns."""
    assert key_at() == FRAGMENT_COLUMN == [0, 2, 4, 6, 1, 3, 5, 7]


@pytest.mark.parametrize("D", [64, 80, 128])
def test_body_model_within_float32_gate(D):
    """The model against the plain K1 (`dense_reference`) within the float32
    gate; one TF32 product a k-step, or Vᵀ's keys in their natural order,
    miss it."""
    q, k, v, sc, mask = operands(D, seed=D)
    ops = bs.kernel_operands(bs.prepare_inputs(q, k, v, mask, sc))
    want = bs.dense_reference(q, k, v, mask, sc).reshape(H, T, D)
    err = float((body_model(ops) - want).abs().max())
    assert err <= F32_TOL, err
    one = float((body_model(ops, terms=1) - want).abs().max())
    natural = float((body_model(ops, keys=list(range(8))) - want).abs().max())
    assert one > 10 * F32_TOL and natural > 100 * F32_TOL, (one, natural)
