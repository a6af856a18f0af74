"""The ring's window padding on the CPU (`block_sparse.pad_window`).

The window wrappers (K6 `fwd_stats_window`, K7 `dq_window`, K8
`dkv_window`) pad a shard's rows and a window's columns to whole 128-row
tiles before they launch a body on the card, as `prepare_inputs` pads T for
the unsharded kernels: the bf16 bodies' q-tiles and dk/dv's k-tiles are 128
wide, and so are the float32 forward's q-tiles at head width 64. Shards of
any whole `block_q` are the ring's (`_ring_blocks`), e.g. 4 shards of 192
rows at `block_q=64`. The padded operands must describe the same work: the
lists and words they carry give the unpadded window's element mask on the
real rows and columns and nothing alive on the padded ones, the transposed
lists name the same tiles, and the softmax over that mask, on the padded q,
k and v and cut back, is the unpadded plain K6."""

import numpy as np
import pytest
import torch

from sea_tpu_torch.ops.kernels import block_sparse as bs
from sea_tpu_torch.parallel import sharded_attention as sa

H, T_M, D = 2, 64, 64
T, S, BLOCK = 768, 4, 64  # 4 shards of 192 rows, windows of 192 columns


def budget_mask(seed, K=16):
    """(1, H, T, T_M) compressed mask with a per-row budget round(H·K·T_M / w)."""
    rng = np.random.default_rng(seed)
    flat = np.zeros((T, H * T_M), np.float32)
    for r in range(T):
        budget = min(max(round(H * K * T_M / (r + 1)), 1), H * T_M)
        flat[r, rng.choice(H * T_M, size=budget, replace=False)] = 1.0
    return torch.from_numpy(flat.reshape(T, H, T_M).transpose(1, 0, 2)[None].copy())


def listed(counts, idx, n_blocks):
    """(NH, NQ, n_blocks) bool: the blocks each q-block's (or k-block's)
    list names."""
    used = torch.arange(idx.shape[-1]) < counts[..., None]
    dense = torch.zeros((*idx.shape[:-1], n_blocks + 1), dtype=torch.bool)
    dense.scatter_(-1, torch.where(used, idx, n_blocks).long(), True)
    return dense[..., :n_blocks]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shard", [0, 3])
def test_window_padding(dtype, shard):
    g = torch.Generator().manual_seed(11 + shard)
    q, k, v = (torch.randn((1, H, T, D), generator=g).to(dtype) for _ in range(3))
    mask = budget_mask(seed=shard)
    perm, _, rows = sa._row_order(T, S, BLOCK, True, q.device)
    TL = T // S
    part = slice(shard * TL, (shard + 1) * TL)
    q_l, m_l, r_l = q[:, :, perm][:, :, part], mask[:, :, perm][:, :, part], rows[part]
    ops = bs.window_operands(q_l, m_l, r_l, T, S, BLOCK, BLOCK)
    CH = ops.window
    assert (TL, CH) == (192, 192)
    per_call = (torch.randn((H, TL, D), generator=g).to(dtype),
                torch.randn((H, TL), generator=g), torch.randn((H, TL), generator=g))
    widths = (r_l + 1).float()
    for w in range(S):
        col0 = w * CH
        k_w, v_w = (x[:, :, col0:col0 + CH].contiguous() for x in (k, v))
        p, k_p, v_p, *rows_p = bs.pad_window(ops, k_w, v_w, per_call)
        TP, CP = p.shape[2], p.window
        assert (TP, CP) == (256, 256) and p.q.shape == (H, TP, D)
        assert k_p.shape == v_p.shape == (1, H, CP, D)
        assert torch.equal(k_p[:, :, :CH], k_w) and not bool(k_p[:, :, CH:].any())
        assert torch.equal(p.mbits[:, :TL], ops.mbits) and not bool(p.mbits[:, TL:].any())
        assert torch.equal(p.row_base[:TL // BLOCK], ops.row_base)
        # the per-call rows: dou and delta padded with zeros, lse with +inf
        for got, want, fill in zip(rows_p, per_call, (0.0, float("inf"), 0.0)):
            assert torch.equal(got[:, :TL], want)
            assert bool((got[:, TL:] == fill).all())

        # the tiles: the forward lists (global k-block ids) and the
        # transposed ones (window-local k-blocks, local q-blocks) name the
        # same ones, none on a padded row or column
        nq, nk = TP // BLOCK, CP // BLOCK
        fwd = listed(p.counts[w], p.idx[w] - col0 // BLOCK, nk)  # (NH, nq, nk)
        assert torch.equal(fwd, listed(p.counts_t[w], p.idx_t[w], nq).transpose(1, 2))
        assert not bool(fwd[:, TL // BLOCK:].any()) and not bool(fwd[:, :, CH // BLOCK:].any())
        assert torch.equal(fwd[:, :TL // BLOCK, :CH // BLOCK],
                           listed(ops.counts[w], ops.idx[w] - col0 // BLOCK, CH // BLOCK))

        # the element mask on those tiles, and the softmax over it on the
        # padded operands, cut back: the plain K6 on the unpadded ones
        raw = torch.zeros((H, TP, CP), dtype=torch.bool)
        raw[:, :TL] = bs._alive_dense(m_l, CP, widths[:, None], col0).reshape(H, TL, CP)
        alive = raw & fwd.repeat_interleave(BLOCK, 1).repeat_interleave(BLOCK, 2)
        want_alive = bs._alive_dense(m_l, CH, widths[:, None], col0).reshape(H, TL, CH)
        assert torch.equal(alive[:, :TL, :CH], want_alive)
        assert not bool(alive[:, TL:].any()) and not bool(alive[:, :, CH:].any())
        out, _, _ = bs._softmax_pv(p.q.reshape(1, H, TP, D), k_p, v_p, alive[None], None)
        want_o, _ = bs.fwd_stats_window_reference(q_l.float(), k_w.float(), v_w.float(), m_l,
                                                  col0, row_widths=widths)
        torch.testing.assert_close(out[:, :, :TL], want_o, atol=1e-6, rtol=0)
        assert not bool(out[:, :, TL:].any())


def test_whole_tiles_are_not_copied():
    """Shards and windows of whole 128-row tiles (the main path's 4 shards
    of 4096 rows at blocks 128) go to the kernels as they are."""
    q = torch.zeros((1, H, 256, D))
    mask = torch.ones((1, H, 256, T_M))
    ops = bs.window_operands(q, mask, torch.arange(256), 512, 2, 128, 128)
    kv = torch.zeros((1, H, 256, D))
    p, k_p, v_p = bs.pad_window(ops, kv, kv)
    assert p is ops and k_p is kv and v_p is kv
