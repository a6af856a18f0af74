"""The bf16 backward bodies' walks on the CPU (csrc/block_sparse_diff.cu,
`causal_dq_wgmma_kernel` and `causal_dkv_wgmma_kernel`).

A block owns 128 query rows (dq) or 128 key columns (dk/dv), one consumer
warpgroup of 64 each. Its producer walks the union of the two consumers'
lists in increasing order (dq: the two q-blocks' `counts`/`idx`; dk/dv: the
two k-blocks' transposed `counts_t`/`idx_t`) and tags each 64-wide sub-tile
with each consumer's list entry, -1 where the sub-tile is dead for it. The
plain model below repeats that walk step for step (`seek_cols`,
`seek_rows`, `next`) on the lists the wrappers build (`kernel_operands`,
`window_operands`), and holds it to the element mask: every alive element
lies in exactly one visited (block, sub-tile) of the consumer that owns its
row (dq) or column (dk/dv). The alive words a dk/dv stage reads, one per
query row over each consumer's 64 columns (built by that consumer with
`alive_bits`, modelled by `alive_words`), must give the element mask
transposed. Budget masks at 64 x 64 and 128 x 256 lists, a 'seq' shard's
row bases, and a ring shard's windows (global k-block ids and column
bases)."""

from dataclasses import dataclass

import pytest
import torch

from sea_tpu_torch.ops.kernels import block_sparse as bs
from sea_tpu_torch.parallel import sharded_attention as sa
from tests.test_torch_block_sparse import budget_mask

SUB = 64  # a sub-tile's rows or columns, a consumer's share of a block
BLOCK = 2 * SUB  # a block's rows (dq) or columns (dk/dv)
H, T_M, D = 2, 64, 64


@dataclass
class Walk:
    """One consumer's walk: entry e, the sub-tile at `pos`, the list's
    length, its edge (dq: the first column past its rows' causal edge;
    dk/dv: its first global column) and the list."""

    e: int
    pos: int
    cnt: int
    edge: int
    lst: list


def seek_cols(w: Walk, block_k: int, col_stop: int) -> bool:
    while w.e < w.cnt:
        start = w.lst[w.e] * block_k
        w.pos = max(w.pos, start)
        if w.pos >= w.edge or w.pos >= col_stop:
            break
        if w.pos < start + block_k:
            return True
        w.e, w.pos = w.e + 1, -1
    w.e = w.cnt
    return False


def seek_rows(w: Walk, block_q: int, row_base: list) -> bool:
    while w.e < w.cnt:
        start = w.lst[w.e] * block_q
        w.pos = max(w.pos, start)
        while w.pos < start + block_q:
            if row_base[w.pos // block_q] + w.pos % block_q + SUB - 1 >= w.edge:
                return True
            w.pos += SUB
        w.e, w.pos = w.e + 1, -1
    return False


def union(walks, seek):
    """The producer's stages: [(sub-tile, entry of consumer 0, entry of
    consumer 1)], -1 where the sub-tile is not in that consumer's walk."""
    have = [seek(w) for w in walks]
    tags = []
    while have[0] or have[1]:
        at = walks[0].pos if not have[1] or (have[0] and walks[0].pos <= walks[1].pos) \
            else walks[1].pos
        tag = [at]
        for i, w in enumerate(walks):
            tag.append(w.e if have[i] and w.pos == at else -1)
            if tag[-1] >= 0:
                w.pos += SUB
                have[i] = seek(w)
        tags.append(tag)
    return tags


def dq_visits(counts, idx, row_base, block_q, block_k, t_dst, col_base, t_src):
    """{(bh, consumer's first local row): [visited sub-tiles' first global
    columns]} of every block of `causal_dq_wgmma_kernel`."""
    out = {}
    for bh in range(counts.shape[0]):
        for row0 in range(0, t_dst, BLOCK):
            walks = []
            for c in range(2):
                lr = row0 + SUB * c
                qb = lr // block_q
                first = row_base[qb] + lr - qb * block_q
                walks.append(Walk(0, -1, int(counts[bh, qb]), first + SUB, idx[bh, qb].tolist()))
            tags = union(walks, lambda w: seek_cols(w, block_k, col_base + t_src))
            for c in range(2):
                out[bh, row0 + SUB * c] = [t[0] for t in tags if t[1 + c] >= 0]
    return out


def dkv_visits(counts_t, idx_t, row_base, block_q, block_k, t_src, col_base):
    """{(bh, consumer's first local column): [visited sub-tiles' first local
    rows]} of every block of `causal_dkv_wgmma_kernel`."""
    out = {}
    for bh in range(counts_t.shape[0]):
        for col0 in range(0, t_src, BLOCK):
            walks = []
            for c in range(2):
                kb = (col0 + SUB * c) // block_k
                walks.append(Walk(0, -1, int(counts_t[bh, kb]), col_base + col0 + SUB * c,
                                  idx_t[bh, kb].tolist()))
            tags = union(walks, lambda w: seek_rows(w, block_q, row_base))
            for c in range(2):
                out[bh, col0 + SUB * c] = [t[0] for t in tags if t[1 + c] >= 0]
    return out


def check_dq(visits, alive, col_base):
    """Every alive element (bh, r, s) lies in exactly one visited sub-tile
    of the consumer owning row r: each consumer visits a sub-tile at most
    once, and every sub-tile with an alive element of its rows."""
    NH, T, C = alive.shape
    for (bh, r0), cols in visits.items():
        assert len(set(cols)) == len(cols), (bh, r0, cols)
        seen = torch.zeros(C // SUB, dtype=torch.bool)
        for c0 in cols:
            assert col_base <= c0 < col_base + C and c0 % SUB == 0, (bh, r0, c0)
            seen[(c0 - col_base) // SUB] = True
        live = alive[bh, r0:r0 + SUB].reshape(SUB, C // SUB, SUB).any(-1).any(0)
        assert not bool((live & ~seen).any()), (bh, r0, live.nonzero().flatten(), cols)


def check_dkv(visits, alive):
    """The same for dk/dv: each alive element of column s in exactly one
    visited 64-row sub-tile of the consumer owning s."""
    NH, T, C = alive.shape
    for (bh, c0), rows in visits.items():
        assert len(set(rows)) == len(rows), (bh, c0, rows)
        seen = torch.zeros(T // SUB, dtype=torch.bool)
        for r0 in rows:
            assert 0 <= r0 < T and r0 % SUB == 0, (bh, c0, r0)
            seen[r0 // SUB] = True
        live = alive[bh, :, c0:c0 + SUB].reshape(T // SUB, SUB, SUB).any(-1).any(-1)
        assert not bool((live & ~seen).any()), (bh, c0, live.nonzero().flatten(), rows)


def check_stage_words(visits, mbits, widths, alive, col_base, t_m):
    """The words each visited dk/dv stage reads: per query row of the
    sub-tile, `alive_words` over the consumer's 64 global columns (the
    kernel calls `alive_bits` at c0 = the consumer's first global column,
    the row's last column being its global row), which must give the
    element mask transposed: bit j of row r's word is alive[r, c0 + j]."""
    NH, T, C = alive.shape
    last = widths.long() - 1
    for bh in range(NH):
        words = bs.alive_words(mbits[bh], widths, last, col_base + C, t_m)
        for (b, c0), rows in visits.items():
            if b != bh:
                continue
            want_t = alive[bh, :, c0:c0 + SUB].T  # (columns, rows)
            for r0 in rows:
                got = bs.words_to_mask(words[r0:r0 + SUB, (col_base + c0) // SUB:][:, :1], SUB)
                assert torch.equal(got.T, want_t[:, r0:r0 + SUB]), (bh, c0, r0)


def _inputs(T, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((1, H, T, D), generator=g)
    k = torch.randn((1, H, T, D), generator=g)
    mask = torch.from_numpy(budget_mask(T, H=H, T_M=T_M, seed=seed))
    return q, k, mask


@pytest.mark.parametrize("blocks", [(64, 64), (128, 256)])
@pytest.mark.parametrize("shard", ["whole", "seq shard"])
def test_unsharded_walks(blocks, shard):
    """K3's and K4's walks over `kernel_operands`' lists: the whole sequence
    (T = 1024), or a 'seq' shard's rows 512-1023 against every column
    (`row_base`), at 64 x 64 and 128 x 256 lists."""
    block_q, block_k = blocks
    T = 1024
    row_base = None
    q, k, mask = _inputs(T, seed=3)
    if shard == "seq shard":
        q, mask = q[:, :, 512:], mask[:, :, 512:]
        row_base = torch.arange(512 // block_q, dtype=torch.int32) * block_q + 512
    x = bs.prepare_inputs(q, k, k, mask, row_base=row_base, block_q=block_q, block_k=block_k)
    ops = bs.kernel_operands(x, differentiable=True)
    NH, T_DST, _ = ops.mbits.shape
    widths = bs._row_widths(ops.row_base, block_q)
    alive = bs._alive_dense(x.mask_m, T, widths[:, None]).reshape(NH, T_DST, T)
    if shard == "whole":
        assert torch.equal(alive, bs.element_mask_int8(x.mask_m, T, True).reshape(NH, T_DST, T) == 1)
    rb = ops.row_base.tolist()
    check_dq(dq_visits(ops.counts, ops.idx, rb, block_q, block_k, T_DST, 0, T), alive, 0)
    visits = dkv_visits(ops.counts_t, ops.idx_t, rb, block_q, block_k, T, 0)
    check_dkv(visits, alive)
    check_stage_words(visits, ops.mbits, widths, alive, 0, T_M)


@pytest.mark.parametrize("block", [64, 128])
def test_ring_window_walks(block):
    """K7's and K8's walks over `window_operands`' lists: shard 1 of 4 at T
    = 1024 (zigzag rows), on each of its four windows: dq's lists carry
    global k-block ids and its columns stop at the window's end, dk/dv's
    are window-local while the skip and the words use global columns."""
    T, S = 1024, 4
    q, k, mask = _inputs(T, seed=5)
    perm, _, rows = sa._row_order(T, S, block, True, q.device)
    TL = T // S
    q_l, m_l, r_l = q[:, :, perm][:, :, TL:2 * TL], mask[:, :, perm][:, :, TL:2 * TL], rows[TL:2 * TL]
    ops = bs.window_operands(q_l, m_l, r_l, T, S, block, block)
    widths = (r_l + 1).float()
    NH = H
    rb = ops.row_base.tolist()
    for w in range(S):
        col_base = w * ops.window
        alive = bs._alive_dense(m_l, ops.window, widths[:, None], col_base).reshape(NH, TL, -1)
        check_dq(dq_visits(ops.counts[w], ops.idx[w], rb, block, block, TL, col_base,
                           ops.window), alive, col_base)
        visits = dkv_visits(ops.counts_t[w], ops.idx_t[w], rb, block, block, ops.window, col_base)
        check_dkv(visits, alive)
        check_stage_words(visits, ops.mbits, widths, alive, col_base, T_M)


def test_walk_skips_dead_sub_tiles():
    """The tags: at 64 x 64 lists the two consumers of a block own different
    q-blocks (dq) or k-blocks (dk/dv), so some stages are dead for one of
    them; a consumer never visits a sub-tile wholly past its rows' causal
    edge (dq) or wholly above its columns (dk/dv)."""
    T = 512
    q, k, mask = _inputs(T, seed=7)
    ops = bs.kernel_operands(bs.prepare_inputs(q, k, k, mask), differentiable=True)
    dq = dq_visits(ops.counts, ops.idx, ops.row_base.tolist(), 64, 64, T, 0, T)
    dkv = dkv_visits(ops.counts_t, ops.idx_t, ops.row_base.tolist(), 64, 64, T, 0)
    assert all(c0 <= r0 + SUB - 1 for (_, r0), cols in dq.items() for c0 in cols)
    assert all(r0 + SUB - 1 >= c0 for (_, c0), rows in dkv.items() for r0 in rows)
    # the second consumer's rows see one more sub-tile on the diagonal
    assert any(len(dq[bh, r0 + SUB]) > len(dq[bh, r0]) for bh in range(H)
               for r0 in range(0, T, BLOCK))
