"""Port parity: the causal forward's impl variants 'flat_wr', 'flat_fori' and
'subtile' (kernels K9a-c on the card) against the JAX package.

Their prep (`_tile_word_ranges`, `tile_activity_sub`) is held bit for bit;
the element mask each variant sees on its operands (`alive_from_operands`,
and `alive_mask(impl=)`, the plain version of the restricted predicate the
card checks) must equal the oracle `element_mask_int8` bit for bit, so a word
range or piece mask that dropped an alive element fails here; the wrapper's
plain path is held to 2e-5 abs against the JAX wrapper running each Pallas
kernel in interpret mode (the JAX tests' bound). The CUDA kernels are held to
the same plain versions on the card by chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.ops.kernels import block_sparse as jb
from sea_tpu_torch.ops.kernels import block_sparse as tb
from tests._torch_parity import t
from tests.test_torch_block_sparse import budget_mask, make_case

ATOL = 2e-5
VARIANTS = ("flat_wr", "flat_fori", "subtile")

# (T, T_M, block_q, block_k, sub, rows shifted by): the JAX canary's geometry
# (tests/test_block_sparse_kernel.py:215-227), the impl test's, a shard whose
# rows start at 512, and 512-wide outer blocks in 128-wide pieces
PREP_CASES = {
    "canary_512": (512, 256, 128, 128, 64, 0),
    "tm32_256": (256, 32, 64, 64, 64, 0),
    "row_base_512": (512, 256, 128, 128, 64, 512),
    "outer_512_sub_128": (1024, 256, 512, 512, 128, 0),
}


def _widths(T, shift):
    return None if not shift else np.arange(T, dtype=np.float32) + shift + 1.0


@pytest.mark.parametrize("case", PREP_CASES)
def test_tile_word_ranges_and_sub_activity_exact(case):
    T, T_M, bq, bk, sub, shift = PREP_CASES[case]
    mask = budget_mask(T, H=2, T_M=T_M)
    w = _widths(T, shift)
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else t(w)
    t_src = T + shift
    n_words = (T_M + 31) // 32
    wc, wi = jb.tile_activity_lists(jnp.asarray(mask), t_src, True, bq, bk, row_widths=jw)
    want = jb._tile_word_ranges(wc, wi, T_M, n_words, bq, bk, row_widths=jw)
    _, gi = tb.tile_activity_lists(t(mask), t_src, True, bq, bk, row_widths=tw)
    got = tb._tile_word_ranges(gi, T_M, n_words, bq, bk, row_widths=tw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jb.tile_activity_sub(jnp.asarray(mask), t_src, bq, bk, sub, row_widths=jw)
    got = tb.tile_activity_sub(t(mask), t_src, bq, bk, sub, row_widths=tw)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_submask_bit_31_exact():
    """32 pieces of 64 in one 2048-wide block: bit 31 wraps to the sign; the
    first pieces of the last q-block, whose pixels are all off, are dead."""
    mask = budget_mask(2048, H=1, T_M=256)
    mask[..., :128] = 0.0
    want = jb.tile_activity_sub(jnp.asarray(mask), 2048, 64, 2048, 64)
    got = tb.tile_activity_sub(t(mask), 2048, 64, 2048, 64)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    last = int(got[2][0, 0, -1, 0])
    assert last < 0 and last & 0x7FFF == 0, hex(last & 0xFFFFFFFF)
    q, k, v, _, sc = (t(x) for x in make_case(T=2048, T_M=256, H=1))
    x = tb.prepare_inputs(q, k, v, t(mask), sc, block_q=64, block_k=2048)
    ops = tb.kernel_operands(x, impl="subtile", sub=64)
    oracle = tb.element_mask_int8(t(mask), 2048, True).bool()
    assert torch.equal(tb.alive_from_operands(ops, "subtile"), oracle)


@pytest.mark.parametrize("case", PREP_CASES)
@pytest.mark.parametrize("impl", tb.IMPLS)
def test_alive_from_operands_is_the_oracle(case, impl):
    T, T_M, bq, bk, sub, shift = PREP_CASES[case]
    q, k, v, _, sc = (t(x) for x in make_case(T=T, T_M=T_M, H=2))
    mask = t(budget_mask(T, H=2, T_M=T_M))
    row_base = None if not shift else torch.arange(T // bq, dtype=torch.int32) * bq + shift
    x = tb.prepare_inputs(q, k, v, mask, sc, row_base=row_base, block_q=bq, block_k=bk)
    ops = tb.kernel_operands(x, impl=impl, sub=sub if impl == "subtile" else 0)
    got = tb.alive_from_operands(ops, impl)
    want = tb.element_mask_int8(mask, T, True) if not shift else tb._alive_dense(
        mask, T, (torch.arange(T) + shift + 1.0)[:, None])
    assert torch.equal(got, want.bool())
    if not shift:
        # the plain version of the restricted predicate that chip_smoke holds
        # the card's to, at the wrapper's default blocks and at these
        assert torch.equal(tb.alive_mask(mask, T, impl=impl), want)
        assert torch.equal(tb.alive_mask(mask, T, impl=impl, block_q=bq, block_k=bk), want)


def test_a_range_that_drops_a_word_is_caught():
    """The check has teeth: narrowing one listed tile's range by a word that
    holds alive pixels makes the mask differ from the oracle."""
    q, k, v, _, sc = (t(x) for x in make_case(T=512, T_M=256, H=1))
    mask = t(budget_mask(512, H=1, T_M=256))
    ops = tb.kernel_operands(tb.prepare_inputs(q, k, v, mask, sc), impl="flat_wr")
    oracle = tb.element_mask_int8(mask, 512, True).bool()
    wr = ops.tile_aux.clone()
    e = int(ops.counts[0, -1]) - 1  # the last q-block's last listed tile
    lo, hi = int(wr[0, -1, e]) & 0xFF, (int(wr[0, -1, e]) >> 8) & 0xFF
    assert hi > lo
    wr[0, -1, e] = lo | ((hi - 1) << 8)
    narrowed = tb.alive_from_operands(ops._replace(tile_aux=wr), "flat_wr")
    assert not torch.equal(narrowed, oracle)
    # one 'subtile' piece off: columns 0-63 of the last q-block
    ops = tb.kernel_operands(tb.prepare_inputs(q, k, v, mask, sc, block_q=128, block_k=256),
                             impl="subtile", sub=64)
    dropped = ops.tile_aux.clone()
    dropped[0, -1, 0] &= ~1
    assert not torch.equal(tb.alive_from_operands(ops._replace(tile_aux=dropped), "subtile"),
                           oracle)


# the JAX tests' cases: every impl at T=256, T_M=32, 64 x 64 blocks
# (tests/test_block_sparse_kernel.py:203-212), the word-range canary at
# T=512, T_M=256, 128 x 128 (:215-227), and the defaults of each wrapper
WRAPPER_CASES = [(impl, 256, 32, 0.3, 64, 64) for impl in tb.IMPLS] + [
    (impl, 512, 256, 0.25, 128, 128) for impl in ("flat_wr", "flat_fori")
] + [(impl, 512, 256, 0.25, None, None) for impl in VARIANTS]


@pytest.mark.parametrize("impl,T,T_M,density,bq,bk", WRAPPER_CASES)
def test_impl_matches_jax_interpret(impl, T, T_M, density, bq, bk):
    q, k, v, mask, sc = make_case(T=T, T_M=T_M, density=density)
    want = jb.sea_block_sparse_attention(
        *(jnp.asarray(a) for a in (q, k, v, mask, sc)), is_causal=True, block_q=bq,
        block_k=bk, impl=impl, interpret=True)
    got = tb.sea_block_sparse_attention(*(t(a) for a in (q, k, v, mask, sc)),
                                        block_q=bq, block_k=bk, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_impl_with_row_base_and_oversample_matches_jax():
    """A shard's rows at global 512.., with the undersampling predicate."""
    q, k, v, mask, sc = make_case(T=256, T_M=32, density=0.3)
    row_base = np.arange(4, dtype=np.int32) * 64 + 512
    for impl in VARIANTS:
        want = jb.sea_block_sparse_attention(
            *(jnp.asarray(a) for a in (q, k, v, mask, sc)), is_causal=True, block_q=64,
            block_k=64, row_base=jnp.asarray(row_base), oversample=2.0, k_cfg=16.0,
            impl=impl, interpret=True)
        got = tb.sea_block_sparse_attention(
            *(t(a) for a in (q, k, v, mask, sc)), block_q=64, block_k=64,
            row_base=t(row_base), oversample=2.0, k_cfg=16.0, impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=impl)


def test_non_causal_ignores_impl():
    q, k, v, mask, sc = (t(x) for x in make_case(T=256, T_M=32))
    want = tb.sea_block_sparse_attention(q, k, v, mask, sc, is_causal=False)
    got = tb.sea_block_sparse_attention(q, k, v, mask, sc, is_causal=False, impl="subtile")
    assert torch.equal(got, want)


def test_refusals():
    q, k, v, mask, sc = (t(x) for x in make_case(T=256, T_M=32))
    with pytest.raises(ValueError, match="unknown impl"):
        tb.sea_block_sparse_attention(q, k, v, mask, sc, impl="fused")
    x = tb.prepare_inputs(q, k, v, mask, sc, block_q=128, block_k=128)
    with pytest.raises(ValueError, match="multiple of 64"):  # sub not a multiple of 64
        tb.kernel_operands(x, impl="subtile", sub=96)
    q, k, v, mask, sc = (t(x) for x in make_case(T=4096, T_M=32, H=1, density=0.01))
    x = tb.prepare_inputs(q, k, v, mask, sc, block_q=4096, block_k=4096)
    with pytest.raises(ValueError, match="at most 32"):  # 4096 / 64 = 64 pieces
        tb.kernel_operands(x, impl="subtile", sub=64)
    with pytest.raises(ValueError):  # the impls are the causal forward's only
        tb.kernel_operands(tb.prepare_inputs(q, k, v, mask, sc), differentiable=True,
                           impl="flat_wr")
