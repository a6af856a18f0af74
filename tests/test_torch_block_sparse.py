"""Port parity: the fused causal kernel's prep, oracles and plain version
(sea_tpu_torch.ops.kernels.block_sparse vs sea_tpu.ops.kernels.block_sparse).

Prep and oracles are exact; the plain version is held to <= 1e-5 abs
against the JAX wrapper running the Pallas kernel in interpret mode. The
CUDA kernel itself is checked against the same plain version on the card
by chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.ops.kernels import block_sparse as jb
from sea_tpu_torch.ops.kernels import block_sparse as tb
from tests._torch_parity import t

ATOL = 1e-5


def make_case(seed=0, N=1, H=2, T=256, D=64, T_M=32, density=0.3):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((N, H, T, D)) * 0.2).astype(np.float32)
    k = (rng.standard_normal((N, H, T, D)) * 0.2).astype(np.float32)
    v = rng.standard_normal((N, H, T, D)).astype(np.float32)
    mask = (rng.uniform(size=(N, H, T, T_M)) < density).astype(np.float32)
    scaler = rng.uniform(0.1, 1.0, (N, H, T)).astype(np.float32)
    return q, k, v, mask, scaler


def budget_mask(T, H=12, T_M=256, K=64, seed=0):
    """Compressed mask with the production per-row budget round(H·k·T_M/w)."""
    rng = np.random.default_rng(seed)
    flat = np.zeros((1, T, H * T_M), np.float32)
    for r in range(T):
        budget = min(max(round(H * K * T_M / (r + 1)), 1), H * T_M)
        flat[0, r, rng.choice(H * T_M, size=budget, replace=False)] = 1.0
    return np.transpose(flat.reshape(1, T, H, T_M), (0, 2, 1, 3)).copy()


def test_pack_compressed_bits_exact():
    mask = make_case(T=64, T_M=256)[3]
    want = np.asarray(jb.pack_compressed_bits(jnp.asarray(mask)))
    got = tb.pack_compressed_bits(t(mask)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_tile_activity_lists_exact():
    """Main-path geometry: T=1024, T_M=256, 64x64 tiles."""
    mask = budget_mask(1024, H=2)
    for bq, bk in ((64, 64), (128, 256)):
        wc, wi = jb.tile_activity_lists(jnp.asarray(mask), 1024, True, bq, bk)
        gc, gi = tb.tile_activity_lists(t(mask), 1024, True, bq, bk)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_tile_activity_lists_row_widths_exact():
    mask = make_case(T=256, T_M=32, density=0.05)[3]
    widths = jnp.arange(256, dtype=jnp.float32) + 257.0  # rows 256.. of a shard
    wc, wi = jb.tile_activity_lists(jnp.asarray(mask), 512, True, 64, 64, row_widths=widths)
    gc, gi = tb.tile_activity_lists(t(mask), 512, True, 64, 64, row_widths=t(widths))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_element_mask_and_nnz_exact():
    mask = budget_mask(1024, H=2)
    want = np.asarray(jb.element_mask_int8(jnp.asarray(mask), 1024, True))
    got = tb.element_mask_int8(t(mask), 1024, True).numpy()
    np.testing.assert_array_equal(got, want)
    assert int(tb.mask_nnz(t(mask), 1024, True)) == int(jb.mask_nnz(jnp.asarray(mask), 1024, True))
    assert int(got.astype(np.int64).sum()) == int(tb.mask_nnz(t(mask), 1024, True))


def test_noncausal_oracles_exact():
    mask = make_case(T=256, T_M=32, density=0.2)[3]
    jm = jnp.asarray(mask)
    np.testing.assert_array_equal(
        tb.element_mask_int8(t(mask), 256, False).numpy(),
        np.asarray(jb.element_mask_int8(jm, 256, False)),
    )
    assert int(tb.mask_nnz(t(mask), 256, False)) == int(jb.mask_nnz(jm, 256, False))
    wc, wi = jb.tile_activity_lists(jm, 256, False, 64, 64)
    gc, gi = tb.tile_activity_lists(t(mask), 256, False, 64, 64)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    q, k, v, _, scaler = make_case(T=256, T_M=32)
    want = jb.dense_reference(q, k, v, jm, scaler, is_causal=False)
    got = tb.dense_reference(t(q), t(k), t(v), t(mask), t(scaler), is_causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_alive_mask_cpu_is_the_oracle():
    mask = make_case(T=128, T_M=16)[3]
    np.testing.assert_array_equal(
        tb.alive_mask(t(mask), 128).numpy(),
        tb.element_mask_int8(t(mask), 128, True).numpy(),
    )


def _run_both(case, **kw):
    q, k, v, mask, scaler = case
    jkw = dict(kw)
    if "row_base" in jkw:
        jkw["row_base"] = jnp.asarray(jkw["row_base"])
    want = jb.sea_block_sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        jnp.asarray(scaler), is_causal=True, interpret=True, **jkw,
    )
    if "row_base" in kw:
        kw["row_base"] = t(kw["row_base"])
    got = tb.sea_block_sparse_attention(t(q), t(k), t(v), t(mask), t(scaler), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    return got


@pytest.mark.parametrize("density", [0.05, 0.4])
def test_plain_matches_jax_kernel(density):
    _run_both(make_case(T=256, density=density), block_q=64, block_k=64)


def test_plain_empty_rows_zero():
    case = list(make_case(T=128, T_M=16))
    case[3][:, :, 64:80, :] = 0.0
    got = _run_both(tuple(case), block_q=64, block_k=64)
    assert float(got[:, :, 64:80].abs().max()) == 0.0


def test_plain_nonmultiple_length_padded():
    """T=96 is padded to 128 inside the wrapper and sliced back."""
    _run_both(make_case(T=96, density=0.3))


def test_plain_oversample_matches():
    _run_both(
        make_case(T=256, density=0.4), block_q=64, block_k=64,
        oversample=1.5, k_cfg=4.0,
    )


def test_plain_row_base_matches():
    """Rows of a sequence shard placed at global rows 256..511."""
    case = make_case(T=256, density=0.2, seed=3)
    row_base = (np.arange(4, dtype=np.int32) * 64 + 256)
    _run_both(case, block_q=64, block_k=64, row_base=row_base)


def test_wrapper_refuses_what_is_not_ported():
    """Still refused, as the JAX wrapper refuses it: the undersampling
    predicate off the causal path, and row_base with unpadded T."""
    q, k, v, mask, scaler = (t(x) for x in make_case(T=128, T_M=16))
    with pytest.raises(ValueError):
        tb.sea_block_sparse_attention(q, k, v, mask, scaler, is_causal=False, oversample=2.0)
    with pytest.raises(ValueError):
        tb.sea_block_sparse_attention(
            q[:, :, :100], k[:, :, :100], v[:, :, :100], mask[:, :, :100],
            row_base=torch.zeros(2, dtype=torch.int32),
        )


# --- the padded bidirectional path (kernel K5) ------------------------------


def right_padded(case, lengths):
    """Zero the rows of each example's padding, as the BERT path's top-k
    does (padded query rows keep no pixel)."""
    q, k, v, mask, scaler = case
    mask = mask.copy()
    for n, length in enumerate(lengths):
        mask[n, :, length:] = 0.0
    return q, k, v, mask, scaler


@pytest.mark.parametrize("t_m", [32, 128])
def test_tile_activity_lists_lengths_exact(t_m):
    lengths = np.array([160, 256, 1, 0], np.int32)
    mask = make_case(N=4, T=256, T_M=t_m, density=0.1)[3]
    for bq, bk in ((64, 64), (128, 128)):
        wc, wi = jb.tile_activity_lists(
            jnp.asarray(mask), 256, False, bq, bk, lengths=jnp.asarray(lengths))
        gc, gi = tb.tile_activity_lists(t(mask), 256, False, bq, bk, lengths=t(lengths))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_element_mask_lengths_and_nnz_exact():
    """The lengths-aware oracle against the rule written out in numpy, and
    the compressed-domain nnz against its sum; lengths 0 and 1 included."""
    T, T_M = 256, 128
    lengths = np.array([0, 1, 77, 200, 256], np.int32)
    mask = make_case(N=5, H=2, T=T, T_M=T_M, density=0.3)[3]
    got = tb.element_mask_int8(t(mask), T, False, lengths=t(lengths)).numpy()
    s = np.arange(T, dtype=np.float32)
    for n, length in enumerate(lengths):
        w = np.float32(max(length, 1))
        pix = np.clip(np.floor((s + np.float32(0.5)) / w * np.float32(T_M)
                               - np.float32(1e-4)), 0, T_M - 1).astype(np.int64)
        want = mask[n][:, :, pix] * (s < length)
        np.testing.assert_array_equal(got[n], want.astype(np.int8))
    nnz = int(tb.mask_nnz(t(mask), T, False, lengths=t(lengths)))
    assert nnz == int(got.astype(np.int64).sum())
    np.testing.assert_array_equal(
        tb.alive_mask(t(mask), T, is_causal=False, lengths=t(lengths)).numpy(), got)


def _run_both_bidir(case, lengths, **kw):
    q, k, v, mask, scaler = right_padded(case, lengths)
    want = jb.sea_block_sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        jnp.asarray(scaler), is_causal=False, lengths=jnp.asarray(lengths),
        interpret=True, **kw,
    )
    got = tb.sea_block_sparse_attention(
        t(q), t(k), t(v), t(mask), t(scaler), is_causal=False, lengths=t(lengths), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    plain = tb.dense_reference(t(q), t(k), t(v), t(mask), t(scaler), is_causal=False,
                               lengths=t(lengths))
    jplain = jb.dense_reference(q, k, v, jnp.asarray(mask), scaler, is_causal=False,
                                lengths=jnp.asarray(lengths))
    np.testing.assert_allclose(plain.numpy(), np.asarray(jplain), atol=ATOL)
    return got


@pytest.mark.parametrize("t_m", [32, 128])
@pytest.mark.parametrize("T", [256, 200])
def test_plain_bidir_matches_jax_kernel(T, t_m):
    """T=200 is padded to 256 inside both wrappers."""
    lengths = np.array([160, T], np.int32)
    _run_both_bidir(make_case(N=2, T=T, T_M=t_m, density=0.2, seed=T + t_m), lengths)


def test_plain_bidir_short_examples():
    """A one-token example and one whose rows keep no pixel give what the
    JAX kernel gives; the empty rows are exact zeros."""
    case = list(make_case(N=2, T=128, T_M=32, density=0.3, seed=5))
    case[3][1] = 0.0
    got = _run_both_bidir(tuple(case), np.array([1, 77], np.int32))
    assert float(got[1].abs().max()) == 0.0
