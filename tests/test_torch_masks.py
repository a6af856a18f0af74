"""Port parity: grouped top-k masks and the compressed-mask resize
(sea_tpu_torch.ops.masks vs sea_tpu.ops.masks).

Everything here is exact: the budget, the masks and the resize's index map
are integer-valued results of float32 arithmetic that both sides do in the
same order, and the resize moves values without arithmetic. The training
jitter takes the JAX package's own `jax.random.uniform` draws."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.ops import masks as jm
from sea_tpu_torch.ops import masks as tm
from tests._torch_parity import assert_topk_margin, t

FP_MIN32 = float(np.finfo(np.float32).min) / 2


def test_fp_min_and_round_half_away():
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        assert tm.fp_min_for(td) == jm.fp_min_for(jd)
    x = np.array([0.0, 0.5, 1.5, 2.5, 2.4999, 7.5], np.float32)
    np.testing.assert_array_equal(
        tm.round_half_away(t(x)).numpy(), np.asarray(jm.round_half_away(jnp.asarray(x)))
    )


@pytest.mark.parametrize("k_oversample", [1.0, 1.5])
def test_per_item_top_k_causal_exact(k_oversample):
    """The production schedule round(H·k·T_M/w) at T=1024, T_M=256, k=64."""
    N, T, H, T_M, K = 2, 1024, 12, 256, 64
    ctl = np.broadcast_to(np.arange(1, T + 1, dtype=np.float32).reshape(1, T, 1), (N, T, 1))
    token_length = np.full((N, 1), float(T), np.float32)
    want = jm.per_item_top_k(
        K, k_oversample, "causal_batch", H, T_M, jnp.asarray(token_length),
        jnp.asarray(ctl), causal=True,
    )
    got = tm.per_item_top_k(
        K, k_oversample, "causal_batch", H, T_M, t(token_length), t(ctl), causal=True
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k_flatten_dim", ["batch", "head", "query", "causal_batch"])
def test_per_item_top_k_noncausal_exact(k_flatten_dim):
    token_length = np.array([[100.0], [37.0]], np.float32)
    want = jm.per_item_top_k(7, 1.0, k_flatten_dim, 4, 32, jnp.asarray(token_length))
    got = tm.per_item_top_k(7, 1.0, k_flatten_dim, 4, 32, t(token_length))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("benchmarking", [True, False])
def test_topk_mask_with_ties_exact(benchmarking):
    """Estimates quantised to a few levels, so that most selections cut
    through runs of equal values: ties must break by ascending index on
    both sides, with dead query rows filled."""
    rng = np.random.default_rng(0)
    N, H, T, T_M, K = 2, 3, 64, 16, 4
    probs = (rng.integers(0, 4, (N, H, T, T_M)) / 4.0).astype(np.float32)
    dst_alive = np.ones((N, 1, T, 1), bool)
    dst_alive[1, :, 50:] = False
    probs = probs * dst_alive
    ctl = np.broadcast_to(np.arange(1, T + 1, dtype=np.float32).reshape(1, T, 1), (N, T, 1))
    budget = jm.per_item_top_k(K, 1.0, "causal_batch", H, T_M, None, jnp.asarray(ctl), True)
    fpmin = jm.fp_min_for(jnp.float32)
    want = jm.topk_mask(
        jnp.asarray(probs), jnp.asarray(dst_alive), budget, "causal_batch",
        benchmarking, fpmin,
    )
    got = tm.topk_mask(
        t(probs), t(dst_alive), t(budget), "causal_batch", benchmarking, fpmin
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ranks_desc_stable_on_ties():
    x = np.array([[0.5, 1.0, 0.5, 1.0, 0.0, 0.5]], np.float32)
    np.testing.assert_array_equal(
        tm._ranks_desc(t(x)).numpy(), np.asarray(jm._ranks_desc(jnp.asarray(x)))
    )
    np.testing.assert_array_equal(tm._ranks_desc(t(x)).numpy(), [[2, 0, 3, 1, 5, 4]])


@pytest.mark.parametrize("fill", [0.0, float(np.finfo(np.float32).min) / 2], ids=["zero", "fp_min"])
def test_resize_from_m_to_t_noncausal_exact(fill):
    """The non-causal resize of the BERT path's average-pool weights (T1 = 1)
    and of a full map, on right-padded masks: bit for bit."""
    rng = np.random.default_rng(5)
    T2, T_M = 200, 128
    am = np.zeros((3, 1, 1, T2), np.float32)
    for n, length in enumerate((200, 77, 1)):
        am[n, ..., length:] = jm.fp_min_for(jnp.float32)
    for T1 in (1, 7):
        x = rng.uniform(size=(3, 2, T1, T_M)).astype(np.float32)
        want = jm.resize_from_m_to_t(jnp.asarray(x), fill, jnp.asarray(am), T2, is_causal=False)
        got = tm.resize_from_m_to_t(t(x), fill, t(am), T2, is_causal=False)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def causal_additive_mask(T, lefts):
    """(N, 1, T, T) additive causal mask, example n left-padded by lefts[n]
    (as `build_causal_mask` of both packages makes it)."""
    alive = np.tril(np.ones((T, T), bool))[None] & (np.arange(T)[None, :] >= np.asarray(lefts)[:, None])[:, None, :]
    return np.where(alive, 0.0, FP_MIN32).astype(np.float32)[:, None]


def jax_jitter_draws(rng, shape):
    """The draws the JAX resize takes from `rng`: split, then the noise's
    and the gate's uniforms."""
    jitter_rng, gate_rng = jax.random.split(rng)
    return (np.asarray(jax.random.uniform(jitter_rng, shape)),
            np.asarray(jax.random.uniform(gate_rng, ())))


def gate_seed(on: bool) -> int:
    """The first key whose gate fires (or does not)."""
    for seed in range(1000):
        _, gate = jax.random.split(jax.random.key(seed))
        if (float(jax.random.uniform(gate, ())) < 0.1) == on:
            return seed
    raise AssertionError("no such seed")


@pytest.mark.parametrize("lefts", [(0,), (0, 37)], ids=["no_pad", "left_padded"])
@pytest.mark.parametrize("fill", [0.0, FP_MIN32], ids=["zero", "fp_min"])
def test_resize_from_m_to_t_causal_exact(lefts, fill):
    """The causal resize at T = 256 (the JAX package's one-hot matmul branch
    without padding, its gather with), bit for bit."""
    N, H, T, T_M = len(lefts), 2, 256, 32
    x = np.random.default_rng(1).uniform(size=(N, H, T, T_M)).astype(np.float32)
    am = causal_additive_mask(T, lefts)
    want = jm.resize_from_m_to_t(jnp.asarray(x), fill, jnp.asarray(am), T)
    got = tm.resize_from_m_to_t(t(x), fill, t(am), T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gate_on", [True, False], ids=["gate_on", "gate_off"])
def test_resize_jitter_with_jax_draws_exact(gate_on):
    """The training jitter, given JAX's draws for the same key: bit for bit,
    on a left-padded batch; with the gate on the map differs from the
    unjittered one."""
    N, H, T, T_M = 2, 2, 96, 16
    x = np.random.default_rng(2).uniform(size=(N, H, T, T_M)).astype(np.float32)
    am = causal_additive_mask(T, (0, 11))
    rng = jax.random.key(gate_seed(gate_on))
    want = jm.resize_from_m_to_t(jnp.asarray(x), 0.0, jnp.asarray(am), T, rng=rng)
    draws = tuple(t(d) for d in jax_jitter_draws(rng, am.shape))
    got = tm.resize_from_m_to_t(t(x), 0.0, t(am), T, jitter=draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = tm.resize_from_m_to_t(t(x), 0.0, t(am), T)
    assert torch.equal(got, plain) != gate_on


def test_resize_jitter_draws_shapes_and_range():
    g = torch.Generator().manual_seed(0)
    noise, gate = tm.resize_jitter_draws((2, 1, 8, 8), g)
    assert noise.shape == (2, 1, 8, 8) and gate.shape == ()
    assert float(noise.min()) >= 0.0 and float(noise.max()) < 1.0
    again = tm.resize_jitter_draws((2, 1, 8, 8), torch.Generator().manual_seed(0))
    assert torch.equal(noise, again[0]) and torch.equal(gate, again[1])


@pytest.mark.parametrize("lefts", [(0,), (0, 37)], ids=["no_pad", "left_padded"])
def test_resize_oversample_keep_predicate_exact(lefts):
    """The undersampling keep-predicate at k_oversample 1.5 (k = 4), bit for
    bit."""
    N, H, T, T_M = len(lefts), 2, 128, 16
    x = np.random.default_rng(3).uniform(size=(N, H, T, T_M)).astype(np.float32)
    am = causal_additive_mask(T, lefts)
    want = jm.resize_from_m_to_t(jnp.asarray(x), FP_MIN32, jnp.asarray(am), T,
                                 k=4, oversampled=1.5)
    got = tm.resize_from_m_to_t(t(x), FP_MIN32, t(am), T, k=4, oversampled=1.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dropped = tm.resize_from_m_to_t(t(x), FP_MIN32, t(am), T) != got
    assert bool(dropped.any())


@pytest.mark.parametrize("benchmarking", [True, False])
def test_causal_topk_masking_matches_jax(benchmarking):
    """The standalone causal top-k on a left-padded batch; estimates whose
    top-k cuts are guarded against near ties."""
    rng = np.random.default_rng(4)
    N, H, T, T_M, K = 2, 3, 64, 16, 4
    probs = rng.uniform(size=(N, H, T, T_M)).astype(np.float32)
    am = causal_additive_mask(T, (0, 9))
    dst = np.ascontiguousarray(am[:, :, :, :1])
    dst[1, :, :9] = FP_MIN32
    ctl = np.broadcast_to(np.arange(1, T + 1, dtype=np.float32).reshape(1, T, 1), (N, T, 1))
    budget = jm.per_item_top_k(K, 1.0, "causal_batch", H, T_M, None, jnp.asarray(ctl), True)
    assert_topk_margin([probs * (dst > -1)], [budget])
    want = jm.causal_topk_masking(jnp.asarray(probs), K, jnp.asarray(am), jnp.asarray(dst),
                                  jnp.asarray(am), benchmarking=benchmarking)
    got = tm.causal_topk_masking(t(probs), K, t(am), t(dst), t(am), benchmarking=benchmarking)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
