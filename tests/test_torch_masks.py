"""Port parity: grouped top-k masks (sea_tpu_torch.ops.masks vs sea_tpu.ops.masks).

Everything here is exact: the budget and the mask are integer-valued
results of float32 arithmetic that both sides do in the same order."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.ops import masks as jm
from sea_tpu_torch.ops import masks as tm
from tests._torch_parity import t


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
        got = tm.resize_noncausal(t(x), fill, t(am), T2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
