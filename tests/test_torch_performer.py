"""Port parity: FAVOR+ features and linear attention
(sea_tpu_torch.ops.performer vs sea_tpu.ops.performer), float32, <= 1e-5 abs.

The projection is drawn by JAX and handed to both sides; the port's own
generator only has to give an orthogonal-block matrix."""

import numpy as np
import jax
import pytest
import torch

from sea_tpu.ops import performer as jp
from sea_tpu_torch.ops import performer as tp
from tests._torch_parity import t

ATOL = 1e-5


def _inputs(T, seed=0, N=1, H=2, D=16, M=44, Dv=32):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((N, H, T, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((N, H, T, D)) * 0.5).astype(np.float32)
    v = rng.standard_normal((N, H, T, Dv)).astype(np.float32)
    proj = np.asarray(jp.gaussian_orthogonal_random_matrix(jax.random.key(seed), M, D))
    return q, k, v, proj


def test_kernel_features_match():
    q, k, _, proj = _inputs(T=96)
    for got, want in (
        (tp.relu_kernel_features(t(q), t(proj)), jp.relu_kernel_features(q, proj)),
        (tp.relu_kernel_features(t(q), None), jp.relu_kernel_features(q, None)),
        (tp.softmax_kernel_features(t(q), t(proj), True),
         jp.softmax_kernel_features(q, proj, True)),
        (tp.softmax_kernel_features(t(k), t(proj), False),
         jp.softmax_kernel_features(k, proj, False)),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("T", [200, 256])
def test_causal_linear_attention_matches(T):
    """T=200 leaves a partial last chunk (padding rows with den <= 0)."""
    q, k, v, proj = _inputs(T=T, seed=1)
    qp = np.asarray(jp.relu_kernel_features(q, proj))
    kp = np.asarray(jp.relu_kernel_features(k, proj))
    want = jp.causal_linear_attention(qp, kp, v)
    got = tp.causal_linear_attention(t(qp), t(kp), t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_fast_attention_matches(causal):
    q, k, v, proj = _inputs(T=160, seed=2)
    want = jp.fast_attention(q, k, v, proj, causal=causal, generalized=causal)
    got = tp.fast_attention(t(q), t(k), t(v), t(proj), causal=causal, generalized=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_projection_blocks_orthogonal():
    g = torch.Generator().manual_seed(0)
    proj = tp.gaussian_orthogonal_random_matrix(g, 40, 16, device="cpu")
    assert proj.shape == (40, 16)
    # rows of each full block are orthogonal: the Gram matrix is diagonal
    for b in range(2):
        blk = proj[16 * b: 16 * (b + 1)]
        gram = blk @ blk.T
        off = gram - torch.diag(torch.diagonal(gram))
        assert off.abs().max() < 1e-4
