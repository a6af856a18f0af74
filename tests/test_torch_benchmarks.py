"""Port parity: the attention-operator sweep (sea_tpu_torch.benchmarks vs
sea_tpu.benchmarks and bench.py) on the CPU at a small size.

The sweep runs the plain versions here and returns one record per method;
its inputs are the JAX sweep's numpy draws exactly; each operator is held to
the JAX operator it ports on those inputs (dense and cosformer 1e-5 abs,
float32 sums in another order; the performer 1e-5 on JAX's projection; the
fused kernel's plain version 2e-5, the JAX kernel tests' bound, against the
Pallas 'flat_wr' kernel in interpret mode); `host_topk_mask` is bench.py's,
element for element."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from sea_tpu.ops.cosformer import _cos_features, cosformer_causal
from sea_tpu.ops.kernels.block_sparse import sea_block_sparse_attention
from sea_tpu.ops.performer import fast_attention, gaussian_orthogonal_random_matrix
from sea_tpu_torch import benchmarks as tbench
from tests._torch_parity import t

H, D, T, T_M, K = 2, 64, 256, 32, 16
ATOL = {"dense": 1e-5, "performer": 1e-5, "cosformer": 1e-5, "sea_fused": 2e-5}


def test_sweep_returns_a_record_per_method():
    res = tbench.attention_method_sweep(device="cpu", seq_lens=[T], num_heads=H, t_m=T_M, k=K)
    assert [r["method"] for r in res] == list(tbench.METHODS)
    for r in res:
        assert "error" not in r and r["ms"] > 0 and r["seq_len"] == T
        assert r["device"] == "cpu" and "mem_mb" not in r  # no device numbers on the CPU


def jax_inputs():
    """The JAX sweep's draws (sea_tpu/benchmarks.py:94-103), written out."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, H, T, D)).astype(np.float32) * 0.2
    kk = rng.standard_normal((1, H, T, D)).astype(np.float32) * 0.2
    v = rng.standard_normal((1, H, T, D)).astype(np.float32)
    mask_m = (rng.uniform(size=(1, H, T, T_M)) < min(K * T_M / T, 1.0)).astype(np.float32)
    return q, kk, v, mask_m


def jax_operators(mask_m, proj):
    """The JAX sweep's operators (sea_tpu/benchmarks.py:107-137)."""
    fpmin = float(np.finfo(np.float32).min) / 2

    def dense_fn(q, kk, v):
        causal = jnp.where(jnp.tril(jnp.ones((T, T))) > 0, 0.0, fpmin)[None, None]
        return jnp.einsum("nhts,nhsd->nhtd", jax.nn.softmax(
            jnp.einsum("nhtd,nhsd->nhts", q, kk) + causal, -1), v)

    def cosformer_fn(q, kk, v):
        fold = lambda x: x.reshape(H, T, D)  # noqa: E731
        qp = _cos_features(jax.nn.relu(fold(q)), T)
        kp = _cos_features(jax.nn.relu(fold(kk)), T)
        return cosformer_causal(qp, kp, fold(v)).reshape(1, H, T, D)

    return {
        "dense": dense_fn,
        "performer": lambda q, kk, v: fast_attention(q, kk, v, proj, causal=True,
                                                     generalized=True),
        "cosformer": cosformer_fn,
        "sea_fused": lambda q, kk, v: sea_block_sparse_attention(
            q, kk, v, jnp.asarray(mask_m), None, is_causal=True, impl="flat_wr",
            interpret=True),
    }


def test_sweep_inputs_are_the_jax_sweeps():
    got = tbench.sweep_inputs(T, H, D, T_M, K, torch.float32, "cpu")
    for g, w in zip(got, jax_inputs()):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("method", tbench.METHODS)
def test_operator_matches_jax(method):
    q, kk, v, mask_m = jax_inputs()
    proj = gaussian_orthogonal_random_matrix(jax.random.key(0), 266, D)
    want = jax_operators(mask_m, proj)[method](*(jnp.asarray(a) for a in (q, kk, v)))
    fn = tbench.attention_operators(T, t(mask_m), t(proj), torch.float32)[method]
    got = fn(t(q), t(kk), t(v))
    assert got.shape == (1, H, T, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL[method])


def test_host_topk_mask_is_bench_pys():
    Tm, Hm, Tq = 16, 3, 40
    got = tbench.host_topk_mask(2, Hm, Tq, Tm, 4, seed=3)
    np.testing.assert_array_equal(got, bench.host_topk_mask(2, Hm, Tq, Tm, 4, seed=3))
    per_row = got.transpose(0, 2, 1, 3).reshape(2, Tq, Hm * Tm).sum(-1)
    want = [min(max(round(Hm * 4 * Tm / (r + 1)), 1), Hm * Tm) for r in range(Tq)]
    np.testing.assert_array_equal(per_row, np.broadcast_to(want, (2, Tq)))
