"""Port parity: the uniform flat CSR (sea_tpu_torch.ops.flat_csr vs
sea_tpu.ops.flat_csr) and the benchmark path's CSR routes through whole
models, at tiny sizes.

The expansion's columns are held bit for bit (causal and non-causal, runs
clamped to k, rows truncated at max_nnz, and T_DST < T_SRC); every other
function's values within 1e-6 (float32 sums in another order). OPT's
`use_pallas=False` logits and BERT's oversampled route (`k_oversample=2.0`,
which JAX sends to the CSR) within ATOL 1e-4 as tests/test_torch_opt.py
holds the fused path, on the port's seeded weights (the JAX trees read from
its state dicts), the top-k guarded on the port's estimates."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.config import SeaConfig
from sea_tpu.models import bert as jbert
from sea_tpu.models import opt as jopt
from sea_tpu.ops import flat_csr as jcsr
from sea_tpu_torch.models import bert as tbert
from sea_tpu_torch.models import opt as topt
from sea_tpu_torch.ops import flat_csr as tcsr
from tests._torch_parity import (jax_variables_from_state_dict, port_topk_guard, sharpen_port,
                                 t, torch_opt_config, torch_sea_config)

ATOL = 1e-4
OP_ATOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def compressed(N, H, T_DST, T_M, density, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(N, H, T_DST, T_M)) < density).astype(np.float32)


def both_csr(mask, k, t_src, causal, max_nnz=None):
    want = jax.jit(functools.partial(jcsr.resize_from_m_to_t_csr, k=k, target_width=t_src,
                                     is_causal=causal, max_nnz=max_nnz))(jnp.asarray(mask))
    got = tcsr.resize_from_m_to_t_csr(t(mask), k, t_src, is_causal=causal, max_nnz=max_nnz)
    return got, want


# (causal, T_DST, T_SRC, k, max_nnz): runs clamp to k where the row is wider
# than T_M·k; the last case truncates most rows
CASES = {
    "causal": (True, 48, 48, 2, None),
    "causal_tdst_lt_tsrc": (True, 32, 80, 2, None),
    "noncausal": (False, 40, 40, 2, None),
    "noncausal_wide": (False, 24, 200, 4, None),
    "truncated": (True, 48, 48, 3, 16),
}


@pytest.mark.parametrize("case", CASES)
def test_resize_csr_bit_for_bit(case):
    causal, T_DST, T_SRC, k, max_nnz = CASES[case]
    mask = compressed(2, 3, T_DST, 16, 0.35, seed=len(case))
    got, want = both_csr(mask, k, T_SRC, causal, max_nnz)
    assert got.num_heads == want.num_heads and got.t_src == want.t_src
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.nnz_per_row.numpy(), np.asarray(want.nnz_per_row))
    for name in ("valid", "head_ids", "src_ids"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    if case == "truncated":
        assert (got.nnz_per_row == max_nnz).any()
    if case == "causal":
        # some run was clamped to k entries
        w = np.arange(1, T_SRC + 1) / 16
        assert (np.floor((np.arange(16) + 1) * w[:, None] + 0.5)
                - np.floor(np.arange(16) * w[:, None] + 0.5)).max() > k


@pytest.mark.parametrize("causal", [True, False])
def test_csr_ops_match_jax(causal):
    N, H, T, D, T_M, k = 2, 3, 40, 8, 8, 3
    rng = np.random.default_rng(7)
    q, kk, v = (rng.standard_normal((N, H, T, D)).astype(np.float32) for _ in range(3))
    scaler = rng.uniform(size=(N, H, T)).astype(np.float32)
    mask = compressed(N, H, T, T_M, 0.4, seed=3)
    got, want = both_csr(mask, k, T, causal)

    w = jax.jit(jcsr.flat_csr_masked_bmm)(jnp.asarray(q), jnp.asarray(kk), want)
    g = tcsr.flat_csr_masked_bmm(t(q), t(kk), got)
    np.testing.assert_allclose(g.values.numpy(), np.asarray(w.values), atol=OP_ATOL, rtol=0)
    ws = jax.jit(jcsr.flat_csr_softmax)(w)
    gs = tcsr.flat_csr_softmax(g)
    np.testing.assert_allclose(gs.values.numpy(), np.asarray(ws.values), atol=OP_ATOL, rtol=0)
    we = jax.jit(jcsr.flat_csr_elmul)(ws, jnp.asarray(scaler))
    ge = tcsr.flat_csr_elmul(gs, t(scaler))
    np.testing.assert_allclose(ge.values.numpy(), np.asarray(we.values), atol=OP_ATOL, rtol=0)
    wo = jax.jit(jcsr.flat_csr_sdbmm)(we, jnp.asarray(v))
    go = tcsr.flat_csr_sdbmm(ge, t(v))
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), atol=OP_ATOL, rtol=0)
    wd = jax.jit(jcsr.flat_csr_to_dense)(we)
    gd = tcsr.flat_csr_to_dense(ge)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=OP_ATOL, rtol=0)
    # the chain is a masked softmax: the dense rebuild gives the same context
    alive = tcsr.flat_csr_to_dense(got) > 0
    scores = torch.einsum("nhtd,nhsd->nhts", t(q), t(kk)).masked_fill(~alive, -torch.inf)
    probs = torch.nan_to_num(torch.softmax(scores, -1)) * t(scaler)[..., None]
    np.testing.assert_allclose(go.numpy(), (probs @ t(v)).numpy(), atol=OP_ATOL, rtol=0)


def test_empty_rows_give_zeros():
    mask = np.zeros((1, 2, 16, 8), np.float32)
    mask[0, 1, 5:, 3] = 1.0
    got, want = both_csr(mask, 2, 16, True)
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
    v = torch.ones((1, 2, 16, 4))
    out = tcsr.flat_csr_sdbmm(tcsr.flat_csr_softmax(got), v)
    assert torch.equal(out[0, 0], torch.zeros(16, 4)) and torch.equal(out[0, 1, :5], torch.zeros(5, 4))
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# whole models through the CSR routes


def tiny_opt():
    sea = SeaConfig(num_heads=2, head_dim=16, predictor_length=16, k=4, performer_nb_factor=1,
                    causal=True, max_position_embeddings=128, use_pallas=False).validate()
    return jopt.OptConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, ffn_dim=64,
                          max_position_embeddings=128, attention_method="perlin", sea=sea)


def test_opt_csr_logits_match_jax(monkeypatch):
    """OPT's `use_pallas=False` benchmark forward: logits and loss of a
    left-padded batch within ATOL, and no kernel launched."""
    cfg = tiny_opt()
    T = 96
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 64, (2, T)).astype(np.int32)
    am = np.ones((2, T), np.int32)
    am[1, :21] = 0
    port = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=3)
    model = jopt.OptForCausalLM(cfg)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.asarray(ids), jnp.asarray(am))
    variables = jax_variables_from_state_dict(shapes, port.state_dict())
    want = jax.jit(functools.partial(model.apply, benchmarking=True))(
        variables, jnp.asarray(ids), jnp.asarray(am), jnp.asarray(ids))

    def no_kernel(*a, **kw):
        raise AssertionError("the CSR path ran the fused kernel's wrapper")

    monkeypatch.setattr("sea_tpu_torch.models.attention.sea_block_sparse_attention", no_kernel)
    with torch.no_grad():
        got = port_topk_guard(lambda: port(t(ids).long(), t(am).long(), t(ids).long(),
                                           benchmarking=True))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=ATOL)


def test_bert_oversampled_csr_logits_match_jax(monkeypatch):
    """BERT with `k_oversample=2.0`: the route JAX's use_fused predicate
    sends to the CSR (the fused K5 path takes k_oversample 1 only); logits
    and loss of a right-padded batch within ATOL, no kernel launched."""
    sea = SeaConfig(num_heads=2, head_dim=16, predictor_length=16, k=4, performer_nb_factor=1,
                    causal=False, k_oversample=2.0).validate()
    cfg = jbert.BertConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, ffn_dim=64,
                           max_position_embeddings=64, attention_method="perlin", sea=sea)
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(tbert.BertConfig)}
    port = sharpen_port(tbert.BertForSequenceClassification(
        tbert.BertConfig(**{**d, "sea": torch_sea_config(sea)}), device="cpu", seed=4))
    T = 64
    rng = np.random.default_rng(8)
    am = (np.arange(T)[None, :] < np.array([64, 37])[:, None]).astype(np.int32)
    ids = (rng.integers(4, 64, (2, T)) * am).astype(np.int32)
    types = np.zeros_like(ids)
    labels = np.array([0, 1], np.int32)
    model = jbert.BertForSequenceClassification(cfg)
    jargs = [jnp.asarray(x) for x in (ids, am, types)]
    shapes = jax.eval_shape(model.init, jax.random.key(0), *jargs)
    variables = jax_variables_from_state_dict(shapes, port.state_dict())
    want = jax.jit(functools.partial(model.apply, benchmarking=True))(
        variables, *jargs, jnp.asarray(labels))

    def no_kernel(*a, **kw):
        raise AssertionError("the oversampled non-causal route ran the fused kernel's wrapper")

    monkeypatch.setattr("sea_tpu_torch.models.attention.sea_block_sparse_attention", no_kernel)
    with torch.no_grad():
        got = port_topk_guard(lambda: port(*(t(x).long() for x in (ids, am, types, labels)),
                                           benchmarking=True))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=ATOL)
