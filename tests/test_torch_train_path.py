"""Port parity: the dense train path of `SeaAttention` (benchmarking=False
without use_fused_train) against the JAX module's, and the JAX package's
consistency gates on it: train vs the benchmark path
(tests/test_attention.py:102, tests/test_fused_path.py:12), the causality
canaries (tests/test_attention.py:116, :138) and the use_fused_train
gradients against the dense path's (tests/test_fused_path.py:88), each with
the JAX test's own bound. On the CPU the port's kernels take their plain
versions; chip_smoke.py holds the CUDA kernels to this path on the card.

Tolerances against JAX: the context layer and the loss 1e-5; the resized
estimated probabilities 1e-5 at T_M = 128. At the JAX tests' T_M = 16 the
estimator's LayerNorms run over 4 and 16 columns, and on rows of near-zero
variance at random init (the first query rows) they amplify float32
rounding: the estimated scores then differ from JAX's by up to 9e-4 and the
probabilities by up to 2.7e-5 before any resize (the resize itself is an
exact gather, tests/test_torch_masks.py), so there the probabilities are
held to 5e-5.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from sea_tpu.models.attention import SeaAttention as JaxSeaAttention
from sea_tpu_torch.models.attention import SeaAttention
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import t, torch_sea_config
from tests.test_attention import make_inputs, small_cfg
from tests.test_torch_masks import gate_seed, jax_jitter_draws

ATOL = 1e-5


def jax_run(cfg, inputs, truths, **kw):
    q, k, v, mask, truth, ctx = inputs
    model = JaxSeaAttention(cfg)
    variables = jax.jit(lambda: model.init(
        jax.random.key(0), q, k, v, q, k, v, q, k, mask,
        attention_scores_truth=truth, context_layer_truth=ctx))()
    tk = dict(attention_scores_truth=truth, context_layer_truth=ctx) if truths else {}
    out = model.apply(variables, q, k, v, q, k, v, q, k, mask, **tk, **kw)
    return variables, out


def port_run(cfg, variables, inputs, truths, **kw):
    q, k, v, mask, truth, ctx = (t(x) for x in inputs)
    model = SeaAttention(torch_sea_config(cfg), device="cpu", seed=None)
    model.load_state_dict(state_dict_from_jax(variables))
    tk = dict(attention_scores_truth=truth, context_layer_truth=ctx) if truths else {}
    with torch.no_grad():
        return model(q, k, v, q, k, v, q, k, mask, **tk, **kw)


def check_outputs(got, want, probs_atol):
    np.testing.assert_allclose(got.context_layer.numpy(), np.asarray(want.context_layer),
                               atol=ATOL)
    np.testing.assert_allclose(float(got.loss), float(want.loss), atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(got.partial_attention_mask.numpy() < -1,
                                  np.asarray(want.partial_attention_mask) < -1)
    if want.estimated_attention_probs is None:
        assert got.estimated_attention_probs is None
    else:
        np.testing.assert_allclose(got.estimated_attention_probs.numpy(),
                                   np.asarray(want.estimated_attention_probs), atol=probs_atol)


@pytest.mark.parametrize("t_m,probs_atol", [(128, ATOL), (16, 5e-5)], ids=["t_m128", "t_m16"])
@pytest.mark.parametrize("truths", [True, False], ids=["truths", "no_truths"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_dense_path_matches_jax(causal, truths, t_m, probs_atol):
    """Two examples of 32 tokens (non-causal: lengths 20 and 32): context,
    KD loss, the resized (T, T) mask's dead set and the resized estimate."""
    cfg = small_cfg(causal=causal, predictor_length=t_m)
    inputs = make_inputs(cfg, N=2, T=32, pad=None if causal else [20, 32])
    variables, want = jax_run(cfg, inputs, truths)
    got = port_run(cfg, variables, inputs, truths)
    check_outputs(got, want, probs_atol)
    assert (float(got.loss) > 0) == truths
    assert got.dense_attention_probs.shape == (2, cfg.num_heads, 32, 32)


@pytest.mark.parametrize("gate_on", [True, False], ids=["gate_on", "gate_off"])
def test_dense_path_training_jitter_matches_jax(gate_on):
    """training=True with truths: the causal resizes take JAX's jitter draws
    for the JAX key, gate on and off."""
    cfg = small_cfg(causal=True, predictor_length=128)
    inputs = make_inputs(cfg, N=2, T=32)
    rng = jax.random.key(gate_seed(gate_on))
    variables, want = jax_run(cfg, inputs, True, training=True, rng=rng)
    draws = tuple(t(d) for d in jax_jitter_draws(rng, (2, 1, 32, 32)))
    got = port_run(cfg, variables, inputs, True, training=True, jitter=draws)
    check_outputs(got, want, ATOL)
    plain = port_run(cfg, variables, inputs, True, training=True)
    assert torch.equal(plain.partial_attention_mask, got.partial_attention_mask) != gate_on


def port_model(cfg, seed=0, **kw):
    return SeaAttention(torch_sea_config(dataclasses.replace(cfg, **kw)), device="cpu", seed=seed)


def run(model, inputs, benchmarking, truths=False):
    q, k, v, mask, truth, ctx = (t(x) for x in inputs)
    tk = dict(attention_scores_truth=truth, context_layer_truth=ctx) if truths else {}
    with torch.no_grad():
        return model(q, k, v, q, k, v, q, k, mask, benchmarking=benchmarking, **tk)


@pytest.mark.parametrize("T", [128, 96])
def test_dense_matches_benchmark_path(T):
    """The port's dense train path against its benchmark path (K1's plain
    version on the CPU), within tests/test_fused_path.py:12's 2e-4; T = 96
    also pads inside the kernel wrapper."""
    cfg = small_cfg(causal=True)
    model = port_model(cfg)
    inputs = make_inputs(cfg, N=1, T=T)
    err = (run(model, inputs, False).context_layer
           - run(model, inputs, True).context_layer).abs().max()
    assert float(err) < 2e-4, float(err)


@pytest.mark.parametrize("benchmarking,pos", [(False, 20), (True, 16)], ids=["dense", "benchmark"])
def test_causality_canary(benchmarking, pos):
    """A huge perturbation of every input from position `pos` on leaves the
    outputs before it within 1e-3 (tests/test_attention.py:116, :138)."""
    cfg = small_cfg(causal=True)
    model = port_model(cfg)
    inputs = make_inputs(cfg, N=1, T=32)
    q, k, v, mask, truth, ctx = inputs
    poisoned = tuple(np.asarray(x).copy() for x in (q, k, v))
    for x in poisoned:
        x[..., pos:, :] = 3e5
    clean = run(model, inputs, benchmarking).context_layer[:, :pos]
    dirty = run(model, (*poisoned, mask, truth, ctx), benchmarking).context_layer[:, :pos]
    assert float((clean - dirty).abs().max()) < 1e-3


def test_fused_train_grads_match_dense_path():
    """use_fused_train (K2-K4's plain versions on the CPU) against the dense
    path from the same weights: the loss Σ context² at rtol 1e-4 and every
    gradient at atol 5e-3, rtol 1e-2 (tests/test_fused_path.py:88); the
    parameters behind the top-k selection, which the fused path leaves
    without a gradient, have exactly zero gradient on the dense path too."""
    cfg = small_cfg(causal=True)
    q, k, v, mask, _, _ = (t(x) for x in make_inputs(cfg, N=1, T=128))
    out = {}
    for fused in (False, True):
        model = port_model(cfg, use_fused_train=fused)
        o = model(q, k, v, q, k, v, q, k, mask, benchmarking=False, training=True)
        loss = (o.context_layer.float() ** 2).sum()
        loss.backward()
        out[fused] = (float(loss.detach()),
                      {n: p.grad for n, p in model.named_parameters()})
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-4)
    for name, dense in out[False][1].items():
        fused = out[True][1][name]
        if fused is None:
            assert dense is None or float(dense.abs().max()) == 0.0, name
            continue
        np.testing.assert_allclose(fused.numpy(), dense.numpy(), atol=5e-3, rtol=1e-2,
                                   err_msg=name)
