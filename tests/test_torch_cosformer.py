"""Port parity: the cosformer operator and SEA's cosformer estimator backend
(sea_tpu_torch.ops.cosformer and models.attention vs sea_tpu's).

The operator's pieces are held to 1e-5 abs against JAX on the same numpy
inputs (float32, sums in another order), and the linear causal form to the
masked quadratic form (the port of tests/test_baselines.py:52). The module
and a 2-layer OPT at OPT-125m's widths with `predictor_backend="cosformer"`
run with weights carried from the JAX init by `state_dict_from_jax`: the
module's output to 1e-5, the OPT's top-k masks exactly (under the near-tie
guard) and its logits to LOGIT_ATOL."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.config import opt_config as jax_opt_config
from sea_tpu.models import opt as jopt
from sea_tpu.ops import cosformer as jc
from sea_tpu.utils.profiler import get_bench as jax_bench
from sea_tpu_torch.models import opt as topt
from sea_tpu_torch.ops import cosformer as tc
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import t, topk_near_ties, torch_opt_config

ATOL = 1e-5
# logits of two full-width layers and the tied 768-wide head: float32 sums of
# 768-3072 terms in another order, as tests/test_torch_opt.py's 1e-4
LOGIT_ATOL = 1e-4
# the near-tie guard's margin on the estimates. At OPT-125m's width a row
# holds 12 x 256 estimates of about 1/256 each, so neighbours in the sorted
# row sit 1e-8 to 1e-6 apart and the 1e-4 of the tiny models would refuse
# every seed. A pick flips only if the two estimates of a pair move apart by
# more than their gap, and each moves by at most the largest difference
# between the two sides' estimates: below 0.01, where the top-k cuts, 6.05e-8
# at SEED (both layers; 5.5e-8 to 1.32e-7 over seeds 0-39 wherever the
# layers' masks agree). So a gap above 2e-7, over twice that, cannot flip one.
TOPK_MARGIN = 2e-7


def _features(seed, B=2, T=40, M=8, Dv=12):
    rng = np.random.default_rng(seed)
    qp = rng.uniform(0.1, 1, (B, T, M)).astype(np.float32)
    kp = rng.uniform(0.1, 1, (B, T, M)).astype(np.float32)
    v = rng.standard_normal((B, T, Dv)).astype(np.float32)
    return qp, kp, v


def test_cos_features_match_jax():
    x = np.abs(np.random.default_rng(0).standard_normal((3, 50, 16))).astype(np.float32)
    for m in (50, 77):
        np.testing.assert_allclose(tc._cos_features(t(x), m).numpy(),
                                   np.asarray(jc._cos_features(jnp.asarray(x), m)), atol=ATOL)


@pytest.mark.parametrize("chunk,T", [(16, 40), (16, 48), (128, 200), (128, 256)])
def test_cosformer_causal_matches_jax(chunk, T):
    qp, kp, v = _features(1, T=T)
    want = jc.cosformer_causal(*(jnp.asarray(a) for a in (qp, kp, v)), chunk=chunk)
    got = tc.cosformer_causal(t(qp), t(kp), t(v), chunk=chunk)
    assert got.shape == (2, T, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cosformer_noncausal_matches_jax():
    """The module's non-causal branch, written out as in the JAX module."""
    qp, kp, v = _features(2)
    jq, jk, jv = (jnp.asarray(a) for a in (qp, kp, v))
    kv = jnp.einsum("bsm,bsd->bmd", jk, jv)
    z = jnp.einsum("btm,bm->bt", jq, jnp.sum(jk, axis=1))
    want = jnp.einsum("btm,bmd->btd", jq, kv) / jnp.maximum(z, 1e-6)[..., None]
    got = tc.cosformer_noncausal(t(qp), t(kp), t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cosformer_causal_matches_quadratic():
    """Linear causal cosformer == explicit masked quadratic attention with
    the same cos-reweighted features (tests/test_baselines.py:52)."""
    qp, kp, v = _features(3)
    got = tc.cosformer_causal(t(qp), t(kp), t(v), chunk=16).numpy()
    scores = np.einsum("btm,bsm->bts", qp, kp)
    tri = np.tril(np.ones((40, 40)))
    num = np.einsum("bts,bsd->btd", scores * tri, v)
    den = np.maximum((scores * tri).sum(-1), 1e-6)
    np.testing.assert_allclose(got, num / den[..., None], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("causal,outproj", [(True, False), (False, True)])
def test_cosformer_module_with_carried_weights(causal, outproj):
    """SEA's backend geometry (vdim = 2·embed_dim, no out-projection,
    causal) and the baseline's (non-causal, out-projection), sequence-first
    (L, N, E) inputs."""
    E, H, L, N = 32, 2, 40, 2
    rng = np.random.default_rng(4)
    query = rng.standard_normal((L, N, E)).astype(np.float32)
    value = rng.standard_normal((L, N, 2 * E)).astype(np.float32)
    jm = jc.CosformerAttention(embed_dim=E, num_heads=H, vdim=2 * E, has_outproj=outproj,
                               causal=causal)
    variables = jm.init(jax.random.key(0), jnp.asarray(query), jnp.asarray(query),
                        jnp.asarray(value))
    want = jm.apply(variables, jnp.asarray(query), jnp.asarray(query), jnp.asarray(value))
    port = tc.CosformerAttention(E, H, vdim=2 * E, has_outproj=outproj, causal=causal,
                                 device="cpu")
    port.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        got = port(t(query), t(query), t(value))
    assert got.shape == (L, N, 2 * E)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


SEED = 21
T = 128
# Rows whose top-k cut is within TOPK_MARGIN (a near tie) are not held: the
# two sides may pick differently there. At SEED none is (the smallest nonzero
# gap is 2.17e-7); another torch or jax may move a few below the margin, and
# at most this many row-layers of the 2 x 128 may be near ties.
MAX_NEAR_TIES = 8


def test_opt_full_width_cosformer_backend_matches_jax():
    """2 layers at OPT-125m's widths (hidden 768, 12 heads of 64, FFN 3072,
    `opt_config`: T_M = 256, k = 64) with the cosformer estimator backend,
    `benchmarking=True`, on 1 x 128 tokens; the vocabulary cut to 512 rows
    to keep the JAX init small (the head is tied, so only its width
    counts). The port of tests/test_knobs.py:13's forward, held to JAX."""
    cfg = dataclasses.replace(
        jopt.opt_125m("perlin", sea=jax_opt_config(predictor_backend="cosformer")),
        num_layers=2, vocab_size=512)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg.vocab_size, (1, T)).astype(np.int32)
    am = np.ones((1, T), np.int32)
    model = jopt.OptForCausalLM(cfg)
    variables = jax.jit(model.init)(jax.random.key(SEED), jnp.asarray(ids), jnp.asarray(am))
    assert "cosformer_backend" in variables["params"]["model"]["layers_0"]["self_attn"]["perlin"]
    bench = jax_bench()
    bench.activate_temp_buffers(True)
    try:
        want = model.apply(variables, jnp.asarray(ids), jnp.asarray(am), benchmarking=True)
        probs = bench.buffers["masked_estimated_attention_probs"]
        budget = bench.buffers["per_item_top_k"]
        masks = [np.asarray(m) for m in bench.buffers["partial_attention_mask_before_interp"]]
    finally:
        bench.activate_temp_buffers(False)
    assert len(probs) == cfg.num_layers
    ties = topk_near_ties(probs, budget, TOPK_MARGIN)
    n_ties = sum(int(x.sum()) for x in ties)
    assert n_ties <= MAX_NEAR_TIES, f"{n_ties} near-tie rows"

    port = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(variables))
    got_masks = []
    hooks = [layer.self_attn.perlin.register_forward_hook(
        lambda m, args, out: got_masks.append(out.partial_attention_mask.numpy()))
        for layer in port.model.layers]
    with torch.no_grad():
        got = port(t(ids).long(), t(am).long(), benchmarking=True)
    for h in hooks:
        h.remove()
    assert len(got_masks) == cfg.num_layers
    # every row that is not a near tie picks exactly JAX's pixels; a near tie
    # that picks otherwise changes its own and later positions (causal), so
    # the logits are held before the first such row
    first = T
    for g, w, tie in zip(got_masks, masks, ties):
        same = (g == w).all(axis=(1, 3))  # (N, T): every head's pixels of the row
        assert (same | tie).all(), np.argwhere(~same & ~tie)[:5]
        first = min([first, *np.nonzero(~same.all(axis=0))[0]])
    np.testing.assert_allclose(got["logits"][:, :first].numpy(),
                               np.asarray(want["logits"])[:, :first], atol=LOGIT_ATOL)
