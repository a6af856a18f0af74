"""Port parity: the SEA attention module on the fused benchmark path
(sea_tpu_torch.models.attention.SeaAttention vs sea_tpu's, benchmarking=True).

Weights come from the JAX module's init through `state_dict_from_jax`. The
compressed top-k mask must match exactly and the context layer to <= 1e-4
abs. The JAX side runs eagerly with its buffer registry on, so that the
top-k near-tie guard can read its estimates first."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.config import SeaConfig
from sea_tpu.models.attention import SeaAttention as JaxSeaAttention
from sea_tpu.utils.profiler import get_bench as jax_bench
from sea_tpu_torch.models.attention import SeaAttention
from sea_tpu_torch.ops import flat_csr
from sea_tpu_torch.utils.profiler import get_bench
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import assert_topk_margin, t, torch_sea_config

FP_MIN32 = float(np.finfo(np.float32).min) / 2
ATOL = 1e-4


def tiny_cfg(**kw):
    base = dict(
        num_heads=2, head_dim=16, predictor_length=16, k=4,
        performer_nb_factor=1, causal=True, max_position_embeddings=128,
    )
    base.update(kw)
    return SeaConfig(**base).validate()


def make_inputs(cfg, N=1, T=128, seed=0):
    rng = np.random.default_rng(seed)
    shape = (N, cfg.num_heads, T, cfg.head_dim)
    q, k, v = ((rng.standard_normal(shape) * 0.5).astype(np.float32) for _ in range(3))
    m = np.where(np.tril(np.ones((T, T))) > 0, 0.0, FP_MIN32).astype(np.float32)
    mask = np.broadcast_to(m[None, None], (N, 1, T, T)).copy()
    return q, k, v, mask


def run_jax(cfg, inputs, seed=0):
    q, k, v, mask = (jnp.asarray(x) for x in inputs)
    model = JaxSeaAttention(cfg)
    variables = jax.jit(
        lambda: model.init(
            jax.random.key(seed), q, k, v, q, k, v, q, k, mask, benchmarking=True
        )
    )()
    bench = jax_bench()
    bench.activate_temp_buffers(True)
    try:
        out = model.apply(variables, q, k, v, q, k, v, q, k, mask, benchmarking=True)
        probs = bench.buffers["masked_estimated_attention_probs"]
        budget = bench.buffers["per_item_top_k"]
    finally:
        bench.activate_temp_buffers(False)
    return variables, out, probs, budget


def run_torch(cfg, variables, inputs):
    model = SeaAttention(torch_sea_config(cfg), device="cpu", seed=None)
    model.load_state_dict(state_dict_from_jax(variables))
    q, k, v, mask = (t(x) for x in inputs)
    with torch.no_grad():
        return model(q, k, v, q, k, v, q, k, mask, benchmarking=True)


@pytest.mark.parametrize(
    "extra",
    [
        {},
        {"k_oversample": 2.0},
        {"cnn_row_chunk": 32},
        {"cnn_deeper": True, "query_skips": 2},
        {"context_output_method": "norm", "out_norm": True},
    ],
    ids=["canonical", "oversample", "row_chunked_cnn", "deeper_skips", "norm_out"],
)
def test_sea_attention_benchmark_forward_matches(extra):
    cfg = tiny_cfg(**extra)
    inputs = make_inputs(cfg)
    variables, want, probs, budget = run_jax(cfg, inputs)
    assert_topk_margin(probs, budget)
    got = run_torch(cfg, variables, inputs)
    np.testing.assert_array_equal(
        got.partial_attention_mask.numpy(), np.asarray(want.partial_attention_mask)
    )
    np.testing.assert_allclose(
        got.context_layer.numpy(), np.asarray(want.context_layer), atol=ATOL
    )


# Two examples a call, through the configurations that the canonical cases
# leave at their defaults. Tolerance 1e-5 abs on the context: these inputs
# measured within 9.6e-7 of JAX (float32 sums in another order).
TWO_ATOL = 1e-5


@pytest.mark.parametrize(
    "extra",
    [
        {"partial_attention_scaler": False},
        {"predictor_backend": "cosformer"},
        {"context_output_method": "norm"},
        {"out_norm": True},
        {"block_q": 64},
    ],
    ids=["no_scaler", "cosformer", "norm", "out_norm", "block_q64"],
)
def test_sea_attention_two_examples_match(extra):
    cfg = tiny_cfg(**extra)
    inputs = make_inputs(cfg, N=2, seed=1)
    variables, want, probs, budget = run_jax(cfg, inputs)
    assert_topk_margin(probs, budget)
    got = run_torch(cfg, variables, inputs)
    np.testing.assert_array_equal(
        got.partial_attention_mask.numpy(), np.asarray(want.partial_attention_mask)
    )
    np.testing.assert_allclose(
        got.context_layer.numpy(), np.asarray(want.context_layer), atol=TWO_ATOL
    )


def test_buffers_capture_the_kernel_inputs():
    """The registry holds what the kernel was given, under the JAX names."""
    cfg = tiny_cfg()
    model = SeaAttention(torch_sea_config(cfg), device="cpu", seed=0)
    q, k, v, mask = (t(x) for x in make_inputs(cfg, T=64))
    bench = get_bench()
    bench.activate_temp_buffers(True)
    try:
        with torch.no_grad():
            model(q, k, v, q, k, v, q, k, mask, benchmarking=True)
        buf = dict(bench.buffers)
    finally:
        bench.activate_temp_buffers(False)
    for name in ("q", "k", "v", "partial_attention_mask_before_interp", "estimated_scales"):
        assert len(buf[name]) == 1, name
    assert buf["estimated_scales"][0].shape == (1, 2, 64, 2)
    assert torch.equal(buf["q"][0], q)


def test_train_path_is_refused():
    """The routes around the train path that were refused before the CSR
    and LoRA slice now run: LoRA builds and runs (its deltas live in the
    models' projections, tests/test_torch_lora.py), the uniform-CSR
    benchmark path (`use_pallas=False`) runs without the fused kernel, and
    so does the non-causal oversampled module (JAX's CSR route;
    tests/test_torch_flat_csr.py holds both to JAX). What stays refused is
    decode with the 'comp' predictor, as JAX asserts 'mlp'. The dense train
    path runs, causal and non-causal (tests/test_torch_train_path.py), and
    so does the self-teacher KD loss in training (tests/test_torch_baselines.py)."""
    cfg = tiny_cfg()
    model = SeaAttention(torch_sea_config(cfg), device="cpu", seed=0)
    q, k, v, mask = (t(x) for x in make_inputs(cfg, T=64))
    with torch.no_grad():
        out = model(q, k, v, q, k, v, q, k, mask, benchmarking=False)
    assert torch.isfinite(out.context_layer).all()
    selfteach = SeaAttention(torch_sea_config(dataclasses.replace(cfg, kd_self_teacher=True)),
                             device="cpu", seed=0)
    out = selfteach(q, k, v, q, k, v, q, k, mask, benchmarking=False, training=True)
    assert float(out.loss) > 0
    # LoRA's flags build the module unchanged (the deltas are the models')
    lora = SeaAttention(torch_sea_config(dataclasses.replace(cfg, lora_enabled=True)),
                        device="cpu", seed=0)
    assert set(lora.state_dict()) == set(model.state_dict())
    csr = SeaAttention(torch_sea_config(dataclasses.replace(cfg, use_pallas=False)),
                       device="cpu", seed=0)
    with torch.no_grad():
        fused = model(q, k, v, q, k, v, q, k, mask, benchmarking=True)
        out = csr(q, k, v, q, k, v, q, k, mask, benchmarking=True)
    assert isinstance(out.partial_attention_mask, flat_csr.UniformCsr)
    assert out.context_layer.shape == fused.context_layer.shape
    assert torch.isfinite(out.context_layer).all()
    noncausal = torch_sea_config(dataclasses.replace(cfg, causal=False))
    model = SeaAttention(noncausal, device="cpu")
    pad = torch.zeros((1, 1, 1, 64))  # (N, 1, 1, T) additive: no padding
    with torch.no_grad():
        out = model(q, k, v, q, k, v, q, k, pad, benchmarking=False)
    assert torch.isfinite(out.context_layer).all()
    over = SeaAttention(dataclasses.replace(noncausal, k_oversample=2.0), device="cpu", seed=0)
    with torch.no_grad():
        out = over(q, k, v, q, k, v, q, k, pad, benchmarking=True)
    assert isinstance(out.partial_attention_mask, flat_csr.UniformCsr)
    assert torch.isfinite(out.context_layer).all()
    comp = SeaAttention(torch_sea_config(dataclasses.replace(
        cfg, predictor_method="comp", use_cache=True, comp_patch_count=2,
        comp_patch_size=cfg.predictor_length // 2)), device="cpu", seed=0)
    with pytest.raises(NotImplementedError, match="'mlp' only"):
        comp.prefill_state(q, k, v, 64)
