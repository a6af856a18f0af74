"""Port parity at head width 80 (OPT-2.7b's): the port (sea_tpu_torch)
against the JAX package at tiny sizes on the CPU, Pallas in interpret mode
on the JAX side, the kernels' plain versions on the port's. OPT-2.7b itself
is never built here.

What is held, and the tolerance of each:

  * the plain K1 at D = 80 against JAX's `sea_block_sparse_attention`:
    1e-5 abs (tests/test_torch_block_sparse.py);
  * the plain K2-K4 at D = 80 (`fused_sparse_attention`), float32: output
    1e-5 abs, gradients 1e-4 abs + 1e-4 rel (tests/test_torch_fused_train.py);
    bfloat16: within 2e-2·max|want| of JAX's bf16 custom_vjp and no farther
    from JAX's float32 result on the same bf16 values than JAX's bf16 result
    is (tests/test_torch_bf16.py);
  * a 2-layer OPT with two heads of 80 (hidden 160), T = 128: the benchmark
    path's logits and loss 1e-4 abs (tests/test_torch_opt.py); one
    `use_fused_train` step's loss 1e-5 rel and every gradient 2e-4 abs +
    2e-3 rel (tests/test_torch_fused_train.py); the parallel prefill's
    logits 1e-5 abs and a few decode steps' 1e-5 abs
    (tests/test_torch_decode.py); bf16 parameters on the benchmark path:
    layer 0's top-k mask exactly, the logits within a few bf16 ulps of the
    whole (2e-2·max|want|) and the mean relative error against the float32
    run under 0.15 on both sides (tests/test_torch_bf16.py);
  * `TrainerConfig(model="opt-2.7b")` resolves to JAX's heads and width.

The CUDA kernels at width 80 are held against the same plain versions on
the card by chip_smoke.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.config import SeaConfig
from sea_tpu.models import opt as jopt
from sea_tpu.ops.kernels import block_sparse as jb
from sea_tpu.training.opt_trainer import TrainerConfig as JaxTrainerConfig
from sea_tpu.training.opt_trainer import model_configs as jax_model_configs
from sea_tpu.utils.profiler import get_bench as jax_bench
from sea_tpu_torch.models import opt as topt
from sea_tpu_torch.ops.kernels import block_sparse as tb
from sea_tpu_torch.training import opt_trainer as to
from sea_tpu_torch.training.longctx import train_steps
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import assert_topk_margin, t, torch_opt_config
from tests.test_torch_block_sparse import make_case

D = 80
T = 128
ATOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
MODEL_TOL = dict(atol=2e-4, rtol=2e-3)
LOGIT_ATOL = 1e-4
BF16_REL = 2e-2
# a seed whose estimates keep every top-k boundary of the tiny model at least
# 1e-4 apart (or tied) on the JAX side: see assert_topk_margin
SEED = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny sizes: under the suite's parallel workers torch's intra-op
    threads only contend, so each test runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# The kernels' plain versions at D = 80


def test_plain_k1_width80_matches_jax():
    q, k, v, mask, scaler = make_case(T=256, D=D, density=0.3)
    want = jb.sea_block_sparse_attention(
        *(jnp.asarray(x) for x in (q, k, v, mask, scaler)), is_causal=True,
        block_q=64, block_k=64, interpret=True)
    got = tb.sea_block_sparse_attention(*(t(x) for x in (q, k, v, mask, scaler)))
    assert got.shape == want.shape == (1, 2, 256, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_train_kernels_width80_match_jax(dtype):
    """fused_sparse_attention at D = 80 (T = 256, a band of empty rows): the
    output and the gradients of Σ(o − tgt)² for q, k, v and the scaler."""
    q, k, v, mask, scaler = make_case(T=256, D=D, density=0.3)
    mask[:, :, 100:110] = 0.0
    tgt = np.random.default_rng(11).standard_normal(q.shape).astype(np.float32)

    def jax_run(jdtype):
        def loss(q, k, v, sc):
            o = jb.fused_sparse_attention(q, k, v, jnp.asarray(mask, jdtype), sc, None,
                                          64, 64, True)
            return jnp.sum((o.astype(jnp.float32) - tgt) ** 2), o

        xs = [jnp.asarray(x) for x in (q, k, v, scaler)]
        if dtype == "bfloat16":
            xs = [x.astype(jnp.bfloat16).astype(jdtype) for x in xs]
        (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(*xs)
        return (o, *g)

    tdtype = getattr(torch, dtype)
    leaves = [t(x).to(tdtype).requires_grad_() for x in (q, k, v, scaler)]
    o = tb.fused_sparse_attention(*leaves[:3], t(mask).to(tdtype), leaves[3])
    got = (o, *torch.autograd.grad(((o.float() - t(tgt)) ** 2).sum(), leaves))
    names = ("o", "dq", "dk", "dv", "dscaler")
    if dtype == "float32":
        want = jax_run(jnp.float32)
        np.testing.assert_allclose(f32(got[0]), f32(want[0]), atol=ATOL)
        for name, g, w in zip(names[1:], got[1:], want[1:]):
            np.testing.assert_allclose(f32(g), f32(w), err_msg=name, **GRAD_TOL)
        return
    want, want32 = jax_run(jnp.bfloat16), jax_run(jnp.float32)
    for name, g, w, w32 in zip(names, got, want, want32):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        assert np.isfinite(f32(g)).all(), name
        np.testing.assert_allclose(f32(g), f32(w), atol=BF16_REL * float(np.abs(f32(w32)).max()),
                                   rtol=0, err_msg=name)
        own = float(np.abs(f32(w) - f32(w32)).max())
        assert float(np.abs(f32(g) - f32(w32)).max()) <= own, name
    assert float(got[0].detach()[:, :, 100:110].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# A 2-layer OPT with heads of 80


def tiny_cfg(**sea_kw):
    sea = SeaConfig(
        num_heads=2, head_dim=D, predictor_length=16, k=4, performer_nb_factor=1,
        causal=True, max_position_embeddings=T, **sea_kw,
    ).validate()
    return jopt.OptConfig(
        vocab_size=64, hidden_size=2 * D, num_layers=2, num_heads=2, ffn_dim=4 * D,
        max_position_embeddings=T, attention_method="perlin", sea=sea,
    )


def build(cfg, ids, am):
    """The JAX model and its seeded variables, and the port on them."""
    model = jopt.OptForCausalLM(cfg)
    variables = jax.jit(model.init)(jax.random.key(SEED), jnp.asarray(ids), jnp.asarray(am))
    port = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(variables))
    return model, variables, port


def batch():
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, 64, (1, T)).astype(np.int32)
    return ids, np.ones((1, T), np.int32)


def jax_benchmark(model, variables, ids, am):
    """JAX's benchmark-path outputs and its layers' masked estimates and
    budgets (for the top-k near-tie guard)."""
    bench = jax_bench()
    bench.activate_temp_buffers(True)
    try:
        want = model.apply(variables, jnp.asarray(ids), jnp.asarray(am), jnp.asarray(ids),
                           benchmarking=True)
        bufs = {n: list(bench.buffers.get(n, [])) for n in (
            "masked_estimated_attention_probs", "per_item_top_k",
            "partial_attention_mask_before_interp")}
    finally:
        bench.activate_temp_buffers(False)
    return want, bufs


def test_opt_width80_benchmark_logits_match_jax():
    cfg = tiny_cfg()
    ids, am = batch()
    model, variables, port = build(cfg, ids, am)
    want, bufs = jax_benchmark(model, variables, ids, am)
    assert len(bufs["masked_estimated_attention_probs"]) == cfg.num_layers
    assert_topk_margin(bufs["masked_estimated_attention_probs"], bufs["per_item_top_k"])
    with torch.no_grad():
        got = port(t(ids).long(), t(am).long(), t(ids).long(), benchmarking=True)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=LOGIT_ATOL)


def _grads_by_name(tree):
    return state_dict_from_jax({"params": tree})


def test_opt_width80_fused_train_step_matches_jax():
    """One `use_fused_train` step (K2-K4's plain versions at D = 80): the
    loss and every parameter's gradient against jax.value_and_grad."""
    cfg = tiny_cfg(use_fused_train=True)
    ids, am = batch()
    model, variables, port = build(cfg, ids, am)
    bench = jax_bench()
    bench.activate_temp_buffers(True)
    try:
        model.apply(variables, jnp.asarray(ids), jnp.asarray(am), jnp.asarray(ids),
                    training=True)
        probs = bench.buffers["masked_estimated_attention_probs"]
        budget = bench.buffers["per_item_top_k"]
    finally:
        bench.activate_temp_buffers(False)
    assert_topk_margin(probs, budget)

    def loss_fn(params):
        out = model.apply({**variables, "params": params}, jnp.asarray(ids),
                          jnp.asarray(am), labels=jnp.asarray(ids), training=True)
        return out["loss"] + 0.0 * out["aux_loss"]

    wl, wg = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    losses = train_steps(port, t(ids).long(), t(am).long(), 1)
    np.testing.assert_allclose(losses[0], float(wl), rtol=1e-5)
    want = _grads_by_name(wg)
    names = dict(port.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name,
                                   **MODEL_TOL)


def test_opt_width80_prefill_and_decode_match_jax():
    """The parallel prefill of 96 tokens (K1's plain version at D = 80) and
    4 greedy decode steps after it: logits against JAX's, 1e-5 abs."""
    cfg = tiny_cfg(use_cache=True)
    ids, am = batch()
    P, L, steps = 96, T, 4
    model, variables, port = build(cfg, ids, am)
    prompt = ids[:, :P]
    jl, jst = jax.jit(lambda v: model.apply(
        v, jnp.asarray(prompt), L, method=lambda m, p, L: m.prefill_parallel(p, L)))(variables)
    logits, st = port.prefill_parallel(t(prompt).long(), L)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=ATOL)
    step = jax.jit(lambda v, tok, pos, sts: model.apply(
        v, tok, pos, sts, method=lambda m, a, b, c: m.decode_step(a, b, c)))
    tok = logits[:, -1:].argmax(-1)
    for i in range(steps):
        jlg, jst = step(variables, jnp.asarray(tok.numpy(), jnp.int32), jnp.int32(P + i), jst)
        lg, st = port.decode_step(tok, P + i, st)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL, err_msg=f"step {i}")
        tok = lg[:, -1:].argmax(-1)


def test_opt_width80_bf16_params_benchmark_matches_jax():
    """bf16 parameters (the tree cast as the JAX scripts cast it) on the
    benchmark path: layer 0's top-k mask exactly; the logits within
    2e-2·max|want| of JAX's bf16 run; the mean relative error against the
    float32 run on the same weights under 0.15 on both sides
    (tests/test_precision.py:43)."""
    cfg = tiny_cfg()
    ids, am = batch()
    model, variables, port = build(cfg, ids, am)
    want32, _ = jax_benchmark(model, variables, ids, am)
    variables = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        variables)
    want, bufs = jax_benchmark(model, variables, ids, am)
    port.to(torch.bfloat16)
    port.load_state_dict(state_dict_from_jax(variables))
    from sea_tpu_torch.utils.profiler import get_bench

    tbench = get_bench()
    tbench.activate_temp_buffers(True)
    try:
        with torch.no_grad():
            got = port(t(ids).long(), t(am).long(), t(ids).long(), benchmarking=True)
        mask0 = tbench.buffers["partial_attention_mask_before_interp"][0]
    finally:
        tbench.activate_temp_buffers(False)
    np.testing.assert_array_equal(f32(mask0),
                                  f32(bufs["partial_attention_mask_before_interp"][0]))
    logits, wl, w32 = f32(got["logits"]), f32(want["logits"]), f32(want32["logits"])
    assert str(got["logits"].dtype)[6:] == str(want["logits"].dtype) and np.isfinite(logits).all()
    np.testing.assert_allclose(logits, wl, atol=BF16_REL * float(np.abs(w32).max()), rtol=0)
    for x in (logits, wl):
        assert float(np.abs(x - w32).mean() / np.abs(w32).mean()) < 0.15


# ---------------------------------------------------------------------------
# The trainer's model mapping


def test_trainer_opt27b_resolves_to_jax_heads_and_width():
    """TrainerConfig(model="opt-2.7b"): JAX's (teacher, student)
    configurations, 32 heads of 80 in bfloat16 compute, from the
    configurations alone (no model is built)."""
    want = jax_model_configs(JaxTrainerConfig(model="opt-2.7b"))
    got = to.model_configs(to.TrainerConfig(model="opt-2.7b"))
    assert got == tuple(map(torch_opt_config, want))
    for c in got:
        assert (c.num_heads, c.head_dim, c.sea.num_heads, c.sea.head_dim) == (32, 80, 32, 80)
        assert c.compute_dtype == "bfloat16"
    assert dataclasses.replace(got[1], attention_method="none") == got[0]
