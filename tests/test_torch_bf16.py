"""Port parity in bfloat16: JAX's type rule for OPT and the bf16 paths of the
port (sea_tpu_torch) against the JAX package's, at tiny configurations on
the CPU (Pallas in interpret mode on the JAX side, the kernels' plain
versions on the port's).

What is held, and the tolerance of each:

  * the plain bf16 K2-K4 (`fused_sparse_attention` on bf16 operands): the
    output and the four gradients within 2e-2 of max|want| of JAX's bf16
    custom_vjp (JAX rounds P and dS to bf16 before the products, the port's
    plain versions do not), and no farther from JAX's float32 result on the
    same bf16 values than JAX's own bf16 result is;
  * float32 parameters with `compute_dtype="bfloat16"`: every layer output
    bfloat16 and the projections and attention float32 on both sides;
    logits 1e-4 abs (float32 inside the layers; this seed's layer outputs
    round to the same bfloat16 values on both sides);
  * bfloat16 parameters (the tree cast as the JAX scripts cast it), forward
    and the `use_fused_train` step: layer 0's projections and the
    estimator's probabilities bit for bit, its top-k mask exactly, its
    context within 2e-2 of max|want| (the kernels' plain versions against
    JAX's bf16-rounded P); past layer 0 one bf16 ulp reorders top-k picks,
    so the whole model is held as JAX holds its own bf16 run
    (tests/test_precision.py:43): mean relative error under 0.15 against
    the float32 run on the same weights, for the port as for JAX, and the
    port's logits and loss to JAX's within a few bf16 ulps of the whole;
  * bf16 decode: prefill, decode steps and paged decode against JAX with
    the states' types (caches and window in the state's type, FAVOR+ sums
    and the running sum float32), logits within 2e-2 of max|want|;
  * the SEA module on bf16 operands, benchmark and dense KD paths: the
    masked estimates bit for bit, the top-k mask exactly, the context
    within 2e-2 of max|want|, the KD loss within 1e-2 relative.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.config import SeaConfig
from sea_tpu.models import opt as jopt
from sea_tpu.models.attention import SeaAttention as JaxSeaAttention
from sea_tpu.ops.kernels import block_sparse as jb
from sea_tpu.utils.profiler import get_bench as jax_bench
from sea_tpu_torch.models import opt as topt
from sea_tpu_torch.models.attention import SeaAttention
from sea_tpu_torch.ops.kernels import block_sparse as tb
from sea_tpu_torch.utils.profiler import get_bench
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import t, torch_opt_config, torch_sea_config
from tests.test_torch_block_sparse import make_case

BF16 = torch.bfloat16
T = 128
REL = 2e-2  # of max|want|: JAX's bf16 kernels against the port's plain versions


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models: under the suite's parallel workers torch's intra-op
    threads only contend, so each test runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32(x) -> np.ndarray:
    """A JAX or torch array of any float type as float32 numpy."""
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def cast_bf16(tree):
    """Every floating leaf to bfloat16, as the JAX scripts and trainer cast."""
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def tiny_cfg(compute_dtype="float32", **sea_kw):
    sea = SeaConfig(
        num_heads=2, head_dim=16, predictor_length=16, k=4, performer_nb_factor=1,
        causal=True, max_position_embeddings=128, **sea_kw,
    ).validate()
    return jopt.OptConfig(
        vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, ffn_dim=64,
        max_position_embeddings=128, attention_method="perlin", sea=sea,
        compute_dtype=compute_dtype,
    )


def models(cfg, seed, bf16_params):
    """The JAX model and its variables (cast when `bf16_params`), the port
    on them, and a batch of 1 x T ids."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (1, T)).astype(np.int32)
    am = np.ones((1, T), np.int32)
    model = jopt.OptForCausalLM(cfg)
    variables = jax.jit(model.init)(jax.random.key(seed), jnp.asarray(ids), jnp.asarray(am))
    if bf16_params:
        variables = cast_bf16(variables)
    port = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None)
    if bf16_params:
        port.to(BF16)
    port.load_state_dict(state_dict_from_jax(variables))
    return model, variables, port, ids, am


def capture(bench, fn):
    """fn()'s result and the buffers the profiler registry kept meanwhile."""
    bench.activate_temp_buffers(True)
    try:
        out = fn()
        bufs = {k: list(v) for k, v in bench.buffers.items()}
    finally:
        bench.activate_temp_buffers(False)
    return out, bufs


def rel_err(got, want) -> float:
    """Mean |got − want| over mean |want| (tests/test_precision.py:43)."""
    got, want = f32(got), f32(want)
    return float(np.abs(got - want).mean() / (np.abs(want).mean() + 1e-6))


# ---------------------------------------------------------------------------
# K2-K4's plain versions on bf16 operands


def test_plain_bf16_train_kernels_match_jax():
    """fused_sparse_attention on bf16 q, k, v and scaler (T = 256, a band of
    empty rows): bf16 output and gradients, within 2e-2·max|want| of JAX's
    bf16 custom_vjp, and no farther from JAX's float32 run on the same bf16
    values than JAX's bf16 run is."""
    q, k, v, mask, scaler = make_case(T=256, T_M=32, density=0.3)
    mask[:, :, 100:110] = 0.0
    tgt = np.random.default_rng(11).standard_normal(q.shape).astype(np.float32)

    def jax_run(dtype):
        def loss(q, k, v, sc):
            o = jb.fused_sparse_attention(q, k, v, jnp.asarray(mask, dtype), sc, None,
                                          64, 64, True)
            return jnp.sum((o.astype(jnp.float32) - tgt) ** 2), o

        xs = [jnp.asarray(x).astype(jnp.bfloat16).astype(dtype) for x in (q, k, v, scaler)]
        (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(*xs)
        return (o, *g)

    want, want32 = jax_run(jnp.bfloat16), jax_run(jnp.float32)
    leaves = [t(x).to(BF16).requires_grad_() for x in (q, k, v, scaler)]
    o = tb.fused_sparse_attention(*leaves[:3], t(mask).to(BF16), leaves[3])
    got = (o, *torch.autograd.grad(((o.float() - t(tgt)) ** 2).sum(), leaves))
    for name, g, w, w32 in zip(("o", "dq", "dk", "dv", "dscaler"), got, want, want32):
        assert g.dtype == BF16 and w.dtype == jnp.bfloat16, name
        assert np.isfinite(f32(g)).all(), name
        scale = float(np.abs(f32(w32)).max())
        np.testing.assert_allclose(f32(g), f32(w), atol=REL * scale, rtol=0, err_msg=name)
        own = float(np.abs(f32(w) - f32(w32)).max())
        assert float(np.abs(f32(g) - f32(w32)).max()) <= own, name
    # the empty rows: zero output and dq, no NaN
    assert float(got[0][:, :, 100:110].abs().max()) == 0.0
    assert float(got[1][:, :, 100:110].abs().max()) == 0.0


def test_diff_operands_take_bf16():
    """kernel_operands(differentiable=True) takes bf16 q, k, v: the
    operands keep their type, the scaler is float32, and the mask bits and
    the (transposed) tile lists are the float32 operands' (the lists do not
    depend on the type)."""
    q, k, v, mask, scaler = make_case(T=256, T_M=32, density=0.3)
    got, want = (tb.kernel_operands(tb.prepare_inputs(
        *(t(x).to(dtype) for x in (q, k, v)), t(mask), t(scaler)), differentiable=True)
        for dtype in (BF16, torch.float32))
    assert got.q.dtype == got.k.dtype == got.v.dtype == BF16
    assert got.scaler.dtype == torch.float32
    for name in ("mbits", "counts", "idx", "counts_t", "idx_t", "row_base"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


# ---------------------------------------------------------------------------
# The type rule: float32 parameters, bfloat16 compute


def test_f32_params_bf16_compute_promotes_like_jax():
    """compute_dtype="bfloat16" with float32 parameters (flax promotes a
    bf16 input with f32 parameters to f32): the embedding and every layer
    output are bf16, q, k, v and the logits float32, on both sides; the
    logits within 1e-4 of JAX's."""
    cfg = tiny_cfg("bfloat16")
    model, variables, port, ids, am = models(cfg, seed=1, bf16_params=False)
    want, jbuf = capture(jax_bench(), lambda: model.apply(
        variables, jnp.asarray(ids), jnp.asarray(am), benchmarking=True,
        output_hidden_states=True))
    with torch.no_grad():
        got, tbuf = capture(get_bench(), lambda: port(
            t(ids).long(), t(am).long(), benchmarking=True, output_hidden_states=True))
    assert [h.dtype for h in want["hidden_states"]] == [jnp.bfloat16] * 3
    assert [h.dtype for h in got["hidden_states"]] == [BF16] * 3
    for name in ("q", "k", "v", "performer_context_layer", "partial_context_layer"):
        assert [x.dtype for x in jbuf[name]] == [jnp.float32] * 2, name
        assert [x.dtype for x in tbuf[name]] == [torch.float32] * 2, name
    assert want["logits"].dtype == jnp.float32 and got["logits"].dtype == torch.float32
    np.testing.assert_allclose(f32(got["logits"]), f32(want["logits"]), atol=1e-4)


# ---------------------------------------------------------------------------
# bfloat16 parameters


def check_layer0(jbuf, tbuf):
    """Layer 0's projections and estimates bit for bit, its top-k mask
    exactly, its context within 2e-2·max|want|."""
    for name in ("q", "k", "v", "masked_estimated_attention_probs",
                 "partial_attention_mask_before_interp"):
        assert jbuf[name][0].dtype == jnp.bfloat16 and tbuf[name][0].dtype == BF16, name
        np.testing.assert_array_equal(f32(tbuf[name][0]), f32(jbuf[name][0]), err_msg=name)
    w = f32(jbuf["partial_context_layer"][0])
    np.testing.assert_allclose(f32(tbuf["partial_context_layer"][0]), w,
                               atol=REL * float(np.abs(w).max()), rtol=0)


def test_bf16_params_forward_matches_jax():
    """The benchmark forward with the tree cast to bf16 (bf16 projections,
    estimator and K1 operands): layer 0 as `check_layer0`; the logits bf16,
    within 0.15 mean relative error of the float32 run on the same weights
    (JAX's own bound, met by JAX alike), and within 5% mean relative error
    of JAX's bf16 logits."""
    cfg = tiny_cfg("bfloat16")
    model, variables, port, ids, am = models(cfg, seed=0, bf16_params=True)
    want, jbuf = capture(jax_bench(), lambda: model.apply(
        variables, jnp.asarray(ids), jnp.asarray(am), benchmarking=True))
    with torch.no_grad():
        got, tbuf = capture(get_bench(), lambda: port(
            t(ids).long(), t(am).long(), benchmarking=True))
        port32 = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None)
        port32.load_state_dict({n: x.float() for n, x in port.state_dict().items()})
        ref32 = port32(t(ids).long(), t(am).long(), benchmarking=True)["logits"]
    want32 = model.apply(jax.tree_util.tree_map(lambda x: x.astype(jnp.float32)
                                                if jnp.issubdtype(x.dtype, jnp.floating) else x,
                                                variables),
                         jnp.asarray(ids), jnp.asarray(am), benchmarking=True)["logits"]
    check_layer0(jbuf, tbuf)
    assert got["logits"].dtype == BF16 and want["logits"].dtype == jnp.bfloat16
    assert rel_err(got["logits"], ref32) < 0.15
    assert rel_err(want["logits"], want32) < 0.15
    assert rel_err(got["logits"], want["logits"]) < 0.05


def test_bf16_params_fused_train_step_matches_jax():
    """The use_fused_train loss (K2-K4's plain versions in bf16) with bf16
    parameters: layer 0 as `check_layer0`; the loss within 5e-3 relative of
    JAX's (1e-3 measured); every gradient bf16 on both sides and zero on
    both sides for the parameters behind the top-k (dec_row, the CNN). A
    bf16 gradient is far from its float32 value on both sides (JAX's own
    mean relative error reaches 0.5 at this seed: one ulp of a layer's
    input reorders its picks), so each one is held against the float32
    gradient of the same weights on its own side: the port's error at most
    twice JAX's, plus 0.02."""
    cfg = tiny_cfg("bfloat16", use_fused_train=True)
    model, variables, port, ids, am = models(cfg, seed=0, bf16_params=True)

    def jloss(params, v):
        out = model.apply({**v, "params": params}, jnp.asarray(ids), jnp.asarray(am),
                          jnp.asarray(ids), training=True)
        return out["loss"] + 0.0 * out["aux_loss"]

    # the registry records eager runs only: the buffers from the forward alone
    _, jbuf = capture(jax_bench(), lambda: jloss(variables["params"], variables))
    wl, wg = jax.value_and_grad(jloss)(variables["params"], variables)
    v32 = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x, variables)
    _, wg32 = jax.value_and_grad(jloss)(v32["params"], v32)

    def run(m):
        out = m(t(ids).long(), t(am).long(), t(ids).long(), training=True)
        loss = out["loss"] + 0.0 * out["aux_loss"]
        loss.backward()
        return loss.detach()

    loss, tbuf = capture(get_bench(), lambda: run(port))
    port32 = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None)
    port32.load_state_dict({n: x.float() for n, x in port.state_dict().items()})
    run(port32)
    check_layer0(jbuf, tbuf)
    np.testing.assert_allclose(float(loss), float(wl), rtol=5e-3)
    want = state_dict_from_jax({"params": wg})
    want32 = state_dict_from_jax({"params": wg32})
    grads32 = {n: p.grad for n, p in port32.named_parameters()}
    for name, p in port.named_parameters():
        w = want[name]
        assert w.dtype == BF16 and (p.grad is None or p.grad.dtype == BF16), name
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if not bool(w.any()):
            assert not bool(g.any()), name
            continue
        own = rel_err(w, want32[name])
        assert rel_err(g, grads32[name]) <= 2 * own + 0.02, (name, rel_err(g, grads32[name]), own)


# ---------------------------------------------------------------------------
# bfloat16 decode


def test_bf16_decode_prefill_and_paged_match_jax():
    """With bf16 parameters and bf16 states: prefill_parallel's logits and
    states, then decode steps against the contiguous cache and against
    paged bf16 pools, each against JAX's (logits and the prefill's states
    within 2e-2·max|want|; the states' types JAX's: caches bf16, prefill's
    window float32, the FAVOR+ sums and the running sum float32). A decode step takes one
    row's top-k over bf16 estimates, where one ulp can pick another column:
    at this seed no step does (at seed 2, 3 of 24 paged steps land 0.07-1.1
    off, each alone, the window within 2 ulps of JAX's throughout)."""
    cfg = tiny_cfg("bfloat16", use_cache=True)
    model, variables, port, ids, _ = models(cfg, seed=3, bf16_params=True)
    P, L, steps = 16, 32, 4
    prompt = ids[:, :P]
    jl, jst = model.apply(variables, jnp.asarray(prompt), L,
                          method=lambda m, p, n: m.prefill_parallel(p, n))
    gl, st = port.prefill_parallel(t(prompt).long(), L)
    assert gl.dtype == BF16 and jl.dtype == jnp.bfloat16
    np.testing.assert_allclose(f32(gl), f32(jl), atol=REL * float(np.abs(f32(jl)).max()))
    for li, (g, w) in enumerate(zip(st, jst)):
        for name, gx, wx in zip(g._fields, g, w):
            assert str(gx.dtype) == f"torch.{wx.dtype}", (li, name)
            scale = float(np.abs(f32(wx)).max())
            np.testing.assert_allclose(f32(gx), f32(wx), atol=REL * scale, rtol=0,
                                       err_msg=f"layer {li} {name}")

    # decode steps from JAX's prefill state, contiguous and paged
    H, D = cfg.sea.num_heads, cfg.sea.head_dim
    ps, mp = 4, L // 4
    pages = np.arange(1, 1 + mp, dtype=np.int32)[None]
    step = jax.jit(lambda v, tok, pos, s: model.apply(
        v, tok, pos, s, method=lambda m, a, b, c: m.decode_step(a, b, c)))
    step_p = jax.jit(lambda v, tok, pos, s, a, b, pg: model.apply(
        v, tok, pos, s, a, b, pg,
        method=lambda m, a, b, c, d, e, f: m.decode_step_paged(a, b, c, d, e, f)))
    jst_p = model.apply(variables, 1, 0, jnp.bfloat16,
                        method=lambda m, b, ml, dt: m.init_decode_states(b, ml, dt))
    st_p = port.init_decode_states(1, 0, BF16)
    assert all(x.dtype == BF16 for s in st_p for x in (s.cnn_window, s.k_cache))
    assert all(x.dtype == torch.float32 for s in st_p for x in (s.performer_S, s.cumavg_sum))
    jpk = jpv = jnp.zeros((cfg.num_layers, 1 + mp, ps, H, D), jnp.bfloat16)
    pk = torch.zeros((cfg.num_layers, 1 + mp, ps, H, D), dtype=BF16)
    pv = torch.zeros_like(pk)
    # the paged arm ingests the prompt one token at a time
    for i in range(P):
        tok = ids[:, i:i + 1]
        _, jst_p, jpk, jpv = step_p(variables, jnp.asarray(tok), jnp.full((1,), i, jnp.int32),
                                    jst_p, jpk, jpv, pages)
        _, st_p, pk, pv = port.decode_step_paged(t(tok).long(), torch.full((1,), i), st_p,
                                                 pk, pv, t(pages))
    for i in range(P, P + steps):
        tok = ids[:, i:i + 1]
        jl, jst = step(variables, jnp.asarray(tok), jnp.int32(i), jst)
        gl, st = port.decode_step(t(tok).long(), i, st)
        jlp, jst_p, jpk, jpv = step_p(variables, jnp.asarray(tok), jnp.full((1,), i, jnp.int32),
                                      jst_p, jpk, jpv, pages)
        glp, st_p, pk, pv = port.decode_step_paged(t(tok).long(), torch.full((1,), i), st_p,
                                                   pk, pv, t(pages))
        for g, w, arm in ((gl, jl, "contiguous"), (glp, jlp, "paged")):
            assert g.dtype == BF16 and w.dtype == jnp.bfloat16, arm
            np.testing.assert_allclose(f32(g), f32(w), atol=REL * float(np.abs(f32(w)).max()),
                                       err_msg=f"{arm} step {i}")
    assert pk.dtype == BF16


# ---------------------------------------------------------------------------
# SeaAttention on bf16 operands


@pytest.mark.parametrize("path", ["benchmark", "dense_kd"])
def test_sea_attention_bf16_operands_match_jax(path):
    """The SEA module with bf16 parameters on bf16 q, k, v and the bf16
    causal mask (FP_MIN = fp16 min / 2): on the benchmark path (K1's plain
    version) and on the dense train path with the teacher's truths (the KD
    losses float32), the masked estimates bit for bit, the top-k mask
    exactly, the context bf16 within 2e-2·max|want|, the loss within 1e-2
    relative."""
    sea = tiny_cfg().sea
    rng = np.random.default_rng(6)
    H, D = sea.num_heads, sea.head_dim
    q, k, v = (jnp.asarray(rng.standard_normal((1, H, T, D)) * 0.5, jnp.bfloat16)
               for _ in range(3))
    fp_min = float(np.finfo(np.float16).min) / 2
    mask = jnp.asarray(np.where(np.tril(np.ones((T, T))) > 0, 0.0, fp_min)[None, None],
                       jnp.bfloat16)
    kw = dict(benchmarking=path == "benchmark")
    if path == "dense_kd":
        kw.update(attention_scores_truth=jnp.asarray(
                      rng.standard_normal((1, H, T, T)), jnp.bfloat16),
                  context_layer_truth=jnp.asarray(
                      rng.standard_normal((1, T, H * D)) * 0.5, jnp.bfloat16))
    model = JaxSeaAttention(sea)
    variables = cast_bf16(jax.jit(lambda: model.init(
        jax.random.key(6), q, k, v, q, k, v, q, k, mask, **kw))())
    want, jbuf = capture(jax_bench(), lambda: model.apply(
        variables, q, k, v, q, k, v, q, k, mask, **kw))
    port = SeaAttention(torch_sea_config(sea), device="cpu", seed=None).to(BF16)
    port.load_state_dict(state_dict_from_jax(variables))
    tkw = {n: (t(x.astype(jnp.float32)).to(BF16) if not isinstance(x, bool) else x)
           for n, x in kw.items()}
    tq, tk, tv, tmask = (t(x.astype(jnp.float32)).to(BF16) for x in (q, k, v, mask))
    with torch.no_grad():
        got, tbuf = capture(get_bench(), lambda: port(
            tq, tk, tv, tq, tk, tv, tq, tk, tmask, **tkw))
    for name in ("masked_estimated_attention_probs", "partial_attention_mask_before_interp"):
        np.testing.assert_array_equal(f32(tbuf[name][0]), f32(jbuf[name][0]), err_msg=name)
    assert got.context_layer.dtype == BF16 and want.context_layer.dtype == jnp.bfloat16
    w = f32(want.context_layer)
    np.testing.assert_allclose(f32(got.context_layer), w, atol=REL * float(np.abs(w).max()))
    assert got.loss.dtype == torch.float32
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-2, atol=1e-6)
