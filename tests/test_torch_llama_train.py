"""Port parity for LLaMA training: the 4-group optimizer's labels, K2-K4's
plain versions at head width 128, task-only training through
`use_fused_train` (`training.longctx`), KD through `SeaOptKD` and the
trainer's `llama-*` models, against the JAX package on the CPU (its Pallas
kernels in interpret mode, the port's plain versions).

What is held, and the tolerance of each:

  * `param_labels` equal to JAX's `param_labels` leaf for leaf, for the
    `llama_tiny` and the tiny OPT students (LLaMA's RMSNorm scales are
    no-decay, as every Flax `scale`);
  * K2-K4's plain versions at 1 x 2 x 256 x 128 against JAX's
    `fused_sparse_attention` and its VJP (tests/test_torch_fused_train.py's
    bounds in float32: output 1e-5 abs, gradients 1e-4 abs + 1e-4 rel;
    tests/test_torch_bf16.py's in bf16: 2e-2 of max|want|, and against JAX's
    float32 run on the same bf16 values no farther on average than JAX's
    bf16 run is, and at every element within JAX's own largest gap plus half
    a bf16 ulp of max|want|: both sides round each gradient to bf16 once at
    the end, so which one's largest gap is larger is a coin toss on one
    element; at this width dv's is 0.0301 on the port's side against
    JAX's 0.0263, with a mean gap of 0.00053 against JAX's 0.00061);
  * a one-layer LLaMA with two heads of 128 and `use_fused_train`, and
    `llama_tiny` (MHA and GQA): the loss 1e-5 relative and every gradient
    2e-4 abs + 2e-3 rel (tests/test_torch_fused_train.py's model bound),
    parameters behind the top-k exactly zero on both sides; after one AdamW
    step (lr 1e-5, weight decay 1e-2) against optax: the exact decay where
    the gradient is zero, 1e-7 abs + 3e-7 rel where |g| >= 1e-5, and 2·lr
    elsewhere (Adam's first step is lr·g/(|g| + eps), so a gradient at the
    frameworks' noise level may move a parameter by up to lr either way).
    Under bf16 compute (float32 parameters, layer outputs rounded to bf16 as
    JAX rounds them) the loss within 1e-3 relative and the gradients within
    2e-2 of each tensor's max|want| (tests/test_torch_bf16.py's REL: a bf16
    ulp of a layer output moves what follows), the step 1e-7 abs + 3e-7 rel
    where |g| >= 1e-5 and at least twice that gradient bound (no sign can
    differ there, so lr·g/(|g| + eps) agrees to lr·eps/(2|g|)), 2·lr
    elsewhere;
  * `SeaOptKD` at `llama_tiny`: the loss and every term 1e-5 relative, every
    student gradient 1e-4 of max|want| plus eight times JAX's own jitted-
    vs-eager gap (tests/test_torch_kd.py's rule and its reason);
  * `OptTrainer(model="llama-tiny")`: two accumulated micro-steps and one
    update from JAX's weights against JAX's KD gradients and optimizer, the
    parameters within 1e-6 abs (test_torch_kd.py's update bound); the
    strided PPL against JAX's evaluation 1e-5 relative; `model_configs` of
    'llama-tiny', 'llama-7b' and 'llama-13b' equal to JAX's; a teacher read
    from a local HF directory equal to its state dict bit for bit.

Every test runs on one torch thread.
"""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from sea_tpu.config import SeaConfig as JaxSeaConfig
from sea_tpu.data import wikitext2 as jw
from sea_tpu.models import llama as jl
from sea_tpu.models import opt as jopt
from sea_tpu.ops.kernels import block_sparse as jb
from sea_tpu.training.distill import SeaOptKD as JaxKD
from sea_tpu.training.opt_trainer import OptTrainer as JaxTrainer
from sea_tpu.training.opt_trainer import TrainerConfig as JaxTrainerConfig
from sea_tpu.training.opt_trainer import model_configs as jax_model_configs
from sea_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from sea_tpu.training.optimizer import param_labels as jax_param_labels
from sea_tpu_torch.models import llama as tl
from sea_tpu_torch.models.opt import OptDecoderLayer, OptForCausalLM
from sea_tpu_torch.ops.kernels import block_sparse as tb
from sea_tpu_torch.training import opt_trainer as to
from sea_tpu_torch.training.distill import SeaOptKD, causal_lm_for, decoder_layer_for
from sea_tpu_torch.training.longctx import train_steps
from sea_tpu_torch.training.optimizer import param_labels
from sea_tpu_torch.utils.profiler import get_bench
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import assert_topk_margin, t, torch_llama_config, torch_opt_config
from tests.test_opt_kd import make_batch, tiny_opt
from tests.test_torch_block_sparse import make_case

BF16 = torch.bfloat16
FWD_ATOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
MODEL_TOL = dict(atol=2e-4, rtol=2e-3)
REL = 2e-2  # bf16: of max|want|
KD_REL, KD_GRAD_RTOL = 1e-5, 1e-4
LR, WD = 1e-5, 1e-2


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


def port_llama(cfg, variables):
    port = tl.LlamaForCausalLM(torch_llama_config(cfg), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(variables))
    return port


# ---------------------------------------------------------------------------
# The optimizer's groups


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_param_labels_match_jax(family):
    """Each student parameter's group equals the JAX label of its leaf: for
    `llama_tiny` every RMSNorm scale (`input_layernorm`,
    `post_attention_layernorm`, the final `norm`) is no-decay, as flax names
    it `scale`."""
    if family == "llama":
        cfg = jl.llama_tiny("perlin")
        model, port = jl.LlamaForCausalLM(cfg), tl.LlamaForCausalLM(
            torch_llama_config(cfg), device="cpu", seed=None)
    else:
        cfg = tiny_opt("perlin")
        model, port = jopt.OptForCausalLM(cfg), OptForCausalLM(
            torch_opt_config(cfg), device="cpu", seed=None)
    ids, mask = make_batch(vocab=cfg.vocab_size)
    variables = jax.jit(lambda: model.init(jax.random.key(1), ids, mask))()
    flat, treedef = jax.tree_util.tree_flatten(jax_param_labels(variables["params"]))
    # each leaf's position in the tree, carried to the port's names
    positions = state_dict_from_jax({"params": jax.tree_util.tree_unflatten(
        treedef, [np.full((1,), i, np.float32) for i in range(len(flat))])})
    got = param_labels(port)
    assert set(got) == set(positions)
    assert got == {n: flat[int(positions[n].reshape(-1)[0])] for n in got}
    assert set(got.values()) == {"low", "low_nd", "high", "high_nd"}
    if family == "llama":
        norms = ["model.norm.weight"] + [f"model.layers.{i}.{n}.weight"
                                         for i in range(cfg.num_layers)
                                         for n in ("input_layernorm", "post_attention_layernorm")]
        assert all(got[n] == "low_nd" for n in norms)


# ---------------------------------------------------------------------------
# K2-K4's plain versions at head width 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_train_kernels_width128_match_jax(dtype):
    """fused_sparse_attention at 1 x 2 x 256 x 128 (a band of empty rows):
    the output and the gradients of Σ(o − tgt)² for q, k, v and the scaler
    against JAX's custom_vjp in interpret mode; the kernels' operands build
    at width 128 on the differentiable route."""
    q, k, v, mask, scaler = make_case(T=256, D=128, T_M=32, density=0.3)
    mask[:, :, 100:110] = 0.0
    tgt = np.random.default_rng(11).standard_normal(q.shape).astype(np.float32)
    ops = tb.kernel_operands(tb.prepare_inputs(t(q), t(k), t(v), t(mask), t(scaler)),
                             differentiable=True)
    assert ops.q.shape == (2, 256, 128) and ops.idx_t is not None

    def jax_run(jdtype):
        def loss(q, k, v, sc):
            o = jb.fused_sparse_attention(q, k, v, jnp.asarray(mask, jdtype), sc, None,
                                          64, 64, True)
            return jnp.sum((o.astype(jnp.float32) - tgt) ** 2), o

        xs = [jnp.asarray(x).astype(jnp.bfloat16).astype(jdtype) if dtype == "bfloat16"
              else jnp.asarray(x) for x in (q, k, v, scaler)]
        (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(*xs)
        return (o, *g)

    tdtype = getattr(torch, dtype)
    leaves = [t(x).to(tdtype).requires_grad_() for x in (q, k, v, scaler)]
    o = tb.fused_sparse_attention(*leaves[:3], t(mask).to(tdtype), leaves[3])
    got = (o, *torch.autograd.grad(((o.float() - t(tgt)) ** 2).sum(), leaves))
    names = ("o", "dq", "dk", "dv", "dscaler")
    if dtype == "float32":
        want = jax_run(jnp.float32)
        np.testing.assert_allclose(f32(got[0]), f32(want[0]), atol=FWD_ATOL)
        for name, g, w in zip(names[1:], got[1:], want[1:]):
            np.testing.assert_allclose(f32(g), f32(w), err_msg=name, **GRAD_TOL)
    else:
        want, want32 = jax_run(jnp.bfloat16), jax_run(jnp.float32)
        for name, g, w, w32 in zip(names, got, want, want32):
            assert g.dtype == BF16 and w.dtype == jnp.bfloat16, name
            assert np.isfinite(f32(g)).all(), name
            scale = float(np.abs(f32(w32)).max())
            np.testing.assert_allclose(f32(g), f32(w), atol=REL * scale, rtol=0, err_msg=name)
            gap, own = np.abs(f32(g) - f32(w32)), np.abs(f32(w) - f32(w32))
            assert gap.mean() <= own.mean(), name
            half_ulp = 2.0 ** (np.floor(np.log2(scale)) - 8)
            assert gap.max() <= own.max() + half_ulp, name
    # the empty rows: zero output and dq
    assert float(got[0].detach()[:, :, 100:110].abs().max()) == 0.0
    assert float(got[1][:, :, 100:110].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# Task-only training through use_fused_train


def fused_cfg(kv=None, compute_dtype="float32", width=None):
    """`llama_tiny` with use_fused_train, or with `width` a one-layer LLaMA
    with two heads of that width (LLaMA's 128)."""
    if width is None:
        cfg = jl.llama_tiny("perlin", num_kv_heads=kv)
        sea = dataclasses.replace(cfg.sea, use_fused_train=True)
    else:
        sea = JaxSeaConfig(num_heads=2, head_dim=width, predictor_length=16, k=4,
                           performer_nb_factor=1, causal=True, max_position_embeddings=128,
                           use_fused_train=True).validate()
        cfg = dataclasses.replace(jl.llama_tiny("perlin"), hidden_size=2 * width,
                                  num_layers=1, num_heads=2, intermediate_size=64)
    return dataclasses.replace(cfg, sea=sea, compute_dtype=compute_dtype)


def _grads_by_name(tree):
    return state_dict_from_jax({"params": tree})


def _jax_train_step(cfg, ids, am, seed):
    """JAX's variables, loss, gradients and optax.adamw parameters after one
    step."""
    model = jl.LlamaForCausalLM(cfg)
    variables = jax.jit(model.init)(jax.random.key(seed), jnp.asarray(ids), jnp.asarray(am))

    def loss_fn(params):
        out = model.apply({**variables, "params": params}, jnp.asarray(ids),
                          jnp.asarray(am), labels=jnp.asarray(ids), training=True)
        return out["loss"] + 0.0 * out["aux_loss"]

    params = variables["params"]
    wl, wg = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = optax.adamw(LR, weight_decay=WD)
    updates, _ = tx.update(wg, tx.init(params), params)
    return variables, float(wl), wg, optax.apply_updates(params, updates)


# (GQA K/V heads, compute type, width): llama_tiny MHA and GQA in float32 and
# under bf16 compute, and one layer of LLaMA's heads of 128
TRAIN_CASES = [(None, "float32", None), (2, "float32", None), (None, "bfloat16", None),
               (2, "bfloat16", None), (None, "float32", 128)]


@pytest.mark.parametrize("kv,compute_dtype,width", TRAIN_CASES,
                         ids=["mha", "gqa", "mha-bf16", "gqa-bf16", "width128"])
def test_fused_train_step_matches_jax(kv, compute_dtype, width):
    """One `train_steps` step of a LLaMA with use_fused_train (CE only, the
    fused path on LLaMA's (N, 1, T, T) mask) against jax.value_and_grad and
    optax.adamw(1e-5, weight_decay=1e-2): the loss, every gradient and the
    parameters after the step, at the module doc's bounds."""
    cfg = fused_cfg(kv, compute_dtype, width)
    T, seed = 128, 0  # every top-k cut of every case >= 1e-4 apart (or tied)
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, cfg.vocab_size, (1, T)).astype(np.int32)
    am = np.ones((1, T), np.int32)
    variables, wl, wg, new_params = _jax_train_step(cfg, ids, am, seed)

    port = port_llama(cfg, variables)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    bench = get_bench()
    bench.activate_temp_buffers(True)
    try:
        losses = train_steps(port, t(ids).long(), t(am).long(), 1, lr=LR, weight_decay=WD)
        probs = [p.detach().float() for p in bench.buffers["masked_estimated_attention_probs"]]
        budget = list(bench.buffers["per_item_top_k"])
    finally:
        bench.activate_temp_buffers(False)
    # the near-tie guard on the step's own estimates (JAX's differ from them
    # far below the 1e-4 margin, so a cut this far apart is JAX's cut too)
    assert len(probs) == cfg.num_layers
    assert_topk_margin(probs, budget)
    bf16 = compute_dtype == "bfloat16"
    np.testing.assert_allclose(losses[0], wl, rtol=1e-3 if bf16 else 1e-5)

    want_g = _grads_by_name(wg)
    want_p = state_dict_from_jax({**variables, "params": new_params})
    names = dict(port.named_parameters())
    assert set(names) == set(want_g)
    zero_grads = held = 0
    for name, p in names.items():
        g, wgn = p.grad.numpy(), want_g[name].numpy()
        g_tol = REL * float(np.abs(wgn).max()) + 1e-12
        if bf16:
            np.testing.assert_allclose(g, wgn, atol=g_tol, rtol=0, err_msg=name)
        else:
            np.testing.assert_allclose(g, wgn, err_msg=name, **MODEL_TOL)
        got, want = p.detach().numpy(), want_p[name].numpy()
        # exact zeros: every element in float32; in bf16, where a rounded sum
        # can land on 0 by chance, the tensors the loss does not reach
        zero = (wgn == 0) if not bf16 else np.full(wgn.shape, bool((wgn == 0).all()))
        zero_grads += int(zero.all())
        np.testing.assert_array_equal(g[zero], 0.0, err_msg=name)
        decayed = (before[name] * (1 - LR * WD)).numpy()
        np.testing.assert_allclose(got[zero], decayed[zero], rtol=1e-7, atol=0, err_msg=name)
        sure = np.abs(wgn) >= (max(1e-5, 2 * g_tol) if bf16 else 1e-5)
        held += int(sure.sum())
        np.testing.assert_allclose(got[sure], want[sure], atol=1e-7, rtol=3e-7, err_msg=name)
        np.testing.assert_allclose(got, want, atol=2 * LR + 1e-7, rtol=3e-7, err_msg=name)
    assert zero_grads >= 2 * cfg.num_layers  # dec_row and the CNN of every layer
    assert held >= 0.1 * sum(p.numel() for p in names.values()), held


# ---------------------------------------------------------------------------
# KD through SeaOptKD and the trainer


@pytest.fixture(scope="module")
def kd_setup():
    t_cfg, s_cfg = jl.llama_tiny("none"), jl.llama_tiny("perlin")
    kd = JaxKD(t_cfg, s_cfg)
    ids, mask = make_batch(vocab=t_cfg.vocab_size)
    t_vars = jax.jit(lambda: kd.teacher.init(jax.random.key(0), ids, mask))()
    s_vars = jax.jit(lambda: kd.student.init(jax.random.key(1), ids, mask))()

    def loss_fn(params, ids, mask):
        return kd.kd_loss(t_vars, {**s_vars, "params": params}, ids, mask, ids, use_remat=True)

    # ((loss, terms), student gradients) of one batch, compiled once per shape
    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
    return kd, t_cfg, s_cfg, t_vars, s_vars, ids, mask, grad_fn, jax.jit(grad_fn)


def test_family_builders():
    """`causal_lm_for` and `decoder_layer_for` pick the family by config."""
    cfg = torch_llama_config(jl.llama_tiny("perlin"))
    assert isinstance(causal_lm_for(cfg, device="cpu"), tl.LlamaForCausalLM)
    assert decoder_layer_for(cfg) is tl.LlamaDecoderLayer
    opt = torch_opt_config(tiny_opt("none"))
    assert isinstance(causal_lm_for(opt, device="cpu"), OptForCausalLM)
    assert decoder_layer_for(opt) is OptDecoderLayer
    with pytest.raises(ValueError, match="one model family"):
        SeaOptKD(causal_lm_for(opt, device="cpu"), causal_lm_for(cfg, device="cpu"))


def test_kd_loss_terms_and_grads_match_jax(kd_setup):
    """`SeaOptKD.kd_loss` at `llama_tiny` with use_remat (LLaMA's position
    bundle threaded to every layer pair): the loss, every detail term, and
    every student gradient; the teacher gets none."""
    _, t_cfg, s_cfg, t_vars, s_vars, ids, mask, grad_fn, jit_grad_fn = kd_setup
    (wl, wd), wg = jit_grad_fn(s_vars["params"], ids, mask)
    _, wg_eager = grad_fn(s_vars["params"], ids, mask)
    teacher, student = port_llama(t_cfg, t_vars), port_llama(s_cfg, s_vars)
    loss, details = SeaOptKD(teacher, student).kd_loss(
        t(ids).long(), t(mask).long(), t(ids).long(), use_remat=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(wl), rtol=KD_REL)
    assert set(details) == set(wd)
    for name, w in wd.items():
        np.testing.assert_allclose(float(details[name].detach()), float(w), rtol=KD_REL,
                                   err_msg=name)
    want = state_dict_from_jax({"params": wg})
    eager = state_dict_from_jax({"params": wg_eager})
    names = dict(student.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        w = want[name].numpy()
        assert p.grad is not None, name
        floor = 8 * float(np.abs(eager[name].numpy() - w).max())
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, err_msg=name,
                                   atol=KD_GRAD_RTOL * float(np.abs(w).max()) + floor + 1e-12)
    assert all(p.grad is None for p in teacher.parameters())


def trainer_cfg(tmp_path, **kw):
    base = dict(model="llama-tiny", max_seq_len=64, stride=32, batch_size=2,
                gradient_accumulation_steps=2, num_steps=4, eval_steps=1000,
                log_steps=1, save_dir=str(tmp_path), lr=1e-3)
    base.update(kw)
    return to.TrainerConfig(**base)


@pytest.mark.parametrize("model", ["llama-tiny", "llama-7b", "llama-13b"])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_llama_model_configs_match_jax(model, compute_dtype):
    """The (teacher, student) configurations of the trainer's LLaMA models,
    with and without `compute_dtype`, equal JAX's `model_configs` (no
    weights are built)."""
    kw = dict(model=model, compute_dtype=compute_dtype)
    want = jax_model_configs(JaxTrainerConfig(**kw))
    got = to.model_configs(to.TrainerConfig(**kw))
    assert got == tuple(map(torch_llama_config, want))
    assert all(isinstance(c, tl.LlamaConfig) for c in got)
    if model != "llama-tiny":
        assert got[1].head_dim == got[1].sea.head_dim == 128


def test_trainer_update_matches_jax(tmp_path, kd_setup, monkeypatch):
    """`OptTrainer(model="llama-tiny")` on JAX's weights: two micro-steps
    (accumulation 2, no jitter on either side), their loss terms against
    JAX's KD loss, and one update against the mean of JAX's two KD gradients
    through JAX's 4-group optimizer (lr 1e-3). Adam's first step is
    s·ĝ/(|ĝ| + eps) per element, s the group's rate and ĝ the clipped
    gradient, so two gradients δ apart move a parameter s·eps·δ/|ĝ|² apart:
    where the two sides' accumulated gradients share a sign and |ĝ| >= 1e-4
    the parameters agree within 1e-6 (test_torch_kd.py's update bound);
    elsewhere, where a gradient at the noise level of the two frameworks'
    sums may even take the other sign (under 0.1% of the elements), within
    2·s. Then the student's strided PPL on JAX's weights against JAX's
    evaluation of them (1e-5 relative; no top-k cut of the two windows read
    is a near tie)."""
    _, t_cfg, s_cfg, t_vars, s_vars, ids, mask, _, jit_grad_fn = kd_setup
    tr = to.OptTrainer(trainer_cfg(tmp_path), device="cpu")
    assert isinstance(tr.teacher, tl.LlamaForCausalLM)
    assert isinstance(tr.student, tl.LlamaForCausalLM)
    tr.teacher.load_state_dict(state_dict_from_jax(t_vars))
    tr.student.load_state_dict(state_dict_from_jax(s_vars))
    monkeypatch.setattr(tr, "jitter_draws", lambda n, T: None)
    grads = []
    for seed in (5, 6):
        ids, mask = make_batch(vocab=t_cfg.vocab_size, seed=seed)
        (_, want_terms), g = jit_grad_fn(s_vars["params"], ids, mask)
        terms = tr.micro_step(np.asarray(ids), np.asarray(mask), np.asarray(ids))
        for name, w in want_terms.items():
            np.testing.assert_allclose(float(terms[name]), float(w), rtol=KD_REL, err_msg=name)
        grads.append(g)
    summed = {n: p.grad.detach().clone() for n, p in tr.student.named_parameters()}
    tr.update()
    assert tr.step == 1
    mean = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *grads)
    tx = jax_make_optimizer(lr=1e-3)
    updates, _ = tx.update(mean, tx.init(s_vars["params"]), s_vars["params"])
    new_params = optax.apply_updates(s_vars["params"], updates)
    want, want_g = (state_dict_from_jax({**s_vars, "params": new_params}),
                    state_dict_from_jax({"params": mean}))
    rates = {"low": 1e-3 * 0.2, "low_nd": 1e-3 * 0.2, "high": 1e-3 * 10, "high_nd": 1e-3 * 10}
    labels = param_labels(tr.student)
    clip = min(1.0, 1.0 / float(optax.global_norm(mean)))
    flipped = total = 0
    for name, p in tr.student.named_parameters():
        got, w, g = p.detach().numpy(), want[name].numpy(), want_g[name].numpy()
        same = np.sign(summed[name].numpy()) == np.sign(g)
        sure = same & (np.abs(g) * clip >= 1e-4)
        np.testing.assert_allclose(got[sure], w[sure], atol=1e-6, rtol=0, err_msg=name)
        assert float(np.abs(got - w).max()) <= 2 * rates[labels[name]] + 1e-6, name
        flipped += int((~same).sum())
        total += same.size
    assert flipped <= 1e-3 * total, (flipped, total)

    # the strided PPL of the student: JAX's `OptTrainer.evaluate` on a
    # stand-in holding what it reads (building the JAX trainer would try to
    # download wikitext-2); both read the synthetic test stream (seed 1)
    student = jl.LlamaForCausalLM(s_cfg)

    def eval_step(params, ids, mask, labels):
        out = student.apply({**s_vars, "params": params}, ids, mask)
        return JaxTrainer._eval_nll(out["logits"], labels)

    stand_in = types.SimpleNamespace(
        cfg=JaxTrainerConfig(model="llama-tiny", max_seq_len=64, stride=32, batch_size=2),
        s_params=s_vars["params"], _eval_step=jax.jit(eval_step),
        eval_corpus=jw.WindowedCorpus(jw.synthetic_corpus(s_cfg.vocab_size, seed=1), 64, 32))
    want_ppl = JaxTrainer.evaluate(stand_in, max_batches=2)
    assert np.isfinite(want_ppl) and want_ppl > 1
    tr.student.load_state_dict(state_dict_from_jax(s_vars))
    np.testing.assert_allclose(tr.evaluate(max_batches=2), want_ppl, rtol=1e-5)


def test_teacher_from_local_hf_directory(tmp_path, kd_setup):
    """`teacher_checkpoint` names a local directory holding an HF-layout
    LLaMA safetensors file (the port's names are HF's own): the trainer's
    teacher takes it bit for bit through `load_llama_params`, and the
    student is bootstrapped from it (every tensor but 'perlin')."""
    from safetensors.numpy import save_file

    t_vars = kd_setup[3]
    sd = {k: v.numpy() for k, v in state_dict_from_jax(t_vars).items()}
    ckpt = tmp_path / "teacher"
    ckpt.mkdir()
    save_file(sd, str(ckpt / "model.safetensors"))
    tr = to.OptTrainer(trainer_cfg(tmp_path, teacher_checkpoint=str(ckpt)), device="cpu")
    for name, p in tr.teacher.state_dict().items():
        assert torch.equal(p, torch.as_tensor(sd[name])), name
    student = tr.student.state_dict()
    assert all(torch.equal(student[n], p) for n, p in tr.teacher.state_dict().items())
    assert any(".perlin." in n for n in student)
