"""Port parity: OPT knowledge distillation (sea_tpu_torch.training.distill
`SeaOptKD` with the teacher captures of `models/opt.py`, the 4-group
optimizer, the loader) against the JAX package's, at the tiny config of
tests/test_opt_kd.py and at OPT-125m's width with 2 layers.

Tolerances: teacher captures 1e-5 abs (float32, the same arithmetic); the
KD loss and every detail term 1e-5 relative; one clipped optimizer update
1e-6 abs (with bf16 parameters, one bf16 ulp); the loader and the student bootstrap exact. Student gradients:
1e-4 of the tensor's largest |want| (float32 sums over the batch's tokens
and the (T, T) maps, taken in another order on each side) plus eight times
the largest gap between JAX's own jitted and eager gradients of the same
loss (the port needs up to five at this config). The second term is the
reference's float32 noise floor, which one alternative summation order
samples once and the port's every op reorders: at random init the
estimator's LayerNorms meet rows of near-zero variance (over 2 columns at
this config's T_M = 8), whose gradients amplify rounding, so that JAX's
jitted and eager runs differ by up to 1.6% of the largest `dec_row`
gradient and by 1.1e-4 of it on `k_proj.bias`. `cnn_conv4.bias` has a
true gradient of zero (a constant along the row, which the area resize
keeps and the LayerNorm over the row removes): there the port's gradient
must be no farther from zero than JAX's own (flax's one-pass variance
leaves JAX 2-3e-5 off zero at this config). The resize jitter takes JAX's
own draws for the JAX key.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from sea_tpu.models.loader import opt_params_from_state_dict as jax_opt_params
from sea_tpu.models.loader import student_from_teacher as jax_student_from_teacher
from sea_tpu.models.opt import opt_125m as jax_opt_125m
from sea_tpu.training.distill import SeaOptKD as JaxKD
from sea_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from sea_tpu.training.optimizer import param_labels as jax_param_labels
from sea_tpu.utils.profiler import get_bench as jax_bench
from sea_tpu_torch.models import loader as tl
from sea_tpu_torch.models.opt import OptForCausalLM
from sea_tpu_torch.training.distill import SeaOptKD
from sea_tpu_torch.training.optimizer import GroupedAdamW, param_labels
from sea_tpu_torch.utils.profiler import get_bench
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import t, topk_near_ties, torch_opt_config
from tests.test_loader_formats import hf_opt_state_dict
from tests.test_opt_kd import make_batch, tiny_opt
from tests.test_torch_masks import jax_jitter_draws

REL = 1e-5
GRAD_RTOL = 1e-4


@jax.jit
def _optax_update(grads, params):
    """One update of the JAX package's optimizer (lr 1e-3) from fresh state."""
    tx = jax_make_optimizer(lr=1e-3)
    updates, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates)


def port_model(cfg, variables):
    model = OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None)
    model.load_state_dict(state_dict_from_jax(variables))
    return model


@pytest.fixture(scope="module")
def tiny():
    t_cfg, s_cfg = tiny_opt("none"), tiny_opt("perlin")
    kd = JaxKD(t_cfg, s_cfg)
    ids, mask = make_batch()
    t_vars = jax.jit(lambda: kd.teacher.init(jax.random.key(0), ids, mask))()
    s_vars = jax.jit(lambda: kd.student.init(jax.random.key(1), ids, mask))()
    return kd, t_cfg, s_cfg, t_vars, s_vars, ids, mask


def layer_draws(rng, n_layers, shape):
    """The per-layer jitter draws of the JAX KD loss's key: per layer the
    key splits off the layer's key, whose resize splits it again."""
    draws = []
    for _ in range(n_layers):
        rng, layer_rng = jax.random.split(rng)
        draws.append(tuple(t(d) for d in jax_jitter_draws(layer_rng, shape)))
    return draws


def test_teacher_captures_match_jax(tiny):
    kd, t_cfg, _, t_vars, _, ids, mask = tiny
    want = kd.teacher.apply(t_vars, ids, mask, labels=ids, output_hidden_states=True)
    teacher = port_model(t_cfg, t_vars)
    with torch.no_grad():
        got = teacher(t(ids).long(), t(mask).long(), labels=t(ids).long(),
                      output_hidden_states=True, output_captures=True)
        plain = teacher(t(ids).long(), t(mask).long())
    assert len(got["teacher_captures"]) == t_cfg.num_layers
    for g, w in zip(got["teacher_captures"], want["teacher_captures"]):
        np.testing.assert_allclose(g.attention_scores.numpy(), np.asarray(w.attention_scores),
                                   atol=1e-5)
        np.testing.assert_allclose(g.context_layer.numpy(), np.asarray(w.context_layer), atol=1e-5)
    assert plain["teacher_captures"] == [] and plain["hidden_states"] is None
    assert len(got["hidden_states"]) == t_cfg.num_layers + 1
    for g, w in zip(got["hidden_states"], want["hidden_states"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=REL)


def _port_kd(tiny, rng):
    _, t_cfg, s_cfg, t_vars, s_vars, ids, _ = tiny
    teacher, student = port_model(t_cfg, t_vars), port_model(s_cfg, s_vars)
    jitter = None if rng is None else layer_draws(
        rng, s_cfg.num_layers, (ids.shape[0], 1, ids.shape[1], ids.shape[1]))
    loss, details = SeaOptKD(teacher, student).kd_loss(
        t(ids).long(), t(tiny[6]).long(), t(ids).long(), jitter=jitter, use_remat=True)
    return loss, details, teacher, student


def _check_terms(loss, details, wl, wd):
    np.testing.assert_allclose(float(loss.detach()), float(wl), rtol=REL)
    assert set(details) == set(wd)
    for name, w in wd.items():
        np.testing.assert_allclose(float(details[name].detach()), float(w), rtol=REL,
                                   err_msg=name)


def test_kd_loss_terms_and_grads_match_jax(tiny):
    """`kd_loss` with use_remat: the loss, every detail term, and every
    student gradient; the teacher gets none."""
    kd, _, _, t_vars, s_vars, ids, mask = tiny

    def loss_fn(params):
        return kd.kd_loss(t_vars, {**s_vars, "params": params}, ids, mask, ids, use_remat=True)

    (wl, wd), wg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(s_vars["params"])
    _, wg_eager = jax.value_and_grad(loss_fn, has_aux=True)(s_vars["params"])
    loss, details, teacher, student = _port_kd(tiny, None)
    loss.backward()
    _check_terms(loss, details, wl, wd)
    want = state_dict_from_jax({"params": wg})
    eager = state_dict_from_jax({"params": wg_eager})
    names = dict(student.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        w = want[name].numpy()
        assert p.grad is not None, name
        if name.endswith("cnn_conv4.bias"):
            off = max(float(np.abs(w).max()), float(np.abs(eager[name].numpy()).max()))
            assert float(p.grad.abs().max()) <= off, (name, p.grad, w)
            continue
        floor = 8 * float(np.abs(eager[name].numpy() - w).max())
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, err_msg=name,
                                   atol=GRAD_RTOL * float(np.abs(w).max()) + floor + 1e-12)
    assert all(p.grad is None for p in teacher.parameters())


def test_kd_loss_with_jax_jitter_matches_jax(tiny):
    """The same loss with JAX's jitter draws for a key whose gate fires in
    layer 0 (p = 0.1 per layer): the loss and every term. The jittered
    index map itself is held bit for bit in tests/test_torch_masks.py."""
    kd, _, _, t_vars, s_vars, ids, mask = tiny
    seed = next(s for s in range(1000)
                if float(layer_draws(jax.random.key(s), 1, (1, 1, 1, 1))[0][1]) < 0.1)
    rng = jax.random.key(seed)
    wl, wd = jax.jit(lambda: kd.kd_loss(t_vars, s_vars, ids, mask, ids, rng=rng))()
    plain, _ = jax.jit(lambda: kd.kd_loss(t_vars, s_vars, ids, mask, ids))()
    assert float(wl) != float(plain)
    with torch.no_grad():
        loss, details, _, _ = _port_kd(tiny, rng)
    _check_terms(loss, details, wl, wd)


def test_layerwise_training_detaches_each_layer(tiny):
    """sea.layerwise: no gradient crosses a layer boundary in training (the
    JAX model's stop_gradient on each layer's input)."""
    _, _, s_cfg, _, s_vars, ids, mask = tiny
    cfg = dataclasses.replace(s_cfg, sea=dataclasses.replace(s_cfg.sea, layerwise=True))
    student = port_model(cfg, s_vars)
    out = student(t(ids).long(), t(mask).long(), training=True, output_hidden_states=True)
    out["hidden_states"][-1].sum().backward()
    layers = student.model.layers
    assert all(p.grad is None for p in layers[0].parameters())
    assert student.model.embed_tokens.weight.grad is None
    assert layers[1].fc2.weight.grad is not None


def test_kd_remat_matches_no_remat(tiny):
    """Checkpointed layer pairs give the loss and gradients of the plain
    loop, the jitter draws passed in."""
    _, t_cfg, s_cfg, t_vars, s_vars, ids, mask = tiny
    draws = [tuple(torch.rand(s, generator=torch.Generator().manual_seed(i))
                   for s in ((2, 1, 16, 16), ())) for i in range(s_cfg.num_layers)]
    out = []
    for remat in (True, False):
        student = port_model(s_cfg, s_vars)
        loss, _ = SeaOptKD(port_model(t_cfg, t_vars), student).kd_loss(
            t(ids).long(), t(mask).long(), t(ids).long(), jitter=draws, use_remat=remat)
        loss.backward()
        out.append((loss.detach(), [p.grad.clone() for p in student.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_param_groups_match_param_labels(tiny):
    """Each student parameter's group equals the JAX label of its leaf."""
    _, _, s_cfg, _, s_vars, _, _ = tiny
    flat, treedef = jax.tree_util.tree_flatten(jax_param_labels(s_vars["params"]))
    # each leaf's position in the tree, carried to the port's names
    positions = state_dict_from_jax({"params": jax.tree_util.tree_unflatten(
        treedef, [np.full((1,), i, np.float32) for i in range(len(flat))])})
    got = param_labels(port_model(s_cfg, s_vars))
    assert set(got) == set(positions)
    assert got == {n: flat[int(positions[n].reshape(-1)[0])] for n in got}
    assert set(got.values()) == {"low", "low_nd", "high", "high_nd"}


@pytest.mark.parametrize("scale", [1.0, 1e3], ids=["unclipped", "clipped"])
def test_one_clipped_update_matches_optax(tiny, scale):
    """One update of the 4-group AdamW (lr 1e-3, so that each group's step
    is large against the tolerance) from the same gradients, below and above
    the clipping norm, against `make_optimizer`'s optax chain: 1e-6 abs."""
    _, _, s_cfg, _, s_vars, _, _ = tiny
    params = s_vars["params"]
    grads = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.random.default_rng(x.size).standard_normal(x.shape)
                              .astype(np.float32) * 1e-3 * scale), params)
    want = state_dict_from_jax({**s_vars, "params": _optax_update(grads, params)})
    norm = float(optax.global_norm(grads))
    assert (norm > 1.0) == (scale > 1.0)

    student = port_model(s_cfg, s_vars)
    opt = GroupedAdamW(student, lr=1e-3)
    g = state_dict_from_jax({"params": grads})
    for name, p in student.named_parameters():
        p.grad = g[name].clone()
    got_norm = opt.step()
    np.testing.assert_allclose(float(got_norm), norm, rtol=1e-6)
    for name, p in student.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("param_dtype,mu_dtype", [
    ("float32", "bfloat16"), ("bfloat16", "bfloat16"), ("bfloat16", None)])
def test_update_with_mu_dtype_matches_optax(tiny, param_dtype, mu_dtype):
    """optax's `mu_dtype` (the trainer's moment_dtype) and bf16 parameters:
    two clipped updates of the 4-group AdamW from the same gradients
    (lr 1e-3, the second above the clipping norm) against `make_optimizer`'s
    optax chain with that mu_dtype: the first moment stored in mu_dtype (the
    parameters' type when None), the second in the parameters' type, and
    the parameters within 1e-6 abs in float32 and, in bfloat16, within two
    ulps of |p| plus two of the largest step (lr · 10): every operation is
    JAX's in JAX's types, and the first, unclipped update is bit for bit,
    but the global norm's sums run in another order (the leaves in module
    order, not JAX's sorted tree order, and each leaf's bf16 sum reduced as
    PyTorch reduces it), so in bf16 it lands an ulp apart (103 against JAX's
    102.5 here) and the clipped gradients with it."""
    _, _, s_cfg, _, s_vars, _, _ = tiny
    jdt = jnp.dtype(param_dtype)
    params = jax.tree_util.tree_map(lambda x: x.astype(jdt), s_vars["params"])
    grads = [jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.random.default_rng(x.size + i).standard_normal(x.shape)
                              .astype(np.float32) * 1e-3 * scale).astype(jdt), params)
        for i, scale in enumerate((1.0, 1e3))]
    tx = jax_make_optimizer(lr=1e-3, mu_dtype=mu_dtype)
    state, want = tx.init(params), params
    for g in grads:
        updates, state = tx.update(g, state, want)
        want = optax.apply_updates(want, updates)
    want = state_dict_from_jax({"params": want})

    student = port_model(s_cfg, s_vars).to(getattr(torch, param_dtype))
    opt = GroupedAdamW(student, lr=1e-3, mu_dtype=mu_dtype)
    for g in grads:
        gd = state_dict_from_jax({"params": g})
        for name, p in student.named_parameters():
            p.grad = gd[name].clone()
        opt.step()
    mu_t = getattr(torch, mu_dtype or param_dtype)
    assert all(m.dtype == mu_t for m in opt.mu)
    assert all(v.dtype == p.dtype for v, p in zip(opt.nu, opt.params))
    for name, p in student.named_parameters():
        w = want[name]
        assert p.dtype == w.dtype, name
        atol = 1e-6 if param_dtype == "float32" else 2 ** -6 * (w.float().abs() + 1e-2)
        assert bool(((p.detach().float() - w.float()).abs() <= atol).all()), name


@pytest.mark.parametrize("fmt", ["dict", "safetensors", "bin"])
def test_opt_params_from_state_dict_matches_jax(tmp_path, fmt):
    """An HF-layout OPT state dict built here, as tests/test_loader_formats.py
    builds one: the port's state dict equals the JAX tree converted, bit for
    bit, and the loaded teacher runs."""
    cfg = tiny_opt("none")
    sd = hf_opt_state_dict(cfg, np.random.default_rng(0))
    want = state_dict_from_jax({"params": jax_opt_params(sd, cfg)})
    if fmt == "dict":
        got = tl.opt_params_from_state_dict(sd, torch_opt_config(cfg))
    else:
        if fmt == "safetensors":
            from safetensors.numpy import save_file

            save_file(sd, str(tmp_path / "model.safetensors"))
        else:
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                       str(tmp_path / "pytorch_model.bin"))
        got = tl.load_opt_params(str(tmp_path), torch_opt_config(cfg))
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    teacher = OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None)
    teacher.load_state_dict(got)
    ids, mask = make_batch(N=1, T=8, vocab=cfg.vocab_size)
    with torch.no_grad():
        assert torch.isfinite(teacher(t(ids).long(), t(mask).long())["logits"]).all()
    with pytest.raises(FileNotFoundError):
        tl.load_opt_params(str(tmp_path / "absent"), torch_opt_config(cfg))


def test_student_from_teacher_matches_jax(tiny):
    """Every tensor the teacher has is copied into the student's own
    storage; the 'perlin' estimator keeps its init: equal to JAX's merge."""
    _, t_cfg, s_cfg, t_vars, s_vars, _, _ = tiny
    want = state_dict_from_jax(jax_student_from_teacher(s_vars, t_vars["params"]))
    teacher, student = port_model(t_cfg, t_vars), port_model(s_cfg, s_vars)
    before = {n: x.clone() for n, x in student.state_dict().items()}
    assert tl.student_from_teacher(student, teacher) is student
    got = student.state_dict()
    assert set(got) == set(want)
    t_sd = teacher.state_dict()
    for name, x in got.items():
        assert torch.equal(x, want[name]), name
        if name in t_sd:
            assert torch.equal(x, t_sd[name]) and x.data_ptr() != t_sd[name].data_ptr(), name
        else:
            assert ".perlin." in name and torch.equal(x, before[name]), name


def test_opt125m_width_kd_loss_matches_jax():
    """A 2-layer OPT-125m-width KD loss (H 12, D 64, T_M 256, k 64, vocab
    50272) on 1 x 128 tokens: the loss and every term within 1e-5 relative.
    At this width some rows' top-k cuts are near ties (the estimator's
    gaps <= 1e-4); the layers' compressed masks must then agree on every
    other row, and here they agree on all."""
    t_cfg = dataclasses.replace(jax_opt_125m("none"), num_layers=2)
    s_cfg = dataclasses.replace(jax_opt_125m("perlin"), num_layers=2)
    kd = JaxKD(t_cfg, s_cfg)
    rng = np.random.default_rng(0)
    ids = jnp.asarray(rng.integers(4, t_cfg.vocab_size, (1, 128)), jnp.int32)
    mask = jnp.ones((1, 128), jnp.int32)
    t_vars = jax.jit(lambda: kd.teacher.init(jax.random.key(0), ids, mask))()
    s_vars = jax.jit(lambda: kd.student.init(jax.random.key(1), ids, mask))()
    bench = jax_bench()
    bench.activate_temp_buffers(True)
    try:
        wl, wd = kd.kd_loss(t_vars, s_vars, ids, mask, ids, use_remat=False)
        probs = bench.buffers["masked_estimated_attention_probs"]
        budget = bench.buffers["per_item_top_k"]
        wmasks = bench.buffers["partial_attention_mask_before_interp"]
    finally:
        bench.activate_temp_buffers(False)

    port_bench = get_bench()
    port_bench.activate_temp_buffers(True)
    try:
        with torch.no_grad():
            loss, details = SeaOptKD(port_model(t_cfg, t_vars), port_model(s_cfg, s_vars)).kd_loss(
                t(ids).long(), t(mask).long(), t(ids).long(), use_remat=False)
        gmasks = [port_bench.get_temp_buffer("partial_attention_mask_before_interp", i)
                  for i in range(s_cfg.num_layers)]
    finally:
        port_bench.activate_temp_buffers(False)
        port_bench.reset()
    for layer, (ties, g, w) in enumerate(zip(topk_near_ties(probs, budget), gmasks, wmasks)):
        rows = (g.numpy() != np.asarray(w)).any(axis=(1, 3))  # (N, T)
        assert not (rows & ~ties).any(), (layer, np.argwhere(rows & ~ties)[:5])
        assert not rows.any(), (layer, int(rows.sum()))
    assert np.isfinite(float(wl))
    np.testing.assert_allclose(float(loss), float(wl), rtol=REL)
    for name, w in wd.items():
        np.testing.assert_allclose(float(details[name]), float(w), rtol=REL, err_msg=name)
