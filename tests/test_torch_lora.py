"""Port parity: LoRA (sea_tpu_torch.models.lora vs sea_tpu.models.lora) and
its wiring in OPT, LLaMA (GQA) and BERT, at tiny sizes.

B is zero at init, so a parity test on fresh weights would show nothing:
every test here draws B (and A) from the seed on the port's side
(`seed_lora_`) and hands JAX the same tree (read from the port's state
dict). Tolerances: the delta 1e-6; logits within 1e-4 as
tests/test_torch_opt.py holds the forward; the task loss's LoRA
gradients within 1e-4 of max|want| (float32 on both sides, summed in
another order); the prefill of a LoRA'd model equal to the LoRA-free
one's bit for bit (JAX's prefill takes no deltas, nor does the port's)."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.config import SeaConfig
from sea_tpu.models import bert as jbert
from sea_tpu.models import llama as jl
from sea_tpu.models import lora as jlora
from sea_tpu.models import opt as jopt
from sea_tpu.training.optimizer import param_labels as jax_param_labels
from sea_tpu_torch.models import bert as tbert
from sea_tpu_torch.models import llama as tl
from sea_tpu_torch.models import lora as tlora
from sea_tpu_torch.models import opt as topt
from sea_tpu_torch.training.optimizer import param_labels
from tests._torch_parity import (jax_variables_from_state_dict, port_topk_guard, sharpen_port,
                                 t, torch_llama_config, torch_opt_config, torch_sea_config)

ATOL = 1e-4
GRAD_REL = 1e-4
LORA = dict(lora_enabled=True, lora_in_approx_enabled=True, lora_r=4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seed_lora_(model, seed, scale=0.5):
    """Every LoRA delta's A and B drawn from `seed` (B nonzero)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, tlora.LoraDelta):
                m.reset_parameters(g)
                m.lora_b.copy_(torch.randn(m.lora_b.shape, generator=g) * scale)
    return model


def from_port(jmodel, port, *args):
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), *args)
    return jax_variables_from_state_dict(shapes, port.state_dict())


def test_lora_delta_and_dense_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 5, 12)).astype(np.float32)
    port = tlora.LoraDelta(12, 7, rank=3, generator=torch.Generator().manual_seed(1))
    bound = (6.0 / 12) ** 0.5
    assert torch.equal(port.lora_b, torch.zeros(3, 7))
    assert port.lora_a.abs().max() <= bound and port.lora_a.std() > bound / 4
    seed_lora_(port, 2)
    jd = jlora.LoraDelta(7, 3)
    want = jd.apply({"params": {"lora_a": jnp.asarray(port.lora_a.detach().numpy()),
                                "lora_b": jnp.asarray(port.lora_b.detach().numpy())}},
                    jnp.asarray(x))
    np.testing.assert_allclose(port(t(x)).detach().numpy(), np.asarray(want), atol=1e-6)
    # a bfloat16 input: products in float32, the output cast back
    xb = t(x).bfloat16()
    assert port(xb).dtype == torch.bfloat16
    dense = seed_lora_(tlora.LoraDense(12, 7, rank=3), 3)
    jdense = jlora.LoraDense(7, 3)
    variables = jax_variables_from_state_dict(
        jax.eval_shape(jdense.init, jax.random.key(0), jnp.asarray(x)), dense.state_dict())
    np.testing.assert_allclose(dense(t(x)).detach().numpy(),
                               np.asarray(jdense.apply(variables, jnp.asarray(x))), atol=1e-6)
    assert not hasattr(tlora.LoraDense(12, 7, enabled=False), "lora")


def tiny_sea(causal=True, **kw):
    return SeaConfig(num_heads=2, head_dim=16, predictor_length=16, k=4, performer_nb_factor=1,
                     causal=causal, max_position_embeddings=128, **kw).validate()


def tiny_opt(**sea_kw):
    return jopt.OptConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, ffn_dim=64,
                          max_position_embeddings=128, attention_method="perlin",
                          sea=tiny_sea(**sea_kw))


def tiny_llama(**sea_kw):
    cfg = jl.llama_tiny("perlin", num_kv_heads=1)
    return dataclasses.replace(cfg, sea=dataclasses.replace(cfg.sea, **sea_kw))


def tiny_bert(**sea_kw):
    return jbert.BertConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                            ffn_dim=64, max_position_embeddings=64, attention_method="perlin",
                            sea=tiny_sea(causal=False, **sea_kw))


def torch_bert_config(cfg):
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(tbert.BertConfig)}
    return tbert.BertConfig(**{**d, "sea": torch_sea_config(cfg.sea)})


def causal_batch(vocab, T, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, (2, T)).astype(np.int32)
    am = np.ones((2, T), np.int32)
    am[1, :13] = 0
    return ids, am


@pytest.mark.parametrize("family", ["opt", "llama"])
@pytest.mark.parametrize("benchmarking", [True, False], ids=["bench", "dense"])
def test_causal_lora_logits_match_jax(family, benchmarking):
    """Both flags, B nonzero: logits and loss of a left-padded batch on the
    benchmark path and the dense train path (LLaMA with GQA: one kv head
    of two)."""
    if family == "opt":
        cfg, jcls, tcls, conv, vocab = tiny_opt(**LORA), jopt.OptForCausalLM, \
            topt.OptForCausalLM, torch_opt_config, 64
    else:
        cfg, jcls, tcls, conv, vocab = tiny_llama(**LORA), jl.LlamaForCausalLM, \
            tl.LlamaForCausalLM, torch_llama_config, 256
    ids, am = causal_batch(vocab, 64, seed=3)
    port = seed_lora_(tcls(conv(cfg), device="cpu", seed=2), 5)
    model = jcls(cfg)
    variables = from_port(model, port, jnp.asarray(ids), jnp.asarray(am))
    want = jax.jit(functools.partial(model.apply, benchmarking=benchmarking))(
        variables, jnp.asarray(ids), jnp.asarray(am), jnp.asarray(ids))
    with torch.no_grad():
        got = port_topk_guard(lambda: port(t(ids).long(), t(am).long(), t(ids).long(),
                                           benchmarking=benchmarking))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=ATOL)
    # the deltas move the logits: the same base without LoRA differs
    base = tcls(conv(dataclasses.replace(cfg, sea=dataclasses.replace(
        cfg.sea, lora_enabled=False, lora_in_approx_enabled=False))), device="cpu", seed=None)
    base.load_state_dict(port.state_dict(), strict=False)
    with torch.no_grad():
        plain = base(t(ids).long(), t(am).long(), benchmarking=benchmarking)["logits"]
    assert (plain - got["logits"]).abs().max() > 1e-3


def test_bert_lora_logits_match_jax():
    cfg = tiny_bert(**LORA)
    T = 64
    rng = np.random.default_rng(8)
    am = (np.arange(T)[None, :] < np.array([64, 37])[:, None]).astype(np.int32)
    ids = (rng.integers(4, 64, (2, T)) * am).astype(np.int32)
    types = np.zeros_like(ids)
    labels = np.array([0, 1], np.int32)
    port = seed_lora_(sharpen_port(tbert.BertForSequenceClassification(
        torch_bert_config(cfg), device="cpu", seed=4)), 6)
    model = jbert.BertForSequenceClassification(cfg)
    jargs = [jnp.asarray(x) for x in (ids, am, types)]
    variables = from_port(model, port, *jargs)
    want = jax.jit(functools.partial(model.apply, benchmarking=True))(
        variables, *jargs, jnp.asarray(labels))
    with torch.no_grad():
        got = port_topk_guard(lambda: port(*(t(x).long() for x in (ids, am, types, labels)),
                                           benchmarking=True))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=ATOL)


def test_task_step_lora_gradients_match_jax():
    """One task-only step (the next-token loss on the dense train path, no
    jitter): the gradient of every LoRA leaf against jax.grad's."""
    cfg = tiny_opt(**LORA)
    ids, am = causal_batch(64, 64, seed=9)
    port = seed_lora_(topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=7), 8)
    model = jopt.OptForCausalLM(cfg)
    variables = from_port(model, port, jnp.asarray(ids), jnp.asarray(am))

    def loss_fn(params):
        out = model.apply({**variables, "params": params}, jnp.asarray(ids), jnp.asarray(am),
                          jnp.asarray(ids))
        return out["loss"]

    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    loss = port_topk_guard(lambda: port(t(ids).long(), t(am).long(), t(ids).long())["loss"])
    loss.backward()
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    checked = 0
    for path, g in flat:
        keys = [str(getattr(p, "key", p)) for p in path]
        if not keys[-1].startswith("lora_"):
            continue
        name = ".".join(sum((["layers", k[7:]] if k.startswith("layers_") else [k]
                             for k in keys[:-1]), []) + [keys[-1]])
        got = dict(port.named_parameters())[name].grad.numpy()
        want_g = np.asarray(g)
        np.testing.assert_allclose(got, want_g, rtol=0,
                                   atol=GRAD_REL * float(np.abs(want_g).max()) + 1e-12)
        checked += 1
    assert checked == 2 * 2 * 8  # 2 layers x 8 deltas x (A, B)


def test_param_labels_match_jax_leaf_for_leaf():
    """`param_labels` of an OPT student with both LoRA flags and the 'comp'
    predictor equals JAX's path rule leaf for leaf: the deltas and the
    codebook in the high-lr groups."""
    cfg = tiny_opt(predictor_method="comp", comp_patch_count=2, comp_patch_size=8, **LORA)
    ids, am = causal_batch(64, 32, seed=1)
    port = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=0)
    shapes = jax.eval_shape(jopt.OptForCausalLM(cfg).init, jax.random.key(0),
                            jnp.asarray(ids), jnp.asarray(am))
    want = jax_param_labels(shapes["params"])
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got = param_labels(port)
    names = set()
    for path, label in flat:
        keys = [str(getattr(p, "key", p)) for p in path]
        name = ".".join(sum((["layers", k[7:]] if k.startswith("layers_") else [k]
                             for k in keys[:-1]), []))
        name += "." + ("weight" if keys[-1] in ("kernel", "scale", "embedding") else keys[-1])
        assert got[name] == label, (name, got[name], label)
        names.add(name)
    assert names == set(got)
    assert got["model.layers.0.self_attn.perlin_q_lora.lora_a"] == "high"
    assert got["model.layers.0.self_attn.perlin.comp_codebook"] == "high"


@pytest.mark.parametrize("family", ["opt", "llama"])
def test_prefill_ignores_lora(family):
    """The prefill of a LoRA'd model (logits and decode states) equals the
    LoRA-free model's on the same base weights, bit for bit, as JAX's
    prefill takes plain q, k, v; and JAX's prefill logits agree."""
    if family == "opt":
        cfg, jcls, tcls, conv, vocab = tiny_opt(use_cache=True, **LORA), jopt.OptForCausalLM, \
            topt.OptForCausalLM, torch_opt_config, 64
    else:
        cfg, jcls, tcls, conv, vocab = tiny_llama(use_cache=True, **LORA), \
            jl.LlamaForCausalLM, tl.LlamaForCausalLM, torch_llama_config, 256
    ids = np.random.default_rng(4).integers(4, vocab, (1, 48)).astype(np.int32)
    port = seed_lora_(tcls(conv(cfg), device="cpu", seed=3), 4)
    plain_cfg = dataclasses.replace(cfg, sea=dataclasses.replace(
        cfg.sea, lora_enabled=False, lora_in_approx_enabled=False))
    plain = tcls(conv(plain_cfg), device="cpu", seed=None)
    plain.load_state_dict(port.state_dict(), strict=False)
    logits, states = port.prefill_parallel(t(ids).long(), 64)
    logits_p, states_p = plain.prefill_parallel(t(ids).long(), 64)
    assert torch.equal(logits, logits_p)
    for a, b in zip(states, states_p):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    model = jcls(cfg)
    variables = from_port(model, port, jnp.asarray(ids), jnp.ones_like(jnp.asarray(ids)))
    want, _ = jax.jit(functools.partial(model.apply, method=jcls.prefill_parallel),
                      static_argnums=2)(variables, jnp.asarray(ids), 64)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=ATOL)
