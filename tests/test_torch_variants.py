"""Port parity: the SEA module's predictor variants, the codebook predictor
('comp') and `enc_per_layer` (one encoder over the heads concatenated),
through OPT on the benchmark path and the dense train path and through
BERT on the benchmark path, at tiny sizes; decode's refusal of 'comp' (JAX
asserts 'mlp'); and the `enc_per_layer` decode, which reads `enc_dense` as
JAX's does.

Both sides hold the port's seeded weights (the JAX trees read from its
state dicts); logits within 1e-4 as tests/test_torch_opt.py holds the
forward, the top-k guarded on the port's estimates."""

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
from sea_tpu_torch.models import bert as tbert
from sea_tpu_torch.models import opt as topt
from tests._torch_parity import (jax_variables_from_state_dict, port_topk_guard, sharpen_port,
                                 t, torch_opt_config, torch_sea_config)

ATOL = 1e-4
VARIANTS = {
    "comp": dict(predictor_method="comp", comp_book_size=8, comp_patch_count=2,
                 comp_patch_size=8),
    "enc_per_layer": dict(enc_per_layer=True),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_sea(causal=True, **kw):
    return SeaConfig(num_heads=2, head_dim=16, predictor_length=16, k=4, performer_nb_factor=1,
                     causal=causal, max_position_embeddings=128, **kw).validate()


def tiny_opt(**sea_kw):
    return jopt.OptConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, ffn_dim=64,
                          max_position_embeddings=128, attention_method="perlin",
                          sea=tiny_sea(**sea_kw))


def from_port(jmodel, port, *args, method=None):
    init = jmodel.init if method is None else functools.partial(jmodel.init, method=method)
    shapes = jax.eval_shape(init, jax.random.key(0), *args)
    return jax_variables_from_state_dict(shapes, port.state_dict())


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("benchmarking", [True, False], ids=["bench", "dense"])
def test_opt_variant_logits_match_jax(variant, benchmarking):
    cfg = tiny_opt(**VARIANTS[variant])
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 64, (2, 64)).astype(np.int32)
    am = np.ones((2, 64), np.int32)
    am[1, :9] = 0
    port = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=6)
    model = jopt.OptForCausalLM(cfg)
    variables = from_port(model, port, jnp.asarray(ids), jnp.asarray(am))
    want = jax.jit(functools.partial(model.apply, benchmarking=benchmarking))(
        variables, jnp.asarray(ids), jnp.asarray(am), jnp.asarray(ids))
    with torch.no_grad():
        got = port_topk_guard(lambda: port(t(ids).long(), t(am).long(), t(ids).long(),
                                           benchmarking=benchmarking))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=ATOL)


def test_variant_modules_are_jaxs():
    """Only the modules JAX's forward builds exist: 'comp' has no MLP
    encoder, dec_row or CNN; `enc_per_layer` without the cache has no
    `enc_dense` (decode's, kept with `use_cache`)."""
    names = lambda **kw: {n.split("perlin.")[1].split(".")[0] for n in topt.OptForCausalLM(
        torch_opt_config(tiny_opt(**kw)), device="cpu", seed=None).state_dict()
        if ".perlin." in n}
    comp = names(**VARIANTS["comp"])
    assert {"comp_codebook", "comp_enc_dense", "comp_enc_ln", "comp_dec_row",
            "dec_scaler"} <= comp
    assert not comp & {"enc_dense", "enc_ln", "dec_row", "cnn_conv1", "cnn_ln1"}
    epl = names(enc_per_layer=True)
    assert {"enc_per_layer_dense", "enc_per_layer_ln", "dec_row"} <= epl
    assert "enc_dense" not in epl
    assert "enc_dense" in names(enc_per_layer=True, use_cache=True)


@pytest.mark.parametrize("variant", VARIANTS)
def test_bert_variant_logits_match_jax(variant):
    sea = tiny_sea(causal=False, **VARIANTS[variant])
    cfg = jbert.BertConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, ffn_dim=64,
                           max_position_embeddings=64, attention_method="perlin", sea=sea)
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(tbert.BertConfig)}
    port = sharpen_port(tbert.BertForSequenceClassification(
        tbert.BertConfig(**{**d, "sea": torch_sea_config(sea)}), device="cpu", seed=5))
    T = 64
    rng = np.random.default_rng(9)
    am = (np.arange(T)[None, :] < np.array([64, 41])[:, None]).astype(np.int32)
    ids = (rng.integers(4, 64, (2, T)) * am).astype(np.int32)
    types = np.zeros_like(ids)
    model = jbert.BertForSequenceClassification(cfg)
    jargs = [jnp.asarray(x) for x in (ids, am, types)]
    variables = from_port(model, port, *jargs)
    want = jax.jit(functools.partial(model.apply, benchmarking=True))(variables, *jargs)
    with torch.no_grad():
        got = port_topk_guard(lambda: port(*(t(x).long() for x in (ids, am, types)),
                                           benchmarking=True))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL)


def test_decode_refuses_comp():
    cfg = torch_opt_config(tiny_opt(use_cache=True, **VARIANTS["comp"]))
    port = topt.OptForCausalLM(cfg, device="cpu", seed=0)
    ids = torch.randint(0, 64, (1, 16), generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="'mlp' only"):
        port.prefill_parallel(ids, 32)
    with pytest.raises(NotImplementedError, match="'mlp' only"):
        port.decode_step(ids[:, :1], 0, port.init_decode_states(1, 32))


def test_enc_per_layer_decode_matches_jax():
    """`enc_per_layer` with the cache: JAX's decode and prefill read
    `enc_dense` (not the per-layer encoder), and so do the port's; the
    prefill's logits and every decode step's against JAX's."""
    cfg = tiny_opt(use_cache=True, enc_per_layer=True)
    port = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=4)
    ids = np.random.default_rng(3).integers(0, 64, (1, 12)).astype(np.int32)
    model = jopt.OptForCausalLM(cfg)
    L = 24
    variables = from_port(model, port, jnp.asarray(ids),
                          method=lambda m, p: m.prefill_parallel(p, L))
    assert "enc_dense" in variables["params"]["model"]["layers_0"]["self_attn"]["perlin"]
    jl, jst = jax.jit(lambda v: model.apply(
        v, jnp.asarray(ids), L, method=lambda m, p, n: m.prefill_parallel(p, n)))(variables)
    logits, st = port.prefill_parallel(t(ids).long(), L)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=ATOL)
    step = jax.jit(lambda v, tok, pos, sts: model.apply(
        v, tok, pos, sts, method=lambda m, a, b, c: m.decode_step(a, b, c)))
    tok = np.asarray(jl)[:, -1:].argmax(-1).astype(np.int32)
    for i in range(ids.shape[1], ids.shape[1] + 6):
        jlog, jst = step(variables, jnp.asarray(tok), jnp.int32(i), jst)
        lg, st = port.decode_step(t(tok).long(), i, st)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlog), atol=ATOL, err_msg=f"step {i}")
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("extra", [dict(predictor_method="comp", comp_book_size=8,
                                        comp_patch_count=2, comp_patch_size=8),
                                   dict(enc_per_layer=True)], ids=["comp", "enc_per_layer"])
def test_weights_carry_the_new_leaves(extra):
    """`weights.state_dict_from_jax` carries a JAX tree of the variants with
    both LoRA flags (random leaves in the init's shapes: the codebook, the
    deltas' raw (in, r) and (r, out) matrices, the per-layer encoder) into
    the port with `strict=True`, and the tests' inverse gives the same
    tree back, bit for bit."""
    from sea_tpu_torch.weights import state_dict_from_jax

    cfg = tiny_opt(lora_enabled=True, lora_in_approx_enabled=True, lora_r=4, **extra)
    ids = jnp.zeros((1, 16), jnp.int32)
    shapes = jax.eval_shape(jopt.OptForCausalLM(cfg).init, jax.random.key(0), ids,
                            jnp.ones_like(ids))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    port = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(tree), strict=True)
    sd = port.state_dict()
    a = sd["model.layers.0.self_attn.perlin_q_score_lora.lora_a"].numpy()
    np.testing.assert_array_equal(
        a, tree["params"]["model"]["layers_0"]["self_attn"]["perlin_q_score_lora"]["lora_a"])
    back = jax_variables_from_state_dict(shapes, sd)
    for (path, x), (_, y) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                 jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(np.asarray(y), x, err_msg=str(path))
