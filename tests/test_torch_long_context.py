"""Port parity: the long-context extension (sea_tpu_torch.models.long_context
vs sea_tpu.models.long_context) and the sweep (training.exp_long_context
vs scripts/exp_long_context.py's evaluation), at tiny sizes.

The interpolation positions (jnp.linspace's float32 formula) and every
stretched leaf are held bit for bit; an extended model's logits past its
old context within 1e-4 as tests/test_torch_opt.py holds the forward; the
sweep's perplexity within 1e-5 relative of JAX's on the same weights and
windows (the synthetic corpus: JAX's `get_corpus` would try a download)."""

import dataclasses
import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.config import SeaConfig
from sea_tpu.models import long_context as jlc
from sea_tpu.models import opt as jopt
from sea_tpu_torch.data.wikitext2 import get_corpus
from sea_tpu_torch.models import long_context as tlc
from sea_tpu_torch.models import opt as topt
from sea_tpu_torch.training import exp_long_context as sweep_mod
from sea_tpu_torch.training.opt_trainer import TrainerConfig, build_model, model_configs
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import jax_variables_from_state_dict, port_topk_guard, t, torch_opt_config

ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("old,new", [(2048, 4096), (2048, 8192), (128, 256), (130, 64),
                                     (7, 1000), (64, 64)])
def test_interp_positions_bit_for_bit(old, new):
    want = np.asarray(jnp.linspace(0.0, old - 1, new))
    got = tlc.interp_positions(old, new).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def tiny_opt(max_pos=64):
    sea = SeaConfig(num_heads=2, head_dim=16, predictor_length=16, k=4, performer_nb_factor=1,
                    causal=True, max_position_embeddings=max_pos).validate()
    return jopt.OptConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, ffn_dim=64,
                          max_position_embeddings=max_pos, attention_method="perlin", sea=sea)


def jax_tree(cfg, port, T=32):
    ids = jnp.zeros((1, T), jnp.int32)
    shapes = jax.eval_shape(jopt.OptForCausalLM(cfg).init, jax.random.key(0), ids,
                            jnp.ones_like(ids))
    return jax_variables_from_state_dict(shapes, port.state_dict())


@pytest.mark.parametrize("new", [160, 40])
def test_stretched_leaves_bit_for_bit(new):
    cfg = tiny_opt()
    port = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=1)
    variables = jax_tree(cfg, port)
    # eager, as scripts/exp_long_context.py calls it (under jit XLA folds
    # the positions at compile time, by another rounding)
    want = state_dict_from_jax(
        {**variables, "params": jlc.extend_opt_context(variables["params"], new)})
    got = tlc.extend_opt_context(port.state_dict(), new)
    assert set(got) == set(port.state_dict())
    stretched = 0
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert torch.equal(got[name], w), name
        stretched += got[name].shape != port.state_dict()[name].shape
    assert stretched == 1 + cfg.num_layers  # the positions and each layer's table
    assert torch.equal(got["model.embed_positions.weight"][:2],
                       port.state_dict()["model.embed_positions.weight"][:2])


def test_extended_forward_matches_jax():
    """OPT stretched from 64 to 128 positions, a 128-token batch (twice its
    old context) on the benchmark path: logits and loss within ATOL."""
    cfg = tiny_opt()
    port = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=2)
    variables = jax_tree(cfg, port)
    ext = tlc.extend_opt_model(port, 128, dynamic_k=2)
    assert ext.cfg.max_position_embeddings == ext.cfg.sea.max_position_embeddings == 128
    assert ext.cfg.sea.dynamic_k == 2
    jcfg = tiny_opt(128)
    jcfg = dataclasses.replace(jcfg, sea=dataclasses.replace(jcfg.sea, dynamic_k=2))
    params = jlc.extend_opt_context(variables["params"], 128)
    ids = np.random.default_rng(5).integers(0, 64, (1, 128)).astype(np.int32)
    am = np.ones_like(ids)
    want = jax.jit(functools.partial(jopt.OptForCausalLM(jcfg).apply, benchmarking=True))(
        {**variables, "params": params}, jnp.asarray(ids), jnp.asarray(am), jnp.asarray(ids))
    with torch.no_grad():
        got = port_topk_guard(lambda: ext(t(ids).long(), t(am).long(), t(ids).long(),
                                          benchmarking=True))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=ATOL)


def jax_ppl(s_cfg, variables, ctx, dk, qs, n_batches):
    """scripts/exp_long_context.py's evaluation of one combination (its
    dense forward), on the port's corpus windows."""
    sea = dataclasses.replace(s_cfg.sea, max_position_embeddings=ctx, dynamic_k=dk,
                              query_skips=qs)
    m = jopt.OptForCausalLM(dataclasses.replace(s_cfg, sea=sea, max_position_embeddings=ctx))
    v = {**variables, "params": jlc.extend_opt_context(variables["params"], ctx)}

    @jax.jit
    def eval_step(v, ids, mask, labels):
        logits = m.apply(v, ids, mask)["logits"][:, :-1].astype(jnp.float32)
        tgt = labels[:, 1:]
        valid = tgt != -100
        logp = jax.nn.log_softmax(logits, -1)
        nll = -jnp.take_along_axis(logp, jnp.where(valid, tgt, 0)[..., None], -1)[..., 0]
        return jnp.where(valid, nll, 0.0).sum(), valid.sum()

    tot, toks = 0.0, 0
    corpus = get_corpus(ctx, ctx, "test", vocab_size=s_cfg.vocab_size)
    for i, (ids, mask, labels) in enumerate(corpus.batches(1)):
        if i >= n_batches:
            break
        nll, tk = eval_step(v, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(labels))
        tot += float(nll)
        toks += int(tk)
    return float(np.exp(tot / max(toks, 1)))


def test_sweep_records_match_jax(tmp_path, capsys):
    """The tiny model's sweep over 2 contexts × 2 dynamic_k × 2 query_skips
    on the dense path (JAX's sweep's forward): one printed record per
    combination, each PPL against JAX's; then the benchmark path and a
    checkpoint written by `torch.save` through `main`."""
    from sea_tpu.training.opt_trainer import TrainerConfig as JaxTrainerConfig
    from sea_tpu.training.opt_trainer import model_configs as jax_model_configs

    recs = sweep_mod.sweep(model="tiny", contexts=(64, 128), dynamic_ks=(0, 1),
                           query_skips=(1, 2), n_eval_batches=2, device="cpu",
                           benchmarking=False)
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [{k: r[k] for k in ("context", "dynamic_k", "query_skips")} for r in recs] == [
        dict(context=c, dynamic_k=d, query_skips=q) for c in (64, 128) for d in (0, 1)
        for q in (1, 2)]
    assert printed == recs
    assert all(np.isfinite(r["ppl"]) and r["ms_per_window"] > 0 for r in recs)
    _, s_cfg = jax_model_configs(JaxTrainerConfig(model="tiny"))
    _, port_cfg = model_configs(TrainerConfig(model="tiny"))
    assert torch_opt_config(s_cfg) == port_cfg
    base = build_model(port_cfg, 0, "cpu")
    variables = jax_tree(s_cfg, base)
    for r in (recs[0], recs[-1]):
        want = jax_ppl(s_cfg, variables, r["context"], r["dynamic_k"], r["query_skips"], 2)
        assert abs(r["ppl"] - want) <= 1e-5 * want + 1e-4, (r, want)
    # a checkpoint of other weights moves the perplexity; the benchmark path
    ckpt = str(tmp_path / "student.pt")
    other = build_model(port_cfg, 5, "cpu")
    torch.save({"student": other.state_dict()}, ckpt)
    out = sweep_mod.main(["--model", "tiny", "--contexts", "64", "--query-skips", "1",
                          "--eval-batches", "2", "--checkpoint", ckpt, "--device", "cpu"])
    assert len(out) == 1 and np.isfinite(out[0]["ppl"]) and out[0]["ppl"] != recs[0]["ppl"]
