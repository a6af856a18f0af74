"""Port parity: the baseline attention methods (sea_tpu_torch.ops.baselines
vs sea_tpu.ops.baselines), OPT's and LLaMA's baseline students and BERT's
baseline methods to logits, and `kd_self_teacher`, at tiny sizes.

Inputs come from a numpy seed; both sides hold the port's seeded weights
(the JAX trees read from its state dicts); JAX runs on the CPU in float32
at "highest" precision, the port in float32. JAX's random draws (the LSH
rotations) are passed into the port. Tolerance: 1e-5 of max|want| for every function and
every model's logits (float32 on both sides, summed in another order);
the self-teacher's loss 1e-5 absolute and relative, as the dense train
path's loss is held (tests/test_torch_train_path.py: the estimator's
LayerNorms over a few columns amplify float32 rounding at random init)."""

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
from sea_tpu.models import opt as jopt
from sea_tpu.models.attention import SeaAttention as JaxSeaAttention
from sea_tpu.ops import baselines as jb
from sea_tpu.ops.performer import gaussian_orthogonal_random_matrix as jax_gorm
from sea_tpu_torch.models import bert as tbert
from sea_tpu_torch.models import llama as tl
from sea_tpu_torch.models import opt as topt
from sea_tpu_torch.models.attention import SeaAttention
from sea_tpu_torch.ops import baselines as tb
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import (jax_variables_from_state_dict, t, torch_llama_config,
                                 torch_opt_config, torch_sea_config)

REL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models: one intra-op thread, so that the suite's workers do not
    contend (tests/test_torch_opt_trainer.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def from_port(jmodel, port, *args):
    """JAX variables for `jmodel` holding the port module's seeded weights
    (the tree's shape from `jax.eval_shape`, so no JAX init is compiled)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), *args)
    return jax_variables_from_state_dict(shapes, port.state_dict())


def close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


def jax_rotations(key, D, n_buckets, n_hashes):
    """The reformer's draws: rotation i from fold_in(key, i)."""
    return [np.asarray(jax.random.normal(jax.random.fold_in(key, i), (D, n_buckets // 2)))
            for i in range(n_hashes)]


def qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def right_padded(lengths, T):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)


# ---------------------------------------------------------------------------
# the functions


@pytest.mark.parametrize("causal,masked", [(False, True), (True, False)],
                         ids=["noncausal_padded", "causal"])
def test_reformer_matches_jax(causal, masked):
    N, H, T, D = 2, 2, 48, 8
    q, _, v = qkv((N, H, T, D), seed=1)
    mask = right_padded((48, 29), T) if masked else None
    key = jax.random.key(3)
    want = jax.jit(functools.partial(jb.reformer_lsh_attention, bucket_size=8, n_hashes=3,
                                     causal=causal))(
        jnp.asarray(q), jnp.asarray(v), rng=key,
        mask_1d=None if mask is None else jnp.asarray(mask))
    _, n_buckets = tb.lsh_buckets(T, 8)
    rots = [t(r) for r in jax_rotations(key, D, n_buckets, 3)]
    got = tb.reformer_lsh_attention(t(q), t(v), bucket_size=8, n_hashes=3, causal=causal,
                                    mask_1d=None if mask is None else t(mask), rotations=rots)
    close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_scatterbrain_matches_jax(causal):
    N, H, T, D = 2, 2, 32, 8
    q, k, v = (x * 0.5 for x in qkv((N, H, T, D), seed=2))
    proj = np.asarray(jax_gorm(jax.random.key(5), 16, D))
    key = jax.random.key(4)
    want = jax.jit(functools.partial(jb.scatterbrain_attention, bucket_size=8, causal=causal))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(proj), rng=key)
    rot = t(np.asarray(jax.random.normal(key, (D, T // 8 // 2))))
    got = tb.scatterbrain_attention(t(q), t(k), t(v), t(proj), bucket_size=8, causal=causal,
                                    rotation=rot)
    close(got, want)


def test_sinkhorn_block_matches_jax():
    N, H, T, D = 2, 2, 32, 8
    q, k, v = qkv((N, H, T, D), seed=6)
    mask = right_padded((32, 21), T)
    want = jax.jit(functools.partial(jb.sinkhorn_block_attention, block_size=8))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask_1d=jnp.asarray(mask))
    got = tb.sinkhorn_block_attention(t(q), t(k), t(v), block_size=8, mask_1d=t(mask))
    close(got, want)


@pytest.mark.parametrize("T", [32, 37], ids=["whole_blocks", "padded_T37"])
def test_sinkhorn_causal_matches_jax(T):
    q, k, v = qkv((2, 2, T, 8), seed=T)
    want = jax.jit(functools.partial(jb.sinkhorn_causal_attention, block_size=8))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tb.sinkhorn_causal_attention(t(q), t(k), t(v), block_size=8)
    close(got, want)


def test_synthesizer_matches_jax():
    N, H, T, D = 2, 2, 24, 8
    q, _, v = qkv((N, H, T, D), seed=7)
    mask = right_padded((24, 10), T)[:, None, None, :] > 0
    model = jb.SynthesizerDense(32)
    variables = jax.jit(model.init)(jax.random.key(0), jnp.asarray(q), jnp.asarray(v))
    want, want_p = jax.jit(model.apply)(variables, jnp.asarray(q), jnp.asarray(v),
                                        mask=jnp.asarray(mask))
    port = tb.SynthesizerDense(D, 32)
    port.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        got, got_p = port(t(q), t(v), mask=t(mask))
    close(got, want)
    close(got_p, want_p)


# ---------------------------------------------------------------------------
# OPT's and LLaMA's baseline students


def tiny_opt(method):
    sea = SeaConfig(num_heads=2, head_dim=16, predictor_length=16, k=8, performer_nb_factor=1,
                    causal=True, max_position_embeddings=128).validate()
    return jopt.OptConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, ffn_dim=64,
                          max_position_embeddings=128, attention_method=method, sea=sea)


FAMILIES = {
    "opt": (tiny_opt, jopt.OptForCausalLM, topt.OptForCausalLM, torch_opt_config, 64),
    "llama": (lambda m: jl.llama_tiny(m, num_kv_heads=2), jl.LlamaForCausalLM,
              tl.LlamaForCausalLM, torch_llama_config, 256),
}


@pytest.mark.parametrize("method", topt.BASELINE_METHODS)
@pytest.mark.parametrize("family", FAMILIES)
def test_causal_students_match_jax(family, method):
    """Logits of a batch with a right-padded row (the zeroed value rows);
    the reformer takes JAX's fallback draws (key 7) as each layer's
    `jitter`, and its own default draws (seed 7) give other, finite logits."""
    build, jmodel_cls, tmodel_cls, to_torch, vocab = FAMILIES[family]
    cfg = build(method)
    T = 64
    rng = np.random.default_rng(11)
    ids = rng.integers(4, vocab, (2, T)).astype(np.int32)
    am = right_padded((T, 41), T)
    model = jmodel_cls(cfg)
    port = tmodel_cls(to_torch(cfg), device="cpu", seed=1)
    variables = from_port(model, port, jnp.asarray(ids), jnp.asarray(am))
    want = jax.jit(model.apply)(variables, jnp.asarray(ids), jnp.asarray(am))["logits"]
    D = cfg.hidden_size // cfg.num_heads
    _, n_buckets = tb.lsh_buckets(T, topt.REFORMER_BUCKET)
    draws = [[t(r) for r in jax_rotations(jax.random.key(7), D, n_buckets, 4)]] * cfg.num_layers
    with torch.no_grad():
        got = port(t(ids).long(), t(am).long(),
                   jitter=draws if method == "reformer" else None)["logits"]
    close(got, want)
    if method == "reformer":
        # the default draws are the port's own (seed 7), not JAX's
        with torch.no_grad():
            own = port(t(ids).long(), t(am).long())["logits"]
        assert torch.isfinite(own).all() and not torch.allclose(own, got)


def test_student_buffers_and_seeded_init():
    """The performer student keeps its projection as a buffer (redrawn,
    never trained) and a seed repeats the cosformer student's weights."""
    perf = topt.OptForCausalLM(torch_opt_config(tiny_opt("performer")), device="cpu")
    names = dict(perf.named_buffers())
    assert "model.layers.0.self_attn.performer_proj" in names
    assert not any("performer_proj" in n for n, _ in perf.named_parameters())
    a, b = (tl.LlamaForCausalLM(torch_llama_config(jl.llama_tiny("cosformer")), device="cpu")
            for _ in range(2))
    assert any(".cosformer.q_proj." in n for n in a.state_dict())
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n


# ---------------------------------------------------------------------------
# BERT's methods


def tiny_bert(method, T=64):
    sea = SeaConfig(num_heads=2, head_dim=16, predictor_length=16, k=8, performer_nb_factor=1,
                    causal=False).validate()
    return jbert.BertConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                            ffn_dim=64, max_position_embeddings=T, attention_method=method,
                            sea=sea)


def torch_bert_config(cfg):
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["sea"] = torch_sea_config(cfg.sea)
    return tbert.BertConfig(**d)


def jax_default_rotations(head_dim, n_buckets, n_hashes, generator=None, seed=0, device="cpu"):
    """JAX's draws where a BERT method passes no rng (key 0): the reformer's
    rotation i from fold_in(key(0), i), scatterbrain's one from key(0)."""
    key = jax.random.key(seed)
    if n_hashes == 1:
        return [t(np.asarray(jax.random.normal(key, (head_dim, n_buckets // 2))))]
    return [t(r) for r in jax_rotations(key, head_dim, n_buckets, n_hashes)]


BERT_BASELINES = ("performer", "synthesizer", "cosformer", "reformer", "scatterbrain", "sinkhorn")


def bert_inputs(T, lengths, seed):
    rng = np.random.default_rng(seed)
    am = right_padded(lengths, T)
    ids = (rng.integers(4, 64, (len(lengths), T)) * am).astype(np.int32)
    types = ((np.arange(T)[None, :] >= np.asarray(lengths)[:, None] // 2) * am).astype(np.int32)
    labels = rng.integers(0, 2, (len(lengths),)).astype(np.int32)
    return ids, am, types, labels


@pytest.mark.parametrize("method", BERT_BASELINES)
def test_bert_methods_match_jax(method, monkeypatch):
    """Logits and loss of a right-padded batch for each baseline method,
    with each method's bucket and block sizes; the LSH draws JAX's key 0's.
    Then the padding's token ids changed: the logits again equal JAX's, and
    the padding reaches the unpadded logits in the port where it does in
    JAX (the synthesizer and the cosformer mask it; the performer's key
    features, the reformer's wrapped look-back, scatterbrain's unmasked
    chunks and sinkhorn's matched blocks read it)."""
    monkeypatch.setattr(tb, "lsh_rotations", jax_default_rotations)
    T = 64
    cfg = tiny_bert(method, T)
    ids, am, types, labels = bert_inputs(T, (64, 37), seed=5)
    jargs = [jnp.asarray(x) for x in (ids, am, types, labels)]
    model = jbert.BertForSequenceClassification(cfg)
    port = tbert.BertForSequenceClassification(torch_bert_config(cfg), device="cpu", seed=2)
    variables = from_port(model, port, *jargs[:3])
    apply = jax.jit(model.apply)
    want = apply(variables, *jargs)
    with torch.no_grad():
        got = port(*(t(x).long() for x in (ids, am, types, labels)))
    close(got["logits"], want["logits"])
    close(got["loss"], want["loss"])
    ids2 = np.where(am > 0, ids, 7).astype(np.int32)
    want2 = apply(variables, jnp.asarray(ids2), *jargs[1:])["logits"]
    with torch.no_grad():
        got2 = port(*(t(x).long() for x in (ids2, am, types)))["logits"]
    close(got2, want2)
    reaches = float(np.abs(np.asarray(want2) - np.asarray(want["logits"])).max()) > 0
    assert reaches == (method not in ("synthesizer", "cosformer"))
    assert reaches == (not torch.equal(got2, got["logits"]))


# ---------------------------------------------------------------------------
# kd_self_teacher


def test_kd_self_teacher_matches_jax():
    """The student's own detached dense scores as its truth: the module's
    loss and context on the dense train path, causal, against JAX's."""
    cfg = SeaConfig(num_heads=2, head_dim=8, predictor_length=8, k=2, performer_nb_factor=1,
                    causal=True, max_position_embeddings=128, kd_self_teacher=True).validate()
    N, H, T, D = 1, 2, 32, 8
    q, k, v = (x * 0.5 for x in qkv((N, H, T, D), seed=9))
    mask = np.where(np.tril(np.ones((T, T), bool)), 0.0,
                    float(np.finfo(np.float32).min))[None, None].astype(np.float32)
    jq, jk, jv, jm = (jnp.asarray(x) for x in (q, k, v, mask))
    model = JaxSeaAttention(cfg)
    args = (jq, jk, jv, jq, jk, jv, jq, jk, jm)
    port = SeaAttention(torch_sea_config(cfg), device="cpu", seed=0)
    variables = from_port(model, port, *args)
    want = jax.jit(functools.partial(model.apply, training=True))(variables, *args)
    tq, tk, tv = t(q), t(k), t(v)
    got = port(tq, tk, tv, tq, tk, tv, tq, tk, t(mask), training=True)
    assert float(want.loss) > 0
    np.testing.assert_allclose(float(got.loss.detach()), float(want.loss), atol=1e-5,
                               rtol=1e-5)
    close(got.context_layer, want.context_layer)
    # without training there is no truth and no loss
    with torch.no_grad():
        plain = port(tq, tk, tv, tq, tk, tv, tq, tk, t(mask))
    assert float(plain.loss) == 0.0
