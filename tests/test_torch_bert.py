"""Port parity: the non-causal SEA attention module and the BERT encoder to
classification logits (sea_tpu_torch vs sea_tpu, benchmarking=True), on
right-padded batches at a tiny size.

The JAX side runs on the CPU with its padded bidirectional Pallas kernel in
interpret mode; the port takes the kernel's plain version on CPU tensors.
Weights come from the JAX modules' init through `state_dict_from_jax`.
Tolerances: top-k masks exact; the SEA module's context 1e-5 abs (float32,
the same arithmetic summed in another order); logits 1e-4 abs (the same,
through two layers, LayerNorms and the pooler)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.config import bert_config as jax_bert_config
from sea_tpu.models import bert as jbert
from sea_tpu.models.attention import SeaAttention as JaxSeaAttention
from sea_tpu.utils.profiler import get_bench as jax_bench
from sea_tpu_torch import config as torch_config
from sea_tpu_torch.models import bert as tbert
from sea_tpu_torch.models.attention import SeaAttention
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import assert_topk_margin, t, torch_sea_config

CTX_ATOL = 1e-5
LOGIT_ATOL = 1e-4
FP_MIN32 = float(np.finfo(np.float32).min) / 2
# The near-tie guard. At init the non-causal CNN (no final LayerNorm, unlike
# the causal one) gives scores that vary by about 0.03 over a row, so the
# estimates are all near 1/128 and the top-k cuts between values a few ulps
# apart. The tests scale the CNN's last conv by 30 on both sides
# (`sharpen`), which spreads the scores to about unit deviation as a trained
# estimator's are; the estimates then lie in about [0.003, 0.02], and a gap
# of 1e-7 is still some 200 float32 ulps of such a value.
TOPK_MARGIN = 1e-7
CNN_SCALE = 30.0


def tiny_sea(**kw):
    """bert_config at 2 heads of 64 with a smaller budget (k=16), so that
    the top-k keeps a fraction of the 2 x 128 pixels of a row."""
    return jax_bert_config(num_heads=2, head_dim=64, k=16, **kw)


def sharpen(variables):
    """The JAX variables with every SEA module's `cnn_conv3` weight and bias
    times CNN_SCALE (see TOPK_MARGIN)."""
    def walk(tree):
        return {
            name: (jax.tree_util.tree_map(lambda x: x * CNN_SCALE, sub)
                   if name == "cnn_conv3" else walk(sub) if hasattr(sub, "items") else sub)
            for name, sub in tree.items()
        }
    return {**variables, "params": walk(variables["params"])}


def padding_mask(lengths, T):
    """(N, 1, 1, T) additive mask of right-padded examples."""
    m = np.where(np.arange(T)[None, :] < np.asarray(lengths)[:, None], 0.0, FP_MIN32)
    return m[:, None, None, :].astype(np.float32)


def run_jax_captured(fn):
    """fn() with the JAX buffer registry on; also the top-k estimates and
    budgets it registered, for the near-tie guard."""
    bench = jax_bench()
    bench.activate_temp_buffers(True)
    try:
        out = fn()
        probs = bench.buffers.get("masked_estimated_attention_probs", [])
        budget = bench.buffers.get("per_item_top_k", [])
    finally:
        bench.activate_temp_buffers(False)
    return out, probs, budget


@pytest.mark.parametrize("T,lengths", [(128, (77, 128)), (101, (60, 101))], ids=["T128", "odd_T101"])
def test_sea_attention_noncausal_matches(T, lengths):
    """Masks exact and context within 1e-5; T=101 runs the strided CNN on an
    odd height (T + 1 rows after the upsample, shrunk back by the resize)."""
    cfg = tiny_sea()
    # a seed that keeps every top-k boundary apart by TOPK_MARGIN (or tied)
    rng = np.random.default_rng(T + 1)
    shape = (len(lengths), cfg.num_heads, T, cfg.head_dim)
    q, k, v = ((rng.standard_normal(shape) * 0.5).astype(np.float32) for _ in range(3))
    mask = padding_mask(lengths, T)
    jq, jk, jv, jmask = (jnp.asarray(x) for x in (q, k, v, mask))
    model = JaxSeaAttention(cfg)
    variables = sharpen(jax.jit(lambda: model.init(
        jax.random.key(0), jq, jk, jv, jq, jk, jv, jq, jk, jmask, benchmarking=True))())
    want, probs, budget = run_jax_captured(lambda: model.apply(
        variables, jq, jk, jv, jq, jk, jv, jq, jk, jmask, benchmarking=True))
    assert_topk_margin(probs, budget, TOPK_MARGIN)

    port = SeaAttention(torch_sea_config(cfg), device="cpu", seed=None)
    assert not hasattr(port, "v_eye_learned_causal")
    port.load_state_dict(state_dict_from_jax(variables))
    tq, tk, tv = t(q), t(k), t(v)
    with torch.no_grad():
        got = port(tq, tk, tv, tq, tk, tv, tq, tk, t(mask), benchmarking=True)
    np.testing.assert_array_equal(
        got.partial_attention_mask.numpy(), np.asarray(want.partial_attention_mask))
    np.testing.assert_allclose(
        got.context_layer.numpy(), np.asarray(want.context_layer), atol=CTX_ATOL)


def tiny_bert(method):
    return jbert.BertConfig(
        vocab_size=64, hidden_size=128, num_layers=2, num_heads=2, ffn_dim=256,
        max_position_embeddings=128, attention_method=method, sea=tiny_sea(),
    )


def torch_bert_config(cfg):
    """The port's BertConfig from a JAX one: the fields the port declares."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(tbert.BertConfig)}
    d["sea"] = torch_sea_config(cfg.sea)
    return tbert.BertConfig(**d)


def bert_batch(lengths, T, seed):
    rng = np.random.default_rng(seed)
    N = len(lengths)
    ids = rng.integers(4, 64, (N, T)).astype(np.int32)
    am = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    types = (np.arange(T)[None, :] >= np.asarray(lengths)[:, None] // 2).astype(np.int32) * am
    labels = rng.integers(0, 2, (N,)).astype(np.int32)
    return ids, am, types, labels


@pytest.mark.parametrize(
    "method,T,lengths",
    [("perlin", 128, (77, 128)), ("perlin", 101, (101, 60)), ("none", 128, (77, 128))],
    ids=["perlin_T128", "perlin_odd_T101", "none_T128"],
)
def test_bert_logits_match(method, T, lengths):
    cfg = tiny_bert(method)
    # a seed that keeps every top-k boundary apart by TOPK_MARGIN (or tied)
    ids, am, types, labels = bert_batch(lengths, T, seed=T + 1)
    jargs = tuple(jnp.asarray(x) for x in (ids, am, types, labels))
    model = jbert.BertForSequenceClassification(cfg)
    variables = sharpen(jax.jit(lambda: model.init(jax.random.key(1), *jargs[:3]))())
    want, probs, budget = run_jax_captured(
        lambda: model.apply(variables, *jargs, benchmarking=True))
    assert len(probs) == (cfg.num_layers if method == "perlin" else 0)
    assert_topk_margin(probs, budget, TOPK_MARGIN)

    port = tbert.BertForSequenceClassification(torch_bert_config(cfg), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        got = port(*(t(x).long() for x in (ids, am, types, labels)), benchmarking=True)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=LOGIT_ATOL)


def test_bert_base_config_and_seeded_init():
    """bert_base at full width builds the modules JAX builds (no causal
    identity table) and a seeded init repeats itself; the tiny model's
    forward is finite."""
    cfg = tbert.bert_base("perlin")
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.ffn_dim, cfg.vocab_size,
            cfg.max_position_embeddings, cfg.layer_norm_eps) == (768, 12, 12, 3072, 30522, 512, 1e-12)
    sea = cfg.sea
    assert sea == torch_config.bert_config()
    assert (sea.predictor_length, sea.k, sea.nb_features, sea.causal, sea.k_flatten_dim) == (
        128, 64, 266, False, "causal_batch")
    small = torch_bert_config(tiny_bert("perlin"))
    a = tbert.BertForSequenceClassification(small, device="cpu", seed=0)
    b = tbert.BertForSequenceClassification(small, device="cpu", seed=0)
    for (na, pa), (nb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb), na
    assert not any("v_eye" in n for n in a.state_dict())
    ids, am, types, _ = (t(x).long() for x in bert_batch((40, 96), 96, seed=0))
    with torch.no_grad():
        out = a(ids, am, types, benchmarking=True)["logits"]
    assert out.shape == (2, 2) and torch.isfinite(out).all()


def test_bert_refuses_what_is_not_ported():
    """What BERT still refuses: LoRA, `enc_per_layer`, the 'comp' predictor
    and the non-causal uniform-CSR route (an oversampled top-k). The SEA
    train path, the other methods and token merging run
    (tests/test_torch_bert_kd.py and tests/test_torch_baselines.py hold them
    to JAX)."""
    small = torch_bert_config(tiny_bert("perlin"))
    model = tbert.BertForSequenceClassification(small, device="cpu", seed=0)
    ids, am, types, _ = (t(x).long() for x in bert_batch((40, 64), 64, seed=0))
    with torch.no_grad():
        assert torch.isfinite(model(ids, am, types, benchmarking=False)["logits"]).all()
    for method in ("performer", "synthesizer", "cosformer", "reformer", "scatterbrain",
                   "sinkhorn"):
        tbert.BertForSequenceClassification(
            dataclasses.replace(small, attention_method=method), device="cpu")
    tbert.BertForSequenceClassification(dataclasses.replace(small, token_merging=True),
                                        device="cpu")
    for sea_kw in (dict(lora_enabled=True), dict(enc_per_layer=True),
                   dict(predictor_method="comp"), dict(k_oversample=2.0)):
        with pytest.raises(NotImplementedError):
            tbert.BertForSequenceClassification(
                dataclasses.replace(small, sea=dataclasses.replace(small.sea, **sea_kw)),
                device="cpu")
