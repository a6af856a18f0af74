"""Port parity: BERT's train path and KD (sea_tpu_torch.models.bert's
captures, hidden states and SEA train path, `remat_layers`, ToMe and its
'key' and 'probs' scores, the four other heads, `distill.SeaBertKD`)
against the JAX package's, at a tiny size (2 layers, width 32, 2 heads of
16, T = 64, right-padded rows).

Both sides hold the port's seeded weights (the JAX trees read from its
state dicts). The non-causal estimator ties at random init (no final
LayerNorm), so its CNN's last conv is scaled by 30 (`tests/test_torch_bert.py`'s
`sharpen`), and every top-k is guarded against near ties on the port's
estimates.
Tolerances: hidden states, captures and logits 1e-5 of max|want|; the KD
loss and every term 1e-5 relative; student gradients 1e-4 of the tensor's
largest |want| plus eight times the gap between two JAX gradients of the
same loss summed in other orders, jitted and jitted under `jax.checkpoint`
(tests/test_torch_kd.py's rule, which takes JAX's eager gradient for the
second: the estimator's LayerNorms over few columns amplify float32
rounding at random init, and a true gradient of zero, `cnn_conv3.bias`'s,
is all rounding); ToMe 1e-6 abs (a
gather and a scatter-mean of float32 rows); `remat_layers` bit for bit
against no remat."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.config import SeaConfig
from sea_tpu.models import bert as jbert
from sea_tpu.ops import tome as jtome
from sea_tpu.training.distill import SeaBertKD as JaxBertKD
from sea_tpu_torch.models import bert as tbert
from sea_tpu_torch.ops import tome as ttome
from sea_tpu_torch.training.distill import SeaBertKD
from sea_tpu_torch.weights import state_dict_from_jax
from sea_tpu_torch.models.loader import student_from_teacher
from tests._torch_parity import (jax_variables_from_state_dict, port_topk_guard, sharpen_port, t,
                                 torch_sea_config)

REL = 1e-5
GRAD_RTOL = 1e-4
T = 64
LENGTHS = (64, 41)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models: one intra-op thread (tests/test_torch_opt_trainer.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_bert(method, **kw):
    sea = SeaConfig(num_heads=2, head_dim=16, predictor_length=16, k=4, performer_nb_factor=1,
                    causal=False).validate()
    return jbert.BertConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                            ffn_dim=64, max_position_embeddings=T, attention_method=method,
                            sea=sea, **kw)


def torch_bert_config(cfg):
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["sea"] = torch_sea_config(cfg.sea)
    return tbert.BertConfig(**d)


def batch(seed=3, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    am = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    ids = (rng.integers(4, 64, (len(lengths), T)) * am).astype(np.int32)
    types = ((np.arange(T)[None, :] >= np.asarray(lengths)[:, None] // 2) * am).astype(np.int32)
    labels = rng.integers(0, 2, (len(lengths),)).astype(np.int32)
    return ids, am, types, labels


def close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()) + 1e-30)


def port_and_jax(port_cls, jax_cls, cfg, seed, *args):
    """The port model `port_cls(cfg)` with seeded weights (its non-causal
    estimator sharpened) and the JAX module with the same weights, read from
    the port's state dict (the tree's shape from `jax.eval_shape`, so no
    JAX init is compiled)."""
    port = sharpen_port(port_cls(torch_bert_config(cfg), device="cpu", seed=seed))
    model = jax_cls(cfg)
    shapes = jax.eval_shape(model.init, jax.random.key(0), *args)
    return port, model, jax_variables_from_state_dict(shapes, port.state_dict())


@pytest.fixture(scope="module")
def kd_setup():
    """The KD pair, the student bootstrapped from the teacher and
    sharpened, on both sides, and a batch."""
    args = [jnp.asarray(x) for x in batch()]
    teacher, jt, t_vars = port_and_jax(tbert.BertForSequenceClassification,
                                       jbert.BertForSequenceClassification,
                                       tiny_bert("none"), 0, *args[:3])
    student = tbert.BertForSequenceClassification(torch_bert_config(tiny_bert("perlin")),
                                                  device="cpu", seed=1)
    sharpen_port(student_from_teacher(student, teacher))
    shapes = jax.eval_shape(JaxBertKD(tiny_bert("none"), tiny_bert("perlin")).student.init,
                            jax.random.key(0), *args[:3])
    s_vars = jax_variables_from_state_dict(shapes, student.state_dict())
    kd = JaxBertKD(tiny_bert("none"), tiny_bert("perlin"))
    return kd, t_vars, s_vars, args, teacher.state_dict(), student.state_dict()


def kd_ports(kd_setup, **student_kw):
    """Fresh port teacher and student holding the fixture's weights."""
    *_, t_sd, s_sd = kd_setup
    teacher = tbert.BertForSequenceClassification(torch_bert_config(tiny_bert("none")),
                                                  device="cpu", seed=None)
    teacher.load_state_dict(t_sd)
    student = tbert.BertForSequenceClassification(
        torch_bert_config(tiny_bert("perlin", **student_kw)), device="cpu", seed=None)
    student.load_state_dict(s_sd)
    teacher.requires_grad_(False)
    return teacher, student


def test_train_path_hidden_states_and_captures_match_jax(kd_setup):
    """The dense teacher's captures and hidden states, then the SEA student
    on its train path with those truths: hidden states, logits and the
    attention-distill loss."""
    kd, t_vars, s_vars, (ids, am, types, labels), *_ = kd_setup
    t_want = jax.jit(functools.partial(kd.teacher.apply, output_hidden_states=True))(
        t_vars, ids, am, types, labels=labels)
    s_want = jax.jit(functools.partial(kd.student.apply, training=True,
                                       output_hidden_states=True))(
        s_vars, ids, am, types, labels=labels, teacher_outputs=t_want["teacher_captures"])
    teacher, student = kd_ports(kd_setup)
    args = [t(x).long() for x in (ids, am, types, labels)]
    with torch.no_grad():
        t_got = teacher(*args, output_hidden_states=True)
        s_got = port_topk_guard(lambda: student(
            *args, teacher_outputs=t_got["teacher_captures"], training=True,
            output_hidden_states=True))
    assert len(t_got["teacher_captures"]) == 2 and s_got["teacher_captures"] == []
    for g, w in zip(t_got["teacher_captures"], t_want["teacher_captures"]):
        close(g.attention_scores.clamp(min=-1e30), np.maximum(np.asarray(w.attention_scores),
                                                              -1e30))
        close(g.context_layer, w.context_layer)
    for name, got, want in (("teacher", t_got, t_want), ("student", s_got, s_want)):
        assert len(got["hidden_states"]) == 3, name
        for g, w in zip(got["hidden_states"], want["hidden_states"]):
            close(g, w)
        close(got["logits"], want["logits"])
    assert float(s_want["aux_loss"]) > 0
    np.testing.assert_allclose(float(s_got["aux_loss"]), float(s_want["aux_loss"]), rtol=REL)


def test_kd_loss_terms_and_grads_match_jax(kd_setup):
    """`SeaBertKD.kd_loss`: every term, and every student gradient (the
    masks agree: the port's top-k is guarded against near ties); the
    teacher gets none."""
    kd, t_vars, s_vars, (ids, am, types, labels), *_ = kd_setup

    def loss_fn(params):
        loss, det = kd.kd_loss(t_vars, {**s_vars, "params": params}, ids, am, labels, types)
        return loss, {k: v for k, v in det.items() if k != "logits"}

    (wl, wd), wg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(s_vars["params"])
    # JAX's own float32 noise: the same gradient under jax.checkpoint, which
    # XLA fuses, and so sums, otherwise
    _, wg_other = jax.jit(jax.value_and_grad(jax.checkpoint(loss_fn), has_aux=True))(
        s_vars["params"])
    teacher, student = kd_ports(kd_setup)
    loss, details = port_topk_guard(lambda: SeaBertKD(teacher, student).kd_loss(
        *(t(x).long() for x in (ids, am, labels, types))))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(wl), rtol=REL)
    assert set(details) == set(wd) | {"logits"}
    for name, w in wd.items():
        np.testing.assert_allclose(float(details[name].detach()), float(w), rtol=REL,
                                   err_msg=name)
    want = state_dict_from_jax({"params": wg})
    other = state_dict_from_jax({"params": wg_other})
    names = dict(student.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        w = want[name].numpy()
        floor = 8 * float(np.abs(other[name].numpy() - w).max())
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, err_msg=name,
                                   atol=GRAD_RTOL * float(np.abs(w).max()) + floor + 1e-12)
    assert all(p.grad is None for p in teacher.parameters())


def test_remat_layers_bit_for_bit(kd_setup):
    """`remat_layers`: the KD loss and every student gradient equal to no
    remat's bit for bit."""
    inputs = kd_setup[3]
    args = [t(x).long() for x in (inputs[0], inputs[1], inputs[3], inputs[2])]
    out = []
    for remat in (False, True):
        teacher, student = kd_ports(kd_setup, remat_layers=remat)
        loss, _ = SeaBertKD(teacher, student).kd_loss(*args)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in student.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# ToMe


@pytest.mark.parametrize("source", ["key", "probs"])
def test_tome_merge_unmerge_match_jax(source):
    """The merge and the unmerge on a key-similarity map and on a
    probability map; the round trip keeps the CLS and preserved rows and
    gives every merged source its destination's row."""
    rng = np.random.default_rng(0 if source == "key" else 1)
    N, E = 2, 8
    x = rng.standard_normal((N, T, E)).astype(np.float32)
    if source == "key":
        k = rng.standard_normal((N, 2, T, 4)).astype(np.float32)
        sim = np.einsum("nhtd,nhsd->nts", k, k) / 2
    else:
        logits = rng.standard_normal((N, 2, T, T)).astype(np.float32)
        sim = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).mean(1)
    merged_w, state_w = jtome.tome_merge(jnp.asarray(x), jnp.asarray(sim), 0.5, 0.5)  # eager:
    # the state's counts are Python ints
    merged, state = ttome.tome_merge(t(x), t(sim), 0.5, 0.5)
    np.testing.assert_array_equal(state.sort_idx.numpy(), np.asarray(state_w.sort_idx))
    np.testing.assert_array_equal(state.node_idx.numpy(), np.asarray(state_w.node_idx))
    assert (state.n_preserve, state.n_src, state.n_dst) == (
        state_w.n_preserve, state_w.n_src, state_w.n_dst)
    np.testing.assert_allclose(merged.numpy(), np.asarray(merged_w), atol=1e-6)
    y = rng.standard_normal(merged.shape).astype(np.float32)
    back = ttome.tome_unmerge(t(y), state)
    np.testing.assert_allclose(back.numpy(), np.asarray(jtome.tome_unmerge(jnp.asarray(y),
                                                                           state_w)), atol=1e-6)
    # the round trip: CLS and preserved rows come back in place
    assert torch.equal(back[:, 0], t(y)[:, 0])
    order = state.sort_idx
    for n in range(N):
        kept = order[n, :state.n_preserve] + 1
        assert torch.equal(back[n, kept], t(y)[n, 1:1 + state.n_preserve])
        src = order[n, state.n_preserve:state.n_preserve + state.n_src] + 1
        dst_rows = t(y)[n, 1 + state.n_preserve + state.node_idx[n]]
        assert torch.equal(back[n, src], dst_rows)


@pytest.mark.parametrize("source,method", [("key", "none"), ("probs", "none"),
                                           ("probs", "perlin")])
def test_token_merging_model_matches_jax(source, method):
    """BERT with ToMe around every FFN: the 'key' score, and the 'probs'
    score from the dense layer's and from the SEA train path's attention."""
    cfg = tiny_bert(method, token_merging=True, token_merging_score_source=source)
    ids, am, types, labels = (jnp.asarray(x) for x in batch(seed=4))
    port, model, variables = port_and_jax(tbert.BertForSequenceClassification,
                                          jbert.BertForSequenceClassification, cfg, 2,
                                          ids, am, types)
    want = jax.jit(functools.partial(model.apply, training=True, output_hidden_states=True))(
        variables, ids, am, types, labels=labels)
    with torch.no_grad():
        got = port_topk_guard(lambda: port(*(t(x).long() for x in (ids, am, types, labels)),
                                           training=True, output_hidden_states=True))
    for g, w in zip(got["hidden_states"], want["hidden_states"]):
        close(g, w)
    close(got["logits"], want["logits"])
    if method == "perlin":
        with pytest.raises(ValueError, match="probs"):
            port(*(t(x).long() for x in (ids, am, types)), benchmarking=True)


# ---------------------------------------------------------------------------
# the other heads


def _qa_labels(rng):
    return {"start_positions": rng.integers(0, T + 3, (2,)).astype(np.int32),
            "end_positions": np.asarray([T, 5], np.int32)}


def _token_labels(rng):
    lab = rng.integers(0, 3, (2, T)).astype(np.int32)
    lab[1, 41:] = -100
    return {"labels": lab}


def _mlm_labels(rng):
    lab = np.full((2, T), -100, np.int32)
    pos = rng.integers(0, 41, 10)
    lab[:, pos] = rng.integers(4, 64, (2, 10))
    return {"labels": lab}


HEADS = {
    "qa": (jbert.BertForQuestionAnswering, tbert.BertForQuestionAnswering, _qa_labels,
           ("start_logits", "end_logits")),
    "token": (jbert.BertForTokenClassification, tbert.BertForTokenClassification,
              _token_labels, ("logits",)),
    "choice": (jbert.BertForMultipleChoice, tbert.BertForMultipleChoice,
               lambda rng: {"labels": np.asarray([1, 0], np.int32)}, ("logits",)),
    "mlm": (jbert.BertForMaskedLM, tbert.BertForMaskedLM, _mlm_labels, ("logits",)),
}


@pytest.mark.parametrize("head", HEADS)
def test_heads_losses_match_jax(head):
    """Each head's outputs and loss (QA's positions past T clamped and T
    ignored, -100 ignored by the token and MLM heads, multiple choice over 2
    choices, the MLM decoder tied to the word embeddings), the SEA student
    on its train path."""
    jcls, tcls, make_labels, outs = HEADS[head]
    cfg = tiny_bert("perlin", num_labels=3)
    rng = np.random.default_rng(7)
    ids, am, types, _ = batch(seed=5)
    if head == "choice":
        ids, am, types = (np.stack([x, x[::-1]], 1) for x in (ids, am, types))
    labels = make_labels(rng)
    jargs = [jnp.asarray(x) for x in (ids, am, types)]
    port, model, variables = port_and_jax(tcls, jcls, cfg, 3, *jargs)
    want = jax.jit(functools.partial(model.apply, training=True))(
        variables, *jargs, **{k: jnp.asarray(v) for k, v in labels.items()})
    with torch.no_grad():
        got = port_topk_guard(lambda: port(*(t(x).long() for x in (ids, am, types)),
                                           training=True,
                                           **{k: t(v).long() for k, v in labels.items()}))
    for name in outs:
        close(got[name], want[name])
    assert float(want["loss"]) > 0
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=REL)
    if head == "mlm":
        assert port.bert.word_embeddings.weight.shape == (64, 32)
        assert "decoder.weight" not in port.state_dict()
