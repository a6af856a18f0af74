"""Port parity and behaviour: the OPT KD trainer's loop path
(sea_tpu_torch.training.opt_trainer, sea_tpu_torch.data.wikitext2) against
the JAX package's `OptTrainer` and `WindowedCorpus`, at the tiny config.

Tolerances: the corpus, its windows and batches exact (the same numpy
calls); the strided perplexity 1e-5 relative (float32 logits summed in
another order); a save/load round trip bit for bit; the model configurations
of every type field and model exact. In bfloat16 (`compute_dtype`,
`param_dtype`, `moment_dtype`): the KD loss terms 1e-2 relative (2e-3
measured), and one update of the student against JAX's optax update of
JAX's gradients at least 90% of elements equal (97.6% measured) and every
element within 2·s·(1 + 2^-6) + 2^-7·(|p| + 2·s), s = lr·high_scale:
Adam's first step is about ±s per element (its bf16 moments put it within
2^-7 of that), so a gradient of another sign moves it by 2·s, and each
side's rounding adds half an ulp.
"""

import json
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import optax

from sea_tpu.data import wikitext2 as jw
from sea_tpu.models.loader import student_from_teacher as jax_student_from_teacher
from sea_tpu.models.opt import OptForCausalLM as JaxOpt
from sea_tpu.training.distill import SeaOptKD as JaxKD
from sea_tpu.training.opt_trainer import OptTrainer as JaxTrainer
from sea_tpu.training.opt_trainer import TrainerConfig as JaxTrainerConfig
from sea_tpu.training.opt_trainer import model_configs as jax_model_configs
from sea_tpu.training.opt_trainer import tiny_configs as jax_tiny_configs
from sea_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from sea_tpu_torch.data import wikitext2 as tw
from sea_tpu_torch.training import opt_trainer as to
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import t, torch_opt_config
from tests.test_opt_kd import make_batch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny models here take microseconds an op: under the suite's
    parallel workers torch's intra-op threads only contend (a 0.5 s test
    took 35 s), so each test runs on one thread and restores the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_corpus_matches_jax():
    """The synthetic stream, every window and the shuffled batches."""
    tokens = tw.synthetic_corpus(vocab_size=512, total_tokens=5000, seed=3)
    np.testing.assert_array_equal(tokens, jw.synthetic_corpus(512, 5000, 3))
    for L, stride in ((128, 64), (100, 100), (64, 24)):
        got, want = tw.WindowedCorpus(tokens, L, stride), jw.WindowedCorpus(tokens, L, stride)
        assert len(got) == len(want)
        for i in range(len(want)):
            for a, b in zip(got.window(i), want.window(i)):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(got.batches(3, shuffle=True, seed=5),
                        want.batches(3, shuffle=True, seed=5)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    short = tw.WindowedCorpus(tokens[:50], 64, 32)
    assert len(short) == 1 and short.window(0)[0].shape == (50,)


def test_get_corpus_reads_the_cache_or_falls_back(tmp_path):
    np.save(tmp_path / "wikitext2_test.npy", np.arange(300, dtype=np.int32))
    c = tw.get_corpus(64, 32, "test", cache_dir=str(tmp_path))
    np.testing.assert_array_equal(c.tokens, np.arange(300))
    c = tw.get_corpus(64, 32, "train", vocab_size=512, cache_dir=str(tmp_path))
    np.testing.assert_array_equal(c.tokens, jw.synthetic_corpus(512, seed=0))
    with pytest.raises(FileNotFoundError):
        tw.get_corpus(64, 32, "train", synthetic_fallback=False, cache_dir=str(tmp_path))


def tiny_cfg(tmp_path, **kw):
    base = dict(model="tiny", max_seq_len=64, stride=32, batch_size=2,
                gradient_accumulation_steps=2, num_steps=4, eval_steps=1000,
                log_steps=1, save_dir=str(tmp_path))
    base.update(kw)
    return to.TrainerConfig(**base)


def test_evaluate_matches_jax(tmp_path):
    """The student's strided perplexity on converted weights: 1e-5 rel.
    The JAX side is `OptTrainer.evaluate` itself, on a stand-in that holds
    what it reads: building the JAX trainer compiles its train step, and
    its corpus loader would try to download wikitext-2; both sides read the
    synthetic test stream (seed 1), the port's as its fallback."""
    jcfg = JaxTrainerConfig(model="tiny", max_seq_len=64, stride=32, batch_size=2)
    _, s_cfg = jax_tiny_configs()
    student = JaxOpt(s_cfg)
    ids = jnp.ones((2, 64), jnp.int32)
    variables = jax.jit(lambda: student.init(jax.random.key(1), ids, ids))()

    def eval_step(params, ids, mask, labels):
        out = student.apply({**variables, "params": params}, ids, mask)
        return JaxTrainer._eval_nll(out["logits"], labels)

    stand_in = types.SimpleNamespace(
        cfg=jcfg, s_params=variables["params"], _eval_step=jax.jit(eval_step),
        eval_corpus=jw.WindowedCorpus(jw.synthetic_corpus(s_cfg.vocab_size, seed=1), 64, 32))
    want = JaxTrainer.evaluate(stand_in, max_batches=3)
    tr = to.OptTrainer(tiny_cfg(tmp_path), device="cpu")
    tr.student.load_state_dict(state_dict_from_jax(variables))
    got = tr.evaluate(max_batches=3)
    assert np.isfinite(want) and want > 1
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_tiny_training_moves_the_student(tmp_path):
    """4 optimizer steps with accumulation 2: finite logged terms, the
    student moved and the teacher not, the projections redrawn (every 2
    steps), a perplexity after."""
    tr = to.OptTrainer(tiny_cfg(tmp_path, projection_redraw_steps=2), device="cpu")
    student0 = {n: p.clone() for n, p in tr.student.state_dict().items()}
    teacher0 = {n: p.clone() for n, p in tr.teacher.state_dict().items()}
    tr.train()
    assert tr.step == 4
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    steps = [r for r in records if "loss_kd_hidden" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    assert all(np.isfinite(v) for r in steps for v in r.values())
    after = tr.student.state_dict()
    moved = [n for n in student0 if not torch.equal(after[n], student0[n])]
    assert any(".perlin." in n for n in moved) and any(".perlin." not in n for n in moved)
    assert all(n in moved for n in after if n.endswith("performer_proj"))
    assert all(torch.equal(p, teacher0[n]) for n, p in tr.teacher.state_dict().items())
    assert np.isfinite(tr.evaluate(max_batches=2))


def test_save_load_round_trip(tmp_path):
    tr = to.OptTrainer(tiny_cfg(tmp_path, num_steps=2), device="cpu")
    tr.train()
    tr.save()
    other = to.OptTrainer(tiny_cfg(tmp_path, num_steps=2), device="cpu")
    assert other.load()
    assert other.step == tr.step == 2
    for (n, a), b in zip(tr.student.state_dict().items(), other.student.state_dict().values()):
        assert torch.equal(a, b), n
    sa, sb = tr.optimizer.state_dict()["state"], other.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for key in sa:
        for name in sa[key]:
            assert torch.equal(sa[key][name], sb[key][name]), (key, name)
    assert torch.equal(tr.generator.get_state(), other.generator.get_state())
    assert not other.load("absent")


@pytest.mark.parametrize("field,value", [
    ("scan_kd", True), ("data_parallel", True), ("checkpoint_rotation", 2),
    ("logit_chunk", 256), ("model", "llama-13b"), ("model", "llama-7b"),
])
def test_unported_options_are_refused(tmp_path, field, value):
    with pytest.raises(NotImplementedError):
        to.OptTrainer(tiny_cfg(tmp_path, **{field: value}), device="cpu")


@pytest.mark.parametrize("model", ["tiny", "opt-125m", "opt-350m", "opt-1.3b"])
@pytest.mark.parametrize("compute_dtype", [None, "float32", "bfloat16"])
def test_model_configs_match_jax(model, compute_dtype):
    """The (teacher, student) configurations of each model the port trains,
    with and without `compute_dtype`, equal JAX's `model_configs` (opt-1.3b
    computes in bf16 unless told otherwise)."""
    kw = dict(model=model, compute_dtype=compute_dtype)
    want = jax_model_configs(JaxTrainerConfig(**kw))
    assert to.model_configs(to.TrainerConfig(**kw)) == tuple(map(torch_opt_config, want))


def _cast_bf16(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def test_bf16_type_fields_one_update_match_jax(tmp_path):
    """compute_dtype, param_dtype and moment_dtype bfloat16 at the tiny
    config, one update (accumulation 1, lr 1e-3): every parameter of both
    models bf16 and AdamW's moments bf16; on JAX's cast and bootstrapped
    weights, the KD loss terms against `SeaOptKD.kd_loss`'s and the student
    after `OptTrainer.update` against JAX's optax update (`make_optimizer`
    with mu_dtype) of JAX's gradients, at the module doc's tolerances."""
    kw = dict(compute_dtype="bfloat16", param_dtype="bfloat16", moment_dtype="bfloat16")
    t_cfg, s_cfg = jax_model_configs(JaxTrainerConfig(model="tiny", **kw))
    lr, high = 1e-3, 10.0
    tr = to.OptTrainer(tiny_cfg(tmp_path, gradient_accumulation_steps=1, lr=lr,
                                lr_high_scale=high, **kw), device="cpu")
    assert all(p.dtype == torch.bfloat16 for m in (tr.teacher, tr.student)
               for p in m.parameters())
    kd = JaxKD(t_cfg, s_cfg)
    ids, mask = make_batch(N=2, T=64, vocab=t_cfg.vocab_size, seed=3)
    t_vars = _cast_bf16(jax.jit(lambda: kd.teacher.init(jax.random.key(0), ids, mask))())
    s_vars = jax_student_from_teacher(
        _cast_bf16(jax.jit(lambda: kd.student.init(jax.random.key(1), ids, mask))()),
        t_vars["params"])
    tr.teacher.load_state_dict(state_dict_from_jax(t_vars))
    tr.student.load_state_dict(state_dict_from_jax(s_vars))

    def loss_fn(params):
        return kd.kd_loss(t_vars, {**s_vars, "params": params}, ids, mask, ids, use_remat=True)

    (_, want_terms), grads = jax.value_and_grad(loss_fn, has_aux=True)(s_vars["params"])
    loss, terms = tr.kd.kd_loss(t(ids).long(), t(mask).long(), t(ids).long(),
                                use_remat=True, task_scale=tr.cfg.task_loss_scale)
    for name, v in terms.items():
        np.testing.assert_allclose(float(v), float(want_terms[name]), rtol=1e-2, err_msg=name)
    loss.backward()
    tr.update()
    tx = jax_make_optimizer(lr=lr, lr_high_scale=high, mu_dtype="bfloat16")
    updates, _ = tx.update(grads, tx.init(s_vars["params"]), s_vars["params"])
    want = state_dict_from_jax({"params": optax.apply_updates(s_vars["params"], updates)})
    before = state_dict_from_jax(s_vars)
    assert all(m.dtype == v.dtype == torch.bfloat16
               for m, v in zip(tr.optimizer.mu, tr.optimizer.nu))
    equal = total = 0
    for name, p in tr.student.named_parameters():
        got, w, p0 = p.detach().float(), want[name].float(), before[name].float()
        assert p.dtype == torch.bfloat16, name
        step = lr * high  # the largest group's rate
        bound = 2 * step * (1 + 2 ** -6) + 2 ** -7 * (p0.abs() + 2 * step)
        assert bool(((got - w).abs() <= bound).all()), name
        equal += int((got == w).sum())
        total += got.numel()
    assert equal >= 0.9 * total, equal / total


def test_main_trains_and_prints_a_perplexity(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    to.main(["--model", "tiny", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final ppl:" in out and np.isfinite(float(out.split("final ppl:")[-1]))
    assert (tmp_path / "saves" / "opt_trainer" / "checkpoint.pt").exists()
