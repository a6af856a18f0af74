"""Port parity: GLUE and LRA data, the GLUE metrics, the GLUE and LRA
trainers' steps (sea_tpu_torch.training.glue_trainer / lra_trainer)
against the JAX package's step math rebuilt from its `SeaBertKD` and
`make_optimizer` (no JAX trainer is constructed: the JAX GLUE trainer's
constructor calls its `get_glue`, which would try a download), the
learning-rate schedules, the port's checkpoints (LRA resume,
`OptTrainer.load(only_additionals=True)`), the KD trainer with the
baseline students, and that no port loader touches the network.

Both sides run on the port's seeded weights (the JAX trees read from the
port's state dicts, the non-causal estimator's last conv scaled by 30 as
tests/test_torch_bert.py does, the top-k guarded against near ties).
Tolerances: the data, the metrics and the schedules exact; a step's loss
1e-5 relative (float32, summed in another order); the parameters after
each update 1e-6 abs against JAX's update from the same gradients (the
gradients themselves are held to JAX's by tests/test_torch_bert_kd.py;
AdamW's early steps are sign-like, so two independently rounded gradients
would move a parameter whose gradient is noise either way); a step's
gradient against the mean of its micro-batches' 1e-5 relative; the resumed
state bit for bit."""

import dataclasses
import json
import pickle
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from sea_tpu.config import SeaConfig as JaxSeaConfig
from sea_tpu.data import glue as jglue
from sea_tpu.data import lra as jlra
from sea_tpu.models import bert as jbert
from sea_tpu.training import glue_metrics as jmetrics
from sea_tpu.training.distill import SeaBertKD as JaxBertKD
from sea_tpu.training.glue_trainer import tiny_bert_configs as jax_tiny_bert_configs
from sea_tpu.training.lra_trainer import lra_bert_config as jax_lra_bert_config
from sea_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from sea_tpu_torch.data import glue as tglue
from sea_tpu_torch.data import lra as tlra
from sea_tpu_torch.data import wikitext2 as tw
from sea_tpu_torch.training import glue_metrics as tmetrics
from sea_tpu_torch.training import glue_trainer as tgt
from sea_tpu_torch.training import lra_trainer as tlt
from sea_tpu_torch.training import opt_trainer as to
from sea_tpu_torch.training.optimizer import linear_warmup, rsqrt_schedule
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import jax_variables_from_state_dict, port_topk_guard, sharpen_port


UPDATE_ATOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models: one intra-op thread (tests/test_torch_opt_trainer.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_bert_config(cfg):
    """The JAX BertConfig of a port one (the same fields)."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["sea"] = JaxSeaConfig(**dataclasses.asdict(cfg.sea))
    return jbert.BertConfig(**d)


def arrays(ds):
    return (ds.input_ids, ds.attention_mask, ds.token_type_ids, ds.labels)


def assert_same_dataset(a, b):
    for x, y in zip(arrays(a), arrays(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype


# ---------------------------------------------------------------------------
# data and metrics


@pytest.mark.parametrize("subset", ["cola", "mrpc", "stsb", "mnli"])
def test_glue_metrics_and_synthetic_data_match_jax(subset):
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 2, 64)
    preds = np.where(rng.uniform(size=64) < 0.7, labels, 1 - labels)
    if subset == "stsb":
        labels = np.round(rng.uniform(0, 5, 64), 1)  # ties for the ranks
        preds = np.round(labels + rng.normal(0, 0.5, 64), 1)
    want = jmetrics.glue_compute(subset, preds, labels)
    got = tmetrics.glue_compute(subset, preds, labels)
    assert got == want
    assert tmetrics.primary_score(subset, got) == jmetrics.primary_score(subset, want)
    for split in ("train", "validation"):
        assert_same_dataset(tglue.synthetic_glue(subset, split, n=64, max_length=48),
                            jglue.synthetic_glue(subset, split, n=64, max_length=48))
    assert tglue.TASK_NUM_LABELS == jglue.TASK_NUM_LABELS
    assert tglue.TASK_BATCH_SIZE == jglue.TASK_BATCH_SIZE


def test_lra_data_matches_jax(tmp_path):
    """ListOps, the synthetic text and image streams, the local IMDb and
    CIFAR-10 pipelines, the task table, and ListOps' cache."""
    assert tlra.LRA_TASKS == {k: tlra.LraTaskSpec(**dataclasses.asdict(v))
                              for k, v in jlra.LRA_TASKS.items()}
    assert tlra.LISTOPS_TOKENS == jlra.LISTOPS_TOKENS
    assert_same_dataset(tlra.listops_dataset(48, 96, max_depth=4, seed=2, cache_dir=None),
                        jlra.listops_dataset(48, 96, max_depth=4, seed=2, cache_dir=None))
    empty = str(tmp_path / "none")
    assert_same_dataset(tlra.text_dataset(8, 64, seed=1, data_dir=empty),
                        jlra.text_dataset(8, 64, seed=1, data_dir=empty))
    assert_same_dataset(tlra.image_dataset(8, side=8, data_dir=empty),
                        jlra.image_dataset(8, side=8, data_dir=empty))
    # the local pipelines on a few made-up files
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        for sub in ("pos", "neg"):
            d = tmp_path / "aclImdb" / split / sub
            d.mkdir(parents=True)
            for i in range(3):
                (d / f"{i}.txt").write_bytes(bytes(rng.integers(32, 127, 40 + 9 * i).tolist()))
    cifar = tmp_path / "cifar-10-batches-py"
    cifar.mkdir()
    for name in ("data_batch_1", "test_batch"):
        with open(cifar / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (5, 3072)).astype(np.uint8),
                         b"labels": list(rng.integers(0, 10, 5))}, f)
    assert_same_dataset(tlra.text_dataset(4, 64, data_dir=str(tmp_path)),
                        jlra.text_dataset(4, 64, data_dir=str(tmp_path)))
    assert_same_dataset(tlra.image_dataset(4, data_dir=str(tmp_path)),
                        jlra.image_dataset(4, data_dir=str(tmp_path)))
    # the cache: the second call reads what the first wrote
    a = tlra.get_lra("listops", "train", n=16, max_length=64, cache_dir=str(tmp_path))
    assert len(list(tmp_path.glob("listops_*.npz"))) == 1
    assert_same_dataset(a, tlra.get_lra("listops", "train", n=16, max_length=64,
                                        cache_dir=str(tmp_path)))


def test_loaders_never_download(tmp_path, monkeypatch):
    """`datasets.load_dataset` and the tokenizer loader made to fail: the
    port's `get_glue`, `get_lra` and `get_corpus(dataset="openwebtext")`
    never call them, fall back to their synthetic data, and read a local
    cache when one is there."""
    calls = []

    def refuse(*a, **kw):
        calls.append(a)
        raise AssertionError("a port loader tried to download")

    # stand-ins for both packages (importing the real ones takes seconds):
    # their loaders refuse, and so would any other attribute read
    for name, attr in (("datasets", "load_dataset"), ("transformers", "AutoTokenizer")):
        fake = types.ModuleType(name)
        setattr(fake, attr, refuse if attr == "load_dataset" else types.SimpleNamespace(
            from_pretrained=refuse))
        monkeypatch.setitem(sys.modules, name, fake)
    glue = tglue.get_glue("mrpc", "train", cache_dir=str(tmp_path))
    assert_same_dataset(glue, tglue.synthetic_glue("mrpc", "train", max_length=64))
    for task in ("listops", "text", "image"):
        ds = tlra.get_lra(task, "train", n=4, max_length=64, cache_dir=None,
                          data_dir=str(tmp_path))
        assert ds.input_ids.shape == (4, 64)
    corpus = tw.get_corpus(64, 32, dataset="openwebtext", cache_dir=str(tmp_path))
    np.testing.assert_array_equal(corpus.tokens, tw.synthetic_corpus())
    np.save(tmp_path / "openwebtext_train.npy", np.arange(100, dtype=np.int32))
    assert tw.get_corpus(64, 32, dataset="openwebtext", cache_dir=str(tmp_path)).tokens[7] == 7
    np.savez(tmp_path / "glue_mrpc_train.npz", input_ids=np.ones((3, 8)),
             attention_mask=np.ones((3, 8)), token_type_ids=np.zeros((3, 8)), labels=np.ones(3))
    assert tglue.get_glue("mrpc", "train", cache_dir=str(tmp_path)).input_ids.shape == (3, 8)
    assert calls == []


@pytest.mark.parametrize("kind", ["linear", "rsqrt"])
def test_schedules_match_jax(kind):
    peak, w = 2e-3, 3
    if kind == "linear":
        want = optax.linear_schedule(0.0, peak, w)
        got = linear_warmup(peak, w)
    else:
        def want(s):  # the JAX LRA trainer's rsqrt schedule
            sf = jnp.asarray(s, jnp.float32)
            return peak * jnp.minimum(sf / w, jnp.sqrt(w / jnp.maximum(sf, 1.0)))
        got = rsqrt_schedule(peak, w)
    for s in range(8):
        assert float(got(s)) == float(want(s)), s


# ---------------------------------------------------------------------------
# the trainers' steps against JAX's math


def record_grads(optimizer):
    """The gradients handed to each `optimizer.step()`, recorded by name."""
    seen, step = [], optimizer.step

    def recording():
        seen.append({n: p.grad.detach().clone() for n, p in zip(optimizer.names,
                                                                 optimizer.params)})
        return step()

    optimizer.step = recording
    return seen


def jax_variables(jmodel, port, *args):
    """JAX variables for `jmodel` holding `port`'s weights (the template
    from `jax.eval_shape`, so no init is compiled)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), *args)
    return jax_variables_from_state_dict(shapes, port.state_dict())


def optax_steps(tx, params, grads):
    """JAX's update math (`tx`, an optax transform) over the gradients of
    each step in turn, from fresh optimizer state: the parameters after
    each step."""
    update = jax.jit(tx.update)
    state, out = tx.init(params), []
    for g in grads:
        updates, state = update(jax_variables_from_state_dict(params, g), state, params)
        params = optax.apply_updates(params, updates)
        out.append(params)
    return out


def assert_params(model, want_params):
    want = state_dict_from_jax({"params": want_params})
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=UPDATE_ATOL,
                                   rtol=0, err_msg=name)


def test_glue_step_matches_jax(tmp_path):
    """One `GlueTrainer.train_step` (the tiny model, a synthetic MRPC
    batch) against JAX's `_train_step_impl` rebuilt: the loss equal to
    `SeaBertKD.kd_loss`'s, and the parameters after the update equal to
    `make_optimizer(lr, wd, lr_low_scale=1)`'s update from the same
    gradients; then the trainer's `train` (metrics file), `evaluate` and
    `evaluate_teacher`."""
    cfg = tgt.GlueTrainerConfig(model="tiny", batch_size=4, num_steps=3, eval_steps=2,
                                save_dir=str(tmp_path), data_cache_dir=str(tmp_path))
    tr = tgt.GlueTrainer(cfg, device="cpu")
    sharpen_port(tr.student)
    t_cfg, s_cfg = jax_tiny_bert_configs(2)
    assert (jax_bert_config(tr.teacher.cfg), jax_bert_config(tr.student.cfg)) == (t_cfg, s_cfg)
    kd = JaxBertKD(t_cfg, s_cfg)
    batch = next(tr.train_ds.batches(4, shuffle=True, seed=cfg.seed))
    ids, am, tt, labels = (jnp.asarray(x) for x in batch)
    t_vars = jax_variables(kd.teacher, tr.teacher, ids, am, tt)
    s_vars = jax_variables(kd.student, tr.student, ids, am, tt)
    # eagerly: at the tiny config's T_M = 8 JAX's jitted loss is 2e-4 away
    # from its own eager one (the estimator's LayerNorms over 4 columns)
    want_loss = kd.kd_loss(t_vars, s_vars, ids, am, labels, tt)[0]
    grads = record_grads(tr.optimizer)
    details = port_topk_guard(lambda: tr.train_step(*batch))
    np.testing.assert_allclose(float(details["loss"]), float(want_loss), rtol=1e-5)
    tx = jax_make_optimizer(lr=cfg.lr, wd=cfg.wd, lr_low_scale=1.0)
    assert_params(tr.student, optax_steps(tx, s_vars["params"], grads)[-1])
    tr.train()
    lines = [json.loads(x) for x in open(tmp_path / "mrpc.jsonl")]
    assert [r["step"] for r in lines] == [2, 3] and all("eval" in r for r in lines)
    assert 0.0 <= tr.evaluate(max_batches=2) <= 1.0
    assert set(tr.evaluate(max_batches=2, return_dict=True)) == {"accuracy", "f1"}
    assert 0.0 <= tr.evaluate_teacher(max_batches=2) <= 1.0


def lra_trainer(tmp_path, phase, **kw):
    cfg = tlt.LraTrainerConfig(task="listops", phase=phase, scale=0.25, max_length=64,
                               n_train=64, batch_size=4, accum_steps=2, warmup_steps=2,
                               lr_decay="rsqrt", num_steps=2, log_every=0,
                               save_dir=str(tmp_path), data_cache_dir=str(tmp_path), **kw)
    return tlt.LraTrainer(cfg, device="cpu")


@pytest.mark.parametrize("phase", ["dense", "distill"])
def test_lra_steps_match_jax(tmp_path, phase):
    """Two LRA optimizer steps of two micro-batches each under the rsqrt
    warm-up (step 0's rate 0, step 1's peak/2), 'dense' (the teacher's task
    loss) and 'distill' (`SeaBertKD`), against JAX's
    `_dense_step_impl`/`_kd_step_impl` rebuilt: each step's mean loss over
    its micro-batches equal to JAX's on the parameters JAX reached, each
    step's gradient the mean of the micro-batches' own (JAX sums them and
    divides), and the parameters after each step equal to
    `make_optimizer(schedule, wd, lr_low_scale=1)`'s update from those
    gradients."""
    tr = lra_trainer(tmp_path, phase)
    assert tr.t_cfg.remat_layers and tr.s_cfg.remat_layers
    assert jax_lra_bert_config("listops", "none") == jax_bert_config(
        tlt.lra_bert_config("listops", "none"))
    sharpen_port(tr.student)
    kd = JaxBertKD(jax_bert_config(tr.t_cfg), jax_bert_config(tr.s_cfg))
    micro = list(tr.train_ds.batches(4, shuffle=True, seed=0))[:4]
    jb = [jnp.asarray(x) for x in micro[0][:3]]
    t_vars = jax_variables(kd.teacher, tr.teacher, *jb)
    s_vars = jax_variables(kd.student, tr.student, *jb)
    model, optimizer = ((tr.teacher, tr.t_optimizer) if phase == "dense"
                        else (tr.student, tr.optimizer))
    params = (t_vars if phase == "dense" else s_vars)["params"]
    spec = tlt.LRA_TASKS["listops"]
    peak, w = spec.lr, 2

    def schedule(s):  # the JAX LRA trainer's rsqrt schedule
        sf = jnp.asarray(s, jnp.float32)
        return peak * jnp.minimum(sf / w, jnp.sqrt(w / jnp.maximum(sf, 1.0)))

    @jax.jit
    def loss_fn(p, pair):
        total = 0.0
        for ids, am, tt, labels in pair:
            if phase == "dense":
                total += kd.teacher.apply({"params": p}, ids, am, tt, labels=labels)["loss"]
            else:
                total += kd.kd_loss(t_vars, {**s_vars, "params": p}, ids, am, labels, tt)[0]
        return total / 2

    grads = record_grads(optimizer)
    tx = jax_make_optimizer(lr=schedule, wd=spec.wd, lr_low_scale=1.0)
    for s in range(2):
        pair = micro[2 * s: 2 * s + 2]
        want = loss_fn(params, [[jnp.asarray(x) for x in mb] for mb in pair])
        step = tr.dense_step if phase == "dense" else (lambda mb: tr.kd_step(mb)[0])
        got = port_topk_guard(lambda: step(pair))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        params = optax_steps(tx, (t_vars if phase == "dense" else s_vars)["params"], grads)[-1]
        assert_params(model, params)
    assert tr.step == 2
    # each step's gradient is the mean of its micro-batches' own
    again = lra_trainer(tmp_path / "again", phase)
    sharpen_port(again.student)
    model_b = again.teacher if phase == "dense" else again.student
    micro_grads = []
    for mb in micro[:2]:
        ids, am, tt, labels = again._tensors(*mb)
        if phase == "dense":
            loss = again.teacher(ids, am, tt, labels=labels)["loss"]
        else:
            loss = again.kd.kd_loss(ids, am, labels, tt)[0]
        loss.backward()
        micro_grads.append({n: p.grad.clone() for n, p in model_b.named_parameters()
                            if p.grad is not None})
        model_b.zero_grad(set_to_none=True)
    for name, g in grads[0].items():
        if name in micro_grads[0]:
            torch.testing.assert_close(g, (micro_grads[0][name] + micro_grads[1][name]) / 2,
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("phase", ["dense", "distill"])
def test_lra_resume_restores_full_state(tmp_path, phase):
    """`train` saves at its end; a new trainer resumes the parameters, the
    optimizer state and the step bit for bit, and `evaluate` reads both
    models."""
    if phase == "distill":
        lra_trainer(tmp_path, "dense").train()  # the teacher checkpoint
    tr = lra_trainer(tmp_path, phase)
    tr.train(log=lambda *_: None)
    back = lra_trainer(tmp_path, phase)
    assert back.step == tr.step == 2
    model, opt = ((tr.teacher, tr.t_optimizer) if phase == "dense"
                  else (tr.student, tr.optimizer))
    b_model, b_opt = ((back.teacher, back.t_optimizer) if phase == "dense"
                      else (back.student, back.optimizer))
    for (n, x), y in zip(model.state_dict().items(), b_model.state_dict().values()):
        assert torch.equal(x, y), n
    sa, sb = opt.state_dict(), b_opt.state_dict()
    assert sa["count"] == sb["count"] == 2
    for n in sa["state"]:
        for m in ("mu", "nu"):
            assert torch.equal(sa["state"][n][m], sb["state"][n][m]), (n, m)
    if phase == "distill":
        for (n, x), y in zip(tr.teacher.state_dict().items(), back.teacher.state_dict().values()):
            assert torch.equal(x, y), n
    for which in ("student", "dense"):
        assert 0.0 <= back.evaluate(which, max_batches=1) <= 1.0


# ---------------------------------------------------------------------------
# the OPT trainer: the baseline students and the partial load


def opt_cfg(tmp_path, **kw):
    return to.TrainerConfig(model="tiny", max_seq_len=64, stride=32, save_dir=str(tmp_path),
                            gradient_accumulation_steps=1, log_steps=1, eval_steps=100,
                            num_steps=1, **kw)


@pytest.mark.parametrize("method", ["performer", "reformer", "sinkhorn", "cosformer"])
def test_kd_trainer_takes_the_baseline_students(tmp_path, method):
    """The KD trainer with each JAX student method: a reformer student's
    layer draws are LSH rotations, a KD update moves the student and its
    loss is finite; the performer's projection is redrawn."""
    tr = to.OptTrainer(opt_cfg(tmp_path, method=method, projection_redraw_steps=1),
                       device="cpu")
    draws = tr.jitter_draws(1, 64)
    assert (draws is not None) == (method == "reformer")
    if draws is not None:  # 4 rounds of (head width, buckets / 2) a layer
        assert len(draws) == 2 and [r.shape for r in draws[0]] == [(8, 1)] * 4
    before = {n: p.detach().clone() for n, p in tr.student.named_parameters()}
    proj = [b.clone() for n, b in tr.student.named_buffers() if n.endswith("performer_proj")]
    ids, mask, labels = next(tr.corpus.batches(1))
    details = tr.micro_step(ids, mask, labels)
    tr.update()
    assert all(np.isfinite(float(v)) for v in details.values())
    assert any(not torch.equal(p, before[n]) for n, p in tr.student.named_parameters())
    now = [b for n, b in tr.student.named_buffers() if n.endswith("performer_proj")]
    assert len(now) == (2 if method == "performer" else 0)
    assert all(not torch.equal(a, b) for a, b in zip(proj, now))


def test_load_only_additionals(tmp_path):
    """`load(only_additionals=True)`: the SEA modules' parameters from the
    checkpoint, everything else (base weights, projections, optimizer
    state, step) the trainer's own."""
    src = to.OptTrainer(opt_cfg(tmp_path / "a"), device="cpu")
    src.train()
    src.save()
    dst = to.OptTrainer(opt_cfg(tmp_path / "a", seed=7), device="cpu")
    with torch.no_grad():
        for p in dst.student.parameters():
            p.add_(1.0)
    mine = {n: x.clone() for n, x in dst.student.state_dict().items()}
    opt_before = dst.optimizer.state_dict()
    assert dst.load(only_additionals=True)
    params = dict(dst.student.named_parameters())
    saved = src.student.state_dict()
    moved = 0
    for n, x in dst.student.state_dict().items():
        if n in params and any("perlin" in part for part in n.split(".")):
            assert torch.equal(x, saved[n]), n
            moved += 1
        else:
            assert torch.equal(x, mine[n]), n
    assert moved > 0 and dst.step == 0
    assert dst.optimizer.state_dict()["count"] == opt_before["count"] == 0


def test_glue_teacher_pretraining_matches_optax(tmp_path, monkeypatch):
    """`pretrain_teacher_steps`: the dense teacher's task step is plain
    `optax.adamw(lr, weight_decay=wd)` (every parameter decayed, no
    clipping), its loss JAX's; the student is bootstrapped from the trained
    teacher afterwards."""
    seen = []
    step = tgt.GroupedAdamW.step

    def recording(self):
        seen.append({n: p.grad.detach().clone() for n, p in zip(self.names, self.params)})
        return step(self)

    monkeypatch.setattr(tgt.GroupedAdamW, "step", recording)
    cfg = tgt.GlueTrainerConfig(model="tiny", batch_size=4, pretrain_teacher_steps=1,
                                save_dir=str(tmp_path), data_cache_dir=str(tmp_path))
    fresh = tgt.build_bert(tgt.tiny_bert_configs(2)[0], 0, "cpu")
    tr = tgt.GlueTrainer(cfg, device="cpu")
    assert len(seen) == 1
    t_cfg, _ = jax_tiny_bert_configs(2)
    model = jbert.BertForSequenceClassification(t_cfg)
    batch = next(tr.train_ds.batches(4, shuffle=True, seed=cfg.seed + 500))
    ids, am, tt, labels = (jnp.asarray(x) for x in batch)
    params = jax_variables(model, fresh, ids, am, tt)["params"]
    after = optax_steps(optax.adamw(cfg.lr, weight_decay=cfg.wd), params, seen)[-1]
    assert_params(tr.teacher, after)
    t_sd = tr.teacher.state_dict()
    for name, x in tr.student.state_dict().items():
        if name in t_sd:
            assert torch.equal(x, t_sd[name]), name


@pytest.mark.parametrize("which", ["glue", "lra"])
def test_mains_run_on_the_cpu(tmp_path, capsys, which):
    """The entry points with `--device cpu` (their default is cuda)."""
    if which == "glue":
        tgt.main(["--model", "tiny", "--steps", "2", "--batch-size", "4", "--device", "cpu",
                  "--save-dir", str(tmp_path)])
        assert "eval score:" in capsys.readouterr().out
    else:
        argv = ["--task", "listops", "--scale", "0.05", "--steps", "1", "--max-length", "32",
                "--n-train", "16", "--batch-size", "4", "--device", "cpu", "--save-dir",
                str(tmp_path)]
        tlt.main(argv + ["--phase", "dense"])
        tlt.main(argv)
        out = capsys.readouterr().out
        assert "listops dense accuracy:" in out and "listops student accuracy:" in out
