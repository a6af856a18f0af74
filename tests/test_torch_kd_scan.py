"""Port parity for `scan_kd`: the scanned teacher/student pair
(`training.distill.SeaOptKDScan`) with its chunked logit losses, the KD
pair's combined JAX tree (`weights.kd_state_dicts_from_jax`) and the trainer
under `scan_kd` and `logit_chunk`, against the JAX package on the CPU.

What is held, and the tolerance of each:

  * `SeaOptKDScan.kd_loss` on weights read from JAX's
    `SeaOptKDScan.combine_params` tree, against JAX's `SeaOptKDScan.kd_loss`
    on that tree, unchunked and with `logit_chunk` 5 (T = 16: chunks of 4),
    for the tiny OPT and `llama_tiny`: the loss 1e-5 relative, every detail
    term 1e-4 relative (tests/test_kd_scan.py's bounds);
  * in the port, chunked against unchunked: the loss 1e-6 relative, the
    terms 1e-5 relative, every student gradient 1e-5 abs
    (tests/test_kd_scan.py:104's rule), the teacher without gradients;
  * the combined tree read into the teacher's and the student's state dicts
    equal to their loop-layout trees' bit for bit;
  * the trainer with `scan_kd` and `logit_chunk` on JAX's weights: one
    micro-step's terms against JAX's chunked `SeaOptKDScan.kd_loss` (1e-5
    and 1e-4 relative), no jitter drawn, `evaluate` equal to the loop
    trainer's on the same student bit for bit, the layout saved and a
    mismatch raised on load (`CheckpointLayoutError`), `pretrain_teacher`
    refused after construction, `logit_chunk` read only under `scan_kd`, the
    projections not redrawn (JAX's scanned step never reads its redraw).

Every test runs on one torch thread.
"""

import functools

import numpy as np
import jax
import pytest
import torch

from sea_tpu.models import llama as jl
from sea_tpu.models import opt as jopt
from sea_tpu.training.distill import SeaOptKDScan as JaxKDScan
from sea_tpu.training.opt_trainer import tiny_configs as jax_tiny_configs
from sea_tpu_torch.training import opt_trainer as to
from sea_tpu_torch.training.distill import SeaOptKD, SeaOptKDScan, causal_lm_for
from sea_tpu_torch.weights import kd_state_dicts_from_jax, state_dict_from_jax
from tests._torch_parity import t, torch_llama_config, torch_opt_config
from tests.test_opt_kd import make_batch, tiny_opt
from tests.test_torch_opt_trainer import tiny_cfg

REL, DETAIL_REL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_vars(t_cfg, s_cfg, ids, mask):
    """Loop-layout teacher (key 0) and student (key 1) variables and their
    combined tree."""
    lm = jopt.OptForCausalLM if isinstance(t_cfg, jopt.OptConfig) else jl.LlamaForCausalLM
    t_vars = jax.device_get(jax.jit(lambda: lm(t_cfg).init(jax.random.key(0), ids, mask))())
    s_vars = jax.device_get(jax.jit(lambda: lm(s_cfg).init(jax.random.key(1), ids, mask))())
    return t_vars, s_vars, JaxKDScan.combine_params(t_vars, s_vars, t_cfg.num_layers)


@functools.lru_cache(maxsize=None)
def _jax_pair(family, T=16):
    """(teacher cfg, student cfg, teacher and student variables, their
    combined tree, ids, mask) on the JAX side, built once a module run."""
    if family == "opt":
        t_cfg, s_cfg = tiny_opt("none"), tiny_opt("perlin")
    else:
        t_cfg, s_cfg = jl.llama_tiny("none"), jl.llama_tiny("perlin")
    ids, mask = make_batch(N=2, T=T, vocab=t_cfg.vocab_size)
    return (t_cfg, s_cfg, *_jax_vars(t_cfg, s_cfg, ids, mask), ids, mask)


def _port_pair(t_cfg, s_cfg, combined, **kw):
    """The port's `SeaOptKDScan` on the combined tree's weights."""
    conv = torch_opt_config if isinstance(t_cfg, jopt.OptConfig) else torch_llama_config
    teacher = causal_lm_for(conv(t_cfg), device="cpu", seed=None)
    student = causal_lm_for(conv(s_cfg), device="cpu", seed=None)
    t_sd, s_sd = kd_state_dicts_from_jax(combined)
    teacher.load_state_dict(t_sd)
    student.load_state_dict(s_sd)
    teacher.requires_grad_(False)
    return SeaOptKDScan(teacher, student, **kw)


@pytest.mark.parametrize("chunk", [None, 5], ids=["unchunked", "chunk5"])
@pytest.mark.parametrize("family", ["opt", "llama"])
def test_scan_kd_matches_jax(family, chunk):
    t_cfg, s_cfg, _, _, combined, ids, mask = _jax_pair(family)
    kds = JaxKDScan(t_cfg, s_cfg, logit_chunk=chunk)
    want_loss, want = jax.jit(lambda cv: kds.kd_loss(cv, ids, mask, ids))(combined)
    kd = _port_pair(t_cfg, s_cfg, combined, logit_chunk=chunk)
    tids, tmask = t(ids).long(), t(mask).long()
    loss, got = kd.kd_loss(tids, tmask, tids)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=REL)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=DETAIL_REL,
                                   err_msg=name)


@pytest.mark.parametrize("chunk", [4, 5])
def test_chunked_kd_matches_unchunked(chunk):
    t_cfg, s_cfg, _, _, combined, ids, mask = _jax_pair("opt")
    tids, tmask = t(ids).long(), t(mask).long()
    results = []
    for c in (None, chunk):
        kd = _port_pair(t_cfg, s_cfg, combined, logit_chunk=c)
        loss, details = kd.kd_loss(tids, tmask, tids)
        loss.backward()
        assert all(p.grad is None for p in kd.teacher.parameters())
        results.append((loss.detach(), details,
                        {n: p.grad for n, p in kd.student.named_parameters()}))
    (l0, d0, g0), (l1, d1, g1) = results
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for name in d0:
        np.testing.assert_allclose(float(d1[name]), float(d0[name]), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    for name, g in g0.items():
        assert (g is None) == (g1[name] is None), name
        if g is not None:
            np.testing.assert_allclose(g1[name].numpy(), g.numpy(), atol=1e-5, rtol=0,
                                       err_msg=name)


@pytest.mark.parametrize("family", ["opt", "llama"])
def test_kd_state_dicts_from_the_combined_tree(family):
    *_, t_vars, s_vars, combined, _, _ = _jax_pair(family)
    for got, want in zip(kd_state_dicts_from_jax(combined),
                         (state_dict_from_jax(t_vars), state_dict_from_jax(s_vars))):
        assert got.keys() == want.keys()
        for name in want:
            assert torch.equal(got[name], want[name]), name


def test_trainer_scan_kd_step_layout_and_evaluation(tmp_path):
    T, chunk = 64, 16
    jt, js = jax_tiny_configs("perlin")
    ids, mask = make_batch(N=2, T=T, vocab=jt.vocab_size)
    _, _, combined = _jax_vars(jt, js, ids, mask)
    kds = JaxKDScan(jt, js, logit_chunk=chunk)
    want_loss, want = jax.jit(lambda cv: kds.kd_loss(cv, ids, mask, ids))(combined)

    cfg = tiny_cfg(tmp_path, scan_kd=True, logit_chunk=chunk, gradient_accumulation_steps=1,
                   projection_redraw_steps=1)
    tr = to.OptTrainer(cfg, device="cpu")
    assert (tr.t_cfg, tr.s_cfg) == (torch_opt_config(jt), torch_opt_config(js))
    assert isinstance(tr.kd, SeaOptKDScan) and tr.kd.logit_chunk == chunk
    assert tr.student.cfg.scan_layers
    t_sd, s_sd = kd_state_dicts_from_jax(combined)
    tr.teacher.load_state_dict(t_sd)
    tr.student.load_state_dict(s_sd)
    generator0 = tr.generator.get_state()
    got = tr.micro_step(np.asarray(ids), np.asarray(mask), np.asarray(ids))
    np.testing.assert_allclose(float(got["loss"]), float(want_loss), rtol=REL)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=DETAIL_REL,
                                   err_msg=name)
    assert torch.equal(tr.generator.get_state(), generator0)  # no jitter drawn
    tr.update()
    assert tr.step == 1
    # JAX's scanned step never reads its redrawn projections (ROADMAP §3)
    proj = [n for n in s_sd if n.endswith("performer_proj")]
    assert proj and all(torch.equal(tr.student.state_dict()[n], s_sd[n]) for n in proj)

    # the loop trainer: logit_chunk is read only under scan_kd
    loop = to.OptTrainer(tiny_cfg(tmp_path, logit_chunk=chunk), device="cpu")
    assert type(loop.kd) is SeaOptKD and not loop.student.cfg.scan_layers
    loop.student.load_state_dict(tr.student.state_dict())
    assert tr.evaluate(max_batches=2) == loop.evaluate(max_batches=2)

    # the layout travels with the checkpoint
    tr.save()
    with pytest.raises(to.CheckpointLayoutError, match="scan_kd"):
        loop.load()
    again = to.OptTrainer(cfg, device="cpu")
    assert again.load() and again.step == 1
    for name, p in tr.student.state_dict().items():
        assert torch.equal(again.student.state_dict()[name], p), name
    loop.save("loop")
    with pytest.raises(to.CheckpointLayoutError, match="scan_kd"):
        again.load("loop")

    # the teacher is pretrained by the constructor or not at all
    with pytest.raises(RuntimeError, match="pretrain_teacher"):
        tr.pretrain_teacher(1)
    pre = to.OptTrainer(tiny_cfg(tmp_path / "pre", scan_kd=True, pretrain_teacher_steps=1),
                        device="cpu")
    assert isinstance(pre.kd, SeaOptKDScan)
