"""Port parity: pipeline parallelism (sea_tpu_torch.parallel.pp against
sea_tpu.parallel.pp), tests/test_pp.py case by case at its tiny configs.

The port's stages are LocalGroup positions on the CPU. JAX's references are
jitted once a process (tests/_torch_parallel.py): its GPipe over 4 virtual
devices (logits and task gradients), its unsharded KD value and gradient,
its loop forward of a 4-layer llama_tiny. Bounds are JAX's own: 3e-5 on the
pipelined logits (OPT and LLaMA), 2e-4 on the pipelined and interleaved
task gradients, 1e-4 on the KD loss and gradients at one microbatch (2e-3
with dp, tests/test_pp.py:172-185's top-k flips), 2e-5 against the serial
microbatch decomposition, 2e-6 for 1F1B against GPipe.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from sea_tpu.models.opt import opt_2_7b as jax_opt_2_7b
from sea_tpu.parallel import pp as jpp
from sea_tpu_torch.models.opt import (OptDecoderLayer, OptForCausalLM, cross_entropy_shifted,
                                      opt_2_7b)
from sea_tpu_torch.parallel import pp
from sea_tpu_torch.parallel.pp import (make_pp_mesh, pipeline_1f1b_value_and_grad,
                                       pipeline_layers, pp_causal_lm_forward,
                                       pp_kd_1f1b_value_and_grad, pp_kd_loss, shard_params_pp,
                                       sim_1f1b_schedule, split_scan_vars)
from sea_tpu_torch.training.optimizer import GroupedAdamW
from tests._torch_parallel import (STUDENT_SEED, TEACHER_SEED, jax_llama4_logits, jax_kd,
                                   jax_opt4_pp, opt4_batch, opt4_config, port_kd,
                                   port_llama4, port_opt4)
from tests._torch_parity import torch_opt_config


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh(dp=1, size=4):
    return make_pp_mesh(dp=dp, pp=size, devices=["cpu"] * (dp * size))


def batch():
    return tuple(torch.tensor(x) for x in opt4_batch())


def grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def assert_grads_close(got: dict, want: dict, atol, label=""):
    """Leaf for leaf; a parameter the port's autograd gave no gradient (a
    predictor's on the task path) must have JAX's zero."""
    assert set(got) <= set(want), set(got) - set(want)
    for name, g in want.items():
        mine = got[name].numpy() if name in got else np.zeros(g.shape, np.float32)
        np.testing.assert_allclose(mine, g.numpy(), atol=atol, err_msg=label + name)


def pp_task_grads(model, **kw) -> dict:
    ids, mask = batch()
    model.zero_grad()
    logits, _ = pp_causal_lm_forward(model, ids, mask, num_microbatches=2, **kw)
    cross_entropy_shifted(logits, ids).backward()
    return grads(model)


@pytest.mark.parametrize("num_micro", [1, 2, 4])
def test_pp_forward_matches_loop(num_micro):
    """GPipe over 4 stages at 1, 2 and 4 microbatches: JAX's pipelined
    logits within 3e-5, a finite aux."""
    want, _, _ = jax_opt4_pp()
    ids, mask = batch()
    with torch.no_grad():
        logits, aux = pp_causal_lm_forward(port_opt4(), ids, mask, mesh=mesh(),
                                           num_microbatches=num_micro)
    np.testing.assert_allclose(logits.numpy(), want, atol=3e-5)
    assert np.isfinite(aux.item())


def test_pp_grads_match_scan():
    """The task loss's gradients through GPipe (autograd over the
    schedule) against JAX's jax.grad through its GPipe, 2e-4 leaf for
    leaf."""
    _, want_loss, want = jax_opt4_pp()
    got = pp_task_grads(port_opt4(), mesh=mesh())
    assert_grads_close(got, want, 2e-4)


def test_pp_dp_composed():
    """dp2 x pp4 over 8 positions: the rows split over dp inside the
    pipeline, the logits still JAX's within 3e-5."""
    want, _, _ = jax_opt4_pp()
    ids, mask = batch()
    with torch.no_grad():
        logits, _ = pp_causal_lm_forward(port_opt4(), ids, mask, mesh=mesh(dp=2),
                                         num_microbatches=2, dp_axis="dp")
    np.testing.assert_allclose(logits.numpy(), want, atol=3e-5)


KD_PP = 2  # the KD pair's two layers, one a stage


def kd_pair():
    return port_kd("none", TEACHER_SEED), port_kd("perlin", STUDENT_SEED)


@pytest.mark.parametrize("dp", [1, 2])
def test_pp_kd_matches_unsharded(dp):
    """KD through pp2 (and pp2 x dp2) at one microbatch against JAX's
    unsharded SeaOptKD: the loss within 1e-4, the student's gradients within
    1e-4 (dp 1) or 2e-3 (dp 2: each replica's rows alone flip near-tied
    top-k picks, tests/test_pp.py:172-185). The teacher gets none."""
    want_loss, want = jax_kd()
    teacher, student = kd_pair()
    ids, mask = batch()
    loss, _ = pp_kd_loss(teacher, student, ids, mask, ids, mesh=mesh(dp=dp, size=KD_PP),
                         num_microbatches=1, dp_axis="dp" if dp > 1 else None)
    loss.backward()
    assert abs(loss.item() - want_loss) < 1e-4, (loss.item(), want_loss)
    assert all(p.grad is None for p in teacher.parameters())
    assert_grads_close(grads(student), want, 1e-4 if dp == 1 else 2e-3)


def kd_grads(pp_size, num_micro, **kw):
    teacher, student = kd_pair()
    ids, mask = batch()
    loss, det = pp_kd_loss(teacher, student, ids, mask, ids, mesh=mesh(size=pp_size),
                           num_microbatches=num_micro, **kw)
    loss.backward()
    return loss.item(), det, grads(student)


def test_pp_kd_microbatched_matches_serial_decomposition():
    """At 2 microbatches the pipelined KD gradient equals the same
    decomposition run serially (pp 1) within 2e-5; the loss stays JAX's
    full-batch loss within 1e-4."""
    want_loss, _ = jax_kd()
    loss, _, got = kd_grads(KD_PP, 2)
    _, _, serial = kd_grads(1, 2)
    assert abs(loss - want_loss) < 1e-4
    assert_grads_close(got, serial, 2e-5)


def test_pp_kd_details_and_update():
    """One optimizer step through the pipelined KD loss (dp2 x pp2, 2
    microbatches): finite details, the student moved, the teacher without
    gradients."""
    teacher, student = kd_pair()
    ids, mask = batch()
    loss, det = pp_kd_loss(teacher, student, ids, mask, ids, mesh=mesh(dp=2, size=KD_PP),
                           num_microbatches=2, dp_axis="dp")
    for k, v in det.items():
        assert np.isfinite(v.item()), k
    loss.backward()
    before = {n: p.detach().clone() for n, p in student.named_parameters()}
    GroupedAdamW(student, lr=1e-3).step()
    moved = sum(float((p.detach() - before[n]).abs().sum()) for n, p in student.named_parameters())
    assert moved > 0 and all(p.grad is None for p in teacher.parameters())


def test_pp_remat_grads_match():
    """use_remat through the pipeline: the same gradients within 1e-6."""
    plain = pp_task_grads(port_opt4(), mesh=mesh())
    remat = pp_task_grads(port_opt4(), mesh=mesh(), use_remat=True)
    assert_grads_close(remat, plain, 1e-6)


@pytest.mark.parametrize("size,V,M", [(2, 2, 4), (4, 1, 4), (2, 2, 2)])
def test_pp_interleaved_forward_matches_loop(size, V, M):
    """The interleaved schedule (V chunks a stage): JAX's logits within
    3e-5; V = 1 is GPipe with one chunk a stage."""
    want, _, _ = jax_opt4_pp()
    ids, mask = batch()
    with torch.no_grad():
        logits, aux = pp_causal_lm_forward(port_opt4(), ids, mask, mesh=mesh(size=size),
                                           num_microbatches=M, interleave=V)
    np.testing.assert_allclose(logits.numpy(), want, atol=3e-5)
    assert np.isfinite(aux.item())


def test_pp_interleaved_grads_match_scan():
    _, _, want = jax_opt4_pp()
    got = pp_task_grads(port_opt4(), mesh=mesh(size=2), interleave=2)
    assert_grads_close(got, want, 2e-4)


def test_pp_llama_forward():
    """The same machinery over LLaMA (the RoPE tables cut into
    microbatches with the hidden states): JAX's loop logits within 3e-5."""
    ids, mask, want = jax_llama4_logits()
    with torch.no_grad():
        logits, _ = pp_causal_lm_forward(port_llama4(), torch.tensor(ids), torch.tensor(mask),
                                         mesh=mesh(), num_microbatches=2)
    np.testing.assert_allclose(logits.numpy(), want, atol=3e-5)


def test_external_layers_shell_and_scan_split():
    """An `external_layers` shell (embed, finalize, logits; no layers) runs
    a pipeline over another model's layers to the same logits; the port's
    `split_scan_vars` splits a stacked tree as JAX's does, and
    `shard_params_pp` gives each stage its contiguous rows of it."""
    ids, mask = batch()
    model = port_opt4()
    shell = OptForCausalLM(
        torch_opt_config(dataclasses.replace(opt4_config(), external_layers=True)),
        device="cpu", seed=None)
    assert len(shell.model.layers) == 0
    shell.load_state_dict(model.state_dict(), strict=False)
    with torch.no_grad():
        want, _ = pp_causal_lm_forward(model, ids, mask, mesh=mesh(), num_microbatches=2)
        got, _ = pp_causal_lm_forward(shell, ids, mask, mesh=mesh(), num_microbatches=2,
                                      layers=model.model.layers)
        with pytest.raises(ValueError, match="external_layers"):
            pp_causal_lm_forward(shell, ids, mask, mesh=mesh(), num_microbatches=2)
    assert torch.equal(got, want)
    tree = {"params": {"model": {"layers_scan": {"layer": {"w": np.arange(8.0).reshape(4, 2)}},
                                 "embed_tokens": {"embedding": np.ones(3)}}},
            "performer": {"model": {"layers_scan": {"layer": {"projection": np.zeros((4, 1))}}}}}
    got_split, rest = split_scan_vars(tree)
    want_split, want_rest = jpp.split_scan_vars(tree)
    assert got_split.keys() == want_split.keys() == {"params", "performer"} and rest is tree
    stages = shard_params_pp(got_split["params"], mesh(size=2))
    np.testing.assert_array_equal(stages[1]["w"], np.arange(4.0, 8.0).reshape(2, 2))
    assert pp.pp_stage_specs(got_split) == {"params": {"w": ("pp",)},
                                            "performer": {"projection": ("pp",)}}


def test_pp_kd_27b_geometry_stages():
    """The multi-chip plan for OPT-2.7b KD at its full geometry (no
    weights drawn: one decoder layer, uninitialised): between 2.2e9 and
    3.6e9 student parameters (tests/test_pp.py:342-345's bound), 8 layers
    on each of 4 stages, JAX's depth."""
    cfg = opt_2_7b("perlin")
    layer = OptDecoderLayer(cfg)
    embed = cfg.vocab_size * cfg.hidden_size + (cfg.max_position_embeddings + 2) * cfg.hidden_size
    n_params = embed + 2 * cfg.hidden_size + cfg.num_layers * sum(
        p.numel() for p in layer.parameters())
    assert 2.2e9 < n_params < 3.6e9, n_params
    stages = shard_params_pp(list(range(cfg.num_layers)), mesh())
    assert stages == [list(range(8 * s, 8 * s + 8)) for s in range(4)]
    assert jax_opt_2_7b("perlin").num_layers == cfg.num_layers == 32


# ---------------------------------------------------------------------------
# 1F1B


@pytest.mark.parametrize("S,M", [(2, 2), (4, 4), (4, 8), (3, 5), (4, 1)])
def test_1f1b_schedule_properties(S, M):
    """JAX's schedule, table for table, and its properties: every F and B
    once, the dataflow, the in-flight window S - s, at most 2(M + S - 1)
    ticks."""
    f, b = sim_1f1b_schedule(S, M)
    jf, jb = jpp.sim_1f1b_schedule(S, M)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(b, jb)
    T = f.shape[0]
    assert T <= 2 * (M + S - 1)
    t_f = np.full((S, M), -1)
    t_b = np.full((S, M), -1)
    for t in range(T):
        for s in range(S):
            if f[t, s] >= 0:
                assert t_f[s, f[t, s]] == -1
                t_f[s, f[t, s]] = t
            if b[t, s] >= 0:
                assert t_b[s, b[t, s]] == -1
                t_b[s, b[t, s]] = t
    assert (t_f >= 0).all() and (t_b >= 0).all()
    for s in range(S):
        for m in range(M):
            if s > 0:
                assert t_f[s, m] > t_f[s - 1, m]
            if s < S - 1:
                assert t_b[s, m] > t_b[s + 1, m]
        assert (t_b[S - 1] > t_f[S - 1]).all()
        for t in range(T):
            in_flight = sum(1 for m in range(M) if t_f[s, m] <= t and t_b[s, m] > t)
            assert in_flight <= S - s


class Synth(nn.Module):
    """tests/test_pp.py's synthetic layer: tanh(x·w + b)·gate + x."""

    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(w))
        self.b = nn.Parameter(torch.tensor(b))


def synth_case(seed=0, N=8, L=4, T=16, D=32, C=7):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((L, D, D)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    wo = (rng.standard_normal((D, C)) * 0.3).astype(np.float32)
    h = rng.standard_normal((N, T, D)).astype(np.float32)
    gate = rng.uniform(0.5, 1.5, (N, T, 1)).astype(np.float32)
    y = rng.integers(0, C, (N, T))
    return w, b, wo, h, gate, y


def synth_apply(p, x, bnd):
    y = torch.tanh(x @ p.w + p.b) * bnd["gate"] + x
    return y, torch.mean(y.float() ** 2)


def synth_head(wo, C=7):
    def head_loss(y_mb, ha):
        lp = torch.log_softmax(y_mb @ wo, -1)
        return -torch.mean(torch.sum(torch.nn.functional.one_hot(ha["y"], C) * lp, -1))
    return head_loss


@pytest.fixture(scope="module")
def synth_jax():
    """JAX's value and gradients of the synthetic stack and head over the
    whole batch (what GPipe and 1F1B decompose), one jit."""
    w, b, wo, h, gate, y = synth_case()

    def loss(w_, b_, wo_, h_):
        x, aux = h_, 0.0
        for i in range(w_.shape[0]):
            x = jnp.tanh(x @ w_[i] + b_[i]) * gate + x
            aux = aux + jnp.mean(x ** 2)
        lp = jax.nn.log_softmax(x @ wo_, -1)
        return -jnp.mean(jnp.sum(jax.nn.one_hot(y, 7) * lp, -1)), aux / w_.shape[0]

    (value, aux), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
        w, b, wo, h)
    return float(value), aux.item(), [np.asarray(x) for x in g]


def synth_run(M, dp=1, schedule="1f1b"):
    w, b, wo, h, gate, y = synth_case()
    layers = [Synth(w[i], b[i]) for i in range(w.shape[0])]
    wo_t = nn.Parameter(torch.tensor(wo))
    h_t = torch.tensor(h, requires_grad=True)
    bundle = {"gate": torch.tensor(gate)}
    m = mesh(dp=dp)
    stages = shard_params_pp(layers, m)
    if schedule == "1f1b":
        loss, aux, (d_st, d_head, d_h) = pipeline_1f1b_value_and_grad(
            synth_apply, synth_head(wo_t), stages, {"wo": wo_t}, h_t, bundle,
            {"y": torch.tensor(y)}, mesh=m, num_microbatches=M,
            dp_axis="dp" if dp > 1 else None)
        dw = torch.stack([d[f"{j}.w"] for d in d_st for j in range(len(stages[0]))])
        db = torch.stack([d[f"{j}.b"] for d in d_st for j in range(len(stages[0]))])
        return loss.item(), aux.item(), [dw, db, d_head["wo"], d_h]
    out, aux = pipeline_layers(synth_apply, stages, h_t, bundle, mesh=m, num_microbatches=M)
    loss = synth_head(wo_t)(out, {"y": torch.tensor(y)})
    loss.backward()
    return (loss.item(), aux.item(), [torch.stack([l.w.grad for l in layers]),
                                      torch.stack([l.b.grad for l in layers]), wo_t.grad,
                                      h_t.grad])


@pytest.mark.parametrize("M", [4, 8])
def test_1f1b_value_and_grad_matches_gpipe(M, synth_jax):
    """The explicit 1F1B pass gives GPipe's loss, aux and gradients (layer
    parameters, head, pipeline input) within 2e-6, and both JAX's."""
    loss, aux, got = synth_run(M)
    g_loss, g_aux, gpipe = synth_run(M, schedule="gpipe")
    np.testing.assert_allclose(loss, g_loss, rtol=1e-6)
    np.testing.assert_allclose(aux, g_aux, rtol=1e-6)
    for a, b_ in zip(got, gpipe):
        np.testing.assert_allclose(a.detach().numpy(), b_.detach().numpy(), atol=2e-6)
    j_loss, j_aux, want = synth_jax
    np.testing.assert_allclose(loss, j_loss, rtol=1e-6)
    np.testing.assert_allclose(aux, j_aux, rtol=1e-6)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b_, atol=2e-6)


def test_1f1b_dp_composed():
    """pp4 x dp2: dp-split rows with averaged gradients equal dp 1's."""
    l1, _, g1 = synth_run(4)
    l2, _, g2 = synth_run(4, dp=2)
    np.testing.assert_allclose(l1, l2, rtol=1e-6)
    for a, b_ in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=2e-6)


def test_1f1b_kd_matches_gpipe_kd():
    """1F1B on the KD pair at one microbatch: GPipe KD's gradients within
    2e-6 and its details within 2e-5 (the per-layer losses riding in the
    carry), JAX's unsharded loss and gradients within 1e-4; the gradient
    covers every student parameter that GPipe's does."""
    want_loss, want = jax_kd()
    g_loss, g_det, gpipe = kd_grads(KD_PP, 1)
    teacher, student = kd_pair()
    ids, mask = batch()
    loss, det, d_s = pp_kd_1f1b_value_and_grad(teacher, student, ids, mask, ids,
                                               mesh=mesh(size=KD_PP),
                                               num_microbatches=1)
    assert abs(loss.item() - want_loss) < 1e-4
    for k, v in det.items():
        assert np.isfinite(v.item()), k
    for k in ("loss_model", "loss_kd_hidden", "loss_kd_logit", "loss_sp"):
        np.testing.assert_allclose(float(det[k]), float(g_det[k]), atol=2e-5, err_msg=k)
    assert_grads_close({n: d_s[n] for n in gpipe}, gpipe, 2e-6)
    assert_grads_close({n: d_s[n] for n in want}, want, 1e-4)
    assert all(p.grad is None for p in teacher.parameters())


def test_1f1b_kd_microbatched_matches_serial_decomposition():
    """At 2 microbatches 1F1B's KD gradient is the serial decomposition's
    (pp_kd_loss at pp 1) within 2e-5; the loss JAX's within 1e-4."""
    want_loss, _ = jax_kd()
    _, _, serial = kd_grads(1, 2)
    teacher, student = kd_pair()
    ids, mask = batch()
    loss, _, d_s = pp_kd_1f1b_value_and_grad(teacher, student, ids, mask, ids,
                                             mesh=mesh(size=KD_PP), num_microbatches=2)
    assert abs(loss.item() - want_loss) < 1e-4
    assert_grads_close({n: d_s[n] for n in serial}, serial, 2e-5)


def test_1f1b_kd_dp_composed():
    """pp2 x dp2 1F1B KD: the loss and gradients of dp 1 within the
    top-k-flip bound of the GPipe dp case (1e-4, 2e-3)."""
    runs = []
    for dp in (1, 2):
        teacher, student = kd_pair()
        ids, mask = batch()
        runs.append(pp_kd_1f1b_value_and_grad(teacher, student, ids, mask, ids,
                                              mesh=mesh(dp=dp, size=KD_PP),
                                              num_microbatches=2,
                                              dp_axis="dp" if dp > 1 else None))
    (l1, _, g1), (l2, _, g2) = runs
    assert abs(float(l1) - float(l2)) < 1e-4
    assert_grads_close(g2, g1, 2e-3)
