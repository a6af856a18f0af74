"""Port parity at head width 32: the plain versions of K1 (the scaling
sweep's causal forward) and K5 (LRA image's padded bidirectional forward),
the routes that take width 32, and LRA image's student (1 layer, 1 head of
32) against the JAX package's.

Tolerances: the plain K1 and K5 and the student's logits within 1e-5 of
max|want| against JAX's (Pallas in interpret mode for the kernels; the same
float32 arithmetic summed in another order); the KD loss and its terms
within 2e-4 relative (at a short T_M, JAX's jitted loss sits up to 2e-4
from its own eager one, tests/test_torch_glue_lra.py); the update 1e-6 of
the parameters, as tests/test_torch_glue_lra.py holds it. The card runs
K1 and K5 at width 32 in chip_smoke.py, against these plain versions.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.config import SeaConfig as JaxSeaConfig
from sea_tpu.models import bert as jbert
from sea_tpu.ops.kernels import block_sparse as jb
from sea_tpu.training.distill import SeaBertKD as JaxBertKD
from sea_tpu.training.lra_trainer import lra_bert_config as jax_lra_bert_config
from sea_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from sea_tpu_torch.ops.kernels import block_sparse as tb
from sea_tpu_torch.training import lra_trainer as tlt
from tests._torch_parity import jax_variables_from_state_dict, port_topk_guard, sharpen_port, t
from tests.test_torch_glue_lra import assert_params, optax_steps, record_grads

OUT_REL = 1e-5
LOSS_REL = 2e-4
D = 32


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_case(seed, N, H, T, T_M, density):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((N, H, T, D)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((N, H, T, D)) * 0.3).astype(np.float32)
    v = rng.standard_normal((N, H, T, D)).astype(np.float32)
    mask = (rng.uniform(size=(N, H, T, T_M)) < density).astype(np.float32)
    scaler = rng.uniform(0.1, 1.0, (N, H, T)).astype(np.float32)
    return q, k, v, mask, scaler


def assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=OUT_REL * float(np.abs(want).max()))


@pytest.mark.parametrize("block_q,density", [(64, 0.1), (128, 0.3)])
def test_plain_k1_at_width_32_matches_jax(block_q, density):
    """The scaling sweep's geometry cut to T = 256: 4 heads of 32, T_M =
    32; blocks of 128 rows are the 'seq' kind's."""
    q, k, v, mask, scaler = make_case(1, 1, 4, 256, 32, density)
    want = jb.sea_block_sparse_attention(*(jnp.asarray(x) for x in (q, k, v, mask, scaler)),
                                         is_causal=True, block_q=block_q, block_k=64,
                                         interpret=True)
    got = tb.sea_block_sparse_attention(*(t(x) for x in (q, k, v, mask, scaler)),
                                        block_q=block_q, block_k=64)
    assert got.shape == want.shape == (1, 4, 256, D)
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("T", [256, 200])
def test_plain_k5_at_width_32_matches_jax(T):
    """LRA image's geometry cut to short rows: one head of 32, T_M = 128,
    ragged lengths (T = 200 padded inside both wrappers)."""
    q, k, v, mask, scaler = make_case(T, 3, 1, T, 128, 0.2)
    lengths = np.array([T, 137, 1], np.int32)
    mask *= (np.arange(T)[None, None, :, None] < lengths[:, None, None, None])
    want = jb.sea_block_sparse_attention(*(jnp.asarray(x) for x in (q, k, v, mask, scaler)),
                                         is_causal=False, lengths=jnp.asarray(lengths),
                                         interpret=True)
    got = tb.sea_block_sparse_attention(*(t(x) for x in (q, k, v, mask, scaler)),
                                        is_causal=False, lengths=t(lengths))
    assert got.shape == want.shape == (3, 1, T, D)
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("route", ["causal", "bidirectional", "differentiable", "impl",
                                   "window"])
def test_width_32_routes(route):
    """Width 32 builds operands on the causal forward (K1) and the padded
    bidirectional forward (K5); the differentiable path, the impl variants
    and the ring's windows refuse it, naming ROADMAP queue 2 item 6."""
    q = torch.zeros((1, 2, 128, D))
    mask = torch.ones((1, 2, 128, 32))
    tb._check_head_dim(D, "causal")
    if route in ("causal", "bidirectional"):
        x = tb.prepare_inputs(q, q, q, mask, is_causal=route == "causal")
        assert tb.kernel_operands(x).q.shape == (2, 128, D)
        return
    with pytest.raises(ValueError, match="queue 2 item 6"):
        if route == "window":
            ops = tb.window_operands(q, mask, torch.arange(128), 256, 2, 64, 64)
            tb._window_args(ops, 0, q, q, "fwd_stats_window")
        else:
            tb.kernel_operands(tb.prepare_inputs(q, q, q, mask),
                               differentiable=route == "differentiable",
                               impl="flat_wr" if route == "impl" else "flat")


def jax_bert_config(cfg):
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["sea"] = JaxSeaConfig(**dataclasses.asdict(cfg.sea))
    return jbert.BertConfig(**d)


@pytest.fixture(scope="module")
def image_trainer(tmp_path_factory):
    """LRA image's distill trainer at the task's widths (1 layer, 1 head of
    32, ffn 64) on its synthetic stream cut to T = 64 (8 x 8 pixels), batch
    2, T_M = 32 and k = 8; the student's estimator sharpened as
    tests/test_torch_bert.py does, so that no top-k cut ties."""
    cfg = tlt.LraTrainerConfig(task="image", phase="distill", max_length=64, n_train=8,
                               batch_size=2, predictor_length=32, k=8, num_steps=1,
                               log_every=0, save_dir=str(tmp_path_factory.mktemp("image")))
    tr = tlt.LraTrainer(cfg, device="cpu")
    sharpen_port(tr.student)
    return tr


def test_image_config_matches_jax(image_trainer):
    tr = image_trainer
    for port_cfg, method in ((tr.t_cfg, "none"), (tr.s_cfg, "perlin")):
        assert jax_bert_config(port_cfg) == jax_lra_bert_config("image", method, k=8,
                                                                predictor_length=32)
    c = tr.s_cfg
    assert (c.num_layers, c.num_heads, c.hidden_size // c.num_heads, c.ffn_dim) == (1, 1, D, 64)


def test_image_student_benchmark_forward_matches_jax(image_trainer):
    """The student's benchmarking forward (K5's plain version at width 32)
    against JAX's (K5 in interpret mode): logits and layer 0's context."""
    tr = image_trainer
    ids, am, tt, _ = (jnp.asarray(x) for x in next(tr.eval_ds.batches(2)))
    jmodel = jbert.BertForSequenceClassification(jax_bert_config(tr.s_cfg))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), ids, am, tt)
    variables = jax_variables_from_state_dict(shapes, tr.student.state_dict())
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, benchmarking=True)["logits"])(
        variables, ids, am, tt)
    tr.student.eval()
    with torch.no_grad():
        got = port_topk_guard(lambda: tr.student(*(t(x).long() for x in (ids, am, tt)),
                                                 benchmarking=True)["logits"])
    assert got.shape == want.shape == (2, 10)
    assert_close(got.numpy(), want)


def test_image_kd_step_matches_jax(image_trainer):
    """One KD step (`kd_step` of one micro-batch): the loss and its terms
    against JAX's `SeaBertKD.kd_loss`, and the student after the update
    against optax's update from the same gradients."""
    tr = image_trainer
    batch = next(tr.train_ds.batches(2, shuffle=True, seed=0))
    ids, am, tt, labels = (jnp.asarray(x) for x in batch)
    kd = JaxBertKD(jax_bert_config(tr.t_cfg), jax_bert_config(tr.s_cfg))
    t_vars = jax_variables_from_state_dict(
        jax.eval_shape(kd.teacher.init, jax.random.key(0), ids, am, tt), tr.teacher.state_dict())
    s_vars = jax_variables_from_state_dict(
        jax.eval_shape(kd.student.init, jax.random.key(0), ids, am, tt), tr.student.state_dict())
    want_loss, want = jax.jit(lambda s: kd.kd_loss(t_vars, s, ids, am, labels, tt))(s_vars)
    grads = record_grads(tr.optimizer)
    tr.student.train()
    loss, terms = port_topk_guard(lambda: tr.kd_step([batch]))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_REL)
    for name, v in terms.items():
        np.testing.assert_allclose(float(v), float(want[name]), rtol=LOSS_REL, atol=1e-7,
                                   err_msg=name)
    tx = jax_make_optimizer(lr=tr.lr, wd=tr.wd, lr_low_scale=1.0)
    assert_params(tr.student, optax_steps(tx, s_vars["params"], grads)[-1])
