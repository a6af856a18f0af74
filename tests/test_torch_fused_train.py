"""Port parity: task-only training through the differentiable fused kernel
(sea_tpu_torch `fused_sparse_attention` and the `use_fused_train` path of
`SeaAttention` / `OptForCausalLM` vs the JAX package's).

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
takes the kernels' plain versions on CPU tensors. The CUDA kernels are held
against the same plain versions on the card by chip_smoke.py. Tolerances:

  * prep (bit packing, tile lists, transposed lists) and top-k masks: exact;
  * forward output and logsumexp: 1e-5 abs (float32, the same arithmetic
    summed in another order: the JAX kernel's online softmax against the
    port's dense one);
  * attention gradients: 1e-4 abs + 1e-4 rel (float32 sums over up to T
    products, taken in another order on each side);
  * module and model gradients: 2e-4 abs + 2e-3 rel (the same, compounded
    through the estimator, LayerNorms and several layers);
  * zeros where the JAX side's gradients are exactly zero (the predictor's
    `dec_row` and CNN sit behind the top-k selection): exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from sea_tpu.models import opt as jopt
from sea_tpu.models.attention import SeaAttention as JaxSeaAttention
from sea_tpu.ops import masks as jm
from sea_tpu.ops.kernels import block_sparse as jb
from sea_tpu.utils.profiler import get_bench as jax_bench
from sea_tpu_torch.models import opt as topt
from sea_tpu_torch.models.attention import SeaAttention
from sea_tpu_torch.ops import masks as tm
from sea_tpu_torch.ops.kernels import _build
from sea_tpu_torch.ops.kernels import block_sparse as tb
from sea_tpu_torch.training.longctx import train_steps
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import assert_topk_margin, t, torch_opt_config, torch_sea_config
from tests.test_attention import make_inputs as jax_attention_inputs
from tests.test_attention import small_cfg
from tests.test_torch_block_sparse import make_case

FWD_ATOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
MODEL_TOL = dict(atol=2e-4, rtol=2e-3)
FP_MIN32 = float(np.finfo(np.float32).min) / 2


def _case(T=256, density=0.3, seed=0, empty=(100, 110)):
    """make_case(T, T_M=32, density) with a band of rows whose mask is empty."""
    q, k, v, mask, scaler = make_case(seed=seed, T=T, T_M=32, density=density)
    mask[:, :, empty[0]:empty[1]] = 0.0
    return q, k, v, mask, scaler


def _rows_to_widths(row_base, block_q):
    rw = row_base[:, None] + np.arange(block_q)[None, :]
    return t((rw + 1).reshape(-1).astype(np.float32))


@pytest.mark.parametrize("row_base", [None, np.arange(4, dtype=np.int32) * 64 + 256],
                         ids=["plain", "row_base"])
def test_diff_operands_match_jax_diff_prep(row_base):
    q, k, _, mask, _ = _case()
    want = jb._diff_prep(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(mask), 64, 64,
        None if row_base is None else jnp.asarray(row_base),
    )
    x = tb.prepare_inputs(t(q), t(k), t(k), t(mask), block_q=64, block_k=64,
                          row_base=None if row_base is None else t(row_base))
    got = tb.kernel_operands(x, differentiable=True)
    np.testing.assert_array_equal(got.mbits.numpy().view(np.uint32), np.asarray(want[0]))
    for name, w in zip(("counts", "idx", "counts_t", "idx_t"), want[1:5]):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(got.row_base.numpy(), np.asarray(want[5])[0])


@pytest.mark.parametrize("density", [0.05, 0.3])
def test_fwd_with_stats_reference_matches_jax(density):
    """(a) o and lse[..., 0] of the JAX stats kernel, +inf rows included."""
    q, k, v, mask, scaler = _case(density=density)
    wo, wlse = jb._fwd_with_stats(*(jnp.asarray(x) for x in (q, k, v, mask, scaler)),
                                  64, 64, True)
    go, glse = tb.fwd_with_stats_reference(t(q), t(k), t(v), t(mask), t(scaler))
    wlse = np.asarray(wlse)[..., 0].reshape(glse.shape)
    assert np.isinf(wlse).any() and np.array_equal(np.isinf(wlse), torch.isinf(glse).numpy())
    assert (glse[torch.isinf(glse)] > 0).all()
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), atol=FWD_ATOL)
    np.testing.assert_allclose(glse.numpy(), wlse, atol=FWD_ATOL)


@pytest.mark.parametrize("blocks", [(64, 64), (128, 128)], ids=["b64", "b128"])
def test_fused_value_and_grads_match_jax(blocks):
    """(b) value and the gradients of Σ(o − tgt)² for q, k, v and the scaler
    against jax.grad of the JAX custom_vjp; the block sizes do not change the
    result on either side."""
    bq, bk = blocks
    q, k, v, mask, scaler = _case()
    tgt = np.random.default_rng(11).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v, sc):
        o = jb.fused_sparse_attention(q, k, v, jnp.asarray(mask), sc, None, bq, bk, True)
        return jnp.sum((o - tgt) ** 2), o

    (_, wo), wg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v, scaler))
    )
    leaves = [t(x).requires_grad_() for x in (q, k, v, scaler)]
    go = tb.fused_sparse_attention(*leaves[:3], t(mask), leaves[3], block_q=bq, block_k=bk)
    gg = torch.autograd.grad(((go - t(tgt)) ** 2).sum(), leaves)
    np.testing.assert_allclose(go.detach().numpy(), np.asarray(wo), atol=FWD_ATOL)
    for a, b, name in zip(gg, wg, ("dq", "dk", "dv", "dscaler")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("row_base", [None, np.arange(4, dtype=np.int32) * 64 + 256],
                         ids=["plain", "row_base"])
def test_plain_grads_match_autograd_through_dense_reference(row_base):
    """(c) backward_terms + dq_reference + dkv_reference against autograd
    through the forward's plain version, with lse from
    fwd_with_stats_reference; row_base places the rows in a sequence shard."""
    q, k, v, mask, scaler = (t(x) for x in _case(seed=3))
    tgt = t(np.random.default_rng(12).standard_normal(q.shape).astype(np.float32))
    widths = None if row_base is None else _rows_to_widths(row_base, 64)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, scaler)]
    o = tb.dense_reference(*leaves[:3], mask, leaves[3], row_widths=widths)
    want = torch.autograd.grad(((o - tgt) ** 2).sum(), leaves)

    o, lse = tb.fwd_with_stats_reference(q, k, v, mask, scaler, row_widths=widths)
    dscaler, dou, delta = tb.backward_terms(2 * (o - tgt), o, scaler, q.dtype)
    dq = tb.dq_reference(q, k, v, mask, dou, lse, delta, row_widths=widths)
    dk, dv = tb.dkv_reference(q, k, v, mask, dou, lse, delta, row_widths=widths)
    for a, b, name in zip((dq, dk, dv, dscaler), want, ("dq", "dk", "dv", "dscaler")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **GRAD_TOL)
    if row_base is not None:
        got = tb.fused_sparse_attention(
            q, k, v, mask, scaler, row_base=t(row_base), block_q=64, block_k=64)
        np.testing.assert_allclose(got.numpy(), o.numpy(), atol=FWD_ATOL)


def test_empty_rows_give_zero_grads_and_no_nan():
    """(d) rows with an empty mask: lse = +inf, zero output and zero dq rows,
    no NaN; a mask with no alive element at all gives zero gradients."""
    q, k, v, mask, scaler = (t(x) for x in _case(empty=(64, 128)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v, scaler)]
    o = tb.fused_sparse_attention(*leaves[:3], mask, leaves[3])
    grads = torch.autograd.grad((o ** 2).sum(), leaves)
    o = o.detach()
    _, lse = tb.fwd_with_stats_reference(q, k, v, mask, scaler)
    assert torch.isinf(lse[:, :, 64:128]).all()
    assert float(o[:, :, 64:128].abs().max()) == 0.0
    assert float(grads[0][:, :, 64:128].abs().max()) == 0.0
    assert float(grads[3][:, :, 64:128].abs().max()) == 0.0
    for g in grads:
        assert torch.isfinite(g).all()

    leaves = [x.clone().requires_grad_() for x in (q, k, v, scaler)]
    o = tb.fused_sparse_attention(*leaves[:3], torch.zeros_like(mask), leaves[3])
    grads = torch.autograd.grad((o ** 2).sum() + o.sum(), leaves)
    o = o.detach()
    assert float(o.abs().max()) == 0.0
    for g in grads:
        assert torch.isfinite(g).all() and float(g.abs().max()) == 0.0


def test_topk_mask_train_mode_matches_jax():
    """(e) the additive train-mode grouped top-k at the production budget
    schedule, on estimates whose values are distinct by 1/(H·T_M)."""
    rng = np.random.default_rng(2)
    N, H, T, T_M, K = 1, 4, 128, 32, 4
    # per row, the H·T_M estimates are a permutation of evenly spaced levels
    levels = np.stack([rng.permutation(H * T_M) for _ in range(T)]) / (H * T_M)
    probs = np.transpose(levels.reshape(N, T, H, T_M), (0, 2, 1, 3)).astype(np.float32)
    dst_alive = np.ones((N, 1, T, 1), bool)
    ctl = np.broadcast_to(np.arange(1, T + 1, dtype=np.float32).reshape(1, T, 1), (N, T, 1))
    budget = jm.per_item_top_k(K, 1.0, "causal_batch", H, T_M, None, jnp.asarray(ctl), True)
    assert_topk_margin([probs], [budget])
    want = jm.topk_mask(jnp.asarray(probs), jnp.asarray(dst_alive), budget,
                        "causal_batch", False, FP_MIN32)
    got = tm.topk_mask(t(probs), t(dst_alive), t(budget), "causal_batch", False, FP_MIN32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) == {0.0, np.float32(FP_MIN32)}


def _grads_by_name(tree):
    return state_dict_from_jax({"params": tree})


def _assert_grads_match(model, want, tol):
    """Every parameter's gradient against the JAX tree mapped by name; a
    parameter the loss does not reach has no gradient in the port and must
    be exactly zero on the JAX side."""
    names = dict(model.named_parameters())
    assert set(names) == set(want), set(names) ^ set(want)
    unreached = []
    for name, p in names.items():
        w = want[name].numpy()
        if p.grad is None:
            unreached.append(name)
            np.testing.assert_array_equal(w, np.zeros_like(w), err_msg=name)
        else:
            np.testing.assert_allclose(p.grad.numpy(), w, err_msg=name, **tol)
    return unreached


@pytest.mark.parametrize(
    "thin,extra",
    [(False, {}), (True, {}), (False, {"partial_attention_scaler": False})],
    ids=["square_mask", "thin_mask", "no_scaler"],
)
def test_sea_attention_fused_train_grads_match_jax(thin, extra):
    """(f) SeaAttention with use_fused_train at tests/test_fused_path.py:88's
    geometry (T=128): loss Σ context² and every parameter's gradient; the
    kernel's scaler is all ones when partial_attention_scaler is off."""
    cfg = small_cfg(causal=True, use_fused_train=True, **extra)
    q, k, v, mask, _, _ = jax_attention_inputs(cfg, N=1, T=128)
    if thin:
        mask = mask[:, :, :, :1]
    model = JaxSeaAttention(cfg)
    variables = jax.jit(lambda: model.init(
        jax.random.key(0), q, k, v, q, k, v, q, k, mask, benchmarking=False))()
    bench = jax_bench()
    bench.activate_temp_buffers(True)
    try:
        model.apply(variables, q, k, v, q, k, v, q, k, mask, training=True)
        probs = bench.buffers["masked_estimated_attention_probs"]
        budget = bench.buffers["per_item_top_k"]
    finally:
        bench.activate_temp_buffers(False)
    assert_topk_margin(probs, budget)

    def loss_fn(params):
        out = model.apply({**variables, "params": params}, q, k, v, q, k, v, q, k,
                          mask, training=True)
        return jnp.sum(out.context_layer.astype(jnp.float32) ** 2)

    wl, wg = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])

    port = SeaAttention(torch_sea_config(cfg), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(variables))
    assert not port.performer_proj.requires_grad
    tq, tk, tv, tmask = (t(x) for x in (q, k, v, mask))
    out = port(tq, tk, tv, tq, tk, tv, tq, tk, tmask, training=True)
    loss = (out.context_layer ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(wl), rtol=1e-5)
    unreached = _assert_grads_match(port, _grads_by_name(wg), MODEL_TOL)
    assert any(n.startswith("dec_row") for n in unreached), unreached
    assert any(n.startswith("cnn_") for n in unreached), unreached
    assert port.dec_scaler.weight.grad is not None


def test_thin_mask_needs_the_fused_train_path():
    cfg = small_cfg(causal=True)
    q, k, v, mask, _, _ = jax_attention_inputs(cfg, N=1, T=64)
    port = SeaAttention(torch_sea_config(cfg), device="cpu", seed=0)
    tq, tk, tv = (t(x) for x in (q, k, v))
    with pytest.raises(ValueError):
        port(tq, tk, tv, tq, tk, tv, tq, tk, t(mask)[:, :, :, :1], benchmarking=True)
    # the dense train path needs the square mask
    with pytest.raises(ValueError):
        port(tq, tk, tv, tq, tk, tv, tq, tk, t(mask)[:, :, :, :1], benchmarking=False,
             training=True)
    with torch.no_grad():
        out = port(tq, tk, tv, tq, tk, tv, tq, tk, t(mask), benchmarking=False, training=True)
    assert torch.isfinite(out.context_layer).all()


SEED = 4  # keeps every top-k boundary of the tiny model >= 1e-4 apart (or tied)


def _tiny_opt_cfg():
    sea = small_cfg(causal=True, use_fused_train=True)
    return jopt.OptConfig(
        vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, ffn_dim=64,
        max_position_embeddings=128, attention_method="perlin", sea=sea,
    )


def test_tiny_opt_train_step_matches_jax():
    """(g) a 2-layer OPT with use_fused_train: loss, every gradient, and the
    parameters after one train_steps step against jax.value_and_grad plus
    optax.adamw(1e-5, weight_decay=1e-2). AdamW's first step moves a
    parameter by lr·g/(|g| + eps), so where |g| is at the noise level of the
    two frameworks' sums (< 1e-5) the step may differ by up to 2·lr; the
    parameters are held to 1e-7 abs + 3e-7 rel (two or three float32 ulps)
    elsewhere, and to the exact decay p·(1 − lr·wd) where the gradient is
    exactly zero."""
    cfg = _tiny_opt_cfg()
    T, lr, wd = 128, 1e-5, 1e-2
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg.vocab_size, (1, T)).astype(np.int32)
    am = np.ones((1, T), np.int32)
    model = jopt.OptForCausalLM(cfg)
    variables = jax.jit(model.init)(jax.random.key(SEED), jnp.asarray(ids), jnp.asarray(am))
    bench = jax_bench()
    bench.activate_temp_buffers(True)
    try:
        model.apply(variables, jnp.asarray(ids), jnp.asarray(am), jnp.asarray(ids),
                    training=True)
        probs = bench.buffers["masked_estimated_attention_probs"]
        budget = bench.buffers["per_item_top_k"]
    finally:
        bench.activate_temp_buffers(False)
    assert len(probs) == cfg.num_layers
    assert_topk_margin(probs, budget)

    def loss_fn(params):
        out = model.apply({**variables, "params": params}, jnp.asarray(ids),
                          jnp.asarray(am), labels=jnp.asarray(ids), training=True)
        return out["loss"] + 0.0 * out["aux_loss"]

    params = variables["params"]
    wl, wg = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = optax.adamw(lr, weight_decay=wd)
    updates, _ = tx.update(wg, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)

    port = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(variables))
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    losses = train_steps(port, t(ids).long(), t(am).long(), 1, lr=lr, weight_decay=wd)
    np.testing.assert_allclose(losses[0], float(wl), rtol=1e-5)

    want_g = _grads_by_name(wg)
    want_p = state_dict_from_jax({**variables, "params": new_params})
    names = dict(port.named_parameters())
    assert set(names) == set(want_g)
    zero_grads = 0
    for name, p in names.items():
        g, wgn = p.grad.numpy(), want_g[name].numpy()
        np.testing.assert_allclose(g, wgn, err_msg=name, **MODEL_TOL)
        got, want = p.detach().numpy(), want_p[name].numpy()
        zero = wgn == 0
        zero_grads += int(zero.all())
        np.testing.assert_array_equal(g[zero], 0.0, err_msg=name)
        decayed = (before[name] * (1 - lr * wd)).numpy()
        np.testing.assert_allclose(got[zero], decayed[zero], rtol=1e-7, atol=0, err_msg=name)
        sure = np.abs(wgn) >= 1e-5
        np.testing.assert_allclose(got[sure], want[sure], atol=1e-7, rtol=3e-7, err_msg=name)
        np.testing.assert_allclose(got, want, atol=2 * lr + 1e-7, rtol=3e-7, err_msg=name)
    assert zero_grads >= 2 * cfg.num_layers  # dec_row and the CNN of every layer


def test_build_key_covers_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header changes every library's file name, so
    that the libraries that include it are rebuilt."""
    (tmp_path / "kern.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("kern")
    assert _build._target("kern") == first
    header.write_text("// v2\n")
    second = _build._target("kern")
    assert second != first and second.parent == first.parent
    (tmp_path / "kern.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _build._target("kern") not in (first, second)
