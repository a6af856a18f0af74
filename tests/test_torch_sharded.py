"""Port parity: sequence- and head-sharded attention and the sharding scope
(sea_tpu_torch.parallel over a `LocalGroup`) against the JAX package's
(sea_tpu.parallel over meshes of the 8 virtual CPU devices, Pallas in
interpret mode), from the attention op up to a 2-layer OPT train step.

Tolerances: sharded forwards 1e-5 abs against JAX's (the same plain
arithmetic on both sides of each shard); sharded losses 1e-5 rel and
gradients 1e-4 abs + 1e-4 rel (tests/test_torch_fused_train.py); the module
and the model, context 1e-4 abs (tests/test_torch_attention.py) and
gradients 2e-4 abs + 2e-3 rel (tests/test_torch_fused_train.py); top-k
masks exact.
"""

import dataclasses
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.models import opt as jopt
from sea_tpu.models.attention import SeaAttention as JaxSeaAttention
from sea_tpu.parallel import context as jctx
from sea_tpu.parallel import sharded_attention as jsa
from sea_tpu.parallel.mesh import make_mesh
from sea_tpu.utils.profiler import get_bench as jax_bench
from sea_tpu_torch.models import opt as topt
from sea_tpu_torch.models.attention import SeaAttention
from sea_tpu_torch.ops.kernels import block_sparse as tb
from sea_tpu_torch.parallel import (
    RING_MIN_T,
    AttnShardingContext,
    LocalGroup,
    current_attention_sharding,
    resolve_attention_kind,
    sharded_attention_scope,
)
from sea_tpu_torch.parallel import sharded_attention as tsa
from sea_tpu_torch.training.longctx import train_steps
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import assert_topk_margin, t, torch_opt_config, torch_sea_config
from tests.test_attention import make_inputs as jax_attention_inputs
from tests.test_attention import small_cfg
from tests.test_torch_ring import make_case

FWD_ATOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
MODULE_ATOL = 1e-4
MODEL_TOL = dict(atol=2e-4, rtol=2e-3)


def _jax(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "rowwise"])
@pytest.mark.parametrize("zigzag", [False, True], ids=["natural", "zigzag"])
def test_sharded_sea_attention_matches_jax(zigzag, use_kernel):
    q, k, v, mask, scaler = make_case()
    mesh = make_mesh(dp=2, sp=4)
    want = jax.jit(lambda *a: jsa.sharded_sea_attention(
        *a, mesh=mesh, zigzag=zigzag, use_kernel=use_kernel, block_q=64, block_k=64,
        interpret=True,
    ))(*_jax(q, k, v, mask, scaler))
    got = tsa.sharded_sea_attention(*(t(x) for x in (q, k, v, mask, scaler)), LocalGroup(4),
                                    zigzag=zigzag, use_kernel=use_kernel, block_q=64,
                                    block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


def test_head_sharded_sea_attention_matches_jax():
    q, k, v, mask, scaler = make_case(H=4)
    mesh = make_mesh(dp=2, sp=4)
    want = jax.jit(lambda *a: jsa.head_sharded_sea_attention(
        *a, mesh=mesh, block_q=64, block_k=64, interpret=True,
    ))(*_jax(q, k, v, mask, scaler))
    got = tsa.head_sharded_sea_attention(*(t(x) for x in (q, k, v, mask, scaler)),
                                         LocalGroup(4), block_q=64, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


def _loss_and_grads(fn, q, k, v, scaler, tgt):
    leaves = [t(x).requires_grad_() for x in (q, k, v, scaler)]
    loss = ((fn(*leaves) - t(tgt)) ** 2).sum()
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


KINDS = ["seq-natural", "seq-zigzag", "head"]


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_fused_train_matches_jax(kind):
    """Loss and q/k/v/scaler gradients of Σ(o − tgt)² through the sequence-
    (dk/dv summed over the shards) and head-sharded differentiable paths,
    against jax.grad through the JAX package's."""
    H = 4 if kind == "head" else 2
    q, k, v, mask, scaler = make_case(H=H, seed=3)
    tgt = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    mesh = make_mesh(dp=2, sp=4)
    jmask = jnp.asarray(mask)
    if kind == "head":
        def jfn(q, k, v, sc):
            return jsa.head_sharded_fused_train(q, k, v, jmask, sc, mesh, block_q=64,
                                                block_k=64, interpret=True)

        def tfn(q, k, v, sc):
            return tsa.head_sharded_fused_train(q, k, v, t(mask), sc, LocalGroup(4),
                                                block_q=64, block_k=64)
    else:
        zigzag = kind == "seq-zigzag"

        def jfn(q, k, v, sc):
            return jsa.sharded_fused_train_attention(q, k, v, jmask, sc, mesh, zigzag=zigzag,
                                                     block_q=64, block_k=64, interpret=True)

        def tfn(q, k, v, sc):
            return tsa.sharded_fused_train_attention(q, k, v, t(mask), sc, LocalGroup(4),
                                                     zigzag=zigzag, block_q=64, block_k=64)

    wl, wg = jax.jit(jax.value_and_grad(lambda *a: jnp.sum((jfn(*a) - tgt) ** 2),
                                        argnums=(0, 1, 2, 3)))(*_jax(q, k, v, scaler))
    gl, gg = _loss_and_grads(tfn, q, k, v, scaler, tgt)
    np.testing.assert_allclose(gl, float(wl), rtol=1e-5)
    for a, b, name in zip(gg, wg, ("dq", "dk", "dv", "dscaler")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)


def test_resolve_attention_kind_matches_jax():
    """The port of tests/test_sharded_attention.py:363-388, and the same
    answer as the JAX rule over sizes, lengths, oversampling and kinds."""
    ctx = AttnShardingContext(group=LocalGroup(2))
    assert resolve_attention_kind(ctx, t=4096) == "seq"
    assert resolve_attention_kind(ctx, t=RING_MIN_T) == "ring"
    assert resolve_attention_kind(ctx, t=65536) == "ring"
    assert resolve_attention_kind(ctx, t=65536, oversample=2.0) == "seq"
    for kind in ("seq", "head", "ring"):
        assert resolve_attention_kind(AttnShardingContext(LocalGroup(2), kind), t=65536) == kind
    assert resolve_attention_kind(AttnShardingContext(group=LocalGroup(1)), t=65536) == "seq"
    assert RING_MIN_T == jctx.RING_MIN_T
    for size in (1, 2, 4):
        mesh = make_mesh(dp=8 // size, sp=size)
        for kind in ("auto", "seq", "head", "ring"):
            for t_ in (512, RING_MIN_T - 128, RING_MIN_T, 65536):
                for over in (1.0, 2.0):
                    want = jctx.resolve_attention_kind(
                        jctx.AttnShardingContext(mesh=mesh, kind=kind), t=t_, oversample=over)
                    got = resolve_attention_kind(
                        AttnShardingContext(LocalGroup(size), kind), t=t_, oversample=over)
                    assert got == want, (size, kind, t_, over)


def test_scope_is_thread_local_and_nests():
    seen = []
    with sharded_attention_scope(LocalGroup(4), kind="ring", block_q=64) as outer:
        assert current_attention_sharding() is outer and outer.group.size == 4
        worker = threading.Thread(target=lambda: seen.append(current_attention_sharding()))
        worker.start()
        worker.join()
        with sharded_attention_scope(LocalGroup(2), kind="head") as inner:
            assert current_attention_sharding() is inner
        assert current_attention_sharding() is outer
    assert current_attention_sharding() is None and seen == [None]
    with pytest.raises(ValueError):
        with sharded_attention_scope(LocalGroup(2), kind="rings"):
            pass


# (kind, shards, benchmark): the JAX module tests of
# tests/test_sharded_attention.py, head-sharded over 2 shards (H = 2)
MODULE_CASES = [("ring", 4, True), ("ring", 4, False), ("seq", 4, True), ("seq", 4, False),
                ("head", 2, True), ("head", 2, False)]


@pytest.mark.parametrize("kind,shards,benchmark", MODULE_CASES,
                         ids=[f"{k}-{'bench' if b else 'train'}" for k, _, b in MODULE_CASES])
def test_sea_attention_under_scope_matches_jax(kind, shards, benchmark):
    """SeaAttention at T = 512 inside each package's sharding scope (blocks
    of 64 where the scope sets them): the benchmark context layer, or the
    use_fused_train loss Σ context² and every parameter's gradient."""
    cfg = small_cfg(causal=True, use_pallas=True, use_fused_train=not benchmark,
                    max_position_embeddings=512)
    q, k, v, mask, _, _ = jax_attention_inputs(cfg, N=1, T=512)
    model = JaxSeaAttention(cfg)
    variables = jax.jit(lambda: model.init(
        jax.random.key(0), q, k, v, q, k, v, q, k, mask, benchmarking=False))()
    bench = jax_bench()
    bench.activate_temp_buffers(True)
    try:
        model.apply(variables, q, k, v, q, k, v, q, k, mask, benchmarking=benchmark,
                    training=not benchmark)
        assert_topk_margin(bench.buffers["masked_estimated_attention_probs"],
                           bench.buffers["per_item_top_k"])
    finally:
        bench.activate_temp_buffers(False)
    blocks = {} if kind == "head" else dict(block_q=64, block_k=64)
    mesh = make_mesh(dp=8 // shards, sp=shards)

    def jrun(params):
        out = model.apply({**variables, "params": params}, q, k, v, q, k, v, q, k, mask,
                          benchmarking=benchmark, training=not benchmark)
        return jnp.sum(out.context_layer.astype(jnp.float32) ** 2), out

    port = SeaAttention(torch_sea_config(cfg), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(variables))
    tq, tk, tv, tmask = (t(x) for x in (q, k, v, mask))
    with jctx.sharded_attention_scope(mesh, axis="sp", kind=kind, **blocks):
        if benchmark:
            _, want = jax.jit(jrun)(variables["params"])
        else:
            (wl, _), wg = jax.jit(jax.value_and_grad(jrun, has_aux=True))(variables["params"])
    with sharded_attention_scope(LocalGroup(shards), kind=kind, **blocks):
        if benchmark:
            with torch.no_grad():
                got = port(tq, tk, tv, tq, tk, tv, tq, tk, tmask, benchmarking=True)
        else:
            got = port(tq, tk, tv, tq, tk, tv, tq, tk, tmask, training=True)
    if benchmark:
        np.testing.assert_array_equal(got.partial_attention_mask.numpy(),
                                      np.asarray(want.partial_attention_mask))
        np.testing.assert_allclose(got.context_layer.numpy(), np.asarray(want.context_layer),
                                   atol=MODULE_ATOL)
        return
    loss = (got.context_layer ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(wl), rtol=1e-5)
    want = state_dict_from_jax({"params": wg})
    for name, p in port.named_parameters():
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, w, err_msg=name, **MODEL_TOL)
    assert port.dec_scaler.weight.grad is not None


def test_tiny_opt_ring_train_step_matches_jax():
    """A 2-layer OPT with use_fused_train at T = 512 inside kind='ring'
    scopes of 4 shards, blocks of 128 (as __graft_entry__.dryrun_multichip
    runs the JAX ring): one train_steps step's loss and every gradient
    against jax.value_and_grad under the JAX scope; the ring's first layer
    also against the port's unsharded step."""
    T, seed = 512, 4
    sea = small_cfg(causal=True, use_fused_train=True, max_position_embeddings=T)
    cfg = jopt.OptConfig(
        vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, ffn_dim=64,
        max_position_embeddings=T, attention_method="perlin", sea=sea,
    )
    rng = np.random.default_rng(seed)
    ids = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, T)).astype(np.int32))
    am = jnp.ones((1, T), jnp.int32)
    model = jopt.OptForCausalLM(cfg)
    variables = jax.jit(model.init)(jax.random.key(seed), ids, am)
    bench = jax_bench()
    bench.activate_temp_buffers(True)
    try:
        model.apply(variables, ids, am, ids, training=True)
        assert_topk_margin(bench.buffers["masked_estimated_attention_probs"],
                           bench.buffers["per_item_top_k"])
    finally:
        bench.activate_temp_buffers(False)

    def loss_fn(params):
        out = model.apply({**variables, "params": params}, ids, am, labels=ids, training=True)
        return out["loss"] + 0.0 * out["aux_loss"]

    mesh = make_mesh(dp=2, sp=4)
    with jctx.sharded_attention_scope(mesh, axis="sp", kind="ring", block_q=128, block_k=128):
        wl, wg = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])

    def port_step(scoped):
        port = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None)
        port.load_state_dict(state_dict_from_jax(variables))
        tids, tam = t(ids).long(), t(am).long()
        if scoped:
            with sharded_attention_scope(LocalGroup(4), kind="ring", block_q=128, block_k=128):
                losses = train_steps(port, tids, tam, 1)
        else:
            losses = train_steps(port, tids, tam, 1)
        return losses[0], {n: p.grad for n, p in port.named_parameters()}

    loss, grads = port_step(True)
    np.testing.assert_allclose(loss, float(wl), rtol=1e-5)
    want = state_dict_from_jax({"params": wg})
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **MODEL_TOL)
    plain_loss, plain_grads = port_step(False)
    np.testing.assert_allclose(loss, plain_loss, rtol=1e-5)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), plain_grads[name].numpy(), err_msg=name,
                                   **MODEL_TOL)
