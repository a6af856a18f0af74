"""Port parity: tensor parallelism (sea_tpu_torch.parallel.tp against
sea_tpu.parallel.tp), tests/test_tp.py case by case at its tiny configs.

The port's positions are LocalGroup positions on the CPU; JAX's side is
jitted over its sharded parameters on the 8 virtual devices, its trees read
from the port's seeded state dicts. Bounds are JAX's own: the specs leaf
for leaf, the TP forward within 2e-4 of JAX's, the TP KD gradients within
5e-4. The JAX references are shared with tests/test_torch_pp.py
(tests/_torch_parallel.py).
"""

import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sea_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sea_tpu.models.llama import LlamaForCausalLM as JaxLlama
from sea_tpu.models.llama import llama_tiny as jax_llama_tiny
from sea_tpu.models.opt import OptForCausalLM as JaxOpt
from sea_tpu.models.opt import stack_layer_params as jax_stack
from sea_tpu.parallel import tp as jtp
from sea_tpu.parallel.context import sharded_attention_scope as jax_scope
from sea_tpu_torch import weights
from sea_tpu_torch.models.llama import LlamaForCausalLM
from sea_tpu_torch.models.opt import OptForCausalLM
from sea_tpu_torch.parallel import LocalGroup
from sea_tpu_torch.parallel.tp import (ColumnParallelDense, RowParallelDense, gather_tp,
                                       make_tp_mesh, shard_params_tp, tensor_parallel,
                                       tp_param_specs)
from sea_tpu_torch.training.distill import SeaOptKD
from tests._torch_parallel import (STUDENT_SEED, TEACHER_SEED, jax_llama4_logits, jax_kd,
                                   opt4_batch, port_kd, port_llama4)
from tests._torch_parity import (jax_variables_from_state_dict, torch_llama_config,
                                 torch_opt_config)
from tests.test_opt_kd import tiny_opt

CPUS = ["cpu"] * 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(N, T, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(4, vocab, (N, T)), np.ones((N, T), np.int64)


def _port(jcfg, seed=0):
    if isinstance(jcfg, JaxLlamaConfig):
        return LlamaForCausalLM(torch_llama_config(jcfg), device="cpu", seed=seed)
    return OptForCausalLM(torch_opt_config(jcfg), device="cpu", seed=seed)


def _jax_vars(jmodel, port, ids, mask):
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.asarray(ids),
                                                jnp.asarray(mask)))
    return jax_variables_from_state_dict(shapes, port.state_dict())


def _as_port_spec(path, spec):
    """A JAX spec in the port's layout: a 2-D kernel's transposed."""
    spec = tuple(spec)
    return spec[::-1] if path[-1] == "kernel" and len(spec) == 2 else spec


def _port_name(path):
    mods = []
    for n in path[:-1]:
        mods.extend(["layers", n[len("layers_"):]] if n.startswith("layers_") else [n])
    leaf = path[-1]
    return ".".join(mods + ["weight" if leaf in ("kernel", "scale", "embedding") else leaf])


def _check_specs(jcfg, dp, tp):
    """The port's specs of its state dict against JAX's of the same
    parameters, leaf for leaf; and each position's shard equal to the
    block JAX puts on the position's device."""
    jmodel, port = (JaxLlama if isinstance(jcfg, JaxLlamaConfig) else JaxOpt)(jcfg), _port(jcfg)
    ids, mask = _ids(1, 8, jcfg.vocab_size)
    params = _jax_vars(jmodel, port, ids, mask)["params"]
    jmesh = jtp.make_tp_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    mesh = make_tp_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))
    want = jtp.tp_param_specs(params, jmesh)
    named = dict(port.named_parameters())
    got = tp_param_specs(named, mesh)
    flat = jax.tree_util.tree_leaves_with_path(want, is_leaf=lambda x: isinstance(x, P))
    assert len(flat) == len(got)
    shards = shard_params_tp({n: p.detach() for n, p in named.items()}, mesh)
    placed = jtp.shard_params_tp(params, jmesh)
    for key, spec in flat:
        path = [k.key for k in key]
        name = _port_name(path)
        assert got[name] == _as_port_spec(path, spec), (name, got[name], spec)
        leaf = placed
        for k in path:
            leaf = leaf[k]
        blocks = {s.device: s.data for s in leaf.addressable_shards}
        for p in range(tp):
            block = np.asarray(blocks[jmesh.devices[0, p]])  # mesh position (0, p)
            block = block.T if path[-1] == "kernel" else block
            np.testing.assert_array_equal(shards[p][name].numpy(), block, err_msg=name)
    # the nested-tree form is JAX's rule itself
    assert tp_param_specs(params, mesh) == jax.tree_util.tree_map(
        tuple, want, is_leaf=lambda x: isinstance(x, P))
    return got


def test_spec_rules_llama():
    got = _check_specs(jax_llama_tiny("perlin"), dp=2, tp=4)
    L0 = "model.layers.0."
    assert got[L0 + "self_attn.q_proj.weight"] == ("tp", None)
    assert got[L0 + "self_attn.o_proj.weight"] == (None, "tp")
    assert got[L0 + "mlp.gate_proj.weight"] == ("tp", None)
    assert got[L0 + "mlp.down_proj.weight"] == (None, "tp")
    assert got[L0 + "input_layernorm.weight"] == ()
    assert got["lm_head.weight"] == ("tp", None)
    assert got["model.embed_tokens.weight"] == ()
    # the SEA estimator stays replicated
    assert all(s == () for n, s in got.items() if ".perlin." in n)


def test_spec_rules_opt_bias_and_scan():
    got = _check_specs(tiny_opt("perlin"), dp=4, tp=2)
    L0 = "model.layers.0."
    assert got[L0 + "self_attn.q_proj.weight"] == ("tp", None)
    assert got[L0 + "self_attn.q_proj.bias"] == ("tp",)
    assert got[L0 + "self_attn.out_proj.weight"] == (None, "tp")
    assert got[L0 + "self_attn.out_proj.bias"] == ()
    assert got[L0 + "fc1.weight"] == ("tp", None)
    assert got[L0 + "fc2.weight"] == (None, "tp")
    # the stacked layout (weights.stack_layer_params): the leading layer dim
    # whole, the same body specs, JAX's leaf for leaf
    cfg = tiny_opt("perlin")
    port = _port(cfg)
    ids, mask = _ids(1, 8, cfg.vocab_size)
    params = jax.tree_util.tree_map(np.asarray, _jax_vars(JaxOpt(cfg), port, ids, mask)["params"])
    mesh, jmesh = make_tp_mesh(dp=4, tp=2, devices=CPUS), jtp.make_tp_mesh(dp=4, tp=2)
    stacked = weights.stack_layer_params(params, cfg.num_layers)
    sspecs = tp_param_specs(stacked, mesh)
    want = jtp.tp_param_specs(jax_stack(params, cfg.num_layers), jmesh)
    assert sspecs == jax.tree_util.tree_map(tuple, want, is_leaf=lambda x: isinstance(x, P))
    body = sspecs["model"]["layers_scan"]["layer"]
    assert body["self_attn"]["q_proj"]["kernel"] == (None, None, "tp")
    assert body["self_attn"]["out_proj"]["kernel"] == (None, "tp", None)


def test_spec_fallbacks_to_replicated():
    """Dims that tp does not divide fall back to replicated, as JAX's rule:
    at tp = 3 a GQA LLaMA (6 heads of 8, 2 K/V heads) shards q, o and the
    SwiGLU but not its 16-wide k/v projections."""
    cfg = dataclasses.replace(jax_llama_tiny("perlin", num_kv_heads=2), hidden_size=48,
                              num_heads=6, intermediate_size=96)
    cfg = dataclasses.replace(cfg, sea=dataclasses.replace(cfg.sea, num_heads=6))
    got = _check_specs(cfg, dp=2, tp=3)
    L0 = "model.layers.0."
    assert got[L0 + "self_attn.q_proj.weight"] == ("tp", None)
    assert got[L0 + "self_attn.k_proj.weight"] == got[L0 + "self_attn.v_proj.weight"] == ()
    assert got[L0 + "mlp.up_proj.weight"] == ("tp", None)


def _gqa_fallback():
    cfg = dataclasses.replace(jax_llama_tiny("perlin", num_kv_heads=2), hidden_size=48,
                              num_heads=6, intermediate_size=96)
    return dataclasses.replace(cfg, sea=dataclasses.replace(cfg.sea, num_heads=6))


def test_tp_forward_matches_replicated_llama():
    """The TP forward (dense path) of a 4-layer llama_tiny at (dp 2, tp 4)
    against JAX's replicated forward from the same weights (2e-4, JAX's
    TP-vs-replicated bound); every sharded projection a parallel module."""
    ids, mask, want = jax_llama4_logits()
    tp_model = tensor_parallel(port_llama4(), make_tp_mesh(dp=2, tp=4, devices=CPUS))
    attn = tp_model.model.layers[0].self_attn
    assert isinstance(attn.q_proj, ColumnParallelDense) and isinstance(attn.o_proj, RowParallelDense)
    assert isinstance(tp_model.lm_head, ColumnParallelDense)
    with torch.no_grad():
        got = tp_model(torch.tensor(ids), torch.tensor(mask))["logits"]
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_tp_forward_gqa_fallback_matches_jax():
    """GQA where tp does not divide the K/V width: a LLaMA of 6 heads of 8
    and 2 K/V heads at (dp 2, tp 3) keeps k_proj and v_proj whole (JAX's
    fallback) and still computes JAX's TP forward (2e-4)."""
    cfg, dp, tp = _gqa_fallback(), 2, 3
    jmodel, port = JaxLlama(cfg), _port(cfg)
    ids, mask = _ids(2, 16, cfg.vocab_size, seed=1)
    variables = _jax_vars(jmodel, port, ids, mask)
    jmesh = jtp.make_tp_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    params = jtp.shard_params_tp(variables["params"], jmesh)
    extra = {k: v for k, v in variables.items() if k != "params"}
    data = NamedSharding(jmesh, P("dp"))
    with jmesh:
        want = jax.jit(lambda p, i, m: jmodel.apply({**extra, "params": p}, i, m)["logits"])(
            params, jax.device_put(jnp.asarray(ids), data), jax.device_put(jnp.asarray(mask), data))
    tp_model = tensor_parallel(port, make_tp_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp)))
    attn = tp_model.model.layers[0].self_attn
    assert isinstance(attn.q_proj, ColumnParallelDense) and isinstance(attn.o_proj, RowParallelDense)
    assert not isinstance(attn.k_proj, ColumnParallelDense)
    with torch.no_grad():
        got = tp_model(torch.tensor(ids), torch.tensor(mask))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_tp_benchmark_fused_head_sharded():
    """TP x the fused benchmark path: K1 (its plain version here) on each
    position's heads of the compressed mask, the estimator replicated;
    equal to JAX's TP forward under its 'head' scope over tp (2e-4)."""
    cfg = tiny_opt("perlin")  # H = 2 shards over tp = 2
    jmodel, port = JaxOpt(cfg), _port(cfg)
    ids, mask = _ids(2, 64, cfg.vocab_size, seed=3)
    variables = _jax_vars(jmodel, port, ids, mask)
    jmesh = jtp.make_tp_mesh(dp=4, tp=2)
    params = jtp.shard_params_tp(variables["params"], jmesh)
    extra = {k: v for k, v in variables.items() if k != "params"}
    with jmesh, jax_scope(jmesh, axis="tp", kind="head"):
        want = jax.jit(lambda p, i, m: jmodel.apply(
            {**extra, "params": p}, i, m, benchmarking=True)["logits"])(
                params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        plain = port(torch.tensor(ids), torch.tensor(mask), benchmarking=True)["logits"]
        tp_model = tensor_parallel(port, make_tp_mesh(dp=4, tp=2, devices=CPUS))
        assert all(layer.self_attn.perlin.head_group is tp_model.tp_group
                   for layer in tp_model.model.layers)
        got = tp_model(torch.tensor(ids), torch.tensor(mask), benchmarking=True)["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-4)


def test_tp_kd_grad_matches_replicated():
    """One KD step of a TP student (the tiny OPT, tp = 2; the dense
    teacher whole): its loss and gradients (the shards joined, `gather_tp`)
    against JAX's unsharded `SeaOptKD` value and gradient, within 5e-4 leaf
    for leaf (JAX's TP-vs-replicated bound)."""
    want_loss, want = jax_kd()
    teacher, student = port_kd("none", TEACHER_SEED), port_kd("perlin", STUDENT_SEED)
    ids, mask = (torch.tensor(x) for x in opt4_batch())
    tp_student = tensor_parallel(student, make_tp_mesh(dp=4, tp=2, devices=CPUS))
    loss, _ = SeaOptKD(teacher, tp_student).kd_loss(ids, mask, ids)
    loss.backward()
    assert abs(loss.item() - want_loss) < 1e-4
    got = gather_tp(tp_student, grads=True)
    assert set(want) <= set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), atol=5e-4, err_msg=name)


def test_tp_layouts_and_autograd_regions():
    """The parallel modules hold each position's block of the whole Dense,
    `gather_tp` joins them back bit for bit, and a TP model trains on every
    shard: its dense-path task gradients equal the unsharded model's (the
    shards' joined) within 1e-6 over 2 and 4 LocalGroup positions (at 4,
    half a head each: q, k and v are gathered before the heads)."""
    cfg = tiny_opt("perlin")
    ids, mask = (torch.tensor(x) for x in _ids(2, 16, cfg.vocab_size, seed=5))
    ref = _port(cfg, seed=4)
    ref(ids, mask, labels=ids)["loss"].backward()
    want = {n: p.grad for n, p in ref.named_parameters()}
    for tp in (2, 4):
        model = tensor_parallel(copy.deepcopy(ref), LocalGroup(tp, "cpu"))
        model.zero_grad()
        full = gather_tp(model)
        assert all(torch.equal(full[n], p.detach()) for n, p in ref.named_parameters())
        model(ids, mask, labels=ids)["loss"].backward()
        got = gather_tp(model, grads=True)
        for n, g in want.items():
            if g is None:
                assert got[n] is None, n
            else:
                np.testing.assert_allclose(got[n].numpy(), g.numpy(), atol=1e-6, err_msg=n)
