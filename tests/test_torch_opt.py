"""Port parity: OPT forward to logits (sea_tpu_torch.models.opt vs
sea_tpu.models.opt) at a tiny configuration, for the SEA student on the
fused benchmark path and for the dense teacher; logits to <= 1e-4 abs.
Also: the port package imports no JAX and nothing of sea_tpu; the OPT
builders' fields equal JAX's; a bfloat16 tree converts exactly."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.config import SeaConfig
from sea_tpu.models import opt as jopt
from sea_tpu.utils.profiler import get_bench as jax_bench
from sea_tpu_torch.models import opt as topt
from sea_tpu_torch.ops.kernels import block_sparse as tb
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import assert_topk_margin, t, torch_opt_config

ATOL = 1e-4
T = 128
# a seed whose estimates keep every top-k boundary at least 1e-4 apart (or
# exactly tied) on the JAX side: see assert_topk_margin
SEED = 4


def tiny_cfg(method):
    sea = SeaConfig(
        num_heads=2, head_dim=16, predictor_length=16, k=4,
        performer_nb_factor=1, causal=True, max_position_embeddings=128,
    ).validate()
    return jopt.OptConfig(
        vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, ffn_dim=64,
        max_position_embeddings=128, attention_method=method, sea=sea,
    )


def run_both(cfg, ids, am, labels):
    """The JAX model (seeded init) and the port on its weights, both on the
    fused benchmark path: (port outputs, JAX outputs). The top-k near-tie
    guard reads the JAX side's estimates first."""
    model = jopt.OptForCausalLM(cfg)
    variables = jax.jit(model.init)(jax.random.key(SEED), jnp.asarray(ids), jnp.asarray(am))
    bench = jax_bench()
    bench.activate_temp_buffers(True)
    try:
        want = model.apply(
            variables, jnp.asarray(ids), jnp.asarray(am), jnp.asarray(labels),
            benchmarking=True,
        )
        probs = bench.buffers.get("masked_estimated_attention_probs", [])
        budget = bench.buffers.get("per_item_top_k", [])
    finally:
        bench.activate_temp_buffers(False)
    assert len(probs) == (cfg.num_layers if cfg.attention_method == "perlin" else 0)
    assert_topk_margin(probs, budget)

    port = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        got = port(t(ids).long(), t(am).long(), t(labels).long(), benchmarking=True)
    return got, want


@pytest.mark.parametrize("method", ["perlin", "none"])
def test_opt_logits_match(method):
    cfg = tiny_cfg(method)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg.vocab_size, (1, T)).astype(np.int32)
    am = np.ones((1, T), np.int32)
    labels = rng.integers(0, cfg.vocab_size, (1, T)).astype(np.int32)
    got, want = run_both(cfg, ids, am, labels)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=ATOL)


# A left-padded batch of two: the second example's first PAD positions are
# padding. Logits and loss to 1e-5 abs: these inputs measured within 1.9e-6
# and 4.8e-7 of JAX (float32 sums in another order through two layers).
PAD, PADDED_ATOL = 37, 1e-5


@pytest.mark.parametrize("method", ["perlin", "none"])
def test_opt_logits_match_left_padded(method):
    cfg = tiny_cfg(method)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    am = np.ones((2, T), np.int32)
    am[1, :PAD] = 0
    labels = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    got, want = run_both(cfg, ids, am, labels)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               atol=PADDED_ATOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=PADDED_ATOL)


def test_seeded_init_is_reproducible_and_finite():
    cfg = torch_opt_config(tiny_cfg("perlin"))
    a = topt.OptForCausalLM(cfg, device="cpu", seed=0)
    b = topt.OptForCausalLM(cfg, device="cpu", seed=0)
    for (na, pa), (nb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb), na
    ids = torch.randint(0, cfg.vocab_size, (2, 96), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = a(ids, torch.ones_like(ids), benchmarking=True)["logits"]
    assert out.shape == (2, 96, cfg.vocab_size)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("builder", ["opt_125m", "opt_350m", "opt_1_3b", "opt_2_7b"])
@pytest.mark.parametrize("method", ["perlin", "none"])
def test_builders_match_jax(builder, method):
    """Every field of the OPT builders, compute_dtype (bfloat16 from 1.3b)
    and the SEA geometry included, equals the JAX package's."""
    want = torch_opt_config(getattr(jopt, builder)(method))
    assert getattr(topt, builder)(method) == want


def test_bf16_weights_convert_exactly():
    """A JAX tree cast to bfloat16 comes over through float32 (exact) as
    bfloat16 tensors equal to its leaves, and loads into the port cast to
    bfloat16 unchanged; an unknown compute_dtype is refused."""
    cfg = tiny_cfg("perlin")
    ids = jnp.ones((1, 16), jnp.int32)
    variables = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        jopt.OptForCausalLM(cfg).init(jax.random.key(0), ids, ids))
    sd = state_dict_from_jax(variables)
    assert sd and all(x.dtype == torch.bfloat16 for x in sd.values())
    port = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None).to(torch.bfloat16)
    port.load_state_dict(sd)
    for name, x in port.state_dict().items():
        assert x.dtype == torch.bfloat16 and torch.equal(x, sd[name]), name
    want = state_dict_from_jax(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        variables))
    for name, x in sd.items():
        assert torch.equal(x.float(), want[name]), name
    with pytest.raises(ValueError, match="compute_dtype"):
        topt.OptForCausalLM(dataclasses.replace(torch_opt_config(cfg), compute_dtype="float16"),
                            device="cpu")


# (route, head width, refused): OPT-2.7b's width 80 is built for the causal
# forward (K1) and the differentiable path (K2-K4); the padded bidirectional
# forward (K5), the impl variants (K9a-c) and the ring's windows (K6-K8) take
# 64 only, and no route takes 96
WIDTH_ROUTES = [("differentiable", 80, False), ("causal", 80, False),
                ("differentiable", 96, True), ("bidirectional", 80, True),
                ("impl", 80, True), ("window", 80, True)]


@pytest.mark.parametrize("route,width,refused", WIDTH_ROUTES,
                         ids=[f"{r}-{w}" for r, w, _ in WIDTH_ROUTES])
def test_head_width_routes(route, width, refused):
    """OPT-2.7b's heads are 80 wide; the kernels' operands build at that
    width where the kernels have an instance of it, and every other route
    or width is refused, naming the ROADMAP item that adds it."""
    cfg = topt.opt_2_7b("perlin")
    assert cfg.head_dim == cfg.sea.head_dim == 80
    q = torch.zeros((1, 2, 128, width))
    mask = torch.ones((1, 2, 128, 256))

    def build():
        if route == "window":
            ops = tb.window_operands(q, mask, torch.arange(128), 256, 2, 64, 64)
            kv = torch.zeros((1, 2, 128, width))
            return tb._window_args(ops, 0, kv, kv, "fwd_stats_window")
        x = tb.prepare_inputs(q, q, q, mask, is_causal=route != "bidirectional")
        ops = tb.kernel_operands(x, differentiable=route == "differentiable",
                                 impl="flat_wr" if route == "impl" else "flat")
        assert ops.q.shape == (2, 128, width) and (ops.idx_t is not None) == (
            route == "differentiable")

    if refused:
        with pytest.raises(ValueError, match="queue 2 item 6"):
            build()
    else:
        build()


def test_port_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import sea_tpu_torch\n"
        "for m in pkgutil.walk_packages(sea_tpu_torch.__path__, 'sea_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'sea_tpu'))\n"
        "print(len(list(pkgutil.walk_packages(sea_tpu_torch.__path__))), bad)\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
