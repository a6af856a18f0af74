"""Port parity: OPT forward to logits (sea_tpu_torch.models.opt vs
sea_tpu.models.opt) at a tiny configuration, for the SEA student on the
fused benchmark path and for the dense teacher; logits to <= 1e-4 abs.
Also: the port package imports no JAX and nothing of sea_tpu."""

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
