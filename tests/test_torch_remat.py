"""Port parity for the long-context memory plan: the chunked cross entropy
(`logit_chunk`), the scanned layer stack (`scan_layers`, `scan_remat`), the
scan-layout weight trees and the scanned decode helpers, against the JAX
package on the CPU (its Pallas kernels in interpret mode, the port's plain
versions).

What is held, and the tolerance of each:

  * `chunked_cross_entropy_shifted` on the same (N, T, E) hidden states,
    (E, V) head and labels with -100 entries, T not a multiple of the chunk:
    the loss 1e-6 relative, the gradients of h and of the head 1e-5 abs;
    a bf16 h against the tiny OPT's float32 tied head (`logits`) promotes
    to float32 on both sides;
  * the tiny OPT's and `llama_tiny`'s `logit_chunk` loss against JAX's
    chunked loss 1e-5 relative (the models' own float32 noise), and against
    the port's unchunked loss 1e-6 relative with every gradient within 1e-5
    abs (tests/test_long_context.py:77's rule);
  * `stack_layer_params`/`unstack_layer_params` against JAX's, leaf for leaf
    and bit for bit, and the round trip;
  * the scanned OPT and LLaMA (with and without `scan_remat`), weights read
    from JAX's scan-layout trees through `weights.state_dict_from_jax`,
    against JAX's scanned model: logits 2e-5 abs (tests/test_scan_layers.py's
    bound); the port's scanned forward equal to its loop forward bit for bit;
  * `scan_benchmarking` (tests/test_scan_layers.py:50) at T = 64: logits
    against JAX's scanned benchmark forward 2e-5 abs, K1's plain version
    once a layer, equal to the port's loop benchmark forward bit for bit;
  * in the port, the fused train step of the scanned model with and without
    remat and of the loop model: losses and gradients equal bit for bit, K2's
    plain version run twice a layer under remat;
  * the tiny OPT with `use_fused_train`, `scan_layers` and `scan_remat` against
    JAX's `nn.remat` scan: loss 1e-5 relative and every gradient 2e-4 abs +
    2e-3 rel (tests/test_torch_fused_train.py's model bound);
  * the scanned decode helpers against JAX's `scan_generate_greedy`,
    `scan_prefill_parallel` and `scan_decode_step` (tests/test_opt_decode.py:286):
    tokens equal, logits 2e-5 abs, every stacked state field 1e-5 abs;
  * `training.longctx.main` with `--logit-chunk` on the CPU.

Every test runs on one torch thread.
"""

import dataclasses
import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.models import llama as jl
from sea_tpu.models import opt as jopt
from sea_tpu_torch.models import llama as tl
from sea_tpu_torch.models import opt as topt
from sea_tpu_torch.ops.kernels import block_sparse as tb
from sea_tpu_torch.training import longctx
from sea_tpu_torch.weights import stack_layer_params, state_dict_from_jax, unstack_layer_params
from tests._torch_parity import t, torch_llama_config, torch_opt_config
from tests.test_opt_kd import make_batch, tiny_opt
from tests.test_torch_fused_train import SEED, _tiny_opt_cfg

MODEL_TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labels(ids: np.ndarray, seed: int) -> np.ndarray:
    """ids with about a quarter of the positions set to -100."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random(ids.shape) < 0.25, -100, ids).astype(np.int32)


def _scan_vars(variables, num_layers):
    """JAX's loop-layout variables in the scan layout (both collections)."""
    out = {"params": jopt.stack_layer_params(variables["params"], num_layers)}
    if "performer" in variables:
        out["performer"] = jopt.stack_layer_params(variables["performer"], num_layers)
    return out


# ---------------------------------------------------------------------------
# The chunked cross entropy


@pytest.mark.parametrize("chunk", [4, 6, 7, 18, 64])
def test_chunked_cross_entropy_matches_jax(chunk):
    """T = 18: chunks 4 and 7 fall back to the divisors 3 and 6."""
    N, T, E, V = 2, 18, 8, 32
    rng = np.random.default_rng(chunk)
    h = rng.standard_normal((N, T, E)).astype(np.float32)
    proj = (rng.standard_normal((E, V)) * 0.5).astype(np.float32)
    labels = _labels(rng.integers(0, V, (N, T)), chunk)

    def jax_loss(h_, p_):
        return jopt.chunked_cross_entropy_shifted(h_, p_, jnp.asarray(labels), chunk)

    wl, (wh, wp) = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(proj))
    th, tp = t(h).requires_grad_(), t(proj).requires_grad_()
    loss = topt.chunked_cross_entropy_shifted(th, lambda x: x @ tp, t(labels).long(), chunk)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(wl), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(wh), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(wp), atol=1e-5, rtol=0)
    # the unchunked loss of the same logits
    full = topt.cross_entropy_shifted(t(h) @ t(proj), t(labels).long())
    np.testing.assert_allclose(float(loss.detach()), float(full), rtol=1e-6)


def test_chunked_cross_entropy_promotes_bf16_hidden_states():
    """A bf16 h against the tiny OPT's float32 tied head (`logits`): the
    product in float32 (jnp's rule)."""
    port = topt.OptForCausalLM(torch_opt_config(tiny_opt("perlin")), device="cpu", seed=SEED)
    w = port.model.embed_tokens.weight.detach()
    V, E = w.shape
    rng = np.random.default_rng(1)
    h = jnp.asarray(rng.standard_normal((1, 12, E)), jnp.bfloat16)
    labels = _labels(rng.integers(0, V, (1, 12)), 1)
    want = jopt.chunked_cross_entropy_shifted(h, jnp.asarray(w.numpy().T), jnp.asarray(labels), 5)
    with torch.no_grad():
        got = topt.chunked_cross_entropy_shifted(
            t(h.astype(jnp.float32)).bfloat16(), port.logits, t(labels).long(), 5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_model(family, T=16):
    """(JAX model, its loop-layout variables on the host, ids, mask) for the
    tiny OPT or `llama_tiny`, 2 x 16 tokens or 1 x T, built once a module
    run."""
    if family == "opt":
        model = jopt.OptForCausalLM(tiny_opt("perlin"))
    else:
        model = jl.LlamaForCausalLM(jl.llama_tiny("perlin"))
    ids, mask = make_batch(N=2 if T == 16 else 1, T=T, vocab=model.cfg.vocab_size)
    variables = jax.device_get(jax.jit(lambda: model.init(jax.random.key(0), ids, mask))())
    return model, variables, ids, mask


def _port(family, cfg, variables):
    """The port's model of the JAX config `cfg`, on `variables`' weights."""
    if family == "opt":
        port = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None)
    else:
        port = tl.LlamaForCausalLM(torch_llama_config(cfg), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(variables))
    return port


def _model_pair(family):
    """(JAX model, its variables, the port's model on the same weights, ids,
    mask) for the tiny OPT or `llama_tiny`."""
    model, variables, ids, mask = _jax_model(family)
    return model, variables, _port(family, model.cfg, variables), ids, mask


@pytest.mark.parametrize("family", ["opt", "llama"])
def test_model_logit_chunk_matches_jax_and_unchunked(family):
    model, variables, port, ids, mask = _model_pair(family)
    labels = _labels(np.asarray(ids), 3)
    want = jax.jit(lambda v: model.apply(v, ids, mask, labels=jnp.asarray(labels),
                                         logit_chunk=5))(variables)
    assert want["logits"] is None
    tids, tmask, tlab = t(ids).long(), t(mask).long(), t(labels).long()
    out = port(tids, tmask, labels=tlab, logit_chunk=5)
    assert out["logits"] is None
    np.testing.assert_allclose(float(out["loss"]), float(want["loss"]), rtol=1e-5)
    out["loss"].backward()
    chunked = {n: p.grad.clone() for n, p in port.named_parameters() if p.grad is not None}
    port.zero_grad(set_to_none=True)
    full = port(tids, tmask, labels=tlab)
    full["loss"].backward()
    np.testing.assert_allclose(float(out["loss"]), float(full["loss"]), rtol=1e-6)
    grads = {n: p.grad for n, p in port.named_parameters() if p.grad is not None}
    assert chunked.keys() == grads.keys()
    for n, g in grads.items():
        np.testing.assert_allclose(chunked[n].numpy(), g.numpy(), atol=1e-5, rtol=0, err_msg=n)


# ---------------------------------------------------------------------------
# The scan-layout trees and the scanned stack


def test_stack_unstack_match_jax():
    model = jopt.OptForCausalLM(tiny_opt("perlin"))
    ids, mask = make_batch(N=1, T=16)
    variables = jax.device_get(jax.jit(lambda: model.init(jax.random.key(0), ids, mask))())
    L = model.cfg.num_layers
    for coll in ("params", "performer"):
        want = jopt.stack_layer_params(variables[coll], L)
        got = stack_layer_params(variables[coll], L)
        wl, gl = jax.tree_util.tree_leaves_with_path(want), jax.tree_util.tree_leaves_with_path(got)
        assert [jax.tree_util.keystr(p) for p, _ in wl] == [jax.tree_util.keystr(p) for p, _ in gl]
        for (p, a), (_, b) in zip(wl, gl):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                          err_msg=jax.tree_util.keystr(p))
        back = unstack_layer_params(got, L)
        want_back = jopt.unstack_layer_params(want, L)
        for a, b, c in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want_back),
                           jax.tree_util.tree_leaves(variables[coll])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
    # the scan-layout tree reads into the same state dict as the loop layout
    sd_loop = state_dict_from_jax(variables)
    sd_scan = state_dict_from_jax(_scan_vars(variables, L))
    assert sd_loop.keys() == sd_scan.keys()
    for n in sd_loop:
        assert torch.equal(sd_loop[n], sd_scan[n]), n


@functools.lru_cache(maxsize=None)
def _jax_scanned(family, T=16, benchmarking=False):
    """JAX's scanned model (`scan_benchmarking=benchmarking`) on
    `_jax_model`'s weights in the scan layout: (its logits, that tree, its
    config)."""
    loop, variables, ids, mask = _jax_model(family, T)
    cfg = dataclasses.replace(loop.cfg, scan_layers=True, scan_benchmarking=benchmarking)
    model = type(loop)(cfg)
    v_scan = _scan_vars(variables, cfg.num_layers)
    want = jax.jit(lambda v: model.apply(v, ids, mask, benchmarking=benchmarking)["logits"])(v_scan)
    return np.asarray(want), v_scan, cfg


@pytest.mark.parametrize("remat", [False, True], ids=["scan", "scan_remat"])
@pytest.mark.parametrize("family", ["opt", "llama"])
def test_scanned_logits_match_jax(family, remat):
    """JAX's scanned model against the port's, scanned with and without
    `scan_remat` (remat changes no forward value), weights from the
    scan-layout tree; the port's scanned forward, run under grad so that
    remat checkpoints each layer, equals its loop forward bit for bit."""
    _, _, port_loop, ids, mask = _model_pair(family)
    want, v_scan, cfg = _jax_scanned(family)
    port = _port(family, dataclasses.replace(cfg, scan_remat=remat), v_scan)
    tids, tmask = t(ids).long(), t(mask).long()
    got = port(tids, tmask)["logits"]
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5, rtol=0)
    assert torch.equal(got, port_loop(tids, tmask)["logits"])
    with pytest.raises(ValueError, match="plain forward"):
        port(tids, tmask, output_hidden_states=True)


@pytest.mark.parametrize("family", ["opt", "llama"])
def test_scan_benchmarking_matches_jax(family, monkeypatch):
    """`scan_benchmarking` (tests/test_scan_layers.py:50): every scanned layer
    runs the fused benchmark path whatever the caller passes, K1's plain
    version once a layer; logits against JAX's scanned benchmark forward
    2e-5 abs, and equal to the port's loop benchmark forward bit for bit."""
    T = 64  # a length the fused path takes (the JAX test's)
    loop, variables, ids, mask = _jax_model(family, T)
    want, v_scan, cfg = _jax_scanned(family, T, benchmarking=True)
    port = _port(family, cfg, v_scan)
    calls = []
    real = tb.dense_reference
    monkeypatch.setattr(tb, "dense_reference", lambda *a, **k: calls.append(1) or real(*a, **k))
    tids, tmask = t(ids).long(), t(mask).long()
    with torch.no_grad():
        got = port(tids, tmask)["logits"]
        assert len(calls) == cfg.num_layers
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
        port_loop = _port(family, loop.cfg, variables)
        assert torch.equal(got, port_loop(tids, tmask, benchmarking=True)["logits"])


@pytest.mark.parametrize("family", ["opt", "llama"])
def test_remat_step_equals_plain_step_bit_for_bit(family, monkeypatch):
    """The fused train step (`use_fused_train`) of the loop model, the scanned
    model and the scanned model under remat: the same loss and gradients bit
    for bit; under remat K2 runs twice a layer (the recompute), K3 and K4
    once."""
    T = 128
    ids = torch.randint(0, 64, (1, T), generator=torch.Generator().manual_seed(SEED))
    fwd_calls = []
    real = tb.fwd_with_stats_reference
    monkeypatch.setattr(tb, "fwd_with_stats_reference",
                        lambda *a, **k: fwd_calls.append(1) or real(*a, **k))
    results = {}
    for name, kw in (("loop", {}), ("scan", dict(scan_layers=True)),
                     ("remat", dict(scan_layers=True, scan_remat=True))):
        if family == "opt":
            cfg = dataclasses.replace(torch_opt_config(_tiny_opt_cfg()), **kw)
            model = topt.OptForCausalLM(cfg, device="cpu", seed=SEED)
        else:
            cfg = tl.llama_tiny()
            cfg = dataclasses.replace(
                cfg, vocab_size=64, sea=dataclasses.replace(cfg.sea, use_fused_train=True), **kw)
            model = tl.LlamaForCausalLM(cfg, device="cpu", seed=SEED)
        fwd_calls.clear()
        out = model(ids, torch.ones_like(ids), labels=ids, training=True)
        loss = out["loss"] + 0.0 * out["aux_loss"]
        loss.backward()
        results[name] = (loss.detach(), len(fwd_calls),
                         {n: p.grad for n, p in model.named_parameters()})
    L = 2
    assert [results[n][1] for n in ("loop", "scan", "remat")] == [L, L, 2 * L]
    for name in ("scan", "remat"):
        assert torch.equal(results[name][0], results["loop"][0]), name
        for n, g in results["loop"][2].items():
            g2 = results[name][2][n]
            assert (g is None) == (g2 is None), (name, n)
            assert g is None or torch.equal(g, g2), (name, n)


def test_fused_scan_remat_step_matches_jax():
    """The tiny OPT with use_fused_train under `scan_layers` and `scan_remat`
    (JAX's `nn.remat` scan; the scanned body runs the fused train path):
    loss and every gradient against `jax.value_and_grad`."""
    cfg = dataclasses.replace(_tiny_opt_cfg(), scan_layers=True, scan_remat=True)
    T = 128
    rng = np.random.default_rng(SEED)
    ids = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, T)), jnp.int32)
    am = jnp.ones((1, T), jnp.int32)
    model = jopt.OptForCausalLM(cfg)
    variables = jax.jit(model.init)(jax.random.key(SEED), ids, am)

    def loss_fn(params):
        out = model.apply({**variables, "params": params}, ids, am, labels=ids,
                          training=True)
        return out["loss"] + 0.0 * out["aux_loss"]

    wl, wg = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    port = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(variables))
    out = port(t(ids).long(), t(am).long(), labels=t(ids).long(), training=True)
    loss = out["loss"] + 0.0 * out["aux_loss"]
    loss.backward()
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
    want = state_dict_from_jax({"params": wg})
    names = dict(port.named_parameters())
    assert set(names) == set(want)
    for n, p in names.items():
        w = want[n].numpy()
        if p.grad is None:
            np.testing.assert_array_equal(w, np.zeros_like(w), err_msg=n)
        else:
            np.testing.assert_allclose(p.grad.numpy(), w, err_msg=n, **MODEL_TOL)


# ---------------------------------------------------------------------------
# The scanned decode helpers and the long-context script


def test_scan_decode_helpers_match_jax():
    cfg = dataclasses.replace(tiny_opt("perlin"), num_layers=3)
    N, P, STEPS, MAXLEN = 2, 6, 5, 32
    ids, mask = make_batch(N=N, T=P, vocab=cfg.vocab_size, seed=9)
    model = jopt.OptForCausalLM(cfg)
    v_loop = jax.jit(lambda: model.init(jax.random.key(0), ids, mask))()
    scan_cfg = dataclasses.replace(cfg, scan_layers=True)
    scan_model = jopt.OptForCausalLM(scan_cfg)
    v_scan = _scan_vars(jax.device_get(v_loop), cfg.num_layers)
    want_toks = jax.jit(
        lambda v: jopt.scan_generate_greedy(scan_model, v, ids, MAXLEN, STEPS))(v_scan)
    want_logits, want_states = jax.jit(
        lambda v: jopt.scan_prefill_parallel(scan_model, v, ids, MAXLEN))(v_scan)
    nxt = jnp.argmax(want_logits[:, -1], -1).astype(jnp.int32)[:, None]
    want_l2, want_s2 = jax.jit(
        lambda v, sts: jopt.scan_decode_step(scan_model, v, nxt, P, sts))(v_scan, want_states)

    port = topt.OptForCausalLM(torch_opt_config(scan_cfg), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(v_scan))
    tids = t(ids).long()
    toks = topt.scan_generate_greedy(port, tids, MAXLEN, STEPS)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want_toks))
    logits, states = topt.scan_prefill_parallel(port, tids, MAXLEN)
    np.testing.assert_allclose(logits[:, -1].numpy(), np.asarray(want_logits[:, -1]), atol=2e-5)

    def same_states(got, want):
        assert len(got) == len(want)
        for name, g, w in zip(got._fields, got, want):
            assert g.shape == w.shape and g.shape[0] == cfg.num_layers, name
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                       atol=1e-5, rtol=0, err_msg=name)

    same_states(states, want_states)
    l2, s2 = topt.scan_decode_step(port, t(nxt).long(), P, states)
    np.testing.assert_allclose(l2.numpy(), np.asarray(want_l2), atol=2e-5)
    same_states(s2, want_s2)


def test_longctx_main_with_logit_chunk(capsys):
    longctx.main(["--device", "cpu", "--t", "64", "--layers", "2", "--steps", "2",
                  "--logit-chunk", "16"])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["t"] == 64 and len(record["losses"]) == 2
    assert np.isfinite(record["losses"]).all()
    model = longctx.longctx_model(64, 2, "cpu", remat=True)
    assert model.cfg.scan_layers and model.cfg.scan_remat and model.cfg.sea.use_fused_train
