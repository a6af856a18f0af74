"""Port parity: the SEA decode cache and OPT generation
(sea_tpu_torch.models.state, SeaAttention.decode / decode_paged /
prefill_state, OptForCausalLM's decode, prefill and generation loops, the
performer's carried state) against the JAX package's, at the configurations
of tests/test_decode_cache.py (`small_cfg(causal=True, use_cache=True)`) and
tests/test_opt_kd.py (`tiny_opt("perlin")`). Weights pass through
`state_dict_from_jax`; inputs come from numpy seeds; the port runs float32
on the CPU (K1's plain version on the prefill).

Tolerances: the state ops bit for bit where both sides do the same float
operations in the same order (the window push, the running average, the
row resets and selects, int8 quantisation), 1e-6 where a sum is reordered
(the FAVOR+ step and the chunked linear attention); a decode step's output
and every state field 1e-5 against JAX (float32 einsums in another order;
rows whose top-k cut is a near tie on JAX's side are refused by the guard of
tests/_torch_parity.py); logits 1e-5, greedy and beam tokens exactly, beam
scores 1e-5. The port's decode against its own forward at the JAX tests'
bounds: 5e-3 (1e-3 on the first 8 rows) for the attention, 2e-2 with argmax
agreement 1.0 for OPT's logits.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.models import state as jstate
from sea_tpu.models.attention import SeaAttention as JaxSeaAttention
from sea_tpu.models.opt import OptForCausalLM as JaxOpt
from sea_tpu.ops.performer import causal_linear_attention as jax_cla
from sea_tpu.utils.profiler import get_bench as jax_bench
from sea_tpu_torch.models import state as tstate
from sea_tpu_torch.models.attention import SeaAttention
from sea_tpu_torch.models.opt import OptForCausalLM
from sea_tpu_torch.ops.performer import causal_linear_attention
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import assert_topk_margin, t, torch_opt_config, torch_sea_config
from tests.test_attention import make_inputs, small_cfg
from tests.test_opt_kd import make_batch, tiny_opt

ATOL = 1e-5
STATE_ATOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models: under the suite's parallel workers torch's intra-op
    threads only contend, so each test runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_state_close(got, want, atol, msg=""):
    for name, g, w in zip(tstate.SeaDecodeState._fields, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (msg, name, tuple(g.shape), w.shape)
        np.testing.assert_allclose(g.numpy(), w, atol=atol, err_msg=f"{msg} {name}")


# ---------------------------------------------------------------------------
# state ops


def random_state(rng, N=3, H=2, M=5, D=4, C=4, Wd=3, S=6):
    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return jstate.SeaDecodeState(
        performer_S=f(N, H, M, 2 * D), performer_z=np.abs(f(N, H, M)),
        cnn_window=f(N, C, tstate.CNN_WINDOW, Wd),
        cnn_filled=rng.integers(0, 25, (N,)).astype(np.int32),
        cumavg_sum=f(N, H, 1, D), cumavg_len=rng.integers(0, 9, (N,)).astype(np.int32),
        k_cache=f(N, H, S, D), v_cache=f(N, H, S, D),
        length=np.asarray(4, np.int32),
    )


def to_torch(state):
    return tstate.SeaDecodeState(*(t(x) for x in state))


def test_init_decode_state_matches_jax():
    got = tstate.init_decode_state(2, 3, 8, 11, 16, 2, 4, 20, device="cpu")
    want = jstate.init_decode_state(2, 3, 8, 11, 16, 2, 4, 20)
    for name, g, w in zip(tstate.SeaDecodeState._fields, got, want):
        assert g.dtype == t(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_performer_decode_step_matches_jax():
    rng = np.random.default_rng(0)
    N, H, M, Dv = 2, 3, 7, 8
    S = rng.standard_normal((N, H, M, Dv)).astype(np.float32)
    z = np.abs(rng.standard_normal((N, H, M))).astype(np.float32)
    qp, kp = (np.abs(rng.standard_normal((N, H, 1, M))).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((N, H, 1, Dv)).astype(np.float32)
    got = tstate.performer_decode_step(t(S), t(z), t(qp), t(kp), t(v))
    want = jstate.performer_decode_step(S, z, qp, kp, v)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=STATE_ATOL)


def test_window_push_and_running_average_match_jax():
    rng = np.random.default_rng(1)
    st = random_state(rng)
    row = rng.standard_normal((3, 4, 1, 3)).astype(np.float32)
    for filled in (st.cnn_filled, np.asarray(23, np.int32), np.asarray(24, np.int32)):
        got = tstate.cnn_window_push(t(st.cnn_window), t(filled), t(row))
        want = jstate.cnn_window_push(st.cnn_window, filled, row)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    v = rng.standard_normal((3, 2, 1, 4)).astype(np.float32)
    for n in (st.cumavg_len, np.asarray(5, np.int32)):  # per slot and lockstep
        got = tstate.cumavg_step(t(st.cumavg_sum), t(n), t(v))
        want = jstate.cumavg_step(st.cumavg_sum, n, v)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_reset_and_select_rows_match_jax():
    rng = np.random.default_rng(2)
    new, old = random_state(rng), random_state(rng)
    rows = np.asarray([True, False, True])
    got = tstate.reset_state_rows(to_torch(new), t(rows))
    assert_state_close(got, jstate.reset_state_rows(new, rows), 0.0, "reset")
    got = tstate.select_state_rows(to_torch(new), to_torch(old), t(rows))
    assert_state_close(got, jstate.select_state_rows(new, old, rows), 0.0, "select")
    # a () field is left alone by the reset and taken from the new state
    assert int(got.length) == 4 and got.k_cache[1].equal(t(old.k_cache[1]))


def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((5, 4, 3, 16)) * rng.uniform(0.01, 10, (5, 4, 3, 1))).astype(
        np.float32)
    x[0, 0, 0] = 0.0  # a zero vector takes the floor scale
    x[1, 1, 1, :4] = [2.54, -2.54, 1.27, 0.635]  # quotients at half-integers
    q, s = tstate.quantize_kv(t(x))
    jq, js = jstate.quantize_kv(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tstate.dequantize_kv(q, s).numpy(), np.asarray(jstate.dequantize_kv(jq, js)))


def test_causal_linear_attention_carries_state():
    """state= and return_state= against JAX (1e-6), and two halves chained
    through the state equal to the whole."""
    rng = np.random.default_rng(4)
    N, H, T, M, Dv = 2, 2, 300, 12, 8
    # features of the ReLU kernel's size (relu(w·x/d^¼) + 1e-3 on q, k of
    # scale 0.5), so that the 300-row sums stay O(1)
    qp, kp = (np.abs(rng.standard_normal((N, H, T, M)) * 0.1).astype(np.float32)
              for _ in range(2))
    v = rng.standard_normal((N, H, T, Dv)).astype(np.float32)
    S0 = np.abs(rng.standard_normal((N, H, M, Dv)) * 0.1).astype(np.float32)
    z0 = np.abs(rng.standard_normal((N, H, M)) * 0.1).astype(np.float32)
    out, (S, z) = causal_linear_attention(t(qp), t(kp), t(v), state=(t(S0), t(z0)),
                                          return_state=True)
    jout, (jS, jz) = jax_cla(qp, kp, v, state=(S0, z0), return_state=True)
    for g, w in ((out, jout), (S, jS), (z, jz)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=STATE_ATOL, rtol=STATE_ATOL)

    whole, (Sw, zw) = causal_linear_attention(t(qp), t(kp), t(v), return_state=True)
    h = 170
    a, st = causal_linear_attention(t(qp[..., :h, :]), t(kp[..., :h, :]), t(v[..., :h, :]),
                                    return_state=True)
    b, (Sb, zb) = causal_linear_attention(t(qp[..., h:, :]), t(kp[..., h:, :]),
                                          t(v[..., h:, :]), state=st, return_state=True)
    for g, w in ((torch.cat([a, b], dim=-2), whole), (Sb, Sw), (zb, zw)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=STATE_ATOL, rtol=STATE_ATOL)


# ---------------------------------------------------------------------------
# SEA attention: decode, prefill_state, decode_paged


def jax_attention(cfg, T, seed=5):
    """tests/test_decode_cache.py's module and inputs; the JAX dense forward's
    estimates checked for near-ties at the top-k cut (the decode's estimate
    of row t is the forward's row t)."""
    inputs = make_inputs(cfg, N=1, T=T, seed=seed)
    q, k, v, mask, truth, ctx_truth = inputs
    model = JaxSeaAttention(cfg)
    params = jax.jit(lambda: model.init(
        jax.random.key(0), q, k, v, q, k, v, q, k, mask,
        attention_scores_truth=truth, context_layer_truth=ctx_truth))()
    bench = jax_bench()
    bench.activate_temp_buffers(True)
    try:
        full = model.apply(params, q, k, v, q, k, v, q, k, mask, benchmarking=False)
        probs = bench.buffers["masked_estimated_attention_probs"]
        budget = bench.buffers["per_item_top_k"]
    finally:
        bench.activate_temp_buffers(False)
    assert_topk_margin(probs, budget)
    port = SeaAttention(torch_sea_config(cfg), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(params))
    return model, params, port, (q, k, v, mask), np.asarray(full.context_layer)


@pytest.fixture(scope="module", params=[16, 40], ids=["T16", "T40"])
def attention(request):
    cfg = small_cfg(causal=True, use_cache=True)
    return (cfg, request.param, *jax_attention(cfg, request.param))


def test_attention_decode_matches_jax(attention):
    """Every step's output and every state field within 1e-5 of JAX's."""
    cfg, T, model, params, port, (q, k, v, mask), _ = attention
    step = jax.jit(lambda p, a, b, c, s: model.apply(
        p, a, b, c, s, method=lambda m, a, b, c, s: m.decode(a, b, c, s)))
    jst = model.apply(params, 1, T, method=lambda m, b, L: m.init_state(b, L))
    st = port.init_state(1, T)
    with torch.no_grad():
        for i in range(T):
            sl = (slice(None), slice(None), slice(i, i + 1))
            jo, jst = step(params, q[sl], k[sl], v[sl], jst)
            o, st = port.decode(t(q[sl]), t(k[sl]), t(v[sl]), st)
            np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL, err_msg=f"step {i}")
            assert_state_close(st, jst, ATOL, f"step {i}")


def test_decode_leaves_its_input_state(attention):
    """Steps are functional: the state a step reads is not written, so a
    caller that keeps it (the engine's frozen slots, beam search's parents)
    keeps it whole; the paged pools are the one thing written in place."""
    cfg, T, _, _, port, (q, k, v, _), _ = attention
    st = port.init_state(1, T)
    with torch.no_grad():
        for i in range(3):
            sl = (slice(None), slice(None), slice(i, i + 1))
            before = [x.clone() for x in st]
            _, new = port.decode(t(q[sl]), t(k[sl]), t(v[sl]), st)
            assert all(a.equal(b) for a, b in zip(st, before)), i
            assert not new.k_cache.equal(st.k_cache)
            st = new


def test_attention_decode_matches_its_forward(attention):
    """The port's decode against its own dense forward, at the JAX test's
    bounds (tests/test_decode_cache.py:13)."""
    cfg, T, _, _, port, (q, k, v, mask), _ = attention
    q, k, v, mask = (t(x) for x in (q, k, v, mask))
    st = port.init_state(1, T)
    outs = []
    with torch.no_grad():
        full = port(q, k, v, q, k, v, q, k, mask, benchmarking=False).context_layer
        for i in range(T):
            o, st = port.decode(q[:, :, i:i + 1], k[:, :, i:i + 1], v[:, :, i:i + 1], st)
            outs.append(o)
    err = (torch.cat(outs, dim=1) - full).abs()
    assert float(err.max()) < 5e-3, float(err.max())
    assert float(err[:, :min(T, 8)].max()) < 1e-3


def test_prefill_state_matches_jax(attention):
    cfg, T, model, params, port, (q, k, v, _), _ = attention
    max_len = T + 8
    want = model.apply(params, q, k, v, max_len,
                       method=lambda m, a, b, c, L: m.prefill_state(a, b, c, L))
    with torch.no_grad():
        got = port.prefill_state(t(q), t(k), t(v), max_len)
    assert_state_close(got, want, ATOL, "prefill_state")


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "int8"])
def test_attention_decode_paged_matches_jax(attention, quant, monkeypatch):
    """decode_paged over a pool whose rows own scattered pages, float32 or
    int8: the output and the pools against JAX's (1e-5; int8 values exact),
    and the float32 pool against the contiguous decode (1e-6).

    The JAX module's int8 branch calls `quantize_kv` and `dequantize_kv`,
    which `sea_tpu/models/attention.py` never imports (a NameError there);
    the test puts `sea_tpu.models.state`'s own two functions into the
    module's namespace for the call, and changes nothing else."""
    from sea_tpu.models import attention as jattention

    monkeypatch.setattr(jattention, "quantize_kv", jstate.quantize_kv, raising=False)
    monkeypatch.setattr(jattention, "dequantize_kv", jstate.dequantize_kv, raising=False)
    cfg, T, model, params, port, (q, k, v, _), _ = attention
    q, k, v = (np.concatenate([x, x[:, :, ::-1]]) for x in (q, k, v))  # N = 2
    N, H, _, D = q.shape
    ps = 8
    mp = -(-T // ps)
    P = 1 + N * mp
    perm = np.random.default_rng(6).permutation(np.arange(1, P))
    pages = perm.reshape(N, mp).astype(np.int32)
    pool = np.zeros((P, ps, H, D), np.float32)
    if quant:
        jpk = jpv = (pool.astype(np.int8), np.zeros((P, ps, H), np.float32))
        pk = tuple(t(x) for x in jpk)
        pv = tuple(t(x) for x in jpv)
    else:
        jpk = jpv = pool
        pk, pv = t(pool), t(pool)
    step = jax.jit(lambda p, a, b, c, s, e, f, g: model.apply(
        p, a, b, c, s, e, f, g,
        method=lambda m, a, b, c, s, e, f, g: m.decode_paged(a, b, c, s, e, f, g)))

    def per_slot(st, z):
        return st._replace(length=z, cnn_filled=z, cumavg_len=z)

    jst = per_slot(model.apply(params, N, 0, method=lambda m, b, L: m.init_state(b, L)),
                   jnp.zeros((N,), jnp.int32))
    st = per_slot(port.init_state(N, 0), torch.zeros((N,), dtype=torch.int32))
    cst = port.init_state(N, T)
    with torch.no_grad():
        for i in range(T):
            sl = (slice(None), slice(None), slice(i, i + 1))
            jo, jst, jpk, jpv = step(params, q[sl], k[sl], v[sl], jst, jpk, jpv, pages)
            o, st, pk, pv = port.decode_paged(t(q[sl]), t(k[sl]), t(v[sl]), st, pk, pv,
                                              t(pages))
            np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL, err_msg=f"step {i}")
            assert_state_close(st, jst, ATOL, f"step {i}")
            if not quant:
                co, cst = port.decode(t(q[sl]), t(k[sl]), t(v[sl]), cst)
                np.testing.assert_allclose(o.numpy(), co.numpy(), atol=STATE_ATOL)
    if quant:
        for g, w in ((pk, jpk), (pv, jpv)):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))
            np.testing.assert_allclose(g[1].numpy(), np.asarray(w[1]), atol=ATOL)
    else:
        for g, w in ((pk, jpk), (pv, jpv)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# OPT: decode_step, prefill_parallel, generation


def jax_opt(seed, N, T):
    cfg = tiny_opt("perlin")
    model = JaxOpt(cfg)
    ids, mask = make_batch(N=N, T=T, vocab=cfg.vocab_size, seed=seed)
    variables = jax.jit(lambda: model.init(jax.random.key(0), ids, mask))()
    port = OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(variables))
    return cfg, model, variables, port, np.asarray(ids)


def jax_greedy(model, variables, ids, max_len, steps, **kw):
    return np.asarray(jax.jit(lambda v: model.apply(
        v, jnp.asarray(ids), max_len, steps,
        method=lambda m, p, L, s: m.generate_greedy(p, L, s, **kw)))(variables))


def jax_beam(model, variables, ids, max_len, steps, **kw):
    toks, scores = jax.jit(lambda v: model.apply(
        v, jnp.asarray(ids), max_len, steps,
        method=lambda m, p, L, s: m.generate_beam(p, L, s, **kw)))(variables)
    return np.asarray(toks), np.asarray(scores)


def test_opt_decode_step_matches_jax_and_forward():
    """tests/test_opt_decode.py:13: decode logits against JAX's (1e-5) and
    against the port's full forward (2e-2, argmax agreement 1.0)."""
    cfg, model, variables, port, ids = jax_opt(3, 1, 12)
    N, T = ids.shape
    step = jax.jit(lambda v, tok, pos, sts: model.apply(
        v, tok, pos, sts, method=lambda m, a, b, c: m.decode_step(a, b, c)))
    jst = model.apply(variables, N, T, method=lambda m, b, L: m.init_decode_states(b, L))
    st = port.init_decode_states(N, T)
    rows = []
    for i in range(T):
        jl, jst = step(variables, jnp.asarray(ids[:, i:i + 1]), jnp.int32(i), jst)
        lg, st = port.decode_step(t(ids[:, i:i + 1]).long(), i, st)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=ATOL, err_msg=f"step {i}")
        rows.append(lg)
    for li, (g, w) in enumerate(zip(st, jst)):
        assert_state_close(g, w, ATOL, f"layer {li}")
    dec = torch.cat(rows, dim=1)
    with torch.no_grad():
        full = port(t(ids).long(), torch.ones((N, T), dtype=torch.long))["logits"]
    assert float((dec - full).abs().max()) < 2e-2
    assert float((dec.argmax(-1) == full.argmax(-1)).float().mean()) == 1.0


def test_prefill_parallel_matches_jax_and_sequential():
    """tests/test_opt_decode.py:139: prefill_parallel's logits and states
    against JAX's (1e-5); its logits against the port's benchmark forward
    (1e-4) and dense forward (5e-3), its states against P sequential steps at
    the JAX test's bounds, and the greedy continuations of both prefills
    equal to each other and to JAX's."""
    cfg, model, variables, port, ids = jax_opt(11, 1, 8)
    N, P = ids.shape
    L, steps = 32, 6
    jl, jst = jax.jit(lambda v: model.apply(
        v, jnp.asarray(ids), L, method=lambda m, p, L: m.prefill_parallel(p, L)))(variables)
    logits, st = port.prefill_parallel(t(ids).long(), L)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=ATOL)
    for li, (g, w) in enumerate(zip(st, jst)):
        assert_state_close(g, w, ATOL, f"layer {li}")
    last, _ = port.prefill_parallel(t(ids).long(), L, last_only=True)
    np.testing.assert_allclose(last.numpy(), logits[:, -1:].numpy(), atol=1e-6)

    am = torch.ones((N, P), dtype=torch.long)
    with torch.no_grad():
        bench = port(t(ids).long(), am, benchmarking=True)["logits"]
        dense = port(t(ids).long(), am)["logits"]
    np.testing.assert_allclose(logits.numpy(), bench.numpy(), atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), dense.numpy(), atol=5e-3)

    seq = port.init_decode_states(N, L)
    for i in range(P):
        _, seq = port.decode_step(t(ids[:, i:i + 1]).long(), i, seq)
    for li, (sp, sq) in enumerate(zip(st, seq)):
        assert int(sp.length) == int(sq.length) == P
        for name, atol in (("performer_S", 1e-4), ("performer_z", 1e-4),
                           ("k_cache", 2e-2), ("cumavg_sum", 2e-2)):
            np.testing.assert_allclose(getattr(sp, name).numpy(), getattr(sq, name).numpy(),
                                       atol=atol, err_msg=f"layer {li} {name}")
        np.testing.assert_allclose(sp.cnn_window[:, :, -P:].numpy(),
                                   sq.cnn_window[:, :, -P:].numpy(), atol=5e-2)

    gen_seq = port.generate_greedy(t(ids).long(), L, steps).numpy()
    gen_par = port.generate_greedy(t(ids).long(), L, steps, parallel_prefill=True).numpy()
    np.testing.assert_array_equal(gen_seq, gen_par)
    np.testing.assert_array_equal(
        gen_par, jax_greedy(model, variables, ids, L, steps, parallel_prefill=True))


def test_generate_greedy_matches_jax_and_step_loop():
    """tests/test_opt_decode.py:42: greedy tokens equal to JAX's, and to a
    loop of decode_step and argmax over the port's own steps."""
    cfg, model, variables, port, ids = jax_opt(7, 2, 6)
    N, P = ids.shape
    L, steps = 32, 5
    got = port.generate_greedy(t(ids).long(), L, steps)
    assert got.shape == (N, steps) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), jax_greedy(model, variables, ids, L, steps))
    st = port.init_decode_states(N, L)
    for i in range(P):
        logits, st = port.decode_step(t(ids[:, i:i + 1]).long(), i, st)
    loop = []
    for i in range(steps):
        nxt = logits[:, -1].argmax(-1)[:, None]
        loop.append(nxt)
        logits, st = port.decode_step(nxt, P + i, st)
    np.testing.assert_array_equal(got.numpy(), torch.cat(loop, dim=1).numpy())


def test_beam_search_width1_is_greedy():
    """tests/test_opt_decode.py:82: beam_size=1 reproduces greedy, beams
    come best first, and the best of 4 scores at least the one beam."""
    cfg, _, _, port, _ = jax_opt(0, 1, 6)
    prompt = torch.tensor(np.random.default_rng(4).integers(4, cfg.vocab_size, (1, 6)))
    L, steps = 32, 6
    greedy = port.generate_greedy(prompt, L, steps)
    beams, scores = port.generate_beam(prompt, L, steps, beam_size=1)
    np.testing.assert_array_equal(beams[:, 0].numpy(), greedy.numpy())
    beams4, scores4 = port.generate_beam(prompt, L, steps, beam_size=4)
    assert beams4.shape == (1, 4, steps)
    s4 = scores4.numpy()
    assert (np.diff(s4, axis=-1) <= 1e-6).all()
    assert s4[0, 0] >= float(scores[0, 0]) - 1e-6


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_batched_beam_search_matches_jax(parallel):
    """tests/test_opt_decode.py:114 and :258: batched beams' tokens equal to
    JAX's and their scores within 1e-5, each batch row independent (a
    permuted batch permutes the beams), either prefill."""
    cfg, model, variables, port, _ = jax_opt(0, 1, 5)
    prompt = np.random.default_rng(7).integers(4, cfg.vocab_size, (3, 5))
    L, steps, B = 24, 4, 3
    toks, scores = port.generate_beam(t(prompt).long(), L, steps, beam_size=B,
                                      parallel_prefill=parallel)
    assert toks.shape == (3, B, steps) and scores.shape == (3, B)
    jt, js = jax_beam(model, variables, prompt, L, steps, beam_size=B,
                      parallel_prefill=parallel)
    np.testing.assert_array_equal(toks.numpy(), jt)
    np.testing.assert_allclose(scores.numpy(), js, atol=ATOL)
    perm = [2, 0, 1]
    toks_p, _ = port.generate_beam(t(prompt[perm]).long(), L, steps, beam_size=B,
                                   parallel_prefill=parallel)
    np.testing.assert_array_equal(toks_p.numpy(), toks.numpy()[perm])


def test_decode_refuses_without_the_cache():
    cfg = dataclasses.replace(tiny_opt("perlin"), sea=dataclasses.replace(
        tiny_opt("perlin").sea, use_cache=False))
    port = OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=0)
    with pytest.raises(ValueError, match="use_cache"):
        port.generate_greedy(torch.tensor([[5, 6, 7]]), 16, 2)
    dense = OptForCausalLM(torch_opt_config(tiny_opt("none")), device="cpu", seed=0)
    with pytest.raises(NotImplementedError, match="perlin"):
        dense.init_decode_states(1, 16)
