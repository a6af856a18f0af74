"""Port parity and behaviour: paged decode and the continuous-batching engine
(sea_tpu_torch.serving), ports of tests/test_serving.py and
tests/test_sampling.py:189 at `tiny_opt("perlin")` on weights converted
from the JAX model.

Tolerances: paged decode's logits within 1e-6 of the port's contiguous
decode and 1e-5 of JAX's paged decode (float32 einsums in another order);
every engine output token for token: equal to per-request
`generate_greedy`, to chunked runs, and to the JAX engine's on the same
requests and weights, float32 and (a model cast to bf16) with bf16 pools
and states, and head-sharded over two tensor-parallel positions.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.models.opt import OptForCausalLM as JaxOpt
from sea_tpu.serving import ServingEngine as JaxEngine
from sea_tpu_torch.models.opt import OptForCausalLM
from sea_tpu_torch.parallel.tp import make_tp_mesh, tensor_parallel
from sea_tpu_torch.serving import PageAllocator, ServingEngine
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import t, torch_opt_config
from tests.test_opt_kd import make_batch, tiny_opt


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_model(seed=0, N=1, T=12):
    """tests/test_serving.py's `_tiny_model`, and the port on its weights."""
    cfg = tiny_opt("perlin")
    model = JaxOpt(cfg)
    ids, mask = make_batch(N=N, T=T, vocab=cfg.vocab_size, seed=seed)
    variables = jax.jit(lambda: model.init(jax.random.key(0), ids, mask))()
    port = OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(variables))
    return cfg, model, variables, port, np.asarray(ids)


def engine(port, **kw):
    return ServingEngine(port, device="cpu", **kw)


def solo_greedy(port, prompt, max_len, steps):
    return port.generate_greedy(torch.tensor([prompt]), max_len, steps)[0].tolist()


def test_paged_decode_matches_contiguous_and_jax():
    """decode_step_paged against decode_step at every position (1e-6) and
    against JAX's decode_step_paged (1e-5), rows at their own positions."""
    cfg, model, variables, port, ids = tiny_model(seed=11, N=2, T=10)
    N, T = ids.shape
    ps, mp = 4, 4
    L, H, D = cfg.num_layers, cfg.sea.num_heads, cfg.sea.head_dim
    pages = np.asarray([[1 + n * mp + i for i in range(mp)] for n in range(N)], np.int32)
    pool = np.zeros((L, 1 + N * mp, ps, H, D), np.float32)
    jpk = jpv = jnp.asarray(pool)
    pk, pv = t(pool), t(pool)
    jst = model.apply(variables, N, 0, method=lambda m, b, ml: m.init_decode_states(b, ml))
    step_p = jax.jit(lambda v, tok, pos, sts, a, b, pg: model.apply(
        v, tok, pos, sts, a, b, pg,
        method=lambda m, a, b, c, d, e, f: m.decode_step_paged(a, b, c, d, e, f)))
    st_c = port.init_decode_states(N, T)
    st_p = port.init_decode_states(N, 0)
    for i in range(T):
        tok = t(ids[:, i:i + 1]).long()
        lc, st_c = port.decode_step(tok, i, st_c)
        lp, st_p, pk, pv = port.decode_step_paged(tok, torch.full((N,), i), st_p, pk, pv,
                                                  t(pages))
        jl, jst, jpk, jpv = step_p(variables, jnp.asarray(ids[:, i:i + 1]),
                                   jnp.full((N,), i, jnp.int32), jst, jpk, jpv, pages)
        assert float((lc - lp).abs().max()) < 1e-6, i
        np.testing.assert_allclose(lp.numpy(), np.asarray(jl), atol=1e-5, err_msg=f"step {i}")
    np.testing.assert_allclose(pk.numpy(), np.asarray(jpk), atol=1e-5)


def test_engine_matches_generate_greedy():
    """3 staggered requests of different lengths through the engine, each
    equal to its prompt's generate_greedy alone."""
    cfg, _, _, port, _ = tiny_model(seed=5)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(4, cfg.vocab_size, size=p).tolist() for p in (3, 6, 4)]
    expected = [solo_greedy(port, p, 32, 5) for p in prompts]
    eng = engine(port, max_slots=2, page_size=4, num_pages=32, max_pages_per_slot=8)
    rids = [eng.submit(prompts[0], 5), eng.submit(prompts[1], 5)]
    eng.step()
    eng.step()
    rids.append(eng.submit(prompts[2], 5))  # arrives mid-flight
    out = eng.run()
    for rid, exp in zip(rids, expected):
        assert out[rid].output == exp, (rid, out[rid].output, exp)


def test_engine_page_stall_and_recycling():
    """A pool too small for every slot at once: slots stall on allocation,
    finish anyway with the solo tokens, and every page comes back."""
    cfg, _, _, port, _ = tiny_model(seed=9)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(4, cfg.vocab_size, size=4).tolist() for _ in range(3)]
    # 5 usable pages of 4 tokens; a request needs ceil(9 / 4) = 3
    eng = engine(port, max_slots=2, page_size=4, num_pages=6, max_pages_per_slot=3)
    rids = [eng.submit(p, 5) for p in prompts]
    out = eng.run(max_steps=500)
    assert sorted(out) == sorted(rids)
    assert all(len(out[r].output) == 5 for r in rids)
    assert eng.allocator.available == 5
    for rid, p in zip(rids, prompts):
        assert out[rid].output == solo_greedy(port, p, 16, 5)


def test_engine_eos_and_temperature():
    cfg, _, _, port, _ = tiny_model(seed=3)
    prompt = [5, 6, 7]
    greedy = solo_greedy(port, prompt, 32, 8)
    eos = greedy[2]  # the third greedy token plays EOS
    eng = engine(port, max_slots=2, page_size=4, num_pages=16, max_pages_per_slot=4,
                 eos_id=eos)
    rid = eng.submit(prompt, 8)
    rid_t = eng.submit(prompt, 6, temperature=1.0)
    out = eng.run()
    assert out[rid].output == greedy[:greedy.index(eos) + 1]
    assert 1 <= len(out[rid_t].output) <= 6
    assert all(0 <= tok < cfg.vocab_size for tok in out[rid_t].output)


def test_chunked_equals_stepwise():
    """chunk=4 gives chunk=1's outputs, prompt-to-decode transitions and a
    mid-chunk EOS included."""
    cfg, _, _, port, _ = tiny_model(seed=21)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(4, cfg.vocab_size, size=p).tolist() for p in (3, 7, 5)]

    def run_with(chunk):
        eng = engine(port, max_slots=2, page_size=4, num_pages=32, max_pages_per_slot=8)
        rids = [eng.submit(p, 6) for p in prompts]
        out = eng.run(chunk=chunk)
        return [out[r].output for r in rids]

    solo = run_with(1)
    assert solo == run_with(4)
    eos = solo[0][1]
    eng = engine(port, max_slots=1, page_size=4, num_pages=32, max_pages_per_slot=8,
                 eos_id=eos)
    rid = eng.submit(prompts[0], 6)
    out = eng.run(chunk=4)
    assert out[rid].output == solo[0][:solo[0].index(eos) + 1]


def test_chunked_stall_and_truncation():
    cfg, _, _, port, _ = tiny_model(seed=23)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(4, cfg.vocab_size, size=4).tolist() for _ in range(3)]
    eng = engine(port, max_slots=2, page_size=4, num_pages=6, max_pages_per_slot=3)
    rids = [eng.submit(p, 5) for p in prompts]
    out = eng.run(max_steps=500, chunk=3)
    assert sorted(out) == sorted(rids)
    assert eng.allocator.available == 5
    for rid, p in zip(rids, prompts):
        assert out[rid].output == solo_greedy(port, p, 16, 5)
    # capacity 8, prompt 4: 5 tokens, whatever the chunk
    eng = engine(port, max_slots=1, page_size=4, num_pages=8, max_pages_per_slot=2)
    rid = eng.submit([3, 4, 5, 6], 32)
    out = eng.run(max_steps=100, chunk=4)
    assert out[rid].truncated and len(out[rid].output) == 5


def test_page_allocator():
    a = PageAllocator(5)  # pages 1..4
    got = [a.alloc() for _ in range(4)]
    assert sorted(got) == [1, 2, 3, 4]
    assert a.alloc() is None
    a.release([2, 4])
    assert a.available == 2
    assert a.alloc() in (2, 4)


def test_capacity_truncation():
    """The step at the last cache position still emits a token, so a
    truncated request holds capacity − prompt + 1 tokens."""
    _, _, _, port, _ = tiny_model(seed=7)
    eng = engine(port, max_slots=1, page_size=4, num_pages=8, max_pages_per_slot=2)
    rid = eng.submit([3, 4, 5, 6], 32)
    out = eng.run(max_steps=100)
    assert out[rid].truncated and len(out[rid].output) == 8 - 4 + 1


def test_engine_top_k1_matches_greedy_request():
    """tests/test_sampling.py:189: a top_k = 1 sampled request and a greedy
    one on the same prompt give the same tokens in one engine."""
    _, _, _, port, _ = tiny_model()
    eng = engine(port, max_slots=2, page_size=8, num_pages=16, max_pages_per_slot=4)
    rid_g = eng.submit([3, 5, 7], 6)
    rid_s = eng.submit([3, 5, 7], 6, temperature=1.0, top_k=1)
    fin = eng.run()
    assert fin[rid_g].output == fin[rid_s].output


def test_engine_matches_jax_engine():
    """The JAX engine and the port's on the same requests, weights and
    schedule (2 slots, staggered, chunk 3): the same greedy tokens."""
    cfg, model, variables, port, _ = tiny_model(seed=31)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(4, cfg.vocab_size, size=p).tolist() for p in (3, 6, 5)]
    kw = dict(max_slots=2, page_size=4, num_pages=32, max_pages_per_slot=8)
    outs = []
    for eng in (JaxEngine(model, variables, **kw), engine(port, **kw)):
        rids = [eng.submit(p, 5) for p in prompts]
        outs.append([r.output for r in map(eng.run(chunk=3).get, rids)])
    assert outs[0] == outs[1]


def test_engine_refuses_a_mesh():
    """The head-sharded engine (`mesh=`): over a tensor-parallel model
    (tp = 2 LocalGroup positions) its pools and states hold each position's
    heads, and the requests and schedule of `test_engine_matches_jax_engine`
    give the JAX engine's tokens; a model that is not tensor parallel over
    the engine's group is refused."""
    cfg, model, variables, port, _ = tiny_model(seed=31)
    mesh = make_tp_mesh(dp=1, tp=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="tensor parallel"):
        ServingEngine(port, device="cpu", mesh=mesh)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(4, cfg.vocab_size, size=p).tolist() for p in (3, 6, 5)]
    kw = dict(max_slots=2, page_size=4, num_pages=32, max_pages_per_slot=8)
    sharded = engine(tensor_parallel(copy.deepcopy(port), mesh), mesh=mesh, **kw)
    H, D = cfg.sea.num_heads, cfg.sea.head_dim
    assert [tuple(p.shape) for p in sharded.pool_k] == [(cfg.num_layers, 32, 4, H // 2, D)] * 2
    assert all(st.cnn_window.shape[1] == cfg.sea.splits * H // 2 for sts in sharded.states
               for st in sts)
    outs = []
    for eng in (JaxEngine(model, variables, **kw), sharded):
        rids = [eng.submit(p, 5) for p in prompts]
        outs.append([r.output for r in map(eng.run(chunk=3).get, rids)])
    assert outs[0] == outs[1]


def test_bf16_engine_matches_jax_engine():
    """bf16 serving: the tree cast to bf16 and both engines with bf16 pools
    and states (`dtype=`), on the same requests and schedule as
    `test_engine_matches_jax_engine`: the pools and windows bf16, the
    FAVOR+ sums float32, and the same greedy tokens."""
    cfg, model, variables, port, _ = tiny_model(seed=31)
    variables = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        variables)
    port.to(torch.bfloat16)
    port.load_state_dict(state_dict_from_jax(variables))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(4, cfg.vocab_size, size=p).tolist() for p in (3, 6, 5)]
    kw = dict(max_slots=2, page_size=4, num_pages=32, max_pages_per_slot=8)
    ours = engine(port, dtype=torch.bfloat16, **kw)
    assert ours.pool_k.dtype == torch.bfloat16
    assert all(st.cnn_window.dtype == torch.bfloat16 and st.performer_S.dtype == torch.float32
               for st in ours.states)
    outs = []
    for eng in (JaxEngine(model, variables, dtype=jnp.bfloat16, **kw), ours):
        rids = [eng.submit(p, 5) for p in prompts]
        outs.append([r.output for r in map(eng.run(chunk=3).get, rids)])
    assert outs[0] == outs[1]
