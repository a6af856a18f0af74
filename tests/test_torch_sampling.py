"""Port parity: token sampling (sea_tpu_torch.ops.sampling) and
`OptForCausalLM.generate_sample` against the JAX package's
(`sea_tpu.ops.sampling`, tests/test_sampling.py:15-160).

Tolerances: filtered logits equal to JAX's bit for bit (the same float
operations; -inf where JAX has -inf); sampled ids equal to JAX's when the
port is given JAX's own Gumbel draws (`jax.random.gumbel` of the same key,
which is what `jax.random.categorical` adds); generated tokens exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.models.opt import OptForCausalLM as JaxOpt
from sea_tpu.ops import sampling as jsampling
from sea_tpu_torch.models.opt import OptForCausalLM
from sea_tpu_torch.ops.sampling import filter_logits, gumbel_noise, sample_logits
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import t, torch_opt_config
from tests.test_opt_kd import make_batch, tiny_opt


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def filtered_both(logits, **kw):
    """The port's and JAX's filter_logits on the same logits."""
    jkw = {n: jnp.asarray(v) if isinstance(v, np.ndarray) else v for n, v in kw.items()}
    tkw = {n: t(v) if isinstance(v, np.ndarray) else v for n, v in kw.items()}
    got = filter_logits(t(logits), **tkw).numpy()
    want = np.asarray(jsampling.filter_logits(jnp.asarray(logits), **jkw))
    np.testing.assert_array_equal(got, want)
    return got


def test_filter_top_k_oracle():
    logits = np.asarray([[1.0, 5.0, 3.0, 2.0, 4.0], [0.0, -1.0, 2.0, 1.0, -2.0]], np.float32)
    out = filtered_both(logits, top_k=2)
    assert np.isfinite(out[0, [1, 4]]).all() and np.isneginf(out[0, [0, 2, 3]]).all()
    assert np.isfinite(out[1, [2, 3]]).all() and np.isneginf(out[1, [0, 1, 4]]).all()
    assert np.isfinite(filtered_both(logits, top_k=0)).all()


def test_filter_top_p_oracle():
    logits = np.log(np.asarray([0.5, 0.3, 0.15, 0.05], np.float32))[None, :]
    # prefix mass before each token [0, .5, .8, .95] < 0.7 keeps two, the
    # crossing token included
    out = filtered_both(logits, top_p=0.7)
    assert np.isfinite(out[0, :2]).all() and np.isneginf(out[0, 2:]).all()
    out = filtered_both(logits, top_p=1e-6)
    assert np.isfinite(out[0, 0]) and np.isneginf(out[0, 1:]).all()
    assert np.isfinite(filtered_both(logits, top_p=1.0)).all()
    # p = 0 still keeps the argmax
    out = filtered_both(logits, top_p=0.0)
    assert np.isfinite(out[0, 0]) and np.isneginf(out[0, 1:]).all()


def test_filter_top_k_then_top_p():
    """top-p's mass on the top-k survivors renormalised: [0.4, 0.35, 0.25]
    with k=2 is [0.533, 0.467], so p=0.5 keeps only the first token."""
    logits = np.log(np.asarray([0.4, 0.35, 0.25], np.float32))[None, :]
    out = filtered_both(logits, top_k=2, top_p=0.5)
    assert np.isfinite(out[0, 0]) and np.isneginf(out[0, 1:]).all()


def test_filter_exact_k_under_ties():
    """All-equal logits still keep exactly k tokens and the exact prefix."""
    logits = np.zeros((2, 8), np.float32)
    assert (np.isfinite(filtered_both(logits, top_k=2)).sum(-1) == 2).all()
    assert (np.isfinite(filtered_both(logits, top_p=0.5)).sum(-1) == 4).all()
    assert (np.isfinite(filtered_both(logits, top_k=3, top_p=0.5)).sum(-1) == 2).all()


def test_filter_per_row_params():
    logits = np.random.default_rng(0).normal(size=(3, 8)).astype(np.float32)
    out = filtered_both(logits, top_k=np.asarray([1, 0, 4], np.int32), top_p=1.0)
    assert [int(np.isfinite(r).sum()) for r in out] == [1, 8, 4]
    out = filtered_both(logits, top_k=np.asarray([0, 3, 0], np.int32),
                        top_p=np.asarray([0.5, 1.0, 0.9], np.float32))
    assert int(np.isfinite(out[1]).sum()) == 3


@pytest.mark.parametrize("params", [
    dict(temperature=1.0),
    dict(temperature=0.7, top_k=5),
    dict(temperature=1.3, top_p=0.8),
    dict(temperature=2.0, top_k=6, top_p=0.6),
    dict(temperature=np.asarray([0.0, 1.0, 0.5, 3.0], np.float32),
         top_k=np.asarray([0, 2, 7, 0], np.int32),
         top_p=np.asarray([1.0, 1.0, 0.7, 0.9], np.float32)),
], ids=["plain", "top_k", "top_p", "both", "per_row"])
def test_sample_logits_matches_jax_with_its_draws(params):
    """JAX's ids for 16 keys, the port given each key's Gumbel draws."""
    logits = (np.random.default_rng(1).normal(size=(4, 16)) * 3).astype(np.float32)
    jkw = {n: jnp.asarray(v) if isinstance(v, np.ndarray) else v for n, v in params.items()}
    tkw = {n: t(v) if isinstance(v, np.ndarray) else v for n, v in params.items()}
    for i in range(16):
        key = jax.random.key(i)
        want = np.asarray(jsampling.sample_logits(key, jnp.asarray(logits), **jkw))
        draws = jax.random.gumbel(key, logits.shape, jnp.float32)
        got = sample_logits(t(logits), **tkw, gumbel=t(draws))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"key {i}")


def test_sample_logits_modes():
    """tests/test_sampling.py:85 on the port's own generator."""
    rng = np.random.default_rng(1)
    logits = t((rng.normal(size=(4, 16)) * 3).astype(np.float32))
    greedy = logits.argmax(-1)
    g = torch.Generator().manual_seed(0)
    assert sample_logits(logits, temperature=0.0, generator=g).equal(greedy)
    assert sample_logits(logits, temperature=5.0, top_k=1, generator=g).equal(greedy)
    top3 = logits.argsort(-1)[:, -3:]
    for _ in range(64):
        ids = sample_logits(logits, temperature=10.0, top_k=3, generator=g)
        assert all(int(ids[r]) in top3[r].tolist() for r in range(4))
    probs = torch.softmax(logits, -1)
    order = torch.argsort(-probs, -1)
    sp = -torch.sort(-probs, -1).values
    n_keep = ((torch.cumsum(sp, -1) - sp) < 0.6).sum(-1)
    for _ in range(64):
        ids = sample_logits(logits, temperature=1.0, top_p=0.6, generator=g)
        assert all(int(ids[r]) in order[r, :n_keep[r]].tolist() for r in range(4))
    ids = sample_logits(logits, temperature=torch.tensor([0.0, 1.0, 0.0, 1.0]), top_k=1,
                        generator=g)
    assert ids.equal(greedy)


def test_gumbel_noise_is_seeded_and_finite():
    a = gumbel_noise((64, 128), torch.Generator().manual_seed(3), "cpu")
    b = gumbel_noise((64, 128), torch.Generator().manual_seed(3), "cpu")
    assert a.equal(b) and bool(torch.isfinite(a).all())
    # the standard Gumbel's mean is Euler's constant, 0.5772
    assert abs(float(a.mean()) - 0.5772) < 0.05


def test_generate_sample_matches_jax_and_greedy():
    """tests/test_sampling.py:128: temperature 0 and top_k = 1 give the
    greedy tokens; with JAX's draws (the key folded with each step) the
    sampled tokens equal JAX's; a seeded generator reproduces itself."""
    cfg = tiny_opt("perlin")
    model = JaxOpt(cfg)
    N, P, steps, L = 2, 6, 5, 32
    ids, mask = make_batch(N=N, T=P, vocab=cfg.vocab_size, seed=11)
    variables = jax.jit(lambda: model.init(jax.random.key(0), ids, mask))()
    port = OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(variables))
    prompt = t(ids).long()

    greedy = port.generate_greedy(prompt, L, steps)
    g = torch.Generator().manual_seed(5)
    assert port.generate_sample(prompt, L, steps, g, temperature=0.0).equal(greedy)
    assert port.generate_sample(prompt, L, steps, g, temperature=1.0, top_k=1).equal(greedy)

    rng = jax.random.key(7)
    want = np.asarray(jax.jit(lambda v: model.apply(
        v, ids, L, steps, rng, method=lambda m, p, L, s, r: m.generate_sample(
            p, L, s, r, temperature=1.0, top_p=0.9)))(variables))
    draws = torch.stack([t(jax.random.gumbel(jax.random.fold_in(rng, i), (N, cfg.vocab_size),
                                             jnp.float32)) for i in range(steps)])
    got = port.generate_sample(prompt, L, steps, temperature=1.0, top_p=0.9, gumbel=draws)
    np.testing.assert_array_equal(got.numpy(), want)

    a = port.generate_sample(prompt, L, steps, torch.Generator().manual_seed(7), top_p=0.9)
    b = port.generate_sample(prompt, L, steps, torch.Generator().manual_seed(7), top_p=0.9)
    assert a.equal(b) and bool(((a >= 0) & (a < cfg.vocab_size)).all())
