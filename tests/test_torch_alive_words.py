"""The bf16 forward body's predicate on the CPU: the per-row alive words
(`kernel_alive_words`, the plain PyTorch model of csrc/sea_mask.cuh's
`alive_bits`: run boundaries by algebra, one evaluation of the pinned pixel
at the nearest whole column deciding each, a per-column pixel where a row is
narrower than 2·T_M) must give
the element mask bit for bit: against the port's oracle `element_mask_int8`
and the JAX package's, with rows shifted by `row_base`, on bidirectional
lengths, with the undersampling keep-predicate, and, for K9a-c, the mask of
`alive_from_operands` and the output of `impl_reference`. Every row width
from 1 to 2·T_M at T_M = 128, 256 and 512 is covered, so each case reaches
the per-column / run-boundary transition at w = 2·T_M. The card holds the kernel's words to the same
pixel map on every row width to 2^17 (chip_smoke's `mask` phase)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sea_tpu.ops.kernels import block_sparse as jb
from sea_tpu_torch.ops.kernels import block_sparse as tb
from tests._torch_parity import t
from tests.test_torch_block_sparse import budget_mask, make_case


def _mask(T, T_M, kind, H=1, seed=0):
    """(1, H, T, T_M) compressed mask: random at density 0.3, every even or
    every odd pixel (each run boundary flips a bit), or the production
    budget."""
    if kind == "random":
        return make_case(seed=seed, H=H, T=T, T_M=T_M)[3]
    if kind == "budget":
        return budget_mask(T, H=H, T_M=T_M, seed=seed)
    pix = np.arange(T_M) % 2 == (kind == "odd")
    return np.broadcast_to(pix.astype(np.float32), (1, H, T, T_M)).copy()


def _operands(mask, *, impl="flat", row_base=None, lengths=None, oversample=1.0, t_src=None,
              D=64):
    N, H, T, _ = mask.shape
    t_src = t_src or T
    rng = np.random.default_rng(1)
    q = t(rng.standard_normal((N, H, T, D)).astype(np.float32) * 0.2)
    k, v = (t(rng.standard_normal((N, H, t_src, D)).astype(np.float32)) for _ in range(2))
    causal = lengths is None
    bq, bk, sub = tb.impl_blocks(impl, T, t_src) if causal else (None, None, 0)
    x = tb.prepare_inputs(q, k, v, t(mask), None, is_causal=causal, lengths=lengths,
                          row_base=row_base, block_q=bq, block_k=bk)
    return x, tb.kernel_operands(x, oversample, impl=impl, sub=sub)


def _words_mask(ops, impl="flat"):
    words = tb.kernel_alive_words(ops, impl)
    N, H, T, _ = ops.shape
    return tb.words_to_mask(words.reshape(N * H * T, -1), ops.k.shape[1]).reshape(N, H, T, -1)


@pytest.mark.parametrize("kind", ["random", "even", "odd"])
@pytest.mark.parametrize("T_M", [128, 256, 512])
def test_causal_words_equal_both_oracles(T_M, kind):
    """Causal rows of every width 1 .. 3·T_M: the words against the port's
    and the JAX package's `element_mask_int8`."""
    T = 3 * T_M
    mask = _mask(T, T_M, kind)
    _, ops = _operands(mask)
    got = _words_mask(ops)
    want = tb.element_mask_int8(t(mask), T, True).bool()
    assert torch.equal(got, want)
    jax_want = np.asarray(jb.element_mask_int8(jnp.asarray(mask), T, True)).astype(bool)
    np.testing.assert_array_equal(got.numpy(), jax_want)


@pytest.mark.parametrize("shift", [128, 1024, 4096 - 256])
def test_row_base_shifted_words(shift):
    """A sequence shard: the q-blocks' rows start at `shift`, over every
    global column up to the shard's last row; the words against the oracle
    at those widths."""
    T, T_M = 256, 256
    mask = _mask(T, T_M, "random", seed=shift)
    row_base = torch.arange(T // 64, dtype=torch.int32) * 64 + shift
    x, ops = _operands(mask, row_base=row_base, t_src=T + shift)
    got = _words_mask(ops)
    want = tb._alive_dense(t(mask), T + shift, x.row_widths[:, None])
    assert torch.equal(got, want)


@pytest.mark.parametrize("T_M", [128, 256])
def test_bidirectional_words(T_M):
    """Padded examples of lengths across T_M (and 0 and 1): the words of K5
    against the lengths-aware oracle."""
    T = 512
    lengths = torch.tensor([0, 1, 77, T_M - 1, T_M, T_M + 1, 383, T], dtype=torch.int32)
    mask = np.concatenate([_mask(T, T_M, "random", seed=i) for i in range(len(lengths))])
    _, ops = _operands(mask, lengths=lengths)
    got = _words_mask(ops)
    want = tb.element_mask_int8(t(mask), T, False, lengths=lengths).bool()
    assert torch.equal(got, want)


@pytest.mark.parametrize("oversample", [1.0, 2.0, 3.0])
def test_undersampling_words(oversample):
    """K1's keep-predicate folded into the words: the mask and the output
    equal `dense_reference`'s bit for bit, with it and without."""
    T, T_M = 512, 256
    mask = _mask(T, T_M, "budget", H=2)
    x, ops = _operands(mask, oversample=oversample)
    got = _words_mask(ops)
    w = tb._dense_widths(T, T, True, None, "cpu")
    want = tb._alive_dense(t(mask), T, w)
    if oversample != 1.0:
        want = want & tb._keep_dense(w, T, oversample, 64.0)
    assert torch.equal(got, want)
    out, _, _ = tb._softmax_pv(x.q, x.k, x.v, got, x.scaler)
    ref = tb.dense_reference(x.q, x.k, x.v, x.mask_m, x.scaler, oversample=oversample)
    assert torch.equal(out.to(x.q.dtype), ref)


@pytest.mark.parametrize("impl", ["flat", "flat_wr", "flat_fori", "subtile"])
@pytest.mark.parametrize("T_M", [128, 256, 512])
def test_impl_words_equal_the_restricted_mask(impl, T_M):
    """K1 and K9a-c on their own tile lists (K9c at the JAX package's outer
    blocks): the words equal `alive_from_operands` (the oracle's bits on the
    listed tiles, the word range, the active pieces) and the oracle itself,
    and the softmax over them gives `impl_reference`'s output bit for bit."""
    T = 1024
    mask = _mask(T, T_M, "budget", H=2, seed=T_M)
    x, ops = _operands(mask, impl=impl)
    got = _words_mask(ops, impl)
    assert torch.equal(got, tb.alive_from_operands(ops, impl))
    assert torch.equal(got, tb.element_mask_int8(t(mask), T, True).bool())
    out, _, _ = tb._softmax_pv(x.q, x.k, x.v, got, x.scaler)
    assert torch.equal(out.to(x.q.dtype), tb.impl_reference(ops, impl))


def test_pixel_starts_are_the_first_columns_of_each_pixel():
    """B(p) by algebra and one pinned evaluation against a scan of the pinned
    pixel, on widths around T_M and 2·T_M and up to 2^14 (row by row, every
    pixel)."""
    T_M = 256
    widths = torch.tensor([1, 2, 255, 256, 257, 511, 512, 513, 1000, 4095, 4096, 16383, 16384],
                          dtype=torch.float32)
    last = widths.long() - 1
    got = tb.pixel_starts(widths, last, T_M)
    for i, w in enumerate(widths.tolist()):
        cols = torch.arange(int(w))
        pix = tb._row_pixel(cols, torch.tensor(w), T_M, False)
        want = torch.searchsorted(pix, torch.arange(T_M + 1), right=False)
        assert torch.equal(got[i], want), w
