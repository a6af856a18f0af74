"""The float32 backward bodies' arithmetic on the CPU
(csrc/block_sparse_diff.cu: `causal_dq_f32_wgmma_kernel` and
`causal_dkv_f32_wgmma_kernel`, K3/K7 and K4/K8 in float32).

The bodies keep float32 accuracy on bf16 wgmmas by splitting every operand
into three bf16 terms, x = x₁ + x₂ + x₃ with x₁ = bf16_rn(x), x₂ =
bf16_rn(x − x₁), x₃ = bf16_rn(x − x₁ − x₂) (`sea::split3_bf16`), and summing
a·b as six bf16 products per 16-wide k-step into the float32 accumulator,
smallest first (`f3::product3_ss`, `f3::product3_rs`): S = Q·Kᵀ and dP =
dO·Vᵀ, then dq += dS·K per 64-column sub-tile in increasing order; Sᵀ = K·Qᵀ
and dPᵀ = V·dOᵀ, then dv += Pᵀ·dO and dk += dSᵀ·Q per 64-row sub-tile; P
and dS (Pᵀ, dSᵀ) split the same way from the accumulators. The plain model
below repeats that arithmetic step for step, the products' order read from
the CUDA source, and holds it to the plain K3 and K4 (`dq_reference`,
`dkv_reference`) within chip_smoke's float32 gates: 1e-5 (`F32_TOL`), and
the gradients' 1e-8 + 1e-4·max|want| (`check_grad`); on these operands
(max|want| 2.8 to 5.5) 1e-5 is the tighter. The same model with two terms (hi +
lo, their four products) or with three terms but three products (x₂y₁,
x₁y₂, x₁y₁) misses 1e-5, so the test can fail.
"""

import re

import numpy as np
import pytest
import torch

from sea_tpu_torch.ops.kernels import _build
from sea_tpu_torch.ops.kernels import block_sparse as bs

H, T, T_M = 2, 256, 64
F32_TOL = 1e-5  # chip_smoke's float32 gate
GRAD_ATOL, GRAD_RTOL = 1e-8, 1e-4  # chip_smoke's gradient gate (check_grad)
LOG2E = 1.4426950408889634
SUB = 64  # a sub-tile's columns (dq) or rows (dk/dv)
KSTEP = 16  # a bf16 wgmma's k


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def split3(x: torch.Tensor, terms: int = 3) -> list:
    """float32 x as `terms` bf16 terms (held in float32), each the bf16
    rounding to nearest even of what the ones before leave."""
    out, rest = [], x.float()
    for _ in range(terms):
        t = rest.to(torch.bfloat16).float()
        out.append(t)
        rest = rest - t
    return out


def product_order() -> list:
    """[(a term, b term)] of the six products a k-step, 0-based, as
    `f3::product3_ss` issues them, checked against `f3::product3_rs`."""
    text = (_build.CSRC / "block_sparse_diff.cu").read_text()
    ss = text[text.index("void product3_ss("):]
    ss = ss[:ss.index("\n}\n")]
    term = {"": 0, " + T": 1, " + 2 * T": 2}
    pairs = [(term[a], term[b]) for a, b in re.findall(
        r"wgmma_ss_n64\(d, P::kdesc\(a((?: \+ (?:2 \* )?T)?), kk\), "
        r"P::kdesc\(b((?: \+ (?:2 \* )?T)?), kk\)", ss)]
    rs = text[text.index("void product3_rs("):]
    rs = rs[:rs.index("\n}\n")]
    rs_pairs = [(int(f), int(b) - 1) for f, b in re.findall(r"wgmma_rs<D>\(d, f\[(\d)\]\[kk\], b(\d)\)", rs)]
    assert rs_pairs == pairs, (pairs, rs_pairs)
    return pairs


def product(a: list, b: list, acc: torch.Tensor, pairs) -> torch.Tensor:
    """acc + a·b, a (M, K) and b (K, N) as lists of terms: per k-step of 16,
    each pair's product (exact in float64: bf16 times bf16) added to the
    float32 accumulator in the given order."""
    for kk in range(a[0].shape[1] // KSTEP):
        ks = slice(KSTEP * kk, KSTEP * kk + KSTEP)
        for i, j in pairs:
            acc = (acc.double() + a[i][:, ks].double() @ b[j][ks].double()).float()
    return acc


def body_model(q, k, v, alive, dou, lse, delta, terms=3, pairs=None):
    """(dq, dk, dv) of the bodies on float32 operands (1, H, T, D): dq by
    64-column sub-tiles in increasing order, dk and dv by 64-row ones, every
    operand and every register operand in `terms` terms, the products in
    `pairs` (the source's order by default)."""
    pairs = product_order() if pairs is None else pairs
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    zero = torch.zeros(())
    for h in range(H):
        Q, K, V, O = (split3(x[0, h], terms) for x in (q, k, v, dou))
        l2, dl = lse[0, h] * LOG2E, delta[0, h]
        for c0 in range(0, T, SUB):
            cols = slice(c0, c0 + SUB)
            kc, vc = [x[cols] for x in K], [x[cols] for x in V]
            s = product(Q, [x.T for x in kc], torch.zeros(T, SUB), pairs)
            dp = product(O, [x.T for x in vc], torch.zeros(T, SUB), pairs)
            p = torch.where(alive[h, :, cols], torch.exp2(s * LOG2E - l2[:, None]), zero)
            ds = p * (dp - dl[:, None])
            dq[0, h] = product(split3(ds, terms), kc, dq[0, h], pairs)
        for r0 in range(0, T, SUB):
            rows = slice(r0, r0 + SUB)
            qr, orr = [x[rows] for x in Q], [x[rows] for x in O]
            st = product(K, [x.T for x in qr], torch.zeros(T, SUB), pairs)
            dpt = product(V, [x.T for x in orr], torch.zeros(T, SUB), pairs)
            pt = torch.where(alive[h, rows].T, torch.exp2(st * LOG2E - l2[rows][None]), zero)
            dst = pt * (dpt - dl[rows][None])
            dv[0, h] = product(split3(pt, terms), orr, dv[0, h], pairs)
            dk[0, h] = product(split3(dst, terms), qr, dk[0, h], pairs)
    return dq, dk, dv


def operands(D, seed):
    """q, k, v, dO, scaler and a budget mask (the main path's shape of
    mask: about 8 alive pixels a head per row, all of them on early rows)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, H, T, D)).astype(np.float32) * 0.2
    k = rng.standard_normal((1, H, T, D)).astype(np.float32) * 0.2
    v = rng.standard_normal((1, H, T, D)).astype(np.float32)
    do = rng.standard_normal((1, H, T, D)).astype(np.float32)
    sc = rng.uniform(0.1, 1.0, (1, H, T)).astype(np.float32)
    flat = np.zeros((T, H * T_M), np.float32)
    for r in range(T):
        budget = min(max(round(H * 8 * T_M / (r + 1)), 1), H * T_M)
        flat[r, rng.choice(H * T_M, size=budget, replace=False)] = 1.0
    mask = flat.reshape(T, H, T_M).transpose(1, 0, 2)[None].copy()
    return [torch.from_numpy(x) for x in (q, k, v, do, sc, mask)]


def test_split_terms_are_exact():
    """Each term is a bf16 value rounded to nearest even, each subtraction
    is exact in float32 (the float64 differences agree), and the three
    terms leave under 2^-26 of x."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(8192) * 10.0 ** rng.uniform(-6, 6, 8192))
                         .astype(np.float32))
    t1, t2, t3 = split3(x)
    for t in (t1, t2, t3):
        assert torch.equal(t, t.to(torch.bfloat16).float())
    r1 = x.double() - t1.double()
    assert torch.equal(r1, (x - t1).double())
    assert torch.equal(r1 - t2.double(), (x - t1 - t2).double())
    left = (x.double() - t1.double() - t2.double() - t3.double()).abs()
    assert bool((left <= 2.0 ** -26 * x.double().abs()).all())
    tie = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8])  # halfway between bf16s
    assert split3(tie)[0].tolist() == [1.0, 1.0 + 2.0 ** -6]


def test_product_order_is_smallest_first():
    """Both product helpers take the six products whose terms' indices sum
    to at most 4 (1-based), the smallest first: x₃y₁, x₂y₂, x₁y₃, x₂y₁,
    x₁y₂, x₁y₁."""
    assert product_order() == [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]


@pytest.mark.parametrize("D", [64, 128])
def test_body_model_within_float32_gates(D):
    """The model against the plain K3 and K4 on the same operands, lse and
    delta, within 1e-5 and the gradient gate; two terms, or three products,
    miss 1e-5."""
    q, k, v, do, sc, mask = operands(D, seed=D)
    o, lse = bs.fwd_with_stats_reference(q, k, v, mask, sc)
    _, dou, delta = bs.backward_terms(do, o, sc, torch.float32)
    alive = bs.element_mask_int8(mask, T, True).reshape(H, T, T).bool()
    want = (bs.dq_reference(q, k, v, mask, dou, lse, delta),
            *bs.dkv_reference(q, k, v, mask, dou, lse, delta))

    def errs(**kw):
        got = body_model(q, k, v, alive, dou, lse, delta, **kw)
        return [float((g - w).abs().max()) for g, w in zip(got, want)]

    six = errs()
    limits = [GRAD_ATOL + GRAD_RTOL * float(w.abs().max()) for w in want]
    assert all(e <= F32_TOL for e in six), six
    assert all(e <= lim for e, lim in zip(six, limits)), (six, limits)
    two = errs(terms=2, pairs=[(1, 1), (1, 0), (0, 1), (0, 0)])
    three = errs(pairs=[(1, 0), (0, 1), (0, 0)])
    assert max(two) > F32_TOL and max(three) > F32_TOL, (two, three)
