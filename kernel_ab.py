"""A/B and knock-out timing of the forward and backward bodies on one
NVIDIA GPU.

    python3 kernel_ab.py [--parent DIR]

Builds `sea_tpu_torch/csrc/block_sparse_causal.cu` (the forward bodies) and
`sea_tpu_torch/csrc/block_sparse_diff.cu` (the backward bodies) of this tree
and, with `--parent`, the same two files of another checkout (for one
commit: `mkdir DIR && git archive <commit> | tar -x -C DIR`), plus copies
of this tree's sources with one part of a body knocked out (twenty-one):
25 nvcc builds with a parent, 23 without, all started together. Then it
times, with CUDA events on the same operands, the parent and
this tree in the order parent, this, this, parent, then the knock-outs, each
case in float32 and in bfloat16 beside SDPA's same call, each time as the
median of one-call CUDA-event times (`chip_smoke.time_ms`, which counts the
host's launch path too) and as the kernels' device time from
torch.profiler:
  * the forward: K1 and K9a on bench.py's 1 x 12 x 4096 configuration with
    its `host_topk_mask`; K1 and K2 on the budget mask at the main path's 1
    x 12 x 2048 x 64, at OPT-2.7b's layer geometry 1 x 32 x 2048 x 80 and at
    LLaMA-7b's 1 x 32 x 2048 x 128; K2 at the train arms' 1 x 32 x 512 x 80
    and x 128; K5 at BERT's 32 x 12 x 256 (ragged lengths); K6 on one
    (shard, window) of chip_smoke's ring-kernels geometry (4 shards at 1 x
    4096, zigzag rows, blocks 128: shard 0's rows on window 0);
  * the backward, float32 then bfloat16: K3 and K4 on the budget mask at
    1 x 12 x 2048 x 64, at LLaMA-7b's layer, 1 x 32 x 2048 x 128, and at the
    train arms' 1 x 32 x 512 x 80 and x 128, and K7 and K8 on the same ring
    window, beside SDPA's backward on the same shapes in the same type.
Each output is compared with the first library's: equal bit for bit, or
its max|diff| (the float32 forward of a parent older than its wgmma body
sums otherwise).

A knock-out computes another function; it only splits the time. The bf16
forward body (`causal_wgmma_kernel`; `KNOCKOUTS`, timed in bf16):
  pred     the rows' alive words reduced to the causal edge (no pixel, no
           mask word, no run boundary);
  exp      the softmax's 2^x left out (P is the exponent itself);
  split    P·V without P's low half (one wgmma per 16 columns, not two);
  products no Q·Kᵀ or P·V wgmma;
  all      pred, exp and products together: what is left is the walk, the
           TMA copies, the barriers, the bit test, the softmax's
           bookkeeping and the epilogue.
The float32 forward body (`causal_tf32_wgmma_kernel`; `F32_KNOCKOUTS`,
`f32-`, timed in float32; K5's float32 instance runs on `mma.sync` and is
left as it is):
  pred     the alive words reduced to the causal edge, as above;
  lo       the products of the low halves left out: one TF32 wgmma a k-step
           (Q_hi·K_hi, P_hi·Vᵀ_hi), not three;
  products no wgmma at all;
  split    K's split and V's transpose in the producer's warps left out (the
           consumers read raw K and stale low halves and Vᵀ);
  all      pred and products together: the walk, the TMA copies, the
           barriers, the splits, the bit test, the softmax and the
           epilogue.
Backward (`bwd-`; the bf16 bodies on wgmma, `causal_dq_wgmma_kernel` and
`causal_dkv_wgmma_kernel`, each edit made in both; the edits sit in code
that every width's instance shares; `DIFF_KNOCKOUTS`, timed in bf16):
  pred     the alive words reduced to the causal edge (no pixel, no mask
           word, no run boundary);
  exp      P's 2^x left out (P is the exponent itself);
  split    the products of P's and dS's low halves left out;
  products no wgmma at all (S, dP, and dq or dk and dv);
  all      pred, exp and products together: the walk, the TMA copies, the
           barriers, the bit tests, the splits and the epilogue.
The float32 backward bodies in three bf16 terms
(`causal_dq_f32_wgmma_kernel`, `causal_dkv_f32_wgmma_kernel`;
`F32_DIFF_KNOCKOUTS`, `bwd32-`, timed in float32; each edit in both bodies
or in the helpers they share):
  pred     the alive words reduced to the causal edge, as above;
  exp      P's 2^x left out, as above;
  split    the producer warps' split of each operand into its three terms
           left out (the consumers read the raw bits as terms);
  small    the small products left out: one wgmma a k-step (x₁y₁), not six;
  products no wgmma at all;
  all      pred, exp and products together: the walk, the TMA copies, the
           splits, the barriers, the bit tests, the fragment splits and the
           epilogue.
Needs a CUDA device and nvcc; prints one line per timing and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as cs
from sea_tpu_torch.ops.kernels import _build
from sea_tpu_torch.ops.kernels import block_sparse as bs
from sea_tpu_torch.parallel import LocalGroup
from sea_tpu_torch.parallel import sharded_attention as sa

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "sea_tpu_torch" / "csrc" / "block_sparse_causal.cu"
DIFF_SOURCE = ROOT / "sea_tpu_torch" / "csrc" / "block_sparse_diff.cu"
BUILD = ROOT / "sea_tpu_torch" / "_build" / "ab"
# where a forward body's knock-outs apply: the source's text from the first
# marker up to the second (None: the end of the file), in which each edit's
# text must stand once
BF16_SCOPE = ("causal_wgmma_kernel(", "// The float32 body on wgmma in split TF32")
F32_SCOPE = ("// The float32 body on wgmma in split TF32", None)
# and a backward body's (block_sparse_diff.cu)
BWD_BF16_SCOPE = ("// The bf16 bodies on wgmma (K3, K4, K7, K8 in bfloat16)",
                  "// The float32 bodies on wgmma in three bf16 terms")
BWD_F32_SCOPE = ("// The float32 bodies on wgmma in three bf16 terms",
                 "// col_base: the global column")
# the scope by the knock-outs' prefix
SCOPES = {"ko": BF16_SCOPE, "ko-f32": F32_SCOPE, "ko-bwd": BWD_BF16_SCOPE,
          "ko-bwd32": BWD_F32_SCOPE}
# (text of this tree's source, what replaces it) per knock-out of the bf16
# body (`causal_wgmma_kernel`)
KNOCKOUTS = {
    "pred": [("sea::alive_bits<BIDIR, IMPL == WORD_LOOP>(rows, c0, t_m, wlo, whi, t4, bits);",
              "for (int h = 0; h < 2; ++h) bits[h] = rows[h].cl < c0 ? 0ull"
              " : sea::low_bits(min(rows[h].cl, c0 + 63) - c0 + 1);")],
    "exp": [("x = exp2_sfu(__fmaf_rn(x, LOG2E, -ml));  // 2^-inf == 0: dead elements",
             "x = __fmaf_rn(x, LOG2E, -ml);")],
    "split": [("sea::wgmma_rs<D>(acc, pl[kk], vd);", "")],
    "products": [("sea::wgmma_ss_n64(s, L::kdesc(qs, kk), L::kdesc(ks, kk), kk > 0);", ""),
                 ("sea::wgmma_rs<D>(acc, pl[kk], vd);", ""),
                 ("sea::wgmma_rs<D>(acc, ph[kk], vd);", "")],
}
KNOCKOUTS["all"] = KNOCKOUTS["pred"] + KNOCKOUTS["exp"] + KNOCKOUTS["products"]
# the same for the float32 body (`causal_tf32_wgmma_kernel`)
_S_LO = ("sea::wgmma_tf32_ss_n64(s, QT::kdesc(qlo, kk), QT::kdesc(ks, kk), kk > 0);", "")
_S_MID = ("sea::wgmma_tf32_ss_n64(s, QT::kdesc(qhi, kk), QT::kdesc(ks + QT::TILE, kk), 1);", "")
_S_HI = "sea::wgmma_tf32_ss_n64(s, QT::kdesc(qhi, kk), QT::kdesc(ks, kk), 1);"
_PV = ["sea::wgmma_tf32_rs<D>(acc, pl[kk], vhi);", "sea::wgmma_tf32_rs<D>(acc, ph[kk], vlo);",
       "sea::wgmma_tf32_rs<D>(acc, ph[kk], vhi);"]
F32_KNOCKOUTS = {
    "pred": [("sea::alive_bits<BIDIR, !WORDS_SMEM>(rows, c0, t_m, wlo, whi, t4, bits);",
              KNOCKOUTS["pred"][0][1])],
    "lo": [_S_LO, _S_MID, (_S_HI, _S_HI.replace(", 1);", ", kk > 0);")),
           (_PV[0], ""), (_PV[1], "")],
    "products": [_S_LO, _S_MID, (_S_HI, "")] + [(x, "") for x in _PV],
    "split": [("tf::split_tile<L::TILE>(smem + L::K_OFF + st * 2 * L::TILE, tid - 32, "
               "32 * C::SPLITTERS);", "{}"),
              ("tf::transpose_tile<D>(smem + L::RAW_OFF, smem + L::V_OFF + st * 2 * L::TILE, sw,\n"
               "                              C::SPLITTERS, lane);", "")],
}
F32_KNOCKOUTS["all"] = F32_KNOCKOUTS["pred"] + F32_KNOCKOUTS["products"]
# the same for the backward's bf16 bodies (`causal_dq_wgmma_kernel`,
# `causal_dkv_wgmma_kernel`), each edit found once in their scope, in dq and
# in dk/dv
DIFF_KNOCKOUTS = {
    "pred": [("sea::alive_bits<false, false>(rows, c0, t_m, 0, n_words - 1, t4, bits);",
              "for (int h = 0; h < 2; ++h) bits[h] = rows[h].cl < c0 ? 0ull"
              " : sea::low_bits(min(rows[h].cl, c0 + 63) - c0 + 1);"),
             ("sea::alive_bits<false, false, D != 128>(wrow, gcol(cw), t_m, 0, n_words - 1, t4, bits);",
              "for (int h = 0; h < 2; ++h) bits[h] = wrow[h].cl < gcol(cw) ? 0ull"
              " : sea::low_bits(min(wrow[h].cl, gcol(cw) + 63) - gcol(cw) + 1);")],
    "exp": [("exp2_sfu(__fmaf_rn(x, LOG2E, -l2[h]))", "__fmaf_rn(x, LOG2E, -l2[h])"),
            ("exp2_sfu(__fmaf_rn(y, LOG2E, -(i & 1 ? lr.y : lr.x)))",
             "__fmaf_rn(y, LOG2E, -(i & 1 ? lr.y : lr.x))")],
    "split": [("sea::wgmma_rs<D>(acc, fl[kk], kd);", ""),
              ("sea::wgmma_rs<D>(acc_v, pl[kk], od);", ""),
              ("sea::wgmma_rs<D>(acc_k, sl[kk], qd);", "")],
    "products": [
        ("sea::wgmma_ss_n64(s, Pn::kdesc(qs, kk), Pn::kdesc(ks, kk), kk > 0);", ""),
        ("sea::wgmma_ss_n64(dp, Pn::kdesc(os, kk), Pn::kdesc(vs, kk), kk > 0);", ""),
        ("sea::wgmma_rs<D>(acc, fl[kk], kd);", ""),
        ("sea::wgmma_rs<D>(acc, fh[kk], kd);", ""),
        ("sea::wgmma_ss_n64(s, Pn::kdesc(ks, kk), Pn::kdesc(qs, kk), kk > 0);", ""),
        ("sea::wgmma_ss_n64(dp, Pn::kdesc(vs, kk), Pn::kdesc(os, kk), kk > 0);", ""),
        ("sea::wgmma_rs<D>(acc_v, pl[kk], od);", ""),
        ("sea::wgmma_rs<D>(acc_v, ph[kk], od);", ""),
        ("sea::wgmma_rs<D>(acc_k, sl[kk], qd);", ""),
        ("sea::wgmma_rs<D>(acc_k, sh[kk], qd);", "")],
}
DIFF_KNOCKOUTS["all"] = DIFF_KNOCKOUTS["pred"] + DIFF_KNOCKOUTS["exp"] + DIFF_KNOCKOUTS["products"]
# the same for the backward's float32 bodies (`causal_dq_f32_wgmma_kernel`,
# `causal_dkv_f32_wgmma_kernel`); their products are the shared helpers
# `f3::product3_ss` (six a k-step, the first overwriting) and
# `f3::product3_rs`
_SS3 = ["sea::wgmma_ss_n64(d, P::kdesc(a + 2 * T, kk), P::kdesc(b, kk), kk > 0);",
        "sea::wgmma_ss_n64(d, P::kdesc(a + T, kk), P::kdesc(b + T, kk), 1);",
        "sea::wgmma_ss_n64(d, P::kdesc(a, kk), P::kdesc(b + 2 * T, kk), 1);",
        "sea::wgmma_ss_n64(d, P::kdesc(a + T, kk), P::kdesc(b, kk), 1);",
        "sea::wgmma_ss_n64(d, P::kdesc(a, kk), P::kdesc(b + T, kk), 1);",
        "sea::wgmma_ss_n64(d, P::kdesc(a, kk), P::kdesc(b, kk), 1);"]
_RS3 = ["sea::wgmma_rs<D>(d, f[2][kk], b1);", "sea::wgmma_rs<D>(d, f[1][kk], b2);",
        "sea::wgmma_rs<D>(d, f[0][kk], b3);", "sea::wgmma_rs<D>(d, f[1][kk], b1);",
        "sea::wgmma_rs<D>(d, f[0][kk], b2);", "sea::wgmma_rs<D>(d, f[0][kk], b1);"]
F32_DIFF_KNOCKOUTS = {
    "pred": DIFF_KNOCKOUTS["pred"],
    "exp": DIFF_KNOCKOUTS["exp"],
    "split": [("split3_tile<D>(smem + i * L::TERMS, w, lane);", "{}"),
              ("split3_tile<D>(stage, w, lane);", ""),
              ("split3_tile<D>(stage + L::TERMS, w, lane);", "")],
    "small": [(x, "") for x in _SS3[:5]] + [(_SS3[5], _SS3[5].replace(", 1);", ", kk > 0);"))]
             + [(x, "") for x in _RS3[:5]],
    "products": [(x, "") for x in _SS3 + _RS3],
}
F32_DIFF_KNOCKOUTS["all"] = (F32_DIFF_KNOCKOUTS["pred"] + F32_DIFF_KNOCKOUTS["exp"]
                             + F32_DIFF_KNOCKOUTS["products"])
P, I, FL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the entry points timed here, by library
ARGTYPES = {
    "sea_causal_flat_forward": [P] * 9 + [I] * 10 + [FL] * 4 + [I, P],
    "sea_causal_word_range_forward": [P] * 10 + [I] * 11 + [FL] * 4 + [I, P],
    "sea_causal_fwd_stats": [P] * 10 + [I] * 11 + [P],
    "sea_bidir_forward": [P] * 9 + [I] * 10 + [I, P],
    "sea_window_fwd_stats": [P] * 9 + [I] * 12 + [P],
    "sea_causal_dq": [P] * 11 + [I] * 11 + [P],
    "sea_causal_dkv": [P] * 12 + [I] * 11 + [P],
    "sea_window_dq": [P] * 11 + [I] * 12 + [P],
    "sea_window_dkv": [P] * 12 + [I] * 12 + [P],
}


def build(sources: dict) -> dict:
    """{name: (source path, include dir)} -> {name: loaded library}, one
    nvcc each, all at once."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, inc) in sources.items():
        out = BUILD / f"lib_{name}.so"
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{inc}", "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, args in ARGTYPES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = I
        libs[name] = lib
    return libs


def knockout_sources(source: Path = SOURCE, knockouts: dict = KNOCKOUTS,
                     prefix: str = "ko") -> dict:
    """{f"{prefix}-{name}": (knocked-out copy of `source`, include dir)} per
    knock-out; raises unless every edit's text stands once in the prefix's
    scope (`SCOPES`; else the whole source), where it is made."""
    text = source.read_text()
    scope = SCOPES.get(prefix)
    lo, hi = 0, len(text)
    if scope is not None:
        lo = text.index(scope[0])
        hi = text.index(scope[1], lo) if scope[1] else hi
    out = {}
    for name, edits in knockouts.items():
        part = text[lo:hi]
        for old, new in edits:
            if part.count(old) != 1:
                raise RuntimeError(f"knock-out {name}: {old!r} is not in the source once")
            part = part.replace(old, new)
        path = BUILD / f"{prefix}_{name}.cu"
        path.write_text(text[:lo] + part + text[hi:])
        out[f"{prefix}-{name}"] = (path, source.parent)
    return out


def with_lib(lib, fn, attr="_lib"):
    """fn() with the wrappers' library (`bs._lib`, or `bs._diff_lib` for the
    backward) swapped for `lib`."""
    saved = getattr(bs, attr)
    setattr(bs, attr, lambda: lib)
    try:
        return fn()
    finally:
        setattr(bs, attr, saved)


def sdpa_bwd_ms(q, k, v, do, causal):
    """SDPA's backward alone at these shapes (the library's yardstick)."""
    qq, kk, vv = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal)
    return cs.time_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), do, retain_graph=True))


def sdpa_ms(q, k, v, **kw):
    """SDPA's forward at these shapes (the library's yardstick)."""
    return cs.time_ms(lambda: F.scaled_dot_product_attention(q, k, v, **kw))


def ring_window(dtype):
    """Shard 0's rows and window 0 of chip_smoke's ring-kernels geometry (4
    shards at 1 x 12 x 4096, zigzag rows, blocks 128) in `dtype`, with the
    forward's row statistics: (wops, k0, v0, q_l0, (dou, lse, delta) of
    shard 0, the window's alive elements)."""
    T = cs.RING_CHECK_T
    q, k, v, sc = cs.qkv(1, T, dtype, seed=21, device="cuda")
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(22)).to("cuda", dtype)
    mask = cs.budget_mask(1, T, seed=21, device="cuda")
    group = LocalGroup(cs.RING_SHARDS, q.device)
    bq, bk = sa._ring_blocks(T, group.size, cs.RING_BLOCK, cs.RING_BLOCK)
    perm, _, rows = sa._row_order(T, group.size, bq, True, q.device)
    qp, maskp, scp, dop = (x[:, :, perm] for x in (q, mask, sc.to(dtype), do))
    out, L, wops = sa._ring_forward(qp, k, v, maskp, scp, rows, group, bq, bk)
    _, dou, delta = bs.backward_terms(dop, out, scp, dtype)
    L = torch.where(torch.isneginf(L), float("inf"), L)
    q_l, m_l, dou_l, L_l, delta_l, k_w, v_w = (
        group.split_rows(x) for x in (qp, maskp, dou, L, delta, k, v))
    r_l = group.split_rows(rows, 0)
    per_call = (dou_l[0].contiguous(), L_l[0].contiguous(), delta_l[0].contiguous())
    nnz = cs.window_nnz(m_l[0], r_l[0], 0, wops[0].window)
    return wops[0], k_w[0].contiguous(), v_w[0].contiguous(), q_l[0], per_call, nnz


def forward_cases(dtype):
    """[(label, {kid: launch}, {kid: bound ms}, SDPA forward ms)] in
    `dtype`: K1 and K9a at bench.py's 1 x 12 x 4096; K1 and K2 on the budget
    mask at 1 x 12 x 2048 x 64, 1 x 32 x 2048 x 80 and 1 x 32 x 2048 x 128;
    K2 at 1 x 32 x 512 x 80 and x 128; K5 at 32 x 12 x 256; K6 on one ring
    window."""
    cases = []
    q, k, v, sc, mask = cs.bench_inputs(dtype, "cuda")
    ops = bs.kernel_operands(bs.prepare_inputs(q, k, v, mask, sc))
    wops = cs.impl_operands(q, k, v, mask, sc, "flat_wr", None, None)
    b = cs.bound(ops, mask)[0]
    cases.append((f"bench 1x{cs.H}x{cs.BENCH_T}", {
        "K1": lambda ops=ops: bs.launch_causal_flat(ops),
        "K9a": lambda w=wops: bs._launch_impl(w, "flat_wr"),
    }, {"K1": b, "K9a": b}, sdpa_ms(q, k, v, is_causal=True)))
    for T, heads, width, kids in ((2048, cs.H, cs.D, "K1 K2"),
                                  (2048, cs.WIDE_H, cs.WIDE_D, "K1 K2"),
                                  (2048, cs.WIDE_H, cs.LLAMA_D, "K1 K2"),
                                  (512, cs.WIDE_H, cs.WIDE_D, "K2"),
                                  (512, cs.WIDE_H, cs.LLAMA_D, "K2")):
        q, k, v, sc = cs.qkv(1, T, dtype, seed=T, device="cuda", heads=heads, width=width)
        mask = cs.budget_mask(1, T, seed=T, device="cuda", heads=heads)
        ops = bs.kernel_operands(bs.prepare_inputs(q, k, v, mask, sc))
        dops = cs.diff_operands(q, k, v, mask, sc)
        launches = {"K1": lambda ops=ops: bs.launch_causal_flat(ops),
                    "K2": lambda ops=dops: bs.causal_fwd_stats(ops)}
        bounds = {"K1": cs.bound(ops, mask)[0], "K2": cs.diff_bound("K2", dops, mask)[0]}
        cases.append((f"budget 1x{heads}x{T}x{width}",
                      {kid: launches[kid] for kid in kids.split()},
                      {kid: bounds[kid] for kid in kids.split()},
                      sdpa_ms(q, k, v, is_causal=True)))
    n, T, lo, hi = cs.BERT_REQUESTS[0]
    q, k, v, sc = cs.qkv(n, T, dtype, seed=31, device="cuda")
    lengths = torch.from_numpy(
        np.random.default_rng(31).integers(lo, hi + 1, n)).to("cuda", torch.int32)
    mask = cs.bidir_mask(lengths.tolist(), T, seed=31, device="cuda")
    x = bs.prepare_inputs(q, k, v, mask, sc, is_causal=False, lengths=lengths)
    ops = bs.kernel_operands(x)
    keep = cs.key_padding(lengths, T)[:, None, None, :]
    cases.append((f"bert {n}x{cs.H}x{T}", {"K5": lambda ops=ops: bs.bidir_forward(ops)},
                  {"K5": cs.bidir_bound(ops, x.mask_m, lengths)[0]},
                  sdpa_ms(q, k, v, attn_mask=keep, scale=1.0)))
    wops, k0, v0, q0, _, nnz = ring_window(dtype)
    cases.append((f"ring 1x{cs.H}x{cs.RING_CHECK_T} shard 0 window 0",
                  {"K6": lambda: bs.fwd_stats_window(wops, 0, k0, v0)},
                  {"K6": max(cs.window_bound("K6", wops, nnz))}, sdpa_ms(q0, k0, v0)))
    return cases


def backward_cases(dtype):
    """[(label, {kid: launch}, {kid: bound ms}, SDPA backward ms)] in
    `dtype`: K3 and K4 on the budget mask at 1 x 12 x 2048 x 64, at
    LLaMA-7b's layer, 1 x 32 x 2048 x 128, and at the float32 train arms'
    1 x 32 x 512 x 80 and x 128, and K7 and K8 on shard 0's rows and window
    0 of the ring-kernels geometry, each at the lse and delta of its own
    forward (this tree's K2 or K6)."""
    cases = []
    for T, heads, width in ((2048, cs.H, cs.D), (2048, cs.WIDE_H, cs.LLAMA_D),
                            (512, cs.WIDE_H, cs.WIDE_D), (512, cs.WIDE_H, cs.LLAMA_D)):
        q, k, v, sc = cs.qkv(1, T, dtype, seed=T, device="cuda", heads=heads, width=width)
        do = torch.randn(q.shape, generator=torch.Generator().manual_seed(T + 1)).to("cuda", dtype)
        mask = cs.budget_mask(1, T, seed=T, device="cuda", heads=heads)
        ops = cs.diff_operands(q, k, v, mask, sc)
        o, lse = bs.causal_fwd_stats(ops)
        _, dou, delta = bs.backward_terms(do, o, sc.to(dtype), dtype)
        cases.append((f"budget 1x{heads}x{T}x{width}", {
            "K3": lambda ops=ops, a=(dou, lse, delta): bs.causal_dq(ops, *a),
            "K4": lambda ops=ops, a=(dou, lse, delta): bs.causal_dkv(ops, *a),
        }, {kid: cs.diff_bound(kid, ops, mask)[0] for kid in ("K3", "K4")},
            sdpa_bwd_ms(q, k, v, do, True)))
    wops, k0, v0, q0, per_call, nnz = ring_window(dtype)
    cases.append((f"ring 1x{cs.H}x{cs.RING_CHECK_T} shard 0 window 0", {
        "K7": lambda: bs.dq_window(wops, 0, k0, v0, *per_call),
        "K8": lambda: bs.dkv_window(wops, 0, k0, v0, *per_call),
    }, {kid: max(cs.window_bound(kid, wops, nnz)) for kid in ("K7", "K8")},
        sdpa_bwd_ms(q0, k0, v0, per_call[0], False)))
    return cases


def device_ms(fn, n=20) -> float:
    """The device time one call of `fn` spends in the bodies' kernels, from
    torch.profiler's CUDA activity (the mean of n calls after one): the
    one-call event time (`chip_smoke.time_ms`) also counts the host's launch
    path, tens of µs that dominate the short shapes."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
                for ev in prof.key_averages() if "causal_" in ev.key)
    return total / n / 1e3


def time_cases(libs: dict, names: list, cases, what: str, attr: str):
    """Time each case's launches (`forward_cases` or `backward_cases`) with
    each library of `names` swapped in for the wrappers' (`attr`: `_lib`,
    `_diff_lib`), printing each library's one-call and device times and
    whether its outputs equal the first one's bit for bit (else their
    max|diff|)."""
    for label, launches, bounds, sdpa in cases:
        print(f"[ab] {label} {what}: sdpa {sdpa:.4f} ms; bound "
              + ", ".join(f"{kid} {b:.4f} ms" for kid, b in bounds.items()), flush=True)
        ref = None  # the first library's outputs: the others' are held to them
        for name in names:
            outs = with_lib(libs[name], lambda: [fn() for fn in launches.values()], attr)
            ref = ref or (name, outs)
            pairs = list(zip(_tensors(outs), _tensors(ref[1])))
            diff = max(float(torch.where(a == b, 0.0, (a.float() - b.float()).abs()).max())
                       for a, b in pairs)  # equal infinities count as no difference
            same = all(torch.equal(a, b) for a, b in pairs)
            times = {kid: with_lib(libs[name], lambda: cs.time_ms(fn), attr)
                     for kid, fn in launches.items()}
            dev = {kid: with_lib(libs[name], lambda: device_ms(fn), attr)
                   for kid, fn in launches.items()}
            print(f"[ab] {label} {what} {name}: "
                  + ", ".join(f"{kid} {t:.4f} ms (device {dev[kid]:.4f})"
                              for kid, t in times.items())
                  + (f", together {sum(times.values()):.4f} ms" if len(times) > 1 else "")
                  + ("" if name.startswith("ko-") else
                     f"; output bits equal to {ref[0]}'s" if same else
                     f"; max|diff| from {ref[0]}'s {diff:.3g}"),
                  flush=True)


def _tensors(outs):
    """The tensors of a list of kernel outputs (a tensor or a tuple each)."""
    return [t for o in outs for t in (o if isinstance(o, tuple) else (o,))]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of the commit to compare with")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    BUILD.mkdir(parents=True, exist_ok=True)
    sources = {"this": (SOURCE, SOURCE.parent), "this-bwd": (DIFF_SOURCE, DIFF_SOURCE.parent),
               **knockout_sources(),
               **knockout_sources(SOURCE, F32_KNOCKOUTS, "ko-f32"),
               **knockout_sources(DIFF_SOURCE, DIFF_KNOCKOUTS, "ko-bwd"),
               **knockout_sources(DIFF_SOURCE, F32_DIFF_KNOCKOUTS, "ko-bwd32")}
    if args.parent:
        psrc = args.parent / "sea_tpu_torch" / "csrc"
        sources["parent"] = (psrc / "block_sparse_causal.cu", psrc)
        sources["parent-bwd"] = (psrc / "block_sparse_diff.cu", psrc)
    t0 = time.perf_counter()
    libs = build(sources)
    print(f"[ab] {len(libs)} libraries built in {time.perf_counter() - t0:.1f} s", flush=True)
    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    knocked = {prefix: [n for n in libs if n.startswith(prefix + "-")]
               for prefix in ("ko-f32", "ko-bwd", "ko-bwd32")}
    knocked["ko"] = [n for n in libs if n.startswith("ko-")
                     and n not in knocked["ko-f32"] + knocked["ko-bwd"] + knocked["ko-bwd32"]]

    # the forward: float32 with the float32 body's knock-outs, bf16 with the bf16 body's
    for dtype, prefix in ((torch.float32, "ko-f32"), (torch.bfloat16, "ko")):
        time_cases(libs, order + knocked[prefix], forward_cases(dtype),
                   f"{str(dtype)[6:]} forward", "_lib")
    # the backward (its forward, K2 or K6, from this tree's library): float32
    # with the float32 bodies' knock-outs, bf16 with the bf16 bodies'
    bwd = [f"{n}-bwd" for n in order]
    for dtype, ko in ((torch.float32, knocked["ko-bwd32"]), (torch.bfloat16, knocked["ko-bwd"])):
        time_cases(libs, bwd + ko, backward_cases(dtype), f"{str(dtype)[6:]} backward",
                   "_diff_lib")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
