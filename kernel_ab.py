"""A/B and knock-out timing of the forward and backward bodies on one
NVIDIA GPU.

    python3 kernel_ab.py [--parent DIR]

Builds `sea_tpu_torch/csrc/block_sparse_causal.cu` (the forward body) and
`sea_tpu_torch/csrc/block_sparse_diff.cu` (the backward bodies) of this tree
and, with `--parent`, the same two files of another checkout (for one
commit: `mkdir DIR && git archive <commit> | tar -x -C DIR`; the window
entry points take `is_bf16` since the ring's bf16 instances, so a parent
older than that times K7 and K8 through another signature), plus copies
of this tree's sources with one part of a body knocked out (ten): 14 nvcc
builds with a parent, 12 without, all started together (about 20 s on the
card's host). Then it times, with CUDA events on the same operands, the
parent and this tree in the order parent, this, this, parent, then the
knock-outs:
  * the forward: each library's K1 and K9a entry points (bench.py's
    1 x 12 x 4096 configuration with its `host_topk_mask`, and K1 on the
    budget mask at the main path's 1 x 2048), float32 and bfloat16, beside
    SDPA;
  * the backward, float32 then bfloat16: K3 and K4 on the budget mask at
    1 x 12 x 2048 x 64 and at LLaMA-7b's layer, 1 x 32 x 2048 x 128, and K7
    and K8 on one (shard, window) of chip_smoke's ring-kernels geometry (4
    shards at 1 x 4096, zigzag rows, blocks 128: shard 0's rows on window
    0), beside SDPA's backward on the same shapes in the same type; each
    output is compared with the first library's bit for bit.

A knock-out computes another function; it only splits the time. Forward
(the bf16 body on wgmma, `causal_wgmma_kernel`; the float32 instances are
left as they are):
  pred     the rows' alive words reduced to the causal edge (no pixel, no
           mask word, no run boundary);
  exp      the softmax's 2^x left out (P is the exponent itself);
  split    P·V without P's low half (one wgmma per 16 columns, not two);
  products no Q·Kᵀ or P·V wgmma;
  all      pred, exp and products together: what is left is the walk, the
           TMA copies, the barriers, the bit test, the softmax's
           bookkeeping and the epilogue.
Backward (`bwd-`; the bf16 bodies on wgmma, `causal_dq_wgmma_kernel` and
`causal_dkv_wgmma_kernel`, each edit made in both; the edits sit in code
that every width's instance shares; the float32 instances are left as they
are):
  pred     the alive words reduced to the causal edge (no pixel, no mask
           word, no run boundary);
  exp      P's 2^x left out (P is the exponent itself);
  split    the products of P's and dS's low halves left out;
  products no wgmma at all (S, dP, and dq or dk and dv);
  all      pred, exp and products together: the walk, the TMA copies, the
           barriers, the bit tests, the splits and the epilogue.
Needs a CUDA device and nvcc; prints one line per timing and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import time
from pathlib import Path

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
# the same for the backward's bf16 bodies (`causal_dq_wgmma_kernel`,
# `causal_dkv_wgmma_kernel`), each edit found once, in dq and in dk/dv
DIFF_KNOCKOUTS = {
    "pred": [("sea::alive_bits<false, false>(rows, c0, t_m, 0, n_words - 1, t4, bits);",
              "for (int h = 0; h < 2; ++h) bits[h] = rows[h].cl < c0 ? 0ull"
              " : sea::low_bits(min(rows[h].cl, c0 + 63) - c0 + 1);"),
             ("sea::alive_bits<false, false>(wrow, gcol(cw), t_m, 0, n_words - 1, t4, bits);",
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
P, I, FL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the entry points timed here, by library
ARGTYPES = {
    "sea_causal_flat_forward": [P] * 9 + [I] * 10 + [FL] * 4 + [I, P],
    "sea_causal_word_range_forward": [P] * 10 + [I] * 11 + [FL] * 4 + [I, P],
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
    knock-out; raises unless every edit's text is in the source once."""
    text = source.read_text()
    out = {}
    for name, edits in knockouts.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"knock-out {name}: {old!r} is not in the source once")
            src = src.replace(old, new)
        path = BUILD / f"{prefix}_{name}.cu"
        path.write_text(src)
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


def backward_cases(dtype):
    """[(label, {kid: launch}, {kid: bound ms}, SDPA backward ms)] in
    `dtype`: K3 and K4 on the budget mask at 1 x 12 x 2048 x 64 and at
    LLaMA-7b's layer, 1 x 32 x 2048 x 128, and K7 and K8 on shard 0's rows
    and window 0 of the ring-kernels geometry, each at the lse and delta of
    its own forward (this tree's K2 or K6)."""
    cases = []
    T = 2048
    for heads, width in ((cs.H, cs.D), (cs.WIDE_H, cs.LLAMA_D)):
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
    k0, v0 = k_w[0].contiguous(), v_w[0].contiguous()
    nnz = cs.window_nnz(m_l[0], r_l[0], 0, wops[0].window)
    cases.append((f"ring 1x{cs.H}x{T} shard 0 window 0", {
        "K7": lambda: bs.dq_window(wops[0], 0, k0, v0, *per_call),
        "K8": lambda: bs.dkv_window(wops[0], 0, k0, v0, *per_call),
    }, {kid: max(cs.window_bound(kid, wops[0], nnz)) for kid in ("K7", "K8")},
        sdpa_bwd_ms(q_l[0], k0, v0, dou_l[0], False)))
    return cases


def time_backward(libs: dict, order: list, dtypes=(torch.float32, torch.bfloat16)):
    """Time the backward cases in each of `dtypes` with each library of
    `order` (the knock-outs, which edit the bf16 bodies, in bf16 only),
    printing whether each library's outputs equal the first one's bit for
    bit. The forward (K2, K6) that gives lse comes from this tree's
    library."""
    for dtype in dtypes:
        tname = str(dtype)[6:]
        names = [n for n in order if dtype == torch.bfloat16 or not n.startswith("ko-")]
        for label, launches, bounds, sdpa in backward_cases(dtype):
            print(f"[ab] {label} {tname} backward: sdpa bwd {sdpa:.4f} ms; bound "
                  + ", ".join(f"{kid} {b:.4f} ms" for kid, b in bounds.items()), flush=True)
            ref = None  # the first library's outputs: the others' are held to them
            for name in names:
                outs = with_lib(libs[name], lambda: [fn() for fn in launches.values()],
                                "_diff_lib")
                ref = ref or (name, outs)
                same = all(torch.equal(a, b) for a, b in
                           zip(_tensors(outs), _tensors(ref[1])))
                times = {kid: with_lib(libs[name], lambda: cs.time_ms(fn), "_diff_lib")
                         for kid, fn in launches.items()}
                print(f"[ab] {label} {tname} {name}: "
                      + ", ".join(f"{kid} {t:.4f} ms" for kid, t in times.items())
                      + f", together {sum(times.values()):.4f} ms"
                      + ("" if name.startswith("ko-") else
                         f"; output bits {'equal to' if same else 'differ from'} {ref[0]}'s"),
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
               **knockout_sources(DIFF_SOURCE, DIFF_KNOCKOUTS, "ko-bwd")}
    if args.parent:
        psrc = args.parent / "sea_tpu_torch" / "csrc"
        sources["parent"] = (psrc / "block_sparse_causal.cu", psrc)
        sources["parent-bwd"] = (psrc / "block_sparse_diff.cu", psrc)
    t0 = time.perf_counter()
    libs = build(sources)
    print(f"[ab] {len(libs)} libraries built in {time.perf_counter() - t0:.1f} s", flush=True)
    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    order += [n for n in libs if n.startswith("ko-") and not n.startswith("ko-bwd-")]
    bwd_order = [f"{n}-bwd" for n in order if not n.startswith("ko-")]
    bwd_order += [n for n in libs if n.startswith("ko-bwd-")]

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, sc, mask = cs.bench_inputs(dtype, "cuda")
        cases.append((f"bench 1x{cs.H}x{cs.BENCH_T}", dtype, q, k, v, sc, mask, True))
        q, k, v, sc = cs.qkv(1, 2048, dtype, seed=2048, device="cuda")
        cases.append(("budget 1x12x2048", dtype, q, k, v, sc,
                      cs.budget_mask(1, 2048, seed=2048, device="cuda"), False))
    for label, dtype, q, k, v, sc, mask, with_k9a in cases:
        ops = bs.kernel_operands(bs.prepare_inputs(q, k, v, mask, sc))
        wops = cs.impl_operands(q, k, v, mask, sc, "flat_wr", None, None)
        sdpa = cs.time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        bound_ms, bound_by, *_ = cs.bound(ops, mask)
        print(f"[ab] {label} {str(dtype)[6:]}: sdpa {sdpa:.4f} ms, bound {bound_ms:.4f} ms "
              f"by {bound_by}", flush=True)
        ref = None  # (name, outputs) of the first library: the others' are held to them
        for name in order:
            lib = libs[name]
            outs = [with_lib(lib, lambda: bs.launch_causal_flat(ops))]
            if with_k9a:
                outs.append(with_lib(lib, lambda: bs._launch_impl(wops, "flat_wr")))
            ref = ref or (name, outs)
            k1 = with_lib(lib, lambda: cs.time_ms(lambda: bs.launch_causal_flat(ops)))
            k9a = (with_lib(lib, lambda: cs.time_ms(lambda: bs._launch_impl(wops, "flat_wr")))
                   if with_k9a else None)
            same = all(torch.equal(a, b) for a, b in zip(outs, ref[1]))
            print(f"[ab] {label} {str(dtype)[6:]} {name}: K1 {k1:.4f} ms"
                  + (f", K9a {k9a:.4f} ms" if k9a is not None else "")
                  + ("" if name.startswith("ko-") else
                     f"; output bits {'equal to' if same else 'differ from'} {ref[0]}'s"),
                  flush=True)

    time_backward(libs, bwd_order)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
