"""A/B and knock-out timing of the forward and backward mma bodies on one
NVIDIA GPU.

    python3 kernel_ab.py [--parent DIR]

Builds `sea_tpu_torch/csrc/block_sparse_causal.cu` (the forward body) and
`sea_tpu_torch/csrc/block_sparse_diff.cu` (the backward bodies) of this tree
and, with `--parent`, the same two files of another checkout (for one
commit: `mkdir DIR && git archive <commit> | tar -x -C DIR`; the window
entry points take `is_bf16` since the ring's bf16 instances, so a parent
older than that times K7 and K8 through another signature), plus copies
of this tree's sources with one part of a body knocked out (nine): 13 nvcc
builds with a parent, 11 without, all started together (about 20 s on the
card's host). Then it times, with CUDA events on the same operands, the
parent and this tree in the order parent, this, this, parent, then the
knock-outs:
  * the forward: each library's K1 and K9a entry points (bench.py's
    1 x 12 x 4096 configuration with its `host_topk_mask`, and K1 on the
    budget mask at the main path's 1 x 2048), float32 and bfloat16, beside
    SDPA;
  * the backward, float32: K3 and K4 on the budget mask at 1 x 2048, and K7
    and K8 on one (shard, window) of chip_smoke's ring-kernels geometry (4
    shards at 1 x 4096, zigzag rows, blocks 128: shard 0's rows on window
    0), beside SDPA's backward on the same shapes.

A knock-out computes another function; it only splits the time. Forward:
  pred     the element predicate reduced to the causal edge (no pixel, no
           mask word);
  exp      the softmax's 2^x left out (P is the exponent itself);
  split    bf16 P·V without P's low half (one mma, not two);
  products no Q·Kᵀ or P·V mma (bf16);
  all      the three above together: what is left is the walk, the copies,
           the barriers, the softmax's bookkeeping and the epilogue.
Backward (`bwd-`; dq and dk/dv alike):
  pred     the element predicate reduced to the causal edge;
  exp      P's 2^x left out (P is the exponent itself);
  products no mma at all (S, dP, and dq or dk and dv);
  all      the three together: the walk, the copies, the barriers, the
           splits' loads and the epilogue.
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
# (text of this tree's source, what replaces it) per knock-out
KNOCKOUTS = {
    "pred": [("bool a = (BIDIR ? col < len : pix >= 0) & sea::pixel_bit(word, pix);",
              "bool a = col <= r;")],
    "exp": [("x = exp2_sfu(__fmaf_rn(x, LOG2E, -ml));", "x = __fmaf_rn(x, LOG2E, -ml);")],
    "split": [("mma_bf16(acc[2 * jp], pl, b[0], b[1]);", ""),
              ("mma_bf16(acc[2 * jp + 1], pl, b[2], b[3]);", "")],
    "products": [("mma_bf16(s[2 * jp], qa[kk], b[0], b[1]);", ""),
                 ("mma_bf16(s[2 * jp + 1], qa[kk], b[2], b[3]);", ""),
                 ("mma_bf16(acc[2 * jp], pl, b[0], b[1]);", ""),
                 ("mma_bf16(acc[2 * jp], ph, b[0], b[1]);", ""),
                 ("mma_bf16(acc[2 * jp + 1], pl, b[2], b[3]);", ""),
                 ("mma_bf16(acc[2 * jp + 1], ph, b[2], b[3]);", "")],
}
KNOCKOUTS["all"] = KNOCKOUTS["pred"] + KNOCKOUTS["exp"] + KNOCKOUTS["products"]
# the same for the backward bodies, each edit once in dq and once in dk/dv
DIFF_KNOCKOUTS = {
    "pred": [("alive_elem_recip(words, x, col, r, wf[h], yw[h], t_m)", "col <= r"),
             ("alive_elem_recip(words, xc[h], gc[h], grow0 + rl, rt.z, rt.w, t_m)",
              "gc[h] <= grow0 + rl")],
    "exp": [("exp2_sfu(__fmaf_rn(sv, LOG2E, -l2[h]))", "__fmaf_rn(sv, LOG2E, -l2[h])"),
            ("exp2_sfu(__fmaf_rn(pt, LOG2E, -rt.x))", "__fmaf_rn(pt, LOG2E, -rt.x)")],
    "products": [
        ("mma_3xtf32(s[j], qh, ql, kf.x, kf.y);", ";"),
        ("mma_3xtf32(dp[j], oh, ol, vf.x, vf.y);", ";"),
        ("mma_3xtf32(acc[j], ah, al, Ks[c * LDD + 8 * j + g], Ks[(c + 1) * LDD + 8 * j + g]);",
         ";"),
        ("mma_3xtf32(st[j], kh, kl, qf.x, qf.y);", ";"),
        ("mma_3xtf32(dpt[j], vh, vl, of.x, of.y);", ";"),
        ("mma_3xtf32(acc_v[j], ph, pl, Ot[c * LDD + n], Ot[(c + 1) * LDD + n]);", ";"),
        ("mma_3xtf32(acc_k[j], dh, dl, Qt[c * LDD + n], Qt[(c + 1) * LDD + n]);", ";")],
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


def backward_cases():
    """[(label, {kid: launch}, {kid: bound ms}, SDPA backward ms)]: K3 and K4
    on the budget mask at 1 x 2048, and K7 and K8 on shard 0's rows and
    window 0 of the ring-kernels geometry, each at the lse and delta of its
    own forward (this tree's K2 or K6)."""
    T = 2048
    q, k, v, sc = cs.qkv(1, T, torch.float32, seed=T, device="cuda")
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(T + 1)).to("cuda")
    mask = cs.budget_mask(1, T, seed=T, device="cuda")
    ops = cs.diff_operands(q, k, v, mask, sc)
    o, lse = bs.causal_fwd_stats(ops)
    _, dou, delta = bs.backward_terms(do, o, sc, torch.float32)
    cases = [(f"budget 1x{cs.H}x{T}", {
        "K3": lambda: bs.causal_dq(ops, dou, lse, delta),
        "K4": lambda: bs.causal_dkv(ops, dou, lse, delta),
    }, {kid: cs.diff_bound(kid, ops, mask)[0] for kid in ("K3", "K4")},
        sdpa_bwd_ms(q, k, v, do, True))]

    T = cs.RING_CHECK_T
    q, k, v, sc = cs.qkv(1, T, torch.float32, seed=21, device="cuda")
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(22)).to("cuda")
    mask = cs.budget_mask(1, T, seed=21, device="cuda")
    group = LocalGroup(cs.RING_SHARDS, q.device)
    bq, bk = sa._ring_blocks(T, group.size, cs.RING_BLOCK, cs.RING_BLOCK)
    perm, _, rows = sa._row_order(T, group.size, bq, True, q.device)
    qp, maskp, scp, dop = (x[:, :, perm] for x in (q, mask, sc, do))
    out, L, wops = sa._ring_forward(qp, k, v, maskp, scp, rows, group, bq, bk)
    _, dou, delta = bs.backward_terms(dop, out, scp, torch.float32)
    L = torch.where(torch.isneginf(L), float("inf"), L)
    q_l, m_l, dou_l, L_l, delta_l, k_w, v_w = (
        group.split_rows(x) for x in (qp, maskp, dou, L, delta, k, v))
    r_l = group.split_rows(rows, 0)
    per_call = (dou_l[0], L_l[0], delta_l[0])
    nnz = cs.window_nnz(m_l[0], r_l[0], 0, wops[0].window)
    cases.append((f"ring 1x{cs.H}x{T} shard 0 window 0", {
        "K7": lambda: bs.dq_window(wops[0], 0, k_w[0], v_w[0], *per_call),
        "K8": lambda: bs.dkv_window(wops[0], 0, k_w[0], v_w[0], *per_call),
    }, {kid: max(cs.window_bound(kid, wops[0], nnz)) for kid in ("K7", "K8")},
        sdpa_bwd_ms(q_l[0], k_w[0], v_w[0], dou_l[0], False)))
    return cases


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

    # the backward; its forward (K2, K6) from this tree's library
    for label, launches, bounds, sdpa in backward_cases():
        print(f"[ab] {label} float32 backward: sdpa bwd {sdpa:.4f} ms; bound "
              + ", ".join(f"{kid} {b:.4f} ms" for kid, b in bounds.items()), flush=True)
        for name in bwd_order:
            times = {kid: with_lib(libs[name], lambda: cs.time_ms(fn), "_diff_lib")
                     for kid, fn in launches.items()}
            print(f"[ab] {label} float32 {name}: "
                  + ", ".join(f"{kid} {t:.4f} ms" for kid, t in times.items())
                  + f", together {sum(times.values()):.4f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
