"""A/B and knock-out timing of the causal forward body on one NVIDIA GPU.

    python3 kernel_ab.py [--parent DIR]

Builds `sea_tpu_torch/csrc/block_sparse_causal.cu` of this tree and, with
`--parent`, the same file of another checkout (for one commit: `mkdir DIR &&
git archive <commit> | tar -x -C DIR`), plus copies of this tree's source
with one part of the forward body knocked out, one nvcc each, all started
together. Then it times each library's K1 and K9a entry points with CUDA
events on the same operands (bench.py's 1 x 12 x 4096 configuration with
its `host_topk_mask`, and K1 on the budget mask at the main path's 1 x 2048),
float32 and bfloat16, beside SDPA; the parent and this tree in the order
parent, this, this, parent.

A knock-out computes another function; it only splits the time:
  pred     the element predicate reduced to the causal edge (no pixel, no
           mask word);
  exp      the softmax's 2^x left out (P is the exponent itself);
  split    bf16 P·V without P's low half (one mma, not two);
  products no Q·Kᵀ or P·V mma (bf16);
  all      the three above together: what is left is the walk, the copies,
           the barriers, the softmax's bookkeeping and the epilogue.
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

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "sea_tpu_torch" / "csrc" / "block_sparse_causal.cu"
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
P, I, FL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


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
        lib.sea_causal_flat_forward.argtypes = [P] * 9 + [I] * 10 + [FL] * 4 + [I, P]
        lib.sea_causal_word_range_forward.argtypes = [P] * 10 + [I] * 11 + [FL] * 4 + [I, P]
        for fn in (lib.sea_causal_flat_forward, lib.sea_causal_word_range_forward):
            fn.restype = I
        libs[name] = lib
    return libs


def knockout_sources() -> dict:
    text = SOURCE.read_text()
    out = {}
    for name, edits in KNOCKOUTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"knock-out {name}: {old!r} is not in the source once")
            src = src.replace(old, new)
        path = BUILD / f"ko_{name}.cu"
        path.write_text(src)
        out[f"ko-{name}"] = (path, SOURCE.parent)
    return out


def with_lib(lib, fn):
    """fn() with the wrappers' library swapped for `lib`."""
    saved = bs._lib
    bs._lib = lambda: lib
    try:
        return fn()
    finally:
        bs._lib = saved


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of the commit to compare with")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    BUILD.mkdir(parents=True, exist_ok=True)
    sources = {"this": (SOURCE, SOURCE.parent), **knockout_sources()}
    if args.parent:
        psrc = args.parent / "sea_tpu_torch" / "csrc"
        sources["parent"] = (psrc / "block_sparse_causal.cu", psrc)
    t0 = time.perf_counter()
    libs = build(sources)
    print(f"[ab] {len(libs)} libraries built in {time.perf_counter() - t0:.1f} s", flush=True)
    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    order += [n for n in libs if n.startswith("ko-")]

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
        for name in order:
            lib = libs[name]
            k1 = with_lib(lib, lambda: cs.time_ms(lambda: bs.launch_causal_flat(ops)))
            k9a = (with_lib(lib, lambda: cs.time_ms(lambda: bs._launch_impl(wops, "flat_wr")))
                   if with_k9a else None)
            print(f"[ab] {label} {str(dtype)[6:]} {name}: K1 {k1:.4f} ms"
                  + (f", K9a {k9a:.4f} ms" if k9a is not None else ""), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
