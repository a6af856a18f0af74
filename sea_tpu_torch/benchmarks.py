"""The attention-operator sweep: latency and memory per causal attention
operator across sequence lengths (PyTorch port).

Port of `sea_tpu/benchmarks.py` (`timeit`, `device_peak_bytes`,
`compiled_buffer_bytes`, `attention_method_sweep`, `main`), itself the
analogue of the reference's `src/main/benchmark_bert.py:32-100`. Four causal
operators at OPT-125m's attention width (H = 12, D = 64, T_M = 256, k = 64):

  dense      softmax(q·kᵀ + causal mask)·v;
  performer  FAVOR+ with 266 generalized ReLU features (`fast_attention`);
  cosformer  the cos-reweighted causal linear attention (`ops.cosformer`);
  sea_fused  `sea_block_sparse_attention(..., impl="flat_wr")`, kernel K9a
             on the card, on a random compressed mask of density k·T_M/T.

Each timing runs `iters` dependent calls, c ← c + 1e-30·fn(c, k, v), between
two synchronises and keeps the best of 3 such runs, after one warm-up run.
PyTorch runs eagerly, so a host-bound operator (the performer's and the
cosformer's chunk loops) is timed with its host time: its ms is not device
time alone, as the JAX sweep's jitted loop is. `bench.py`'s host-built top-k
mask is here too (`host_topk_mask`), for the kernels' checks.

    python -m sea_tpu_torch.benchmarks --suite attention [--seq-lens 1024 2048 4096]
        [--dtype float32|bfloat16] [--json out.json]

It runs on the card; `attention_method_sweep(device="cpu", ...)` runs the
plain versions at a small size. The JAX sweep's `--suite scaling` is not
ported.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .ops.cosformer import _cos_features, cosformer_causal
from .ops.kernels.block_sparse import sea_block_sparse_attention
from .ops.performer import fast_attention, gaussian_orthogonal_random_matrix

METHODS = ("dense", "performer", "cosformer", "sea_fused")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def host_topk_mask(N, H, T, T_M, K, seed=0):
    """Per-row compressed mask with the reference budget schedule
    round(H·K·T_M/(r + 1)), clipped to [1, H·T_M], each row's pixels drawn
    without replacement over its H·T_M slots (a copy of `bench.py`'s, the
    same numpy calls in the same order)."""
    rng = np.random.default_rng(seed)
    flat = np.zeros((N, T, H * T_M), np.float32)
    for r in range(T):
        budget = min(max(round(H * K * T_M / (r + 1)), 1), H * T_M)
        for n in range(N):
            flat[n, r, rng.choice(H * T_M, size=budget, replace=False)] = 1.0
    return np.transpose(flat.reshape(N, T, H, T_M), (0, 2, 1, 3)).copy()


def _synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> float:
    """Seconds per call of fn(*args): `iters` calls between two
    synchronises of the device of args[0], after `warmup` calls."""
    device = args[0].device
    for _ in range(warmup):
        fn(*args)
    _synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _synchronize(device)
    return (time.perf_counter() - t0) / iters


def device_peak_bytes(device) -> Optional[int]:
    """Peak device memory allocated by PyTorch on `device` since the last
    reset (`torch.cuda.max_memory_allocated`); None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def call_peak_bytes(fn: Callable, *args) -> Optional[int]:
    """One call's own device-memory footprint: the peak allocation during
    fn(*args) above what was allocated before it. The counterpart of the JAX
    sweep's `compiled_buffer_bytes` (XLA's temp + output buffers of the
    compiled call); None on the CPU."""
    device = args[0].device
    if device.type != "cuda":
        return None
    _synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn(*args)
    _synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - before
    del out
    return int(peak)


def attention_operators(T: int, mask_m: torch.Tensor, proj: torch.Tensor,
                        dtype: torch.dtype) -> Dict[str, Callable]:
    """The sweep's operators on (1, H, T, D) q, k, v, each returning
    (1, H, T, D): dense causal softmax attention (scores and softmax in
    float32 past the first product, as the JAX sweep promotes them), FAVOR+
    with the projection `proj`, cosformer, and the fused sparse kernel on
    `mask_m` with impl 'flat_wr'."""
    fpmin = float(np.finfo(np.float16).min) / 2 if dtype != torch.float32 \
        else float(np.finfo(np.float32).min) / 2

    def dense_fn(q, kk, v):
        tri = torch.ones((T, T), device=q.device).tril() > 0
        causal = torch.where(tri, 0.0, fpmin)[None, None]
        scores = torch.einsum("nhtd,nhsd->nhts", q, kk) + causal
        return torch.einsum("nhts,nhsd->nhtd", torch.softmax(scores, -1), v.float())

    def cosformer_fn(q, kk, v):
        N, H, _, D = q.shape
        fold = lambda x: x.reshape(N * H, T, D)  # noqa: E731
        qp = _cos_features(torch.relu(fold(q)), T)
        kp = _cos_features(torch.relu(fold(kk)), T)
        return cosformer_causal(qp, kp, fold(v)).reshape(N, H, T, D)

    return {
        "dense": dense_fn,
        "performer": lambda q, kk, v: fast_attention(
            q, kk, v, proj, causal=True, generalized=True),
        "cosformer": cosformer_fn,
        "sea_fused": lambda q, kk, v: sea_block_sparse_attention(
            q, kk, v, mask_m, None, is_causal=True, impl="flat_wr"),
    }


def sweep_inputs(T: int, num_heads: int, head_dim: int, t_m: int, k: int,
                 dtype: torch.dtype, device):
    """q, k, v (1, H, T, D) in `dtype` and the (1, H, T, T_M) float32 mask of
    density min(k·T_M/T, 1), from numpy's generator seeded 0: the JAX
    sweep's inputs, drawn in the same order."""
    H, D = num_heads, head_dim
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, H, T, D)).astype(np.float32) * 0.2
    kk = rng.standard_normal((1, H, T, D)).astype(np.float32) * 0.2
    v = rng.standard_normal((1, H, T, D)).astype(np.float32)
    mask_m = (rng.uniform(size=(1, H, T, t_m)) < min(k * t_m / T, 1.0)).astype(np.float32)
    q, kk, v = (torch.from_numpy(x).to(device=device, dtype=dtype) for x in (q, kk, v))
    return q, kk, v, torch.from_numpy(mask_m).to(device)


def attention_method_sweep(
    methods: Optional[List[str]] = None,
    seq_lens: Optional[List[int]] = None,
    num_heads: int = 12,
    head_dim: int = 64,
    t_m: int = 256,
    k: int = 64,
    dtype: str = "float32",
    device="cuda",
) -> List[Dict]:
    """Latency and per-call memory of each operator at each sequence
    length: one record per (method, T) with `ms` (the best of 3 timed runs,
    per call), `mem_mb` (`call_peak_bytes`) and `peak_mem_mb` (the device's
    peak during that call, all that was resident included) on the card, and
    the device's name; or, when the card runs out of memory, an `error`
    record instead. The performer's 266 x D projection is drawn from the
    port's generator seeded 0 (the JAX sweep draws it with
    jax.random.key(0))."""
    methods = methods or list(METHODS)
    seq_lens = seq_lens or [1024, 2048, 4096]
    device = torch.device(device)
    dt = DTYPES[dtype]
    proj = gaussian_orthogonal_random_matrix(
        torch.Generator().manual_seed(0), 266, head_dim, device=device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    results = []
    for T in seq_lens:
        q, kk, v, mask_m = sweep_inputs(T, num_heads, head_dim, t_m, k, dt, device)
        fns = attention_operators(T, mask_m, proj, dt)
        # the JAX sweep's count on the chip; 2 on the CPU
        iters = max(4, min(60, 60 * 4096 // T)) if device.type == "cuda" else 2

        def repeat(fn):
            def run(q, *args):
                c = q
                for _ in range(iters):
                    c = c + (1e-30 * fn(c, *args)).to(c.dtype)
                return c
            return run

        for m in methods:
            try:
                fn = repeat(fns[m])
                best = min(timeit(fn, q, kk, v, iters=1, warmup=1 if rep == 0 else 0)
                           for rep in range(3))
                rec = {"method": m, "seq_len": T, "dtype": dtype, "device": name,
                       "ms": best / iters * 1e3}
                buf = call_peak_bytes(fns[m], q, kk, v)
                if buf is not None:
                    rec["mem_mb"] = buf / 2 ** 20
                peak = device_peak_bytes(device)
                if peak is not None:
                    rec["peak_mem_mb"] = peak / 2 ** 20
                results.append(rec)
            except torch.cuda.OutOfMemoryError as e:  # as the reference harness
                results.append({"method": m, "seq_len": T, "dtype": dtype,
                                "device": name, "error": str(e)[:200]})
                torch.cuda.empty_cache()
    return results


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--suite", default="attention", choices=["attention"])
    p.add_argument("--json", default=None)
    p.add_argument("--seq-lens", type=int, nargs="*", default=None)
    p.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    args = p.parse_args()
    res = attention_method_sweep(seq_lens=args.seq_lens, dtype=args.dtype)
    out = json.dumps(res, indent=2)
    print(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out)


if __name__ == "__main__":
    main()
