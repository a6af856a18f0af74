"""Chip smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Needs a CUDA device and nvcc; it builds the port's kernels from `csrc/`,
then runs five phases and fails (non-zero exit) if any of them fails:

  1. device   — the card's name and power limit; TF32 off for matmuls and
                convolutions (the port's float32 path is checked against
                float32 references);
  2. mask     — the kernel's element predicate (`alive_mask`) against the
                torch oracle `element_mask_int8`, bit for bit, for T up to 8192;
  3. kernel   — the causal fused sparse attention kernel against its plain
                PyTorch version at the main-path shapes (H=12, D=64, T_M=256,
                k=64, production top-k budget), float32 and bfloat16, plus
                edge cases; times of the kernel, the plain version and
                PyTorch's own SDPA at the same shape (a yardstick only);
  4. slice    — the main path: OPT-125m with the SEA student, seeded random
                weights, scoring two prompts of 1024 tokens in one batch and
                then one of 2048 to logits on the fused benchmark path; the
                kernel must run 12 times per forward, and layer 0's kernel
                inputs, captured from the run, are held against the plain
                version; ms/forward beside the dense OPT-125m;
  5. result   — one JSON line of per-kernel numbers, then the device line.

Tolerances: float32 1e-5 abs (both sides do float32 arithmetic, summed in
another order); bfloat16 1e-5 plus half a bf16 ulp of the float32 plain
result on the same bf16 inputs (the kernel sums in float32 and rounds once).
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from sea_tpu_torch.models.opt import OptForCausalLM, opt_125m
from sea_tpu_torch.ops.kernels import _build
from sea_tpu_torch.ops.kernels import block_sparse as bs
from sea_tpu_torch.ops.masks import _ranks_desc, fp_min_for, topk_mask
from sea_tpu_torch.utils.profiler import get_bench

H, D, T_M, K = 12, 64, 256, 64
F32_TOL, BF16_HALF_ULP = 1e-5, 2.0 ** -8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # FFMA / tensor cores
KERNEL_SOURCE = "sea_tpu_torch/csrc/block_sparse_causal.cu"
REPLACES = "sea_tpu/ops/kernels/block_sparse.py:240"  # _causal_kernel_flat


def log(*a):
    print(*a, flush=True)


def require(cond, what):
    """A failed check ends the run with a non-zero exit (kept under -O)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fn, iters=20, warmup=3) -> float:
    """Median over `iters` CUDA-event-timed calls, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def budget_mask(N, T, seed, device):
    """(N, H, T, T_M) compressed mask with the production per-row budget
    round(H·k·T_M/(r+1)), clipped to [1, H·T_M], spread at random over
    the row's H·T_M pixels (the schedule of bench.py, written out)."""
    rng = np.random.default_rng(seed)
    flat = np.zeros((N, T, H * T_M), np.float32)
    for r in range(T):
        budget = min(max(round(H * K * T_M / (r + 1)), 1), H * T_M)
        for n in range(N):
            flat[n, r, rng.choice(H * T_M, size=budget, replace=False)] = 1.0
    m = np.transpose(flat.reshape(N, T, H, T_M), (0, 2, 1, 3)).copy()
    return torch.from_numpy(m).to(device)


def qkv(N, T, dtype, seed, device):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((N, H, T, D), generator=g) * 0.2
    k = torch.randn((N, H, T, D), generator=g) * 0.2
    v = torch.randn((N, H, T, D), generator=g)
    sc = torch.rand((N, H, T), generator=g) * 0.9 + 0.1
    return [x.to(device, dtype) for x in (q, k, v)] + [sc.to(device)]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def tolerance(want: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-element limit on |kernel − plain|, `want` being the plain version
    in float32 on the kernel's inputs: 1e-5 in float32; in bfloat16 also
    half a bf16 ulp of `want` (2^-8·|want|), since the kernel rounds its
    float32 result to bfloat16 once."""
    if dtype == torch.bfloat16:
        return F32_TOL + BF16_HALF_ULP * want.abs()
    return torch.full_like(want, F32_TOL)


def bound(ops: bs.KernelOperands, mask_m: torch.Tensor):
    """Least time the card needs for the function this launch computes: the
    larger of the FLOPs its alive elements need (q·k and p·v, 4·D each; the
    count is this mask's element nnz, not the kernel's visited tiles) at the
    peak for the input type, and the bytes of q, k, v, the mask bits, the
    scaler and the row bases read once and the output written once at the
    HBM rate. The tile lists are the kernel's own device, not the
    function's input, so their bytes are not counted."""
    require(ops.oversample == 1.0, "bound() counts alive elements without the keep-predicate")
    N, Hh, T, Dd = ops.shape
    flops = 4 * Dd * int(bs.mask_nnz(mask_m, ops.k.shape[1], True))
    es = ops.q.element_size()
    nbytes = (
        3 * ops.q.numel() * es  # q, k, v
        + ops.mbits.numel() * 4 + ops.scaler.numel() * 4 + ops.row_base.numel() * 4
        + ops.q.numel() * es  # out
    )
    t_ops = flops / PEAK_FLOPS[ops.q.dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def measure(q, k, v, mask, sc, **kw):
    """Kernel-only, wrapper, plain and SDPA times for one call's inputs."""
    x = bs.prepare_inputs(q, k, v, mask, sc)
    ops = bs.kernel_operands(x, kw.get("oversample", 1.0), kw.get("k_cfg", 64.0))
    ms = time_ms(lambda: bs.launch_causal_flat(ops))
    wrapper_ms = time_ms(lambda: bs.sea_block_sparse_attention(q, k, v, mask, sc, **kw))
    plain_ms = time_ms(
        lambda: bs.dense_reference(q, k, v, mask, sc.to(q.dtype), **kw), iters=5, warmup=1
    )
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
    )
    bound_ms, bound_by, flops, nbytes = bound(ops, x.mask_m)
    return dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                flops=flops, bytes=nbytes)


# ---------------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        "TF32 off for matmuls and cuDNN convolutions")
    log(f"[device] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} source(s) compiled in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(_build.sources())})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return smi


def phase_sort():
    """torch.sort(stable=True) on the card ranks ties as on the CPU, with
    +0.0 and -0.0 among them, at the grouped top-k's row width (H·T_M)."""
    g = torch.Generator().manual_seed(5)
    x = (torch.randint(0, 6, (64, H * T_M), generator=g) / 8.0).float()
    x[:, ::7] = 0.0
    x[:, 3::11] = -0.0
    cpu = _ranks_desc(x)
    gpu = _ranks_desc(x.cuda()).cpu()
    bad = int((cpu != gpu).sum())
    log(f"[sort] stable ranks on ties, cuda vs cpu: {bad} mismatches")
    require(bad == 0, "torch.sort ranks differ between the card and the CPU")


def phase_mask():
    dev = "cuda"
    g = torch.Generator().manual_seed(1)
    pix = torch.arange(T_M)
    for T in (128, 1000, 1024, 4096, 8192):
        masks = {
            "even": (pix % 2 == 0).float().expand(1, 1, T, T_M),
            "odd": (pix % 2 == 1).float().expand(1, 1, T, T_M),
            "random": (torch.rand((1, 1, T, T_M), generator=g) < 0.3).float(),
        }
        for name, m in masks.items():
            m = m.contiguous().to(dev)
            got = bs.alive_mask(m, T)
            want = bs.element_mask_int8(m, T, True)
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            log(f"[mask] T={T} {name}: {bad} mismatches of {T * T} elements")
            require(bad == 0, f"alive_mask != element_mask_int8 at T={T} ({name})")


def phase_kernel():
    dev = "cuda"
    for T in (1024, 2048, 4096):
        mask = budget_mask(1, T, seed=T, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, sc = qkv(1, T, dtype, seed=T, device=dev)
            got = bs.sea_block_sparse_attention(q, k, v, mask, sc)
            # the plain version in float32 on the same (rounded) inputs
            want = bs.dense_reference(q.float(), k.float(), v.float(), mask,
                                      sc.to(dtype).float())
            diff = (got.float() - want).abs()
            err = float(diff.max())
            over = float((diff - tolerance(want, dtype)).max())
            m = measure(q, k, v, mask, sc)
            log(f"[kernel] T={T} {str(dtype)[6:]}: max|err|={err:.3g} "
                f"(margin to tol {-over:.3g}) "
                f"kernel {m['ms']:.4f} ms (with prep {m['wrapper_ms']:.4f}), "
                f"plain {m['plain_ms']:.3f} ms, sdpa {m['library_ms']:.4f} ms, "
                f"bound {m['bound_ms']:.4f} ms by {m['bound_by']} "
                f"({m['flops'] / 1e9:.4f} GFLOP, {m['bytes'] / 1e6:.2f} MB)")
            require(over <= 0, f"kernel vs plain at T={T} {dtype}: {err}")

    # edge cases, float32
    q, k, v, sc = qkv(1, 1024, torch.float32, seed=7, device=dev)
    mask = budget_mask(1, 1024, seed=7, device=dev)
    empty = mask.clone()
    empty[:, :, 300:400] = 0.0
    got = bs.sea_block_sparse_attention(q, k, v, empty, sc)
    err = max_err(got, bs.dense_reference(q, k, v, empty, sc))
    zero = float(got[:, :, 300:400].abs().max())
    log(f"[kernel] empty rows: max|err|={err:.3g}, |out| on empty rows {zero}")
    require(err <= F32_TOL and zero == 0.0, f"empty rows: err {err}, |out| {zero}")

    kw = dict(oversample=2.0, k_cfg=64.0)
    got = bs.sea_block_sparse_attention(q, k, v, mask, sc, **kw)
    err = max_err(got, bs.dense_reference(q, k, v, mask, sc, **kw))
    log(f"[kernel] oversample=2.0 k_cfg=64: max|err|={err:.3g}")
    require(err <= F32_TOL, f"oversample: err {err}")

    q1, k1, v1, sc1 = qkv(1, 1000, torch.float32, seed=8, device=dev)
    m1 = budget_mask(1, 1000, seed=8, device=dev)
    got = bs.sea_block_sparse_attention(q1, k1, v1, m1, sc1)
    err = max_err(got, bs.dense_reference(q1, k1, v1, m1, sc1))
    log(f"[kernel] T=1000 (padded to 1024): max|err|={err:.3g}, shape {tuple(got.shape)}")
    require(err <= F32_TOL and got.shape[2] == 1000, f"T=1000: err {err}")

    # a sequence shard: local rows 0..1023 are global rows 1024..2047
    row_base = torch.arange(16, dtype=torch.int32, device=dev) * 64 + 1024
    got = bs.sea_block_sparse_attention(q, k, v, mask, sc, row_base=row_base)
    widths = (torch.arange(1024, device=dev) + 1025).float()
    err = max_err(got, bs.dense_reference(q, k, v, mask, sc, row_widths=widths))
    log(f"[kernel] row_base=1024: max|err|={err:.3g}")
    require(err <= F32_TOL, f"row_base: err {err}")


def forward_ms(model, ids, am, iters=7):
    """Median host ms of one forward ending in a synchronise, after one
    warm-up forward; also the last logits."""
    times = []
    for i in range(iters + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(ids, am, benchmarking=True)["logits"]
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def phase_slice():
    dev = "cuda"
    cfg = opt_125m("perlin")
    t0 = time.perf_counter()
    model = OptForCausalLM(cfg, device=dev, seed=0).eval()
    dense = OptForCausalLM(dataclasses.replace(cfg, attention_method="none"),
                           device=dev, seed=0).eval()
    torch.cuda.synchronize()
    log(f"[slice] OPT-125m perlin + dense built on {dev} in "
        f"{time.perf_counter() - t0:.1f} s ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)")
    g = torch.Generator().manual_seed(11)
    requests = [
        torch.randint(4, cfg.vocab_size, (2, 1024), generator=g),
        torch.randint(4, cfg.vocab_size, (1, 2048), generator=g),
    ]
    requests = [r.to(dev) for r in requests]

    # the main path: every request once, kernel launches counted around it
    bs.sea_block_sparse_attention.launches = 0
    bs.alive_mask.launches = 0
    outs = []
    per_forward = []
    for ids in requests:
        before = bs.sea_block_sparse_attention.launches
        with torch.inference_mode():
            outs.append(model(ids, torch.ones_like(ids), benchmarking=True)["logits"])
        per_forward.append(bs.sea_block_sparse_attention.launches - before)
    torch.cuda.synchronize()
    launches = bs.sea_block_sparse_attention.launches
    for ids, logits, n in zip(requests, outs, per_forward):
        finite = bool(torch.isfinite(logits).all())
        log(f"[slice] request {tuple(ids.shape)}: logits {tuple(logits.shape)} "
            f"finite={finite}, kernel launches {n}")
        require(finite and logits.shape == (*ids.shape, cfg.vocab_size),
                f"logits of request {tuple(ids.shape)}")
        require(n == cfg.num_layers, f"{n} kernel launches in one forward, not {cfg.num_layers}")
    log(f"[slice] main path: {launches} launches of sea_causal_flat_forward, "
        f"{bs.alive_mask.launches} of alive_mask")

    # layer 0's kernel inputs, captured by the buffer registry from the run
    bench = get_bench()
    checks = []
    for ids in requests:
        bench.activate_temp_buffers(True)
        with torch.inference_mode():
            model(ids, torch.ones_like(ids), benchmarking=True)
        buf = {n: bench.get_temp_buffer(n, 0) for n in (
            "q", "k", "v", "partial_attention_mask_before_interp", "estimated_scales",
            "masked_estimated_attention_probs", "per_item_top_k")}
        bench.activate_temp_buffers(False)
        # the grouped top-k on the card against the CPU on the same estimates
        probs = buf["masked_estimated_attention_probs"]
        cpu_mask = topk_mask(
            probs.cpu(), torch.ones((probs.shape[0], 1, probs.shape[2], 1), dtype=torch.bool),
            buf["per_item_top_k"].cpu(), "causal_batch", True, fp_min_for(probs.dtype),
        )
        bad = int((cpu_mask != buf["partial_attention_mask_before_interp"].cpu()).sum())
        log(f"[slice] layer-0 top-k mask, card vs CPU on the same estimates: "
            f"{bad} mismatches of {cpu_mask.numel()}")
        require(bad == 0, "top-k masks differ between the card and the CPU")
        q, k, v = buf["q"], buf["k"], buf["v"]
        mask = (buf["partial_attention_mask_before_interp"] > 0).to(q.dtype)
        sc = torch.sigmoid(buf["estimated_scales"][..., 0])
        got = bs.sea_block_sparse_attention(q, k, v, mask, sc, k_cfg=float(K))
        want = bs.dense_reference(q, k, v, mask, sc, k_cfg=float(K))
        err = max_err(got, want)
        density = float(bs.mask_nnz(mask, q.shape[2], True)) / (
            q.shape[0] * H * q.shape[2] * (q.shape[2] + 1) / 2)
        log(f"[slice] layer-0 kernel inputs {tuple(q.shape)}: kernel vs plain "
            f"max|err|={err:.3g}; element-mask density {density:.4f} of the causal triangle")
        require(err <= F32_TOL, f"kernel vs plain on layer-0 inputs: {err}")
        checks.append((q, k, v, mask, sc, err))

    for ids in requests:
        am = torch.ones_like(ids)
        sea_ms, sea_out = forward_ms(model, ids, am)
        dense_ms, dense_out = forward_ms(dense, ids, am)
        require(bool(torch.isfinite(dense_out).all()), "dense logits not finite")
        ntok = ids.numel()
        log(f"[slice] forward {tuple(ids.shape)}: SEA {sea_ms:.2f} ms "
            f"({ntok / sea_ms * 1e3:.0f} tokens/s), dense OPT-125m {dense_ms:.2f} ms "
            f"({ntok / dense_ms * 1e3:.0f} tokens/s)")
    breakdown(model, requests[-1])
    return launches, checks


def breakdown(model, ids):
    """Where one SEA forward's time goes: the attention stages by host region
    with a device synchronise at each region's end, then the device kernels
    by self time from torch.profiler, and the device's busy share."""
    am = torch.ones_like(ids)
    bench = get_bench()
    bench.reset()
    bench.synchronize = True
    bench.activate_temp_buffers(True)
    t0 = time.perf_counter()
    with torch.inference_mode():
        model(ids, am, benchmarking=True)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    bench.activate_temp_buffers(False)
    bench.synchronize = False
    log(f"[breakdown] forward {tuple(ids.shape)} with synchronised regions: {wall:.2f} ms; "
        "SEA attention stages summed over the 12 layers:")
    for line in bench.format_tracetree().splitlines():
        log(f"[breakdown]   {line}")
    bench.reset()

    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True
    ) as prof:
        t0 = time.perf_counter()
        model(ids, am, benchmarking=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side entries only: an aten op's self device time repeats the
    # time of the kernels it launched, which are listed too
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[breakdown] profiled forward {wall:.2f} ms wall, {sum(e.count for e in kernels)} "
        f"kernel launches, device busy {busy:.2f} ms ({100 * busy / wall:.1f}%, idle "
        f"{100 - 100 * busy / wall:.1f}%); top kernels by device time:")
    for e in kernels[:12]:
        log(f"[breakdown]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")


def main():
    smi = phase_device()
    phase_sort()
    phase_mask()
    phase_kernel()
    launches, checks = phase_slice()
    require(launches > 0, "the main path never launched the kernel")

    # the kernel's numbers at the main path's own inputs (the T=2048 request)
    q, k, v, mask, sc, _ = checks[-1]
    m = measure(q, k, v, mask, sc, k_cfg=float(K))
    err = max(c[-1] for c in checks)
    log(f"[result] main-path T=2048 layer 0: kernel {m['ms']:.4f} ms, plain "
        f"{m['plain_ms']:.3f} ms, sdpa {m['library_ms']:.4f} ms, bound "
        f"{m['bound_ms']:.4f} ms by {m['bound_by']}")
    kernels = [{
        "name": "sea_causal_flat_forward",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": err,
        "ms": m["ms"],
        "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"],
        "library_ms": m["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
