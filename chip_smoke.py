"""Chip smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Needs a CUDA device and nvcc; it builds the port's kernels from `csrc/`
(one nvcc per source, all at once), then runs these phases and fails
(non-zero exit) if any of them fails:

  1. device   — the card's name and power limit; TF32 off for matmuls and
                convolutions (the port's float32 path is checked against
                float32 references); the build's registers and spills (no
                instance of the forward body or of the backward bodies may
                spill), and the tensor-core instructions (HMMA) of every
                instance of the forward body (K1, K2/K6, K5, K9a-c) and of
                the backward bodies (K3/K7, K4/K8) in `cuobjdump -sass`,
                none of which may lack them;
  2. mask     — the kernel's element predicate (`alive_mask`) against the
                torch oracle `element_mask_int8`, bit for bit, for T up to 8192;
                the forward body's pixel quotients, taken from each row's
                reciprocal, against IEEE division on every row width to 2^17;
  3. kernel   — the causal fused sparse attention kernel (K1) against its
                plain PyTorch version at the main-path shapes (H=12, D=64,
                T_M=256, k=64, production top-k budget), float32 and
                bfloat16, plus edge cases; times of the kernel, the plain
                version and PyTorch's own SDPA at the same shape (a yardstick
                only);
  4. slice    — the serving path: OPT-125m with the SEA student, seeded
                random weights, scoring two prompts of 1024 tokens in one
                batch and then one of 2048 to logits on the fused benchmark
                path; K1 must run 12 times per forward (and the train
                kernels never), and layer 0's kernel inputs, captured from
                the run, are held against the plain version; ms/forward
                beside the dense OPT-125m;
  5. train-kernels — the differentiable path's kernels, forward with stats
                (K2), dq (K3) and dk/dv (K4), against their plain versions
                at the same shapes for T = 1024, 2048 and 4096, the whole
                `FusedSparseAttention` backward against autograd through
                `dense_reference`, two block sizes, and edge cases (empty
                rows, T=128, a mask with every pixel on); two launches of K3
                and of K4 on the same operands must give the same bits;
  6. train    — the training path: OPT-125m with `use_fused_train`, full
                width and depth, AdamW steps through `train_steps` on one
                batch of 1 x 2048 tokens (3 steps) and one of 1 x 8192 (2
                steps); every step must give a finite loss and launch K2, K3
                and K4 12 times each and K1 never, and the loss must fall
                over the 2048-token steps; layer 0's kernel inputs and
                incoming gradient, captured from one more step of each
                request, are held against the plain versions; ms/step,
                tokens/s and peak memory beside the
                dense OPT-125m train step at 1 x 2048;
  7. bidir-mask — the padded bidirectional kernel's (K5) element predicate
                against the lengths-aware oracle, bit for bit, for T = 128,
                512 and 2048 with example lengths 1, 77, 128, 255, 383 and T;
  8. bidir-kernel — K5 against its plain version at T = 256, 512, 1024,
                2048 and 200 (padded inside the wrapper), ragged lengths,
                BERT-base heads (H=12, D=64, T_M=128, k=64, the non-causal
                top-k budget), float32 and bfloat16, plus edge cases (empty
                rows, lengths 0 and 1); times of K5, the plain version and
                PyTorch's SDPA (dense, non-causal, boolean key-padding mask);
  9. bert     — the BERT-base SEA forward to classification logits, full
                width and depth, seeded random weights, on two right-padded
                batches: 32 x 256 (the GLUE trainer's MRPC batch and
                max_length) and 8 x 512 (BERT's most positions). K5 must run
                12 times per forward and K1-K4 never; the logits must be
                finite; layer 0's kernel inputs, captured from the run, are
                held against the plain version and must reproduce the run's
                own kernel output; ms/forward, tokens/s and peak memory
                beside the dense BERT-base;
 10. ring-kernels — the ring's windowed kernels, forward with stats (K6),
                dq (K7) and dk/dv (K8), against their plain versions on every
                (shard, window) of a ring of 4 shards (zigzag rows, blocks 128)
                over synthetic 1 x 4096 inputs (H=12, D=64, T_M=256, the budget
                mask, a band of rows with nothing alive, windows wholly past
                their rows' causal edge); the merged ring forward and backward
                against K2-K4 unsharded on the same inputs; times of the S²
                launches of a layer against one launch of K2/K3/K4;
 11. ring-serve — the OPT-125m benchmark forward at 1 x 16384 inside
                `sharded_attention_scope(LocalGroup(4), kind="auto")`, which
                must resolve to 'ring': 192 K6 launches and no other kernel per
                forward, finite logits, layer 0's attention output within 1e-4
                of the unsharded forward's (K1); ms/forward beside the
                unsharded forward;
 12. ring-train — OPT-125m with `use_fused_train` at full width and depth,
                2 AdamW steps on 1 x 16384 tokens inside the same scope, then
                the same from the same weights unsharded (K2-K4): 192 launches
                each of K6, K7 and K8 per step and none of K1-K5, the loss
                falling, the first step's loss within 1e-4 of the unsharded
                step's, every layer's top-k mask compared between the arms and
                every parameter gradient within 2e-4 of the unsharded step's
                when no pick differs (the gap is printed either way); on layer
                0's inputs and incoming gradient captured from the ring arm,
                the ring's output within 3e-5 and its dq, dk, dv and dscaler
                within 2e-4 of the unsharded kernels', and K6-K8 against their
                plain versions on every (shard, window), timed; ms/step,
                tokens/s and peak memory of both arms;
 13. seq-head  — the 'seq' and 'head' kinds at 1 x 4096 over LocalGroup(4):
                the benchmark forward (K1 with row_base, 48 launches) and two
                train steps (K2-K4, 48 launches each a step) against the
                unsharded ones; the 'auto' rule ('seq' at 4096, 'ring' at 16384,
                never 'ring' for one shard);
 14. impl-mask — the restricted element predicates of the impl variants K9a
                ('flat_wr'), K9b ('flat_fori') and K9c ('subtile') on their own
                tile lists (`alive_mask(impl=)`), against `element_mask_int8` bit
                for bit: budget masks at T = 1024, 2048, 4096 and bench.py's
                `host_topk_mask` at 4096, under every block shape of bench.py's
                candidates and each wrapper's defaults;
 15. impl-kernels — bench.py's canonical configuration (N=1, H=12, T=4096,
                D=64, T_M=256, K=64, its `host_topk_mask` and inputs from seed
                0) in float32 and bfloat16 through every impl and every block
                shape: each kernel against its plain version (`impl_reference`)
                and equal to K1's output bit for bit; at each impl's
                default blocks the kernel's, K1's, the plain version's and
                SDPA's times, the bound, the mean words per listed tile (K9a/b)
                and the share of skipped pieces (K9c). This run is what
                launches K9b and K9c;
 16. sweep    — the attention-operator sweep (`sea_tpu_torch.benchmarks`,
                dense, performer, cosformer, sea_fused) at T = 1024, 2048,
                4096 in float32 and bfloat16: no record may hold an error, and
                sea_fused must launch K9a and never K1; the records as JSON
                lines, dense/sea_fused beside each T; then, outside the
                counted run, sea_fused's call (K9a) on the sweep's own inputs
                at each T and type against its plain version;
 17. cosformer-slice — OPT-125m with the cosformer estimator backend at full
                width and depth on 1 x 2048 tokens: 12 K1 launches per forward
                and no other kernel, finite logits, layer 0's kernel inputs
                held against the plain version; ms/forward beside the
                performer-backend forward of the same weights;
 18. dense-vs-fused — one OPT-125m attention layer (H=12, D=64, T_M=256,
                k=64) on 1 x 2048, float32 with TF32 off: the dense train path
                (plain PyTorch, no kernel) as the reference of the fused
                kernels, as the JAX package holds them to it: the benchmark
                path's context (one K1 launch) within 2e-4 of the dense path's
                (tests/test_fused_path.py:12), use_fused_train's loss Σ context²
                (K2, K3, K4 once each) within 1e-4 relative and every gradient
                within 5e-3 + 1e-2·|dense| (:88); the arms' top-k masks
                compared row by row (a row that picked otherwise would be left
                out of the context check, the gradients then reported only);
 19. kd       — the OPT-125m KD trainer (`OptTrainer`, full width and depth,
                random teacher, synthetic corpus, its defaults: 1 x 512 windows,
                stride 256, accumulation 8, use_remat) for 2 optimizer steps
                (16 micro-steps) through `train()`: no kernel launched (the KD
                step is the dense train path), every logged loss term finite,
                the student moved and the teacher unchanged bit for bit, the KD
                loss of the stream's first batch lower after the steps; ms per
                micro-step, tokens/s and peak memory beside the dense teacher's
                own CE step on the same batch, a [breakdown] of a micro-step,
                `evaluate(max_batches=4)`'s PPL and ms per window, and one
                micro-step at 1 x 2048 with its time and peak memory;
 20. result   — one JSON line of per-kernel numbers, then the device line.

Tolerances: float32 1e-5 abs for outputs and the logsumexp (both sides do
float32 arithmetic, summed in another order); bfloat16 1e-5 plus half a
bf16 ulp of the float32 plain result on the same bf16 inputs (the kernel
sums in float32 and rounds once); gradients 1e-4·max|want| abs, plus 1e-8
for tensors that are all zero (sums over up to T float32 products in another
order, whose rounding scales with the largest terms rather than with each
element). The ring phases hold the JAX package's own sharded bounds:
the ring's output 3e-5 and its gradients 2e-4 abs against the unsharded
kernels (tests/test_sharded_attention.py:150, :309-312), a layer's
attention output 1e-4 (:257), the first train step's loss 1e-4
(__graft_entry__.py:283-299).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from sea_tpu_torch.benchmarks import attention_method_sweep, host_topk_mask, sweep_inputs
from sea_tpu_torch.config import opt_config
from sea_tpu_torch.models.attention import SeaAttention
from sea_tpu_torch.models.bert import BertForSequenceClassification, bert_base
from sea_tpu_torch.models.opt import OptForCausalLM, opt_125m
from sea_tpu_torch.ops.kernels import _build
from sea_tpu_torch.ops.kernels import block_sparse as bs
from sea_tpu_torch.ops.masks import _ranks_desc, fp_min_for, topk_mask
from sea_tpu_torch.parallel import (
    AttnShardingContext,
    LocalGroup,
    resolve_attention_kind,
    sharded_attention_scope,
)
from sea_tpu_torch.parallel import sharded_attention as sa
from sea_tpu_torch.training.longctx import longctx_model, make_optimizer, train_step, train_steps
from sea_tpu_torch.training.opt_trainer import OptTrainer, TrainerConfig
from sea_tpu_torch.utils.profiler import get_bench

H, D, T_M, K = 12, 64, 256, 64
F32_TOL, BF16_HALF_ULP = 1e-5, 2.0 ** -8
GRAD_ATOL, GRAD_RTOL = 1e-8, 1e-4  # the latter of max|want|: see the module docstring
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # FFMA / tensor cores
KERNEL_SOURCE = "sea_tpu_torch/csrc/block_sparse_causal.cu"
DIFF_SOURCE = "sea_tpu_torch/csrc/block_sparse_diff.cu"
REPLACES = "sea_tpu/ops/kernels/block_sparse.py:240"  # _causal_kernel_flat
# the differentiable path: (wrapper, CUDA entry point, source, TPU kernel
# replaced, FLOPs per alive element / D)
TRAIN_KERNELS = {
    "K2": (bs.causal_fwd_stats, "sea_causal_fwd_stats", KERNEL_SOURCE,
           "sea_tpu/ops/kernels/block_sparse.py:1328", 4),  # _causal_kernel_fwd_stats
    "K3": (bs.causal_dq, "sea_causal_dq", DIFF_SOURCE,
           "sea_tpu/ops/kernels/block_sparse.py:1420", 6),  # _causal_kernel_dq
    "K4": (bs.causal_dkv, "sea_causal_dkv", DIFF_SOURCE,
           "sea_tpu/ops/kernels/block_sparse.py:1463", 8),  # _causal_kernel_dkv
}
TRAIN_LR = 1e-5  # longctx_train_step.py's AdamW rate
CHECK_TS = (1024, 2048, 4096)  # train-kernel checks; blocks compared at the second
TRAIN_REQUESTS = ((2048, 3), (8192, 2))  # (tokens, AdamW steps): requests A and B
BIDIR_T_M = 128  # bert_config's predictor length
BIDIR_REPLACES = "sea_tpu/ops/kernels/block_sparse.py:839"  # _kernel
# (batch, T, least and most length): the GLUE trainer's MRPC batch at its
# max_length, then BERT's most positions
BERT_REQUESTS = ((32, 256, 32, 256), (8, 512, 128, 512))
# the ring's windowed kernels: (wrapper, CUDA entry point, source, TPU kernel
# replaced, FLOPs per alive element / D)
RING_KERNELS = {
    "K6": (bs.fwd_stats_window, "sea_window_fwd_stats", KERNEL_SOURCE,
           "sea_tpu/ops/kernels/block_sparse.py:1598", 4),  # _causal_kernel_fwd_stats_cb
    "K7": (bs.dq_window, "sea_window_dq", DIFF_SOURCE,
           "sea_tpu/ops/kernels/block_sparse.py:1688", 6),  # _causal_kernel_dq_cb
    "K8": (bs.dkv_window, "sea_window_dkv", DIFF_SOURCE,
           "sea_tpu/ops/kernels/block_sparse.py:1698", 8),  # _causal_kernel_dkv_win
}
RING_SHARDS, RING_BLOCK = 4, 128  # LocalGroup(4); the ring's default blocks
RING_T = 16384  # the ring's main path: kind="auto" resolves to 'ring' from here
RING_CHECK_T = 4096  # ring-kernels' synthetic inputs and the seq-head phase
# the JAX package's bounds (see the module docstring)
RING_OUT_TOL, RING_GRAD_TOL, LAYER_TOL, LOSS_TOL = 3e-5, 2e-4, 1e-4, 1e-4
# the causal forward's impl variants: (impl, TPU kernel replaced); each one's
# entry point and wrapper are `bs.IMPL_KERNELS[impl]`
IMPL_VARIANTS = {
    "K9a": ("flat_wr", "sea_tpu/ops/kernels/block_sparse.py:349"),  # _causal_kernel_flat_wr
    "K9b": ("flat_fori", "sea_tpu/ops/kernels/block_sparse.py:557"),  # _causal_kernel_flat_fori
    "K9c": ("subtile", "sea_tpu/ops/kernels/block_sparse.py:685"),  # _causal_kernel, subtile
}
# bench.py's block candidates (bench.py:104-123), then each wrapper's defaults
BENCH_BLOCKS = ((512, 512), (1024, 512), (256, 512), (256, 256), (512, 256), (None, None))
BENCH_T = 4096  # bench.py's canonical length
SWEEP_TS = [1024, 2048, 4096]
COS_T = 2048  # the cosformer slice's request, 1 x COS_T tokens
QUOT_W_MAX = 1 << 17  # row widths whose pixel quotients phase_mask checks
DENSE_T = 2048  # dense-vs-fused: one OPT-125m attention layer on 1 x DENSE_T
KD_STEPS = 2  # the kd phase's optimizer steps (8 micro-steps each)
KD_ITERS = 3  # timed steady micro-steps and dense CE steps
KD_EVAL_WINDOWS = 4
KD_LONG_T = 2048  # one KD micro-step at OPT's context


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


def reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    bs.sea_block_sparse_attention.launches = 0
    bs.bidir_forward.launches = 0
    bs.alive_mask.launches = 0
    for wrapper, *_ in (*TRAIN_KERNELS.values(), *RING_KERNELS.values()):
        wrapper.launches = 0
    for kernel in bs.IMPL_KERNELS.values():
        kernel.wrapper.launches = 0


def launch_counts() -> dict:
    return {"K1": bs.sea_block_sparse_attention.launches,
            **{kid: TRAIN_KERNELS[kid][0].launches for kid in TRAIN_KERNELS},
            "K5": bs.bidir_forward.launches,
            **{kid: RING_KERNELS[kid][0].launches for kid in RING_KERNELS},
            **{kid: bs.IMPL_KERNELS[impl].wrapper.launches
               for kid, (impl, _) in IMPL_VARIANTS.items()}}


def check_grad(name, got, want) -> float:
    """|got − want| <= 1e-8 + 1e-4·max|want| and finite; returns max|err|."""
    err = max_err(got, want)
    limit = GRAD_ATOL + GRAD_RTOL * float(want.float().abs().max())
    require(bool(torch.isfinite(got).all()), f"{name}: not finite")
    require(err <= limit, f"{name}: max|err| {err:.3g} over {limit:.3g}")
    return err


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
    spilled = []
    for name, text in logs.items():
        fn = None
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
                log(f"[build] {name}: {fn}")
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
                if "bytes spill stores" in line and instance_name(fn or ""):
                    if int(line.split("bytes spill stores")[0].split(",")[-1]):
                        spilled.append(fn)
    require(not spilled, f"forward- or backward-body instances that spill: {spilled}")
    tensor_core_check()
    return smi


# `causal_flat_kernel`'s template arguments <D, T, STATS, BIDIR, IMPL> as the
# mangled name spells them, and the kernels each instance is
FLAT_INSTANCE = re.compile(
    r"causal_flat_kernelILi64E(f|13__nv_bfloat16)Lb([01])ELb([01])ELi([0-3])EE")
INSTANCE_KIDS = {(0, 0, 0): "K1", (1, 0, 0): "K2/K6", (0, 1, 0): "K5",
                 (0, 0, 1): "K9a", (0, 0, 2): "K9b", (0, 0, 3): "K9c"}
# the backward bodies `causal_dq_kernel<D>` and `causal_dkv_kernel<D>`
# (float32 only), and the kernels each is
DIFF_INSTANCE = re.compile(r"causal_(dq|dkv)_kernelILi64EE")
DIFF_KIDS = {"dq": "K3/K7", "dkv": "K4/K8"}


def instance_name(mangled: str):
    """'<kernels> <type>' of a forward- or backward-body instance from its
    mangled name; None for any other function."""
    found = FLAT_INSTANCE.search(mangled)
    if found:
        dt, stats, bidir, impl = found.groups()
        return (f"{INSTANCE_KIDS[int(stats), int(bidir), int(impl)]} "
                f"{'float32' if dt == 'f' else 'bfloat16'}")
    found = DIFF_INSTANCE.search(mangled)
    return f"{DIFF_KIDS[found.group(1)]} float32" if found else None


def required_instances() -> set:
    """The instances (as `instance_name` names them) that the entry points
    launch: the forward body's in both types (K2/K6 float32 only) and the
    backward bodies' (float32)."""
    return ({f"{kid} {dt}" for kid in INSTANCE_KIDS.values() for dt in ("float32", "bfloat16")
             if kid != "K2/K6" or dt == "float32"}
            | {f"{kid} float32" for kid in DIFF_KIDS.values()})


def tensor_core_check():
    """Count the tensor-core instructions (HMMA) of every instance of the
    forward body (`causal_flat_kernel`) and of the backward bodies
    (`causal_dq_kernel`, `causal_dkv_kernel`) in the built libraries' SASS
    (`cuobjdump -sass`); every instance the entry points launch must be
    there and have some."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    hmma, name = {}, None
    for lib in ("block_sparse_causal", "block_sparse_diff"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build._target(lib))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        for line in sass.splitlines():
            if "Function :" in line:
                name = instance_name(line)
                if name:
                    hmma[name] = 0
            elif name and "HMMA" in line:
                hmma[name] += 1
    log(f"[device] HMMA instructions by mma-body instance: {hmma}")
    require(set(hmma) == required_instances(), f"mma-body instances in the SASS: {sorted(hmma)}")
    require(all(hmma.values()), f"instances without tensor-core instructions: {hmma}")


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
    # the forward kernels' pixels: quotients from the row's reciprocal, which
    # must be IEEE division's bit for bit on every row width they can meet
    bad = bs.quotient_mismatches(QUOT_W_MAX, dev)
    log(f"[mask] reciprocal quotients vs IEEE division, x = s + 0.5 and s + 1 for every "
        f"0 <= s < w <= {QUOT_W_MAX}: {bad} mismatches of {QUOT_W_MAX * (QUOT_W_MAX + 1)}")
    require(bad == 0, "the forward's reciprocal quotients differ from IEEE division")


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


def forward_ms(model, *inputs, iters=7):
    """Median host ms of one forward ending in a synchronise, after one
    warm-up forward; also the last logits."""
    times = []
    for i in range(iters + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(*inputs, benchmarking=True)["logits"]
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def host_ms(fn, iters):
    """Median host ms of `fn()` ending in a synchronise, after one warm-up."""
    times = []
    for i in range(iters + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


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
    reset_launches()
    outs = []
    per_forward = []
    for ids in requests:
        before = bs.sea_block_sparse_attention.launches
        with torch.inference_mode():
            outs.append(model(ids, torch.ones_like(ids), benchmarking=True)["logits"])
        per_forward.append(bs.sea_block_sparse_attention.launches - before)
    torch.cuda.synchronize()
    launches = bs.sea_block_sparse_attention.launches
    others = {kid: n for kid, n in launch_counts().items() if kid != "K1"}
    require(not any(others.values()), f"the serving path launched other kernels: {others}")
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
    ids = requests[-1]

    def forward():
        with torch.inference_mode():
            model(ids, torch.ones_like(ids), benchmarking=True)

    breakdown(f"forward {tuple(ids.shape)}", forward)
    return launches, checks


def breakdown(label, run):
    """Where the time of `run()` (one forward, or one train step) goes: the
    SEA attention's forward stages by host region with a device synchronise
    at each region's start and end, then the device kernels by self time from
    torch.profiler, and the device's busy share."""
    bench = get_bench()
    bench.reset()
    bench.synchronize = True
    bench.activate_temp_buffers(True)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    bench.activate_temp_buffers(False)
    bench.synchronize = False
    log(f"[breakdown] {label} with synchronised regions: {wall:.2f} ms; "
        "SEA attention forward stages summed over the 12 layers:")
    for line in bench.format_tracetree().splitlines():
        log(f"[breakdown]   {line}")
    bench.reset()

    from torch.profiler import ProfilerActivity, profile

    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True
    ) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side entries only: an aten op's self device time repeats the
    # time of the kernels it launched, which are listed too, and so does a
    # user annotation's range on the device (the optimizer's step)
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[breakdown] profiled {label} {wall:.2f} ms wall, {sum(e.count for e in kernels)} "
        f"kernel launches, device busy {busy:.2f} ms ({100 * busy / wall:.1f}%, idle "
        f"{100 - 100 * busy / wall:.1f}%); top kernels by device time:")
    for e in kernels[:12]:
        log(f"[breakdown]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")


# ---------------------------------------------------------------------------
# The differentiable path: forward with stats (K2), dq (K3), dk/dv (K4)
# ---------------------------------------------------------------------------


def diff_bound(kid, ops: bs.KernelOperands, mask_m):
    """Least time the card needs for the function one launch of `kid`
    computes: the larger of its FLOPs on the alive elements (per element 4·D
    for K2: q·k, p·v; 6·D for K3: q·k, dO·v, ds·k; 8·D for K4: q·k, dO·v,
    dsᵀ·q, pᵀ·dO; the count is this mask's element nnz) at the float32 FMA
    peak, and its bytes (each operand read once, each output written once)
    at the HBM rate. The tile lists are the kernels' own device and are not
    counted."""
    N, Hh, T, Dd = ops.shape
    flops = TRAIN_KERNELS[kid][4] * Dd * int(bs.mask_nnz(mask_m, ops.k.shape[1], True))
    tile = N * Hh * T * Dd * 4  # one (NH, T, D) float32 tensor
    row = N * Hh * T * 4  # one (NH, T) float32 tensor
    nbytes = ops.mbits.numel() * 4 + ops.row_base.numel() * 4 + 3 * tile + {
        "K2": row + tile + row,  # scaler; out, lse
        "K3": tile + 2 * row + tile,  # dO·scaler, lse, delta; dq
        "K4": tile + 2 * row + 2 * tile,  # dO·scaler, lse, delta; dk, dv
    }[kid]
    t_ops = flops / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def diff_operands(q, k, v, mask, sc):
    return bs.kernel_operands(bs.prepare_inputs(q, k, v, mask, sc), differentiable=True)


def check_train_kernels(label, q, k, v, mask, sc, do):
    """K2, K3 and K4 against their plain versions on one set of inputs. K3
    and K4 read the plain version's lse and backward terms, so that each
    kernel is held alone. Returns {kernel: max|err|}."""
    ops = diff_operands(q, k, v, mask, sc)
    o, lse = bs.causal_fwd_stats(ops)
    want_o, want_lse = bs.fwd_with_stats_reference(q, k, v, mask, sc)
    torch.cuda.synchronize()
    inf = torch.isinf(want_lse)
    require(torch.equal(torch.isinf(lse), inf) and bool((lse[inf] > 0).all()),
            f"{label}: the +inf rows of lse differ")
    err_lse = max_err(lse[~inf], want_lse[~inf]) if bool((~inf).any()) else 0.0
    err_o = max_err(o, want_o)
    require(err_o <= F32_TOL and err_lse <= F32_TOL,
            f"{label}: K2 o err {err_o:.3g}, lse err {err_lse:.3g}")
    _, dou, delta = bs.backward_terms(do, want_o, sc, torch.float32)
    dq = bs.causal_dq(ops, dou, want_lse, delta)
    dk, dv = bs.causal_dkv(ops, dou, want_lse, delta)
    # run to run: no atomics and every sum in a fixed order, so the same bits
    again = (bs.causal_dq(ops, dou, want_lse, delta), *bs.causal_dkv(ops, dou, want_lse, delta))
    require(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
            f"{label}: two launches of K3 or K4 on the same operands differ")
    want_dk, want_dv = bs.dkv_reference(q, k, v, mask, dou, want_lse, delta)
    errs = {
        "K2": max(err_o, err_lse),
        "K3": check_grad(f"{label} K3 dq", dq, bs.dq_reference(q, k, v, mask, dou, want_lse, delta)),
        "K4": max(check_grad(f"{label} K4 dk", dk, want_dk), check_grad(f"{label} K4 dv", dv, want_dv)),
    }
    log(f"[train-kernels] {label}: K2 o {err_o:.3g}, lse {err_lse:.3g} ({int(inf.sum())} "
        f"+inf rows); K3 dq {errs['K3']:.3g}; K4 dk/dv {errs['K4']:.3g} (max|err| vs plain); "
        "two launches of K3 and of K4 equal bit for bit")
    return errs


def autograd_outputs(fn, q, k, v, sc, do):
    """fn(q, k, v, sc)'s output and the gradients of <output, do> for q, k,
    v and sc."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, sc)]
    o = fn(*leaves)
    return (o.detach(), *torch.autograd.grad(o, leaves, do))


def check_fused_backward(label, q, k, v, mask, sc, do, **blocks):
    """The whole FusedSparseAttention (K2 forward; K3, K4 backward) against
    autograd through `dense_reference`. Returns its outputs."""
    got = autograd_outputs(
        lambda *a: bs.fused_sparse_attention(a[0], a[1], a[2], mask, a[3], **blocks),
        q, k, v, sc, do)
    want = autograd_outputs(
        lambda *a: bs.dense_reference(a[0], a[1], a[2], mask, a[3]), q, k, v, sc, do)
    err_o = max_err(got[0], want[0])
    require(err_o <= F32_TOL, f"{label}: fused output err {err_o:.3g}")
    errs = [check_grad(f"{label} fused {n}", g, w)
            for n, g, w in zip(("dq", "dk", "dv", "dscaler"), got[1:], want[1:])]
    log(f"[train-kernels] {label}: FusedSparseAttention vs autograd through dense_reference "
        f"{blocks or ''}: o {err_o:.3g}, dq {errs[0]:.3g}, dk {errs[1]:.3g}, dv {errs[2]:.3g}, "
        f"dscaler {errs[3]:.3g}")
    return got


def measure_train(q, k, v, mask, sc, do):
    """Kernel, plain and library times of K2, K3 and K4 on one set of inputs,
    with their bounds. The library call is F.scaled_dot_product_attention at
    the same shape (dense causal): its forward for K2, and its backward
    alone, timed once, for the pair K3 and K4."""
    ops = diff_operands(q, k, v, mask, sc)
    o, lse = bs.causal_fwd_stats(ops)
    _, dou, delta = bs.backward_terms(do, o, sc, torch.float32)
    qq, kk, vv = (x.detach().clone().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(sdpa_out, (qq, kk, vv), do, retain_graph=True))
    plain = dict(iters=5, warmup=1)
    out = {
        "K2": dict(
            ms=time_ms(lambda: bs.causal_fwd_stats(ops)),
            plain_ms=time_ms(lambda: bs.fwd_with_stats_reference(q, k, v, mask, sc), **plain),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
        ),
        "K3": dict(
            ms=time_ms(lambda: bs.causal_dq(ops, dou, lse, delta)),
            plain_ms=time_ms(lambda: bs.dq_reference(q, k, v, mask, dou, lse, delta), **plain),
            library_ms=sdpa_bwd,
        ),
        "K4": dict(
            ms=time_ms(lambda: bs.causal_dkv(ops, dou, lse, delta)),
            plain_ms=time_ms(lambda: bs.dkv_reference(q, k, v, mask, dou, lse, delta), **plain),
            library_ms=sdpa_bwd,
        ),
    }
    for kid, m in out.items():
        m["bound_ms"], m["bound_by"], m["flops"], m["bytes"] = diff_bound(kid, ops, mask)
    return out


def log_times(label, m):
    for kid, t in m.items():
        log(f"[train-kernels] {label} {kid}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, "
            f"sdpa {'fwd' if kid == 'K2' else 'bwd'} {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({t['flops'] / 1e9:.4f} GFLOP, "
            f"{t['bytes'] / 1e6:.2f} MB)")


def phase_train_kernels():
    dev = "cuda"
    for T in CHECK_TS:
        mask = budget_mask(1, T, seed=T, device=dev)
        q, k, v, sc = qkv(1, T, torch.float32, seed=T, device=dev)
        do = torch.randn(q.shape, generator=torch.Generator().manual_seed(T + 1)).to(dev)
        check_train_kernels(f"T={T}", q, k, v, mask, sc, do)
        got = check_fused_backward(f"T={T}", q, k, v, mask, sc, do)
        if T == CHECK_TS[1]:
            other = check_fused_backward(f"T={T}", q, k, v, mask, sc, do, block_q=128, block_k=256)
            diff = max(max_err(a, b) for a, b in zip(got, other))
            log(f"[train-kernels] T={T}: blocks 128 x 256 vs 64 x 64, max|diff| {diff:.3g}")
            require(diff == 0.0, f"the result depends on the block sizes: {diff}")
        log_times(f"T={T}", measure_train(q, k, v, mask, sc, do))

    # edge cases, float32
    q, k, v, sc = qkv(1, 1024, torch.float32, seed=7, device=dev)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(9)).to(dev)
    mask = budget_mask(1, 1024, seed=7, device=dev)
    empty = mask.clone()
    empty[:, :, 300:400] = 0.0
    check_train_kernels("empty rows 300-399", q, k, v, empty, sc, do)
    o, dq, dk, dv, dsc = check_fused_backward("empty rows 300-399", q, k, v, empty, sc, do)
    _, lse = bs.causal_fwd_stats(diff_operands(q, k, v, empty, sc))
    zero = max(float(o[:, :, 300:400].abs().max()), float(dq[:, :, 300:400].abs().max()))
    finite = all(bool(torch.isfinite(x).all()) for x in (o, dq, dk, dv, dsc))
    log(f"[train-kernels] empty rows: lse +inf on all of them: "
        f"{bool(torch.isposinf(lse[:, :, 300:400]).all())}; |o|, |dq| there {zero}; "
        f"all finite {finite}")
    require(bool(torch.isposinf(lse[:, :, 300:400]).all()) and zero == 0.0 and finite,
            "empty rows: lse, zero rows or NaN")

    q1, k1, v1, sc1 = qkv(1, 128, torch.float32, seed=8, device=dev)
    do1 = torch.randn(q1.shape, generator=torch.Generator().manual_seed(10)).to(dev)
    m1 = budget_mask(1, 128, seed=8, device=dev)
    check_train_kernels("T=128", q1, k1, v1, m1, sc1, do1)
    check_fused_backward("T=128", q1, k1, v1, m1, sc1, do1)

    full = torch.ones_like(mask)
    check_train_kernels("every pixel on", q, k, v, full, sc, do)
    check_fused_backward("every pixel on", q, k, v, full, sc, do)


def run_train(model, ids, steps, label, want=None, after_step=None):
    """`steps` AdamW steps through `train_steps` on one batch, the launch
    counts set to 0 just before and read after every step. Checks a finite
    loss and, for the SEA student, 12 launches of each of K2, K3 and K4 and
    none of the other kernels per step (no kernel launch at all for the
    dense model), or the launches `want` per step. `after_step(i)` runs after
    step i's checks, outside its time. Returns (losses, ms per step,
    launches over the run, peak GiB)."""
    n_layers = model.cfg.num_layers
    sparse = model.cfg.attention_method == "perlin"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, per_step = [], []
    last = [time.perf_counter(), launch_counts()]

    def on_step(i, loss):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), launch_counts()
        times.append((now - last[0]) * 1e3)
        per_step.append({kid: counts[kid] - last[1][kid] for kid in counts})
        last[:] = [now, counts]
        log(f"[train] {label} step {i + 1}: loss {loss:.6f}, {times[-1]:.2f} ms "
            f"({ids.numel() / times[-1] * 1e3:.0f} tokens/s), launches {per_step[-1]}")
        if after_step is not None:
            after_step(i)
            torch.cuda.synchronize()
            last[:] = [time.perf_counter(), launch_counts()]

    losses = train_steps(model, ids, torch.ones_like(ids), steps, lr=TRAIN_LR, callback=on_step)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if want is None:
        want = {**dict.fromkeys(launch_counts(), 0),
                **{kid: n_layers if sparse else 0 for kid in TRAIN_KERNELS}}
    for i, (loss, n) in enumerate(zip(losses, per_step)):
        require(np.isfinite(loss), f"{label} step {i + 1}: loss {loss}")
        require(n == want, f"{label} step {i + 1}: launches {n}, want {want}")
    steady = statistics.median(times[1:])
    log(f"[train] {label}: {steady:.2f} ms/step after the first "
        f"({ids.numel() / steady * 1e3:.0f} tokens/s), peak memory {peak:.2f} GiB")
    return losses, times, launch_counts(), peak


@contextlib.contextmanager
def layer0_registry(model):
    """The buffer registry on while layer 0's SEA attention runs, and off
    for the other layers; layer 0's buffers stay in it afterwards."""
    bench = get_bench()
    attn = model.model.layers[0].self_attn.perlin
    hooks = [attn.register_forward_pre_hook(lambda *_: bench.activate_temp_buffers(True)),
             attn.register_forward_hook(lambda *_: bench.activate_temp_buffers(False))]
    try:
        yield bench
    finally:
        for h in hooks:
            h.remove()
        bench.activate_temp_buffers(False)


def capture_layer0(model, ids):
    """Layer 0's kernel inputs and the gradient reaching its kernel output,
    from one forward and backward of a train step (buffer registry for
    layer 0 and a tensor hook); the parameters' gradients are cleared
    afterwards."""
    grads = []
    with layer0_registry(model) as bench:
        out = model(ids, torch.ones_like(ids), labels=ids, training=True)
        buf = {n: bench.get_temp_buffer(n, 0) for n in (
            "q", "k", "v", "partial_attention_mask_before_interp", "estimated_scales",
            "masked_estimated_attention_probs", "per_item_top_k", "fused_attention_output")}
        buf["fused_attention_output"].register_hook(grads.append)
        (out["loss"] + 0.0 * out["aux_loss"]).backward()
    model.zero_grad(set_to_none=True)
    buf = {n: b.detach() for n, b in buf.items()}
    # the train-mode grouped top-k on the card against the CPU on the same estimates
    probs = buf["masked_estimated_attention_probs"]
    cpu_mask = topk_mask(
        probs.cpu(), torch.ones((probs.shape[0], 1, probs.shape[2], 1), dtype=torch.bool),
        buf["per_item_top_k"].cpu(), "causal_batch", False, fp_min_for(probs.dtype),
    )
    bad = int((cpu_mask != buf["partial_attention_mask_before_interp"].cpu()).sum())
    log(f"[train] layer-0 train-mode top-k mask, card vs CPU on the same estimates: "
        f"{bad} mismatches of {cpu_mask.numel()}")
    require(bad == 0, "train-mode top-k masks differ between the card and the CPU")
    mask = (buf["partial_attention_mask_before_interp"] > -1.0).float()
    sc = torch.sigmoid(buf["estimated_scales"][..., 0])
    return buf["q"], buf["k"], buf["v"], mask, sc, grads[0], buf["fused_attention_output"]


def check_layer0(label, q, k, v, mask, sc, do, step_o):
    """K2, K3 and K4, and the whole FusedSparseAttention, against their plain
    versions on layer 0's captured inputs; K2 must also reproduce the step's
    own output bit for bit. Returns {kernel: max|err|}."""
    density = float(bs.mask_nnz(mask, q.shape[2], True)) / (q.shape[0] * H * q.shape[2] * (q.shape[2] + 1) / 2)
    log(f"[train] layer-0 kernel inputs {tuple(q.shape)}, element-mask density {density:.4f} "
        f"of the causal triangle, |dO| max {float(do.abs().max()):.3g}")
    errs = check_train_kernels(label, q, k, v, mask, sc, do)
    o, _ = bs.causal_fwd_stats(diff_operands(q, k, v, mask, sc))
    require(torch.equal(o, step_o), f"{label}: K2 on the captured inputs differs from the step's output")
    check_fused_backward(label, q, k, v, mask, sc, do)
    return errs


def phase_train():
    dev = "cuda"
    (t_a, steps_a), (t_b, steps_b) = TRAIN_REQUESTS
    model = longctx_model(t_a, 12, dev)
    g = torch.Generator().manual_seed(12)
    ids_a = torch.randint(4, model.cfg.vocab_size, (1, t_a), generator=g).to(dev)
    ids_b = torch.randint(4, model.cfg.vocab_size, (1, t_b), generator=g).to(dev)

    # request A, the main path: 3 steps on 1 x 2048
    losses, _, launches_a, _ = run_train(model, ids_a, steps_a, f"1x{t_a}")
    require(losses[-1] < losses[0], f"the loss did not fall over {steps_a} steps: {losses}")

    # layer 0 of one more step, held against the plain versions
    captured = capture_layer0(model, ids_a)
    errs_a = check_layer0(f"layer-0 1x{t_a}", *captured)
    measured = measure_train(*captured[:6])
    log_times(f"layer-0 1x{t_a}", measured)
    del captured

    optimizer = make_optimizer(model, TRAIN_LR)
    am = torch.ones_like(ids_a)
    breakdown(f"train step (1, {t_a})", lambda: train_step(model, optimizer, ids_a, am))
    dense_cfg = dataclasses.replace(model.cfg, attention_method="none")
    del model, optimizer
    torch.cuda.empty_cache()

    # the yardstick: the dense OPT-125m train step on the same batch
    dense = OptForCausalLM(dense_cfg, device=dev, seed=0)
    run_train(dense, ids_a, steps_a, f"dense 1x{t_a}")
    del dense
    torch.cuda.empty_cache()

    # request B: 2 steps on 1 x 8192, longctx_train_step.py's default length,
    # then layer 0 of one more step against the plain versions (the model is
    # freed first: the dense plain versions hold several 3.2 GB score tensors)
    model_b = longctx_model(t_b, 12, dev)
    _, _, launches_b, _ = run_train(model_b, ids_b, steps_b, f"1x{t_b}")
    captured = capture_layer0(model_b, ids_b)
    del model_b
    torch.cuda.empty_cache()
    errs_b = check_layer0(f"layer-0 1x{t_b}", *captured)
    del captured
    torch.cuda.empty_cache()
    launches = {kid: launches_a[kid] + launches_b[kid] for kid in TRAIN_KERNELS}
    errs = {kid: max(errs_a[kid], errs_b[kid]) for kid in TRAIN_KERNELS}
    return launches, errs, measured


# ---------------------------------------------------------------------------
# The padded bidirectional path: K5 and the BERT-base SEA forward
# ---------------------------------------------------------------------------


def bidir_mask(lengths, T, seed, device):
    """(N, H, T, T_M=128) compressed mask of right-padded examples with the
    non-causal budget of `per_item_top_k` (round(H·k·T_M/len), clipped to
    [1, H·T_M], the same for every row of an example), spread at random over
    each token row's H·T_M pixels; padded rows keep nothing, as the BERT
    path's top-k gives them."""
    rng = np.random.default_rng(seed)
    width = H * BIDIR_T_M
    flat = np.zeros((len(lengths), T, width), np.float32)
    for n, length in enumerate(lengths):
        if length == 0:
            continue
        budget = min(max(round(H * K * BIDIR_T_M / length), 1), width)
        order = np.argsort(rng.random((length, width)), axis=-1)[:, :budget]
        np.put_along_axis(flat[n, :length], order, 1.0, axis=-1)
    m = np.transpose(flat.reshape(len(lengths), T, H, BIDIR_T_M), (0, 2, 1, 3)).copy()
    return torch.from_numpy(m).to(device)


def key_padding(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """(N, T) bool, True on each example's tokens."""
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def bidir_bound(ops: bs.KernelOperands, mask_m: torch.Tensor, lengths: torch.Tensor):
    """Least time the card needs for one K5 launch's function: the larger of
    4·D FLOPs per alive element (q·k and p·v; the count is this mask's
    element nnz at each example's width) at the peak for the input type,
    and the bytes at the HBM rate: q, the mask bits, the scaler and the
    lengths read once and the output written once at the padded size, and
    k and v read once at each example's own length (no key column past it
    is alive, so the function never needs it). The tile lists are the
    kernel's own device and are not counted."""
    N, Hh, T, Dd = ops.shape
    flops = 4 * Dd * int(bs.mask_nnz(mask_m, ops.k.shape[1], False, lengths=lengths))
    es = ops.q.element_size()
    kv_rows = int(ops.lengths.clamp(max=ops.k.shape[1]).sum())  # over the N·H rows
    nbytes = (2 * ops.q.numel() * es  # q; out
              + 2 * kv_rows * Dd * es  # k, v
              + ops.mbits.numel() * 4 + ops.scaler.numel() * 4 + ops.lengths.numel() * 4)
    t_ops = flops / PEAK_FLOPS[ops.q.dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def measure_bidir(q, k, v, mask, sc, lengths):
    """K5-only, wrapper, plain and SDPA times for one call's inputs (q is
    pre-divided by sqrt(D), so SDPA runs with scale 1)."""
    kw = dict(is_causal=False, lengths=lengths)
    x = bs.prepare_inputs(q, k, v, mask, sc, **kw)
    ops = bs.kernel_operands(x)
    keep = key_padding(lengths, k.shape[2])[:, None, None, :]
    out = dict(
        ms=time_ms(lambda: bs.bidir_forward(ops)),
        wrapper_ms=time_ms(lambda: bs.sea_block_sparse_attention(q, k, v, mask, sc, **kw)),
        plain_ms=time_ms(lambda: bs.dense_reference(q, k, v, mask, sc.to(q.dtype), **kw),
                         iters=5, warmup=1),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep, scale=1.0)),
    )
    out["bound_ms"], out["bound_by"], out["flops"], out["bytes"] = bidir_bound(
        ops, x.mask_m, lengths)
    return out


def check_bidir(label, q, k, v, mask, sc, lengths, timed=False):
    """K5 against its plain version in float32 on the same (rounded)
    inputs, within `tolerance`; returns (max|err|, K5's output)."""
    kw = dict(is_causal=False, lengths=lengths)
    got = bs.sea_block_sparse_attention(q, k, v, mask, sc, **kw)
    want = bs.dense_reference(q.float(), k.float(), v.float(), mask,
                              sc.to(q.dtype).float(), **kw)
    diff = (got.float() - want).abs()
    err = float(diff.max())
    over = float((diff - tolerance(want, q.dtype)).max())
    text = f"[bidir-kernel] {label}: max|err|={err:.3g} (margin to tol {-over:.3g})"
    if timed:
        m = measure_bidir(q, k, v, mask, sc, lengths)
        text += (f"; K5 {m['ms']:.4f} ms (with prep {m['wrapper_ms']:.4f}), plain "
                 f"{m['plain_ms']:.3f} ms, sdpa {m['library_ms']:.4f} ms, bound "
                 f"{m['bound_ms']:.4f} ms by {m['bound_by']} ({m['flops'] / 1e9:.4f} GFLOP, "
                 f"{m['bytes'] / 1e6:.2f} MB)")
    log(text)
    require(over <= 0, f"K5 vs plain, {label}: {err}")
    return err, got


def bidir_lengths(T, seed):
    """Four ragged right-padded lengths in [1, T], the first T."""
    rng = np.random.default_rng(seed)
    return [T, *(int(x) for x in rng.integers(1, T + 1, 3))]


def phase_bidir_mask():
    dev = "cuda"
    g = torch.Generator().manual_seed(2)
    pix = torch.arange(BIDIR_T_M)
    for T in (128, 512, 2048):
        lengths = torch.tensor([n for n in dict.fromkeys((1, 77, 128, 255, 383, T)) if n <= T],
                               dtype=torch.int32, device=dev)
        shape = (lengths.numel(), 2, T, BIDIR_T_M)
        masks = {
            "even": (pix % 2 == 0).float().expand(shape),
            "odd": (pix % 2 == 1).float().expand(shape),
            "random": (torch.rand(shape, generator=g) < 0.3).float(),
        }
        for name, m in masks.items():
            m = m.contiguous().to(dev)
            got = bs.alive_mask(m, T, is_causal=False, lengths=lengths)
            want = bs.element_mask_int8(m, T, False, lengths=lengths)
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            log(f"[bidir-mask] T={T} lengths {lengths.tolist()} {name}: {bad} mismatches "
                f"of {want.numel()} elements")
            require(bad == 0, f"K5's predicate != the oracle at T={T} ({name})")


def phase_bidir_kernel():
    dev = "cuda"
    errs = []
    for T in (256, 512, 1024, 2048, 200):
        lengths = bidir_lengths(T, seed=T)
        mask = bidir_mask(lengths, T, seed=T, device=dev)
        lt = torch.tensor(lengths, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, sc = qkv(len(lengths), T, dtype, seed=T, device=dev)
            err, got = check_bidir(f"T={T} lengths {lengths} {str(dtype)[6:]}",
                                   q / math.sqrt(D), k, v, mask, sc, lt, timed=True)
            require(got.shape[2] == T, f"T={T}: output rows {got.shape[2]}")
            errs.append(err)

    # edge cases, float32: empty rows, and examples of 0 and 1 tokens
    T = 512
    lengths = [T, 300, 1, 0]
    lt = torch.tensor(lengths, dtype=torch.int32, device=dev)
    mask = bidir_mask(lengths, T, seed=3, device=dev)
    mask[0, :, 100:164] = 0.0
    q, k, v, sc = qkv(len(lengths), T, torch.float32, seed=3, device=dev)
    err, got = check_bidir(f"T={T} lengths {lengths}, example 0 rows 100-163 empty",
                           q / math.sqrt(D), k, v, mask, sc, lt)
    zero = max(float(got[0, :, 100:164].abs().max()), float(got[3].abs().max()),
               float(got[2, :, 1:].abs().max()), float(got[1, :, 300:].abs().max()))
    log(f"[bidir-kernel] |out| on empty and padded rows: {zero}; all finite "
        f"{bool(torch.isfinite(got).all())}")
    require(zero == 0.0 and bool(torch.isfinite(got).all()), f"empty rows: |out| {zero}")
    errs.append(err)
    return max(errs)


def bert_batch(n, T, lo, hi, seed, vocab, device):
    """Right-padded token ids (0 on the padding), the 1-D attention mask and
    sentence-pair token types (1 from the middle of each example), with
    lengths uniform in [lo, hi]; the first example is `hi` long."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, n)
    lengths[0] = hi
    pos = np.arange(T)[None, :]
    am = pos < lengths[:, None]
    ids = np.where(am, rng.integers(1000, vocab, (n, T)), 0)
    types = am & (pos >= lengths[:, None] // 2)
    return [torch.from_numpy(x.astype(np.int64)).to(device) for x in (ids, am, types)]


def capture_bert_layer0(model, inputs):
    """Layer 0's K5 inputs and output from one forward (buffer registry);
    the grouped top-k on the card is held against the CPU on the same
    estimates."""
    bench = get_bench()
    bench.activate_temp_buffers(True)
    try:
        with torch.inference_mode():
            model(*inputs, benchmarking=True)
        buf = {n: bench.get_temp_buffer(n, 0) for n in (
            "q", "k", "v", "partial_attention_mask_before_interp", "estimated_scales",
            "lengths", "fused_attention_output", "masked_estimated_attention_probs",
            "per_item_top_k")}
    finally:
        bench.activate_temp_buffers(False)
        bench.reset()  # the other layers' buffers
    lengths = buf["lengths"]
    alive = key_padding(lengths, buf["q"].shape[2])[:, None, :, None]
    probs = buf["masked_estimated_attention_probs"]
    cpu_mask = topk_mask(probs.cpu(), alive.cpu(), buf["per_item_top_k"].cpu(),
                         "causal_batch", True, fp_min_for(probs.dtype))
    bad = int((cpu_mask != buf["partial_attention_mask_before_interp"].cpu()).sum())
    log(f"[bert] layer-0 top-k mask, card vs CPU on the same estimates: "
        f"{bad} mismatches of {cpu_mask.numel()}")
    require(bad == 0, "non-causal top-k masks differ between the card and the CPU")
    # the kernel's own operands: q / sqrt(D), v zeroed on the padded rows
    q = buf["q"] / math.sqrt(D)
    v = torch.where(alive, buf["v"], torch.zeros_like(buf["v"]))
    mask = (buf["partial_attention_mask_before_interp"] > 0).to(q.dtype)
    sc = torch.sigmoid(buf["estimated_scales"][..., 0])
    return q, buf["k"], v, mask, sc, lengths, buf["fused_attention_output"]


def phase_bert():
    dev = "cuda"
    cfg = bert_base("perlin")
    t0 = time.perf_counter()
    model = BertForSequenceClassification(cfg, device=dev, seed=0).eval()
    dense = BertForSequenceClassification(
        dataclasses.replace(cfg, attention_method="none"), device=dev, seed=0).eval()
    torch.cuda.synchronize()
    log(f"[bert] BERT-base perlin + dense built on {dev} in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)")
    requests = [bert_batch(n, T, lo, hi, seed=20 + i, vocab=cfg.vocab_size, device=dev)
                for i, (n, T, lo, hi) in enumerate(BERT_REQUESTS)]

    # the main path: every request once, kernel launches counted around it
    reset_launches()
    outs, per_forward = [], []
    for inputs in requests:
        before = launch_counts()
        with torch.inference_mode():
            outs.append(model(*inputs, benchmarking=True)["logits"])
        after = launch_counts()
        per_forward.append({kid: after[kid] - before[kid] for kid in after})
    torch.cuda.synchronize()
    launches = bs.bidir_forward.launches
    want = {**dict.fromkeys(launch_counts(), 0), "K5": cfg.num_layers}
    for (ids, am, _), logits, n in zip(requests, outs, per_forward):
        finite = bool(torch.isfinite(logits).all())
        log(f"[bert] request {tuple(ids.shape)} (lengths {int(am.sum(1).min())}-"
            f"{int(am.sum(1).max())}): logits {tuple(logits.shape)} finite={finite}, "
            f"launches {n}")
        require(finite and logits.shape == (ids.shape[0], cfg.num_labels),
                f"logits of request {tuple(ids.shape)}")
        require(n == want, f"launches in one forward {n}, want {want}")
    log(f"[bert] main path: {launches} launches of sea_bidir_forward")

    # layer 0's kernel inputs, captured from one more forward of each request
    errs, captured = [], None
    for inputs in requests:
        q, k, v, mask, sc, lengths, run_out = capture_bert_layer0(model, inputs)
        err, got = check_bidir(f"layer-0 {tuple(q.shape)}", q, k, v, mask, sc, lengths)
        require(torch.equal(got, run_out), "K5 on the captured inputs differs from the run's output")
        N, T = q.shape[0], q.shape[2]
        alive = float(bs.mask_nnz(mask, T, False, lengths=lengths))
        square = float((lengths.double() ** 2).sum()) * H
        log(f"[bert] layer-0 K5 inputs {tuple(q.shape)}: reproduces the run's output bit for "
            f"bit; element-mask density {alive / square:.4f} of the examples' squares")
        errs.append(err)
        if captured is None:
            captured = (q, k, v, mask, sc, lengths)

    for (ids, am, types), (n, T, _, _) in zip(requests, BERT_REQUESTS):
        real = int(am.sum())
        for label, mdl in (("SEA", model), ("dense", dense)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            ms, out = forward_ms(mdl, ids, am, types)
            peak = torch.cuda.max_memory_allocated()
            require(bool(torch.isfinite(out).all()), f"{label} logits not finite")
            log(f"[bert] forward {n}x{T} {label}: {ms:.2f} ms, {real / ms * 1e3:.0f} real "
                f"tokens/s, {n * T / ms * 1e3:.0f} padded tokens/s, peak memory "
                f"{peak / 2 ** 30:.2f} GiB ({(peak - resident) / 2 ** 30:.2f} GiB above the "
                f"{resident / 2 ** 30:.2f} GiB resident: both models and the inputs)")

    inputs = requests[0]

    def forward():
        with torch.inference_mode():
            model(*inputs, benchmarking=True)

    breakdown(f"BERT forward {tuple(inputs[0].shape)}", forward)
    return launches, max(errs), captured


# ---------------------------------------------------------------------------
# The ring: K6, K7, K8, and OPT-125m sequence-sharded over LocalGroup(4)
# ---------------------------------------------------------------------------


def window_nnz(mask_l, rows_l, col0, ch) -> int:
    """Alive elements of the rows whose global ids are `rows_l` (mask_l
    their compressed mask) in the columns col0 .. col0 + ch − 1: each alive
    pixel's run of columns, cut to the window."""
    vs, ve = bs._pixel_starts((rows_l + 1).float(), mask_l.shape[-1])
    run = (ve.clamp(max=col0 + ch) - vs.clamp(min=col0)).clamp(min=0).to(torch.int64)
    return int(((mask_l > 0).to(torch.int64) * run).sum())


def window_bound(kid, ops: bs.WindowOperands, nnz):
    """(t_ops, t_bytes) in ms of one launch of `kid` on one window, as
    `diff_bound` counts K2-K4: its FLOPs on the window's alive elements at
    the float32 FMA peak, and its bytes (q and the per-row operands of the
    shard's rows, k and v of the window, each read once; each output
    written once) at the HBM rate. The tile lists are not counted."""
    N, Hh, TL, Dd = ops.shape
    flops = RING_KERNELS[kid][4] * Dd * nnz
    q_tile = N * Hh * TL * Dd * 4
    kv_tile = N * Hh * ops.window * Dd * 4
    row = N * Hh * TL * 4
    nbytes = ops.mbits.numel() * 4 + ops.row_base.numel() * 4 + q_tile + 2 * kv_tile + {
        "K6": q_tile + row,  # out, lse (the scaler is one)
        "K7": q_tile + 2 * row + q_tile,  # dO·scaler, lse, delta; dq
        "K8": q_tile + 2 * row + 2 * kv_tile,  # dO·scaler, lse, delta; dk, dv
    }[kid]
    return 1e3 * flops / PEAK_FLOPS[torch.float32], 1e3 * nbytes / HBM_BYTES_PER_S


def ring_windows(label, q, k, v, mask, sc, do, timed=False, zigzag=True):
    """K6, K7 and K8 against their plain versions on every (shard, window)
    of a ring of RING_SHARDS shards (zigzag rows unless `zigzag` is False,
    blocks RING_BLOCK) over
    (q, k, v, mask, sc) with incoming gradient `do`, at the ring's merged
    logsumexp and delta. Returns {kernel: max|err|} and, if `timed`, each
    kernel's numbers per launch averaged over the S² launches of one layer
    (ms, plain ms, bound ms, the library's ms on one window's shapes: SDPA's
    forward for K6 and its backward for the pair K7 + K8) beside their sums
    and one launch of K2, K3 or K4 at the same T."""
    group = LocalGroup(RING_SHARDS, q.device)
    N, Hh, T, Dd = q.shape
    S = group.size
    bq, bk = sa._ring_blocks(T, S, RING_BLOCK, RING_BLOCK)
    perm, _, rows = sa._row_order(T, S, bq, zigzag, q.device)
    qp, maskp, scp, dop = (x if perm is None else x[:, :, perm] for x in (q, mask, sc, do))
    out, L, ops = sa._ring_forward(qp, k, v, maskp, scp, rows, group, bq, bk)
    _, dou, delta = bs.backward_terms(dop, out, scp, torch.float32)
    L_b = torch.where(torch.isneginf(L), float("inf"), L)
    q_l, m_l, dou_l, L_l, delta_l, k_w, v_w = (
        group.split_rows(x) for x in (qp, maskp, dou, L_b, delta, k, v))
    r_l = group.split_rows(rows, 0)
    errs = dict.fromkeys(RING_KERNELS, 0.0)
    sums = {kid: dict(ms=0.0, plain_ms=0.0, t_ops=0.0, t_bytes=0.0, bound_ms=0.0)
            for kid in RING_KERNELS}
    empty = 0
    for j in range(S):
        widths = (r_l[j] + 1).float()
        for w in range(S):
            col0, ch = w * ops[j].window, ops[j].window
            per_call = (dou_l[j], L_l[j], delta_l[j])
            plain = {
                "K6": lambda: bs.fwd_stats_window_reference(
                    q_l[j], k_w[w], v_w[w], m_l[j], col0, row_widths=widths),
                "K7": lambda: bs.dq_window_reference(
                    q_l[j], k_w[w], v_w[w], m_l[j], *per_call, col0, row_widths=widths),
                "K8": lambda: bs.dkv_window_reference(
                    q_l[j], k_w[w], v_w[w], m_l[j], *per_call, col0, row_widths=widths),
            }
            kern = {
                "K6": lambda: bs.fwd_stats_window(ops[j], w, k_w[w], v_w[w]),
                "K7": lambda: bs.dq_window(ops[j], w, k_w[w], v_w[w], *per_call),
                "K8": lambda: bs.dkv_window(ops[j], w, k_w[w], v_w[w], *per_call),
            }
            where = f"{label} shard {j} window {w}"
            (o, lse), (want_o, want_lse) = kern["K6"](), plain["K6"]()
            torch.cuda.synchronize()
            inf = torch.isposinf(want_lse)
            require(torch.equal(torch.isposinf(lse), inf) and not bool(torch.isnan(lse).any()),
                    f"{where}: K6's +inf rows of lse differ")
            e6 = max(max_err(o, want_o),
                     max_err(lse[~inf], want_lse[~inf]) if bool((~inf).any()) else 0.0)
            require(e6 <= F32_TOL and bool(torch.isfinite(o).all()), f"{where}: K6 err {e6:.3g}")
            empty += int(bool(inf.all()))
            e7 = check_grad(f"{where} K7 dq", kern["K7"](), plain["K7"]())
            (dk, dv), (want_dk, want_dv) = kern["K8"](), plain["K8"]()
            e8 = max(check_grad(f"{where} K8 dk", dk, want_dk),
                     check_grad(f"{where} K8 dv", dv, want_dv))
            for kid, e in (("K6", e6), ("K7", e7), ("K8", e8)):
                errs[kid] = max(errs[kid], e)
            if timed:
                nnz = window_nnz(m_l[j], r_l[j], col0, ch)
                for kid in RING_KERNELS:
                    t_ops, t_bytes = window_bound(kid, ops[j], nnz)
                    sums[kid]["ms"] += time_ms(kern[kid], iters=10)
                    sums[kid]["plain_ms"] += time_ms(plain[kid], iters=3, warmup=1)
                    sums[kid]["t_ops"] += t_ops
                    sums[kid]["t_bytes"] += t_bytes
                    sums[kid]["bound_ms"] += max(t_ops, t_bytes)
    log(f"[ring-kernels] {label}: {S * S} (shard, window) pairs, {empty} of them with "
        f"nothing alive on any row; max|err| vs plain K6 {errs['K6']:.3g}, K7 "
        f"{errs['K7']:.3g}, K8 {errs['K8']:.3g}")
    if not timed:
        return errs, None

    # the library's times on one window's shapes, and one launch of K2-K4 at T
    qq, kk, vv = (x.detach().clone().requires_grad_() for x in (q_l[0], k_w[0], v_w[0]))
    sdpa_out = F.scaled_dot_product_attention(qq, kk, vv)
    library = {
        "K6": time_ms(lambda: F.scaled_dot_product_attention(q_l[0], k_w[0], v_w[0])),
        "K7": time_ms(lambda: torch.autograd.grad(sdpa_out, (qq, kk, vv), dou_l[0],
                                                  retain_graph=True)),
    }
    library["K8"] = library["K7"]
    del sdpa_out, qq, kk, vv
    def unsharded_ms(blocks):
        ops_u = bs.kernel_operands(bs.prepare_inputs(q, k, v, mask, sc, block_q=blocks,
                                                     block_k=blocks), differentiable=True)
        o_u, lse_u = bs.causal_fwd_stats(ops_u)
        _, dou_u, delta_u = bs.backward_terms(do, o_u, sc, torch.float32)
        return {
            "K6": time_ms(lambda: bs.causal_fwd_stats(ops_u)),
            "K7": time_ms(lambda: bs.causal_dq(ops_u, dou_u, lse_u, delta_u)),
            "K8": time_ms(lambda: bs.causal_dkv(ops_u, dou_u, lse_u, delta_u)),
        }

    # K2-K4 with the unsharded path's 64-wide tile lists, and with the
    # ring's 128-wide ones: what the lists' width costs apart from the split
    unsharded, unsharded_wide = unsharded_ms(bs.KERNEL_TILE), unsharded_ms(bq)
    n = S * S
    timing = {}
    for kid, t in sums.items():
        timing[kid] = dict(
            ms=t["ms"] / n, sum_ms=t["ms"], plain_ms=t["plain_ms"] / n,
            bound_ms=t["bound_ms"] / n, sum_bound_ms=t["bound_ms"],
            bound_by="operations" if t["t_ops"] >= t["t_bytes"] else "bytes",
            library_ms=library[kid], unsharded_ms=unsharded[kid],
        )
        names = {"K6": "K2", "K7": "K3", "K8": "K4"}
        log(f"[ring-kernels] {label} {kid}: {n} launches {t['ms']:.4f} ms "
            f"({t['ms'] / n:.4f} a launch) against one {names[kid]} launch at T={T} "
            f"{unsharded[kid]:.4f} ms ({t['ms'] / unsharded[kid]:.2f}x; {names[kid]} on "
            f"{bq}-wide lists {unsharded_wide[kid]:.4f} ms, "
            f"{t['ms'] / unsharded_wide[kid]:.2f}x); plain "
            f"{t['plain_ms'] / n:.3f} ms a window; sdpa {'fwd' if kid == 'K6' else 'bwd'} "
            f"{library[kid]:.4f} ms on one window's shapes; bound {t['bound_ms']:.4f} ms over "
            f"the {n} ({t['bound_ms'] / n:.4f} a launch) by {timing[kid]['bound_by']}")
    return errs, timing


def ring_vs_unsharded(label, q, k, v, mask, sc, do):
    """The whole differentiable ring (K6 forward, K7/K8 backward; zigzag,
    blocks RING_BLOCK, LocalGroup(RING_SHARDS)) against FusedSparseAttention
    (K2-K4) unsharded on the same inputs: the output within 3e-5 and dq, dk,
    dv, dscaler within 2e-4 abs and each also within 1e-8 + 1e-4·max|want|
    (check_grad's rule), so that a ring whose gradients are far smaller than
    2e-4 (a CE loss's over 16384 tokens) cannot drop, misroute or zero a dk/dv
    chunk unseen. Returns the ring's (o, dq, dk, dv, dscaler)."""
    group = LocalGroup(RING_SHARDS, q.device)
    got = autograd_outputs(
        lambda a, b, c, d: sa.ring_fused_train_attention(
            a, b, c, mask, d, group, True, RING_BLOCK, RING_BLOCK), q, k, v, sc, do)
    want = autograd_outputs(
        lambda a, b, c, d: bs.fused_sparse_attention(a, b, c, mask, d), q, k, v, sc, do)
    errs = [max_err(g, w) for g, w in zip(got, want)]
    rel = [e / max(float(w.abs().max()), 1e-30) for e, w in zip(errs, want)]
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    log(f"[ring-kernels] {label}: ring (K6-K8) vs unsharded (K2-K4) max|err| o {errs[0]:.3g}, "
        f"dq {errs[1]:.3g}, dk {errs[2]:.3g}, dv {errs[3]:.3g}, dscaler {errs[4]:.3g} "
        f"(relative to max|want|: {', '.join(f'{r:.3g}' for r in rel)}); finite {finite}")
    require(finite and errs[0] <= RING_OUT_TOL and max(errs[1:]) <= RING_GRAD_TOL,
            f"{label}: ring vs unsharded {errs}")
    for name, g, w in zip(("dq", "dk", "dv", "dscaler"), got[1:], want[1:]):
        check_grad(f"{label} ring {name}", g, w)
    return got


def phase_ring_kernels():
    dev = "cuda"
    T = RING_CHECK_T
    q, k, v, sc = qkv(1, T, torch.float32, seed=21, device=dev)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(22)).to(dev)
    mask = budget_mask(1, T, seed=21, device=dev)
    dead = slice(T // 4, T // 4 + 64)
    mask[:, :, dead] = 0.0  # rows with nothing alive
    errs, timing = ring_windows(f"1x{T} zigzag", q, k, v, mask, sc, do, timed=True)
    # rows in the natural order: shard 0's rows end before windows 1-3 begin
    natural, _ = ring_windows(f"1x{T} natural order", q, k, v, mask, sc, do, zigzag=False)
    errs = {kid: max(errs[kid], natural[kid]) for kid in errs}
    o, dq, *_ = ring_vs_unsharded(f"1x{T}", q, k, v, mask, sc, do)
    zero = max(float(o[:, :, dead].abs().max()), float(dq[:, :, dead].abs().max()))
    log(f"[ring-kernels] 1x{T}: |o|, |dq| on rows {dead.start}-{dead.stop - 1}, which have "
        f"nothing alive: {zero}")
    require(zero == 0.0, "rows with nothing alive: nonzero output or dq")
    return errs, timing


def serve_model(t):
    """The serving OPT-125m SEA student with positions up to `t`, random
    weights from seed 0."""
    sea = opt_config(max_position_embeddings=t)
    cfg = dataclasses.replace(opt_125m("perlin", sea=sea), max_position_embeddings=t)
    return OptForCausalLM(cfg, device="cuda", seed=0).eval()


def layer0_forward(model, ids, scope=None):
    """One benchmark forward (inside `scope` if given): (logits, layer 0's
    attention output `partial_context_layer`, its kernel output)."""
    with contextlib.ExitStack() as stack:
        if scope is not None:
            stack.enter_context(sharded_attention_scope(**scope))
        bench = stack.enter_context(layer0_registry(model))
        stack.enter_context(torch.inference_mode())
        logits = model(ids, torch.ones_like(ids), benchmarking=True)["logits"]
    out = (logits, bench.get_temp_buffer("partial_context_layer", 0),
           bench.get_temp_buffer("fused_attention_output", 0))
    bench.reset()
    return out


def phase_ring_serve():
    dev = "cuda"
    T = RING_T
    model = serve_model(T)
    n_layers = model.cfg.num_layers
    ids = torch.randint(4, model.cfg.vocab_size, (1, T),
                        generator=torch.Generator().manual_seed(13)).to(dev)
    am = torch.ones_like(ids)
    scope = dict(group=LocalGroup(RING_SHARDS, dev), kind="auto")

    # the main path: one forward inside the scope, launches counted around it
    with sharded_attention_scope(**scope) as ctx:
        kind = resolve_attention_kind(ctx, t=T)
        require(kind == "ring", f"kind='auto' at T={T} over {RING_SHARDS} shards gave {kind}")
        reset_launches()
        with torch.inference_mode():
            logits = model(ids, am, benchmarking=True)["logits"]
        torch.cuda.synchronize()
        counts = launch_counts()
    want = {**dict.fromkeys(counts, 0), "K6": RING_SHARDS ** 2 * n_layers}
    finite = bool(torch.isfinite(logits).all())
    log(f"[ring-serve] 1x{T} under kind='auto' -> {kind}: logits {tuple(logits.shape)} "
        f"finite={finite}, launches {counts}")
    require(finite and logits.shape == (1, T, model.cfg.vocab_size), "ring logits")
    require(counts == want, f"ring forward launches {counts}, want {want}")

    # layer 0 against the unsharded forward (K1)
    ring = layer0_forward(model, ids, scope)
    before = launch_counts()["K1"]
    plain = layer0_forward(model, ids)
    require(launch_counts()["K1"] - before == n_layers, "the unsharded forward's K1 launches")
    err_ctx, err_kernel, err_logits = (max_err(a, b) for a, b in zip(ring[1:] + ring[:1],
                                                                      plain[1:] + plain[:1]))
    log(f"[ring-serve] layer 0 ring vs unsharded: attention output max|err| {err_ctx:.3g}, "
        f"kernel output {err_kernel:.3g}; logits after 12 layers {err_logits:.3g}; the run's "
        f"logits reproduced {torch.equal(ring[0], logits)}")
    require(err_ctx <= LAYER_TOL, f"layer-0 attention output, ring vs unsharded: {err_ctx}")
    del ring, plain

    def ring_forward():
        with sharded_attention_scope(**scope), torch.inference_mode():
            model(ids, am, benchmarking=True)

    def plain_forward():
        with torch.inference_mode():
            model(ids, am, benchmarking=True)

    times = {label: host_ms(fn, iters=3)
             for label, fn in (("ring", ring_forward), ("unsharded", plain_forward))}
    log(f"[ring-serve] forward 1x{T}: ring over {RING_SHARDS} shards {times['ring']:.2f} ms "
        f"({T / times['ring'] * 1e3:.0f} tokens/s), unsharded {times['unsharded']:.2f} ms "
        f"({T / times['unsharded'] * 1e3:.0f} tokens/s)")
    breakdown(f"ring forward (1, {T})", ring_forward)
    del model
    torch.cuda.empty_cache()
    return counts["K6"]
def train_arm(model, ids, steps, label, want=None):
    """`run_train` with the first step's every-layer top-k masks (bool, from
    forward hooks) and parameter gradients kept for `compare_arms`."""
    masks, grads = [], {}
    hooks = [layer.self_attn.perlin.register_forward_hook(
        lambda m, args, out: masks.append(out.partial_attention_mask > -1.0))
        for layer in model.model.layers]

    def after_step(i):
        if i == 0:
            for h in hooks:
                h.remove()
            grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters()})

    losses, times, launches, peak = run_train(model, ids, steps, label, want=want,
                                              after_step=after_step)
    return dict(label=label, losses=losses, times=times, launches=launches, peak=peak,
                masks=masks, grads=grads, tokens=ids.numel())


def compare_arms(phase, a, b):
    """Arm `a` (sharded) against arm `b` (unsharded) from the same weights
    and batch: the first step's loss within 1e-4; the top-k picks of every
    layer compared; every parameter gradient within 2e-4 abs when no pick
    differs (a later layer's near-tie pick can flip under the arms' float
    reassociation; the gap is then printed and not held to the bound)."""
    dloss = abs(a["losses"][0] - b["losses"][0])
    differ = [(i, int((ma != mb).sum())) for i, (ma, mb) in enumerate(zip(a["masks"], b["masks"]))]
    differ = [(i, n) for i, n in differ if n]
    gaps = {n: max_err(g, b["grads"][n]) for n, g in a["grads"].items()}
    worst = max(gaps, key=gaps.get)
    scale = max(float(g.abs().max()) for g in b["grads"].values())
    log(f"[{phase}] {a['label']} vs {b['label']}: first-step loss {a['losses'][0]:.6f} vs "
        f"{b['losses'][0]:.6f} (|diff| {dloss:.3g}); top-k picks differing by layer "
        f"{differ or 'none'} of {len(a['masks'])} layers; max|grad diff| {gaps[worst]:.3g} "
        f"({worst}; largest gradient {scale:.3g})")
    require(len(a["masks"]) == len(b["masks"]) > 0, "top-k masks captured")
    require(dloss <= LOSS_TOL, f"{phase}: first-step loss differs by {dloss}")
    if differ:
        log(f"[{phase}] top-k picks differ, so the gradient gap {gaps[worst]:.3g} is "
            f"reported and not held to {RING_GRAD_TOL}")
    else:
        require(gaps[worst] <= RING_GRAD_TOL, f"{phase}: gradient {worst} differs by {gaps[worst]}")
    for arm in (a, b):
        steady = statistics.median(arm["times"][1:])
        log(f"[{phase}] {arm['label']}: {steady:.2f} ms/step after the first "
            f"({arm['tokens'] / steady * 1e3:.0f} tokens/s), peak memory {arm['peak']:.2f} GiB")


def phase_ring_train():
    dev = "cuda"
    T, steps = RING_T, 2
    group = LocalGroup(RING_SHARDS, dev)

    # the main path: 2 steps inside the scope, launches counted step by step
    with sharded_attention_scope(group, kind="auto") as ctx:
        kind = resolve_attention_kind(ctx, t=T)
        require(kind == "ring", f"kind='auto' at T={T} over {RING_SHARDS} shards gave {kind}")
        model = longctx_model(T, 12, dev)
        ids = torch.randint(4, model.cfg.vocab_size, (1, T),
                            generator=torch.Generator().manual_seed(14)).to(dev)
        n = RING_SHARDS ** 2 * model.cfg.num_layers
        want = {**dict.fromkeys(launch_counts(), 0), "K6": n, "K7": n, "K8": n}
        ring = train_arm(model, ids, steps, f"ring 1x{T}", want=want)
        launches = {kid: ring["launches"][kid] for kid in RING_KERNELS}
        require(ring["losses"][-1] < ring["losses"][0],
                f"the loss did not fall over {steps} steps: {ring['losses']}")
        # layer 0 of one more step, for the op-level checks below
        captured = capture_layer0(model, ids)
    del model
    torch.cuda.empty_cache()

    # the unsharded arm (K2-K4) from the same weights and batch
    model = longctx_model(T, 12, dev)
    plain = train_arm(model, ids, steps, f"unsharded 1x{T}")
    del model
    torch.cuda.empty_cache()
    compare_arms("ring-train", ring, plain)
    del ring, plain
    torch.cuda.empty_cache()

    # layer 0's attention op at the inputs captured from the ring arm
    q, k, v, mask, sc, do, step_o = captured
    got = ring_vs_unsharded(f"layer-0 1x{T}", q, k, v, mask, sc, do)
    require(torch.equal(got[0], step_o), "the ring on the captured inputs differs from the step's output")
    log(f"[ring-train] layer-0 ring output reproduces the step's own bit for bit")
    del got
    errs, timing = ring_windows(f"layer-0 1x{T}", q, k, v, mask, sc, do, timed=True)
    return launches, errs, timing


def phase_seq_head():
    dev = "cuda"
    T = RING_CHECK_T
    for t, size, want in ((T, RING_SHARDS, "seq"), (RING_T, RING_SHARDS, "ring"),
                          (RING_T, 1, "seq"), (4 * RING_T, 1, "seq")):
        got = resolve_attention_kind(AttnShardingContext(LocalGroup(size, dev)), t=t)
        log(f"[seq-head] kind='auto' at T={t} over {size} shard(s): {got}")
        require(got == want, f"the auto rule at T={t}, {size} shards: {got}, want {want}")

    group = LocalGroup(RING_SHARDS, dev)
    model = serve_model(T)
    n_layers = model.cfg.num_layers
    ids = torch.randint(4, model.cfg.vocab_size, (1, T),
                        generator=torch.Generator().manual_seed(15)).to(dev)
    plain = layer0_forward(model, ids)
    for kind in ("seq", "head", "auto"):
        reset_launches()
        got = layer0_forward(model, ids, dict(group=group, kind=kind))
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {**dict.fromkeys(counts, 0), "K1": RING_SHARDS * n_layers}
        err_ctx, err_logits = max_err(got[1], plain[1]), max_err(got[0], plain[0])
        log(f"[seq-head] forward 1x{T} kind={kind}: launches {counts}; layer-0 attention "
            f"output max|err| {err_ctx:.3g} vs unsharded, logits {err_logits:.3g}; finite "
            f"{bool(torch.isfinite(got[0]).all())}")
        require(counts == want, f"{kind} forward launches {counts}, want {want}")
        require(err_ctx <= LAYER_TOL and bool(torch.isfinite(got[0]).all()),
                f"{kind} forward: layer-0 err {err_ctx}")
    del model, plain, got
    torch.cuda.empty_cache()

    unsharded = train_arm(longctx_model(T, 12, dev), ids, 2, f"unsharded 1x{T}")
    for kind in ("seq", "head"):
        with sharded_attention_scope(group, kind=kind):
            n = RING_SHARDS * n_layers
            arm = train_arm(longctx_model(T, 12, dev), ids, 2, f"{kind} 1x{T}",
                            want={**dict.fromkeys(launch_counts(), 0),
                                  **dict.fromkeys(TRAIN_KERNELS, n)})
        compare_arms("seq-head", arm, unsharded)
        del arm
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The impl variants K9a-c, the attention-operator sweep, the cosformer slice
# ---------------------------------------------------------------------------


def block_label(bq, bk):
    return "defaults" if bq is None else f"{bq}x{bk}"


def phase_impl_mask():
    dev = "cuda"
    masks = [(f"budget T={T}", T, budget_mask(1, T, seed=T, device=dev)) for T in (1024, 2048, 4096)]
    masks.append((f"host_topk_mask T={BENCH_T}", BENCH_T,
                  torch.from_numpy(host_topk_mask(1, H, BENCH_T, T_M, K, seed=0)).to(dev)))
    checked = 0
    for label, T, m in masks:
        want = bs.element_mask_int8(m, T, True)
        for kid, (impl, _) in IMPL_VARIANTS.items():
            bad = {}
            for bq, bk in BENCH_BLOCKS:
                if bq is not None and (T % bq or T % bk):
                    continue
                got = bs.alive_mask(m, T, impl=impl, block_q=bq, block_k=bk)
                torch.cuda.synchronize()
                bad[block_label(bq, bk)] = int((got != want).sum())
                checked += got.numel()
            log(f"[impl-mask] {label} {kid} ({impl}): mismatches by blocks {bad}")
            require(not any(bad.values()), f"{kid}'s predicate != element_mask_int8 ({label})")
        del want
    log(f"[impl-mask] {checked / 1e9:.2f} G elements checked")


def bench_inputs(dtype, device):
    """bench.py's canonical inputs (bench.py:73-79): q, k, v, the scaler and
    the host-built top-k mask, from numpy seeded 0 in bench.py's order."""
    rng = np.random.default_rng(0)
    shape = (1, H, BENCH_T, D)
    q = rng.standard_normal(shape).astype(np.float32) * 0.2
    k = rng.standard_normal(shape).astype(np.float32) * 0.2
    v = rng.standard_normal(shape).astype(np.float32)
    sc = rng.uniform(0.1, 1.0, (1, H, BENCH_T)).astype(np.float32)
    q, k, v, sc = (torch.from_numpy(x).to(device, dtype) for x in (q, k, v, sc))
    mask = torch.from_numpy(host_topk_mask(1, H, BENCH_T, T_M, K, seed=0)).to(device)
    return q, k, v, sc, mask


def impl_operands(q, k, v, mask, sc, impl, bq, bk):
    """The operands `sea_block_sparse_attention(..., impl=)` builds, at the
    blocks given or the wrapper's defaults."""
    bq, bk, sub = bs.impl_blocks(impl, q.shape[2], k.shape[2], bq, bk)
    x = bs.prepare_inputs(q, k, v, mask, sc, block_q=bq, block_k=bk)
    return bs.kernel_operands(x, impl=impl, sub=sub)


def tile_stats(ops) -> str:
    """What the restriction saves on these operands: K9a/b's mean words per
    listed tile (of the row's n_words) and the shares of one- and two-word
    exact ranges; K9c's share of the listed outer tiles' pieces it skips."""
    listed = torch.arange(ops.idx.shape[-1], device=ops.idx.device) < ops.counts[..., None]
    aux = ops.tile_aux[listed]
    if ops.impl == "subtile":
        n = ops.block_k // ops.sub
        bits = (aux[:, None] >> torch.arange(n, device=aux.device, dtype=torch.int32)) & 1
        active = float(bits.sum()) / bits.numel()
        return (f"{int(listed.sum())} listed outer tiles of {n} pieces of {ops.sub}: "
                f"{100 * (1 - active):.1f}% of pieces skipped")
    lo, hi, exact = aux & 0xFF, (aux >> 8) & 0xFF, (aux >> 16) != 0
    words = (hi - lo + 1).float()
    return (f"{int(listed.sum())} listed tiles: {float(words.mean()):.3f} words of "
            f"{ops.mbits.shape[-1]} on average; exact one word {100 * float((exact & (lo == hi)).float().mean()):.1f}%, "
            f"two {100 * float((exact & (hi == lo + 1)).float().mean()):.1f}%")


def phase_impl_kernels():
    """bench.py's configuration through every impl and block shape. Returns
    the main-path launches of K9a-c, {kid: max|kernel - plain| in float32}
    and {dtype: {kid: times at the defaults}}, K1's beside them."""
    dev = "cuda"
    errs, timing = dict.fromkeys(IMPL_VARIANTS, 0.0), {torch.float32: {}, torch.bfloat16: {}}
    launches = dict.fromkeys(IMPL_VARIANTS, 0)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, sc, mask = bench_inputs(dtype, dev)
        ref = bs.sea_block_sparse_attention(q, k, v, mask, sc)  # K1, 64 x 64
        # the main path: every impl and block shape once, launches counted
        reset_launches()
        outs = {}
        for kid, (impl, _) in IMPL_VARIANTS.items():
            for bq, bk in BENCH_BLOCKS:
                outs[kid, bq, bk] = bs.sea_block_sparse_attention(
                    q, k, v, mask, sc, block_q=bq, block_k=bk, impl=impl)
        torch.cuda.synchronize()
        counts = launch_counts()
        want_counts = {**dict.fromkeys(counts, 0),
                       **dict.fromkeys(IMPL_VARIANTS, len(BENCH_BLOCKS))}
        log(f"[impl-kernels] {str(dtype)[6:]} 1x{BENCH_T}: launches {counts}")
        require(counts == want_counts, f"impl launches {counts}, want {want_counts}")
        for kid in IMPL_VARIANTS:
            launches[kid] += counts[kid]
        for (kid, bq, bk), got in outs.items():
            impl = IMPL_VARIANTS[kid][0]
            ops = impl_operands(q, k, v, mask, sc, impl, bq, bk)
            want = bs.impl_reference(ops._replace(q=ops.q.float(), k=ops.k.float(),
                                                  v=ops.v.float()), impl)
            diff = (got.float() - want).abs()
            err = float(diff.max())
            over = float((diff - tolerance(want, dtype)).max())
            vs_k1 = max_err(got, ref)
            log(f"[impl-kernels] {str(dtype)[6:]} {kid} ({impl}) blocks {block_label(bq, bk)}: "
                f"max|err| vs plain {err:.3g} (margin to tol {-over:.3g}); max|diff| vs K1 "
                f"{vs_k1:.3g}; {tile_stats(ops)}")
            require(over <= 0, f"{kid} vs plain at blocks {block_label(bq, bk)} {dtype}: {err}")
            require(vs_k1 == 0, f"{kid} at blocks {block_label(bq, bk)} {dtype} differs from "
                                f"K1 by {vs_k1}")
            if dtype == torch.float32:
                errs[kid] = max(errs[kid], err)
        del outs

        # times at the defaults, K1 beside them at the same inputs
        x = bs.prepare_inputs(q, k, v, mask, sc)
        k1_ops = bs.kernel_operands(x)
        k1_ms = time_ms(lambda: bs.launch_causal_flat(k1_ops))
        timing[dtype]["K1"] = dict(
            ms=k1_ms, wrapper_ms=time_ms(lambda: bs.sea_block_sparse_attention(q, k, v, mask, sc)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)))
        timing[dtype]["K1"]["bound_ms"], timing[dtype]["K1"]["bound_by"], *_ = bound(k1_ops, mask)
        for kid, (impl, _) in IMPL_VARIANTS.items():
            ops = impl_operands(q, k, v, mask, sc, impl, None, None)
            wrapper = bs.IMPL_KERNELS[impl].wrapper
            m = dict(
                ms=time_ms(lambda: wrapper(ops)),
                wrapper_ms=time_ms(lambda: bs.sea_block_sparse_attention(
                    q, k, v, mask, sc, impl=impl)),
                plain_ms=time_ms(lambda: bs.impl_reference(ops, impl), iters=5, warmup=1),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True)),
            )
            m["bound_ms"], m["bound_by"], m["flops"], m["bytes"] = bound(ops, mask)
            log(f"[impl-kernels] {str(dtype)[6:]} {kid} ({impl}) at its defaults "
                f"({ops.block_q}x{ops.block_k}{f', sub {ops.sub}' if ops.sub else ''}): kernel "
                f"{m['ms']:.4f} ms (K1 {k1_ms:.4f} ms; with prep {m['wrapper_ms']:.4f}), plain "
                f"{m['plain_ms']:.3f} ms, sdpa {m['library_ms']:.4f} ms, bound {m['bound_ms']:.4f} "
                f"ms by {m['bound_by']} ({m['flops'] / 1e9:.4f} GFLOP, {m['bytes'] / 1e6:.2f} MB)")
            timing[dtype][kid] = m
        del q, k, v, sc, mask, ref
        torch.cuda.empty_cache()
    return launches, errs, timing


def phase_sweep():
    """The attention-operator sweep on the card, float32 and bfloat16, then
    K9a against its plain version on each T's sea_fused inputs. Returns
    K9a's launches in the sweep and its largest error in float32."""
    n_k9a, err_f32 = 0, 0.0
    for dtype in ("float32", "bfloat16"):
        reset_launches()
        res = attention_method_sweep(seq_lens=SWEEP_TS, dtype=dtype)
        torch.cuda.synchronize()
        counts = launch_counts()
        for rec in res:
            log(f"[sweep] {json.dumps(rec)}")
        bad = [r for r in res if "error" in r]
        require(not bad, f"sweep records with an error: {bad}")
        require({(r["method"], r["seq_len"]) for r in res}
                == {(m, T) for m in ("dense", "performer", "cosformer", "sea_fused")
                    for T in SWEEP_TS}, "the sweep's records")
        by = {(r["method"], r["seq_len"]): r["ms"] for r in res}
        ratios = {T: by["dense", T] / by["sea_fused", T] for T in SWEEP_TS}
        log(f"[sweep] {dtype}: launches {counts}; dense / sea_fused ms by T "
            f"{ {T: round(r, 3) for T, r in ratios.items()} }")
        require(counts["K9a"] > 0 and counts["K1"] == 0,
                f"sea_fused must launch K9a and never K1: {counts}")
        require(not any(n for kid, n in counts.items() if kid != "K9a"),
                f"the sweep launched other kernels: {counts}")
        n_k9a += counts["K9a"]

        # sea_fused's call (`attention_operators`) on the sweep's own inputs,
        # held to the plain version in float32 on the same (rounded) inputs
        dt = getattr(torch, dtype)
        for T in SWEEP_TS:
            q, k, v, mask = sweep_inputs(T, H, D, T_M, K, dt, "cuda")
            got = bs.sea_block_sparse_attention(q, k, v, mask, None, impl="flat_wr")
            ops = impl_operands(q, k, v, mask, None, "flat_wr", None, None)
            want = bs.impl_reference(ops._replace(q=ops.q.float(), k=ops.k.float(),
                                                  v=ops.v.float()), "flat_wr")
            diff = (got.float() - want).abs()
            err = float(diff.max())
            over = float((diff - tolerance(want, dt)).max())
            ms = time_ms(lambda: bs.IMPL_KERNELS["flat_wr"].wrapper(ops))
            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
            bound_ms, bound_by, *_ = bound(ops, mask)
            log(f"[sweep] {dtype} T={T} sea_fused (K9a) vs plain: max|err| {err:.3g} "
                f"(margin to tol {-over:.3g}); K9a {ms:.4f} ms, sdpa {sdpa_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms by {bound_by}")
            require(over <= 0, f"K9a vs plain on the sweep's inputs at T={T} {dtype}: {err}")
            if dt == torch.float32:
                err_f32 = max(err_f32, err)
            del q, k, v, mask, got, ops, want, diff
        torch.cuda.empty_cache()
    return n_k9a, err_f32


def phase_cosformer_slice():
    dev = "cuda"
    cfg = opt_125m("perlin", sea=opt_config(predictor_backend="cosformer"))
    model = OptForCausalLM(cfg, device=dev, seed=0).eval()
    ids = torch.randint(4, cfg.vocab_size, (1, COS_T),
                        generator=torch.Generator().manual_seed(16)).to(dev)
    am = torch.ones_like(ids)

    # the main path: one forward, launches counted around it
    reset_launches()
    with torch.inference_mode():
        logits = model(ids, am, benchmarking=True)["logits"]
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {**dict.fromkeys(counts, 0), "K1": cfg.num_layers}
    finite = bool(torch.isfinite(logits).all())
    log(f"[cosformer-slice] OPT-125m, cosformer backend, 1x{COS_T}: logits "
        f"{tuple(logits.shape)} finite={finite}, launches {counts}")
    require(finite and logits.shape == (1, COS_T, cfg.vocab_size), "cosformer logits")
    require(counts == want, f"cosformer forward launches {counts}, want {want}")

    # layer 0's kernel inputs, captured from a forward, against the plain version
    bench = get_bench()
    bench.activate_temp_buffers(True)
    with torch.inference_mode():
        model(ids, am, benchmarking=True)
    buf = {n: bench.get_temp_buffer(n, 0) for n in (
        "q", "k", "v", "partial_attention_mask_before_interp", "estimated_scales")}
    bench.activate_temp_buffers(False)
    bench.reset()
    q, k, v = buf["q"], buf["k"], buf["v"]
    mask = (buf["partial_attention_mask_before_interp"] > 0).to(q.dtype)
    sc = torch.sigmoid(buf["estimated_scales"][..., 0])
    err = max_err(bs.sea_block_sparse_attention(q, k, v, mask, sc, k_cfg=float(K)),
                  bs.dense_reference(q, k, v, mask, sc, k_cfg=float(K)))
    log(f"[cosformer-slice] layer-0 kernel inputs {tuple(q.shape)}: K1 vs plain max|err| {err:.3g}")
    require(err <= F32_TOL, f"K1 vs plain on the cosformer layer-0 inputs: {err}")

    # the performer backend with the same weights (all but the cosformer's)
    perf = OptForCausalLM(opt_125m("perlin"), device=dev, seed=None).eval()
    perf.load_state_dict({n: p for n, p in model.state_dict().items()
                          if "cosformer_backend" not in n}, strict=False)
    missing = [n for n in perf.state_dict() if n not in model.state_dict()]
    require(not missing, f"weights the performer model did not get: {missing[:3]}")
    cos_ms, _ = forward_ms(model, ids, am)
    perf_ms, perf_out = forward_ms(perf, ids, am)
    require(bool(torch.isfinite(perf_out).all()), "performer-backend logits not finite")
    log(f"[cosformer-slice] forward 1x{COS_T}: cosformer backend {cos_ms:.2f} ms "
        f"({COS_T / cos_ms * 1e3:.0f} tokens/s), performer backend {perf_ms:.2f} ms "
        f"({COS_T / perf_ms * 1e3:.0f} tokens/s)")

    def forward():
        with torch.inference_mode():
            model(ids, am, benchmarking=True)

    breakdown(f"cosformer-backend forward (1, {COS_T})", forward)
    del model, perf
    torch.cuda.empty_cache()
    return err


# ---------------------------------------------------------------------------
# The dense train path against the fused kernels, and KD training
# ---------------------------------------------------------------------------


def attention_inputs(T, seed, device):
    """q, k, v of OPT-125m's attention width (1, H, T, D) as the JAX
    package's attention tests draw them (N(0, 0.25)) and the square
    additive causal mask."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy((rng.standard_normal((1, H, T, D)) * 0.5).astype(np.float32))
               .to(device) for _ in range(3))
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=device))
    mask = torch.where(causal, 0.0, fp_min_for(torch.float32))[None, None]
    return q, k, v, mask


def dead_rows(a, b):
    """(T,) rows whose dead set differs between two masks (any head)."""
    return (a != b).any(-1).any(1)[0]


def phase_dense_vs_fused():
    """The dense train path (plain PyTorch) as the reference of the fused
    kernels at OPT-125m's attention width on 1 x DENSE_T, float32 with TF32
    off: the benchmark path's context (one K1 launch) within 2e-4 of the
    dense path's (tests/test_fused_path.py:12), and use_fused_train's loss
    Σ context² (K2, K3, K4 once each) at rtol 1e-4 and every gradient at
    atol 5e-3, rtol 1e-2 of the dense path's (:88). The arms compute their
    top-k masks by the same code on the same inputs; rows whose picks differ
    would be counted, left out of the context check, and the gradients then
    reported and not held."""
    dev = "cuda"
    cfg = opt_config()
    q, k, v, mask = attention_inputs(DENSE_T, 17, dev)
    dense = SeaAttention(cfg, device=dev, seed=0)
    fused = SeaAttention(dataclasses.replace(cfg, use_fused_train=True), device=dev, seed=None)
    fused.load_state_dict(dense.state_dict())

    bench = get_bench()

    def arm(model, benchmarking, training):
        """One arm's output, loss Σ context², gradients, launches and
        compressed top-k mask (from the buffer registry)."""
        reset_launches()
        bench.reset()
        bench.activate_temp_buffers(True)
        try:
            out = model(q, k, v, q, k, v, q, k, mask, benchmarking=benchmarking,
                        training=training)
            mask_m = bench.get_temp_buffer("partial_attention_mask_before_interp", 0).detach()
        finally:
            bench.activate_temp_buffers(False)
            bench.reset()
        loss = None
        if not benchmarking:
            loss = (out.context_layer.float() ** 2).sum()
            model.zero_grad(set_to_none=True)
            loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad for n, p in model.named_parameters()}
        # dead pixels: additive masks (train) hold FP_MIN, binary ones 0
        dead = mask_m < -1 if not benchmarking else mask_m <= 0
        return out, loss, grads, launch_counts(), dead

    d_out, d_loss, d_grads, d_n, d_dead = arm(dense, False, True)
    with torch.no_grad():
        b_out, _, _, b_n, b_dead = arm(dense, True, False)
    f_out, f_loss, f_grads, f_n, f_dead = arm(fused, False, True)
    zero = dict.fromkeys(launch_counts(), 0)
    require(d_n == zero, f"the dense path launched kernels: {d_n}")
    require(b_n == {**zero, "K1": 1}, f"the benchmark arm's launches {b_n}")
    require(f_n == {**zero, "K2": 1, "K3": 1, "K4": 1}, f"the fused-train arm's launches {f_n}")

    rows_b = dead_rows(d_dead, b_dead)
    rows_f = dead_rows(d_dead, f_dead)
    keep = ~rows_b
    ctx_err = max_err(d_out.context_layer.detach()[:, keep], b_out.context_layer[:, keep])
    log(f"[dense-vs-fused] 1x{DENSE_T}, H={H} D={D} T_M={T_M} k={K}: top-k rows differing from "
        f"the dense arm's: benchmark {int(rows_b.sum())}, fused-train {int(rows_f.sum())}; "
        f"context, dense vs benchmark path (K1), max|err| {ctx_err:.3g} over "
        f"{int(keep.sum())} rows (bound 2e-4)")
    require(ctx_err < 2e-4, f"dense vs benchmark context {ctx_err}")
    f_loss, d_loss = float(f_loss), float(d_loss)
    rel = abs(f_loss - d_loss) / abs(d_loss)
    worst, worst_name = 0.0, None
    unreached = []
    for name, g in d_grads.items():
        f = f_grads[name]
        if f is None:
            unreached.append(name)
            require(g is None or float(g.abs().max()) == 0.0, f"{name}: dense gradient where fused has none")
            continue
        excess = float(((f - g).abs() - (5e-3 + 1e-2 * g.abs())).max())
        if excess > worst or worst_name is None:
            worst, worst_name = excess, name
    gaps = {n: max_err(f_grads[n], g) for n, g in d_grads.items() if f_grads[n] is not None}
    top = max(gaps, key=gaps.get)
    log(f"[dense-vs-fused] use_fused_train (K2-K4) vs dense: loss {float(f_loss):.6f} vs "
        f"{float(d_loss):.6f} (rel {rel:.3g}, bound 1e-4); max|grad err| {gaps[top]:.3g} "
        f"({top}); largest excess over 5e-3 + 1e-2|dense| {worst:.3g} ({worst_name}); "
        f"{len(unreached)} parameters behind the top-k without a gradient on either path")
    require(rel <= 1e-4, f"fused-train loss vs dense: rel {rel}")
    if rows_f.any():
        log(f"[dense-vs-fused] top-k picks differ, so the gradients are reported and not held")
    else:
        require(worst <= 0.0, f"fused-train gradient {worst_name} off the dense path's by {worst}")
    del dense, fused
    torch.cuda.empty_cache()
    return dict(context=ctx_err, loss_rel=rel, grad=gaps[top])


def kd_config(save_dir):
    """The KD trainer's defaults (OPT-125m, 1 x 512, stride 256,
    accumulation 8, use_remat), KD_STEPS optimizer steps, a log line each."""
    return TrainerConfig(model="opt-125m", num_steps=KD_STEPS, log_steps=1,
                         eval_steps=10 ** 9, save_dir=save_dir)


def phase_kd():
    dev = "cuda"
    with tempfile.TemporaryDirectory() as save_dir:
        t0 = time.perf_counter()
        tr = OptTrainer(kd_config(save_dir), device=dev)
        torch.cuda.synchronize()
        cfg = tr.cfg
        log(f"[kd] OPT-125m teacher and student on {dev} in {time.perf_counter() - t0:.1f} s: "
            f"{tr.s_cfg.num_layers} layers, vocab {tr.s_cfg.vocab_size}, "
            f"{cfg.batch_size}x{cfg.max_seq_len} windows, stride {cfg.stride}, accumulation "
            f"{cfg.gradient_accumulation_steps}, remat {cfg.use_remat}, "
            f"{len(tr.corpus)} training windows (synthetic corpus)")
        fixed = next(tr.corpus.batches(cfg.batch_size, shuffle=True, seed=cfg.seed))
        fixed_t = tr._tensors(*fixed)

        def fixed_loss():
            with torch.no_grad():
                loss, details = tr.kd.kd_loss(*fixed_t, use_remat=False)
            return float(loss), {n: float(x) for n, x in details.items()}

        before, before_terms = fixed_loss()
        student0 = {n: x.clone() for n, x in tr.student.state_dict().items()}
        teacher0 = {n: x.clone() for n, x in tr.teacher.state_dict().items()}

        # the main path: KD_STEPS updates of accumulation 8 through train()
        micro = KD_STEPS * cfg.gradient_accumulation_steps
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        require(tr.step == KD_STEPS, f"the trainer took {tr.step} steps, not {KD_STEPS}")
        require(not any(counts.values()), f"the KD step launched kernels: {counts}")
        with open(tr.metrics_path) as f:
            records = [json.loads(line) for line in f]
        for rec in records:
            log(f"[kd] step {rec['step']}: " + ", ".join(
                f"{n} {v:.6f}" for n, v in rec.items() if n not in ("step", "time")))
        require(len(records) == KD_STEPS and all(
            math.isfinite(v) for rec in records for n, v in rec.items() if n != "time"),
            "a KD loss term is not finite")
        ntok = cfg.batch_size * cfg.max_seq_len
        log(f"[kd] main path: {KD_STEPS} steps, {micro} micro-steps in {wall:.1f} ms: "
            f"{wall / micro:.2f} ms per micro-step with the updates "
            f"({ntok * micro / wall * 1e3:.0f} tokens/s), peak memory {peak:.2f} GiB; "
            f"kernel launches {counts}")

        after, after_terms = fixed_loss()
        moved = sum(not torch.equal(x, student0[n]) for n, x in tr.student.state_dict().items())
        same = all(torch.equal(x, teacher0[n]) for n, x in tr.teacher.state_dict().items())
        log(f"[kd] fixed batch (the stream's first): KD loss {before:.6f} -> {after:.6f}; "
            f"terms before {before_terms}, after {after_terms}; {moved} of {len(student0)} "
            f"student tensors moved; teacher unchanged bit for bit: {same}")
        require(all(math.isfinite(v) for v in (*before_terms.values(), *after_terms.values())),
                "a fixed-batch KD term is not finite")
        require(moved > 0 and same, "the student did not move or the teacher changed")
        require(after < before, f"the fixed batch's KD loss did not fall: {before} -> {after}")

        # steady micro-steps on the fixed batch, beside the dense teacher's CE step
        def micro_step():
            tr.micro_step(*fixed)
            tr.student.zero_grad(set_to_none=True)

        torch.cuda.reset_peak_memory_stats()
        kd_ms = host_ms(micro_step, KD_ITERS)
        kd_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        dense = OptForCausalLM(tr.t_cfg, device=dev, seed=0)
        dense_opt = make_optimizer(dense, TRAIN_LR)
        ids, am = fixed_t[0], fixed_t[1]
        torch.cuda.reset_peak_memory_stats()
        dense_ms = host_ms(lambda: train_step(dense, dense_opt, ids, am), KD_ITERS)
        dense_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del dense, dense_opt
        log(f"[kd] micro-step 1x{cfg.max_seq_len}: {kd_ms:.2f} ms ({ntok / kd_ms * 1e3:.0f} "
            f"tokens/s), peak {kd_peak:.2f} GiB; the dense teacher's own CE train step on the "
            f"same batch {dense_ms:.2f} ms ({ntok / dense_ms * 1e3:.0f} tokens/s), peak "
            f"{dense_peak:.2f} GiB")
        breakdown(f"KD micro-step (1, {cfg.max_seq_len})", micro_step)

        t0 = time.perf_counter()
        ppl = tr.evaluate(max_batches=KD_EVAL_WINDOWS)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3 / KD_EVAL_WINDOWS
        log(f"[kd] evaluate(max_batches={KD_EVAL_WINDOWS}): student PPL {ppl:.4f} "
            f"(random weights, synthetic corpus), {eval_ms:.2f} ms per window")
        require(math.isfinite(ppl), f"PPL {ppl}")

        # one micro-step at OPT's context, 1 x KD_LONG_T
        ids = torch.randint(4, tr.s_cfg.vocab_size, (1, KD_LONG_T),
                            generator=torch.Generator().manual_seed(18))
        long = (ids, torch.ones_like(ids), ids)
        tr.micro_step(*long)  # warm-up
        tr.student.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        details = tr.micro_step(*long)
        torch.cuda.synchronize()
        long_ms = (time.perf_counter() - t0) * 1e3
        long_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        terms = {n: float(x) for n, x in details.items()}
        log(f"[kd] micro-step 1x{KD_LONG_T}: {long_ms:.2f} ms ({KD_LONG_T / long_ms * 1e3:.0f} "
            f"tokens/s), peak {long_peak:.2f} GiB; terms {terms}")
        require(all(math.isfinite(v) for v in terms.values()),
                f"a KD term at 1x{KD_LONG_T} is not finite: {terms}")
        del tr
    torch.cuda.empty_cache()
    return dict(micro_ms=kd_ms, peak=peak, ppl=ppl, long_ms=long_ms, long_peak=long_peak)


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
    # the same inputs rounded to bfloat16
    mb = measure(*(x.bfloat16() for x in (q, k, v)), mask, sc, k_cfg=float(K))
    log(f"[result] main-path T=2048 layer 0, bfloat16: K1 {mb['ms']:.4f} ms (with prep "
        f"{mb['wrapper_ms']:.4f}), sdpa {mb['library_ms']:.4f} ms, bound {mb['bound_ms']:.4f} "
        f"ms by {mb['bound_by']}")
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

    phase_train_kernels()
    train_launches, train_errs, train_m = phase_train()
    for kid, (_, name, source, replaces, _) in TRAIN_KERNELS.items():
        t = train_m[kid]
        require(train_launches[kid] > 0, f"the training path never launched {kid}")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": train_launches[kid],
            "max_abs_err": train_errs[kid],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })

    phase_bidir_mask()
    bidir_err = phase_bidir_kernel()
    bidir_launches, bert_err, captured = phase_bert()
    require(bidir_launches > 0, "the BERT path never launched K5")
    # K5's numbers at the main path's own inputs (layer 0 of the 32 x 256 request)
    m = measure_bidir(*captured)
    log(f"[result] BERT main path {tuple(captured[0].shape)} layer 0: K5 {m['ms']:.4f} ms, "
        f"plain {m['plain_ms']:.3f} ms, sdpa {m['library_ms']:.4f} ms, bound "
        f"{m['bound_ms']:.4f} ms by {m['bound_by']}; max|err| of the bidir-kernel phase "
        f"{bidir_err:.3g}")
    kernels.append({
        "name": "sea_bidir_forward",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": BIDIR_REPLACES,
        "launches": bidir_launches,
        "max_abs_err": bert_err,
        "ms": m["ms"],
        "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"],
        "library_ms": m["library_ms"],
    })

    ring_errs, _ = phase_ring_kernels()
    serve_launches = phase_ring_serve()
    train_launches, train_errs, ring_m = phase_ring_train()
    phase_seq_head()
    # K6-K8 at the ring main path's own layer-0 inputs (the 1 x 16384 train
    # step), each number a launch's share of the 16 of a layer
    launches = {"K6": serve_launches + train_launches["K6"],
                "K7": train_launches["K7"], "K8": train_launches["K8"]}
    for kid, (_, name, source, replaces, _) in RING_KERNELS.items():
        t = ring_m[kid]
        require(launches[kid] > 0, f"the ring's main path never launched {kid}")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[kid],
            "max_abs_err": max(ring_errs[kid], train_errs[kid]),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })

    phase_impl_mask()
    impl_launches, impl_errs, impl_m = phase_impl_kernels()
    # K9a's main path is the sweep
    impl_launches["K9a"], sweep_err = phase_sweep()
    impl_errs["K9a"] = max(impl_errs["K9a"], sweep_err)
    cos_err = phase_cosformer_slice()
    log(f"[result] cosformer slice layer-0 K1 max|err| {cos_err:.3g}")
    for dtype, m in impl_m.items():
        log(f"[result] bench.py 1x{H}x{BENCH_T} {str(dtype)[6:]}: " + "; ".join(
            f"{kid} {t['ms']:.4f} ms (with prep {t['wrapper_ms']:.4f}), sdpa "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by {t['bound_by']}"
            for kid, t in m.items()))
    # K9a-c at bench.py's canonical shapes, float32, each impl's default blocks
    for kid, (impl, replaces) in IMPL_VARIANTS.items():
        t = impl_m[torch.float32][kid]
        require(impl_launches[kid] > 0, f"the main path never launched {kid}")
        kernels.append({
            "name": bs.IMPL_KERNELS[impl].entry,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": replaces,
            "launches": impl_launches[kid],
            "max_abs_err": impl_errs[kid],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    dense_errs = phase_dense_vs_fused()
    log(f"[result] dense vs fused at 1x{DENSE_T}: K1 context {dense_errs['context']:.3g}, "
        f"K2-K4 loss rel {dense_errs['loss_rel']:.3g}, gradient {dense_errs['grad']:.3g}")
    kd = phase_kd()
    log(f"[result] KD at 1x512: {kd['micro_ms']:.2f} ms per micro-step, peak "
        f"{kd['peak']:.2f} GiB, PPL {kd['ppl']:.4f}; 1x{KD_LONG_T}: {kd['long_ms']:.2f} ms, "
        f"peak {kd['long_peak']:.2f} GiB")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
