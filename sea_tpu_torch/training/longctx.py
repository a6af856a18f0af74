"""Long-context task-only train step through the differentiable fused kernel.

Port of `scripts/longctx_train_step.py`: an OPT-125m-geometry SEA student
with `use_fused_train`, next-token cross entropy only (no KD truths), so
every layer's attention runs the forward-with-stats, dq and dk/dv kernels
and the dense O(T²) train path never materialises. `train_step` and
`train_steps` take any causal LM of the port whose SEA config sets
`use_fused_train`: OPT (`OptForCausalLM`) or LLaMA (`LlamaForCausalLM`,
whose roped, pre-scaled q and k and (N, 1, T, T) causal mask reach the
same `SeaAttention` dispatch, K2-K4 at its heads of 128 on the card). The
script itself, and so `main`, is OPT-only.

    python -m sea_tpu_torch.training.longctx --t 2048 --steps 3
    python -m sea_tpu_torch.training.longctx --t 32768 --logit-chunk 2048 --steps 2
    python -m sea_tpu_torch.training.longctx --t 256 --layers 2 --steps 2 --device cpu

The optimizer is `torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8,
weight_decay)`, the update rule of `optax.adamw`; the loss is
`loss + 0.0 * aux_loss`, as the script writes it. The model takes the
script's `compute_dtype="bfloat16"` (`longctx_model`'s default; "float32"
also): with its float32 parameters, flax's type rule rounds only the
embedding and each layer's output to bfloat16, and the projections, the
attention and the kernels run float32 (`models/opt.py`). The model is the
script's, `scan_layers=True, scan_remat=True`: each layer runs under a
checkpoint in the step, so the backward keeps one layer's activations and
recomputes the layer's forward (K2 twice a layer a step, K3 and K4 once).
`--logit-chunk` computes the cross entropy per chunk of the sequence
(`train_step(..., logit_chunk=)`, `models.opt.chunked_cross_entropy_shifted`:
at 1 x 32768 the float32 logits alone would take 6.6 GB) and
`--cnn-chunk` runs the predictor's CNN over chunks of rows
(`SeaConfig.cnn_row_chunk`). On the CPU every kernel takes its plain
version.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, List, Optional

import torch

from ..config import opt_config
from ..models.llama import CausalLM
from ..models.opt import OptForCausalLM, opt_125m


def make_optimizer(model: torch.nn.Module, lr: float = 1e-5,
                   weight_decay: float = 1e-2) -> torch.optim.AdamW:
    """AdamW over every parameter, with optax.adamw's defaults."""
    return torch.optim.AdamW(
        model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay,
    )


def train_step(model: CausalLM, optimizer: torch.optim.Optimizer,
               ids: torch.Tensor, mask: torch.Tensor,
               logit_chunk: Optional[int] = None) -> torch.Tensor:
    """One step on one batch; returns the loss before the update (detached).
    `logit_chunk` takes the chunked cross entropy.

    A parameter that the loss does not reach (the estimator's `dec_row` and
    CNN sit behind the top-k selection) gets a zero gradient rather than
    none, so that AdamW's decoupled weight decay still applies to it, as
    `optax.adamw` applies it to every leaf."""
    out = model(ids, mask, labels=ids, training=True, logit_chunk=logit_chunk)
    loss = out["loss"] + 0.0 * out["aux_loss"]
    optimizer.zero_grad(set_to_none=False)
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    optimizer.step()
    return loss.detach()


def train_steps(
    model: CausalLM,
    ids: torch.Tensor,
    mask: torch.Tensor,
    steps: int,
    lr: float = 1e-5,
    weight_decay: float = 1e-2,
    *,
    callback: Optional[Callable[[int, float], None]] = None,
    logit_chunk: Optional[int] = None,
) -> List[float]:
    """`steps` AdamW steps on one batch (ids are their own labels); returns
    each step's loss. `callback(step, loss)` runs after each step, once the
    loss has been read back (so the step's device work has finished)."""
    optimizer = make_optimizer(model, lr, weight_decay)
    losses = []
    for i in range(steps):
        loss = float(train_step(model, optimizer, ids, mask, logit_chunk))
        losses.append(loss)
        if callback is not None:
            callback(i, loss)
    return losses


def longctx_model(t: int, layers: int, device="cuda", compute_dtype: str = "bfloat16",
                  remat: bool = False, cnn_chunk: int = 0) -> OptForCausalLM:
    """OPT-125m widths with `use_fused_train`, `layers` deep, positions up
    to `t`, in `compute_dtype` (the script's bfloat16 by default), float32
    random weights from seed 0; `remat` takes the script's `scan_layers`
    and `scan_remat`, `cnn_chunk` its `cnn_row_chunk`."""
    sea = opt_config(use_fused_train=True, max_position_embeddings=t, cnn_row_chunk=cnn_chunk)
    cfg = dataclasses.replace(
        opt_125m("perlin", sea=sea), num_layers=layers, max_position_embeddings=t,
        compute_dtype=compute_dtype, scan_layers=remat, scan_remat=remat,
    )
    return OptForCausalLM(cfg, device=device, seed=0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--t", type=int, default=8192)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--logit-chunk", type=int, default=0,
                   help="the cross entropy per chunk of this many positions (at 1 x 32768 "
                        "the float32 logits alone take 6.6 GB)")
    p.add_argument("--cnn-chunk", type=int, default=0,
                   help="the predictor's CNN over chunks of this many rows (exact)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; pass --device cpu for the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        name = torch.cuda.get_device_name(device)
    else:
        name = "cpu"
    t0 = time.perf_counter()
    model = longctx_model(args.t, args.layers, device, remat=True, cnn_chunk=args.cnn_chunk)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(4, model.cfg.vocab_size, (1, args.t), generator=g).to(device)
    mask = torch.ones_like(ids)
    print(f"init on {name}: {time.perf_counter() - t0:.1f} s", flush=True)

    times = []
    last = [time.perf_counter()]

    def report(i, loss):
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = now
        print(f"step{i + 1}: {times[-1]:.3f} s loss={loss:.4f}", flush=True)

    losses = train_steps(model, ids, mask, args.steps, callback=report,
                         logit_chunk=args.logit_chunk or None)
    steady = sorted(times[1:])[len(times[1:]) // 2] if len(times) > 1 else None
    print(json.dumps({
        "t": args.t, "layers": args.layers, "device": name,
        "steady_step_s": steady, "losses": losses,
    }), flush=True)


if __name__ == "__main__":
    main()
