"""The long-context sweep (PyTorch port of `scripts/exp_long_context.py`):
the (context × dynamic_k × query_skips) grid of the reference's
`exp_long_context`, in one process.

The student's weights (seeded random, or a `--checkpoint` written by
`OptTrainer.save`) are stretched once per context (`models.long_context.
extend_opt_context`), and each combination's model is rebuilt with that
context, `dynamic_k` and `query_skips`, then scores `n_eval_batches`
windows of the test split (windows of the context, stride the context) to
a perplexity. The corpus is the local cache or the synthetic stream
(`data.wikitext2.get_corpus`): nothing is downloaded.

The forward is the benchmark path (`benchmarking=True`: kernel K1 on the
card) unless `benchmarking=False`, which runs the dense train path as
JAX's sweep does (its model's default); JAX holds the two within 2e-4
(tests/test_fused_path.py). Each record also gives the host time per
window, around work ending in a synchronise.

    python -m sea_tpu_torch.training.exp_long_context --model opt-125m \\
        --contexts 4096,8192 --dynamic-ks 0,32 --query-skips 1,2 --eval-batches 2
    python -m sea_tpu_torch.training.exp_long_context --model tiny --contexts 64,128 \\
        --device cpu

Prints one JSON line per combination: {context, dynamic_k, query_skips,
ppl, ms_per_window}.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..data.wikitext2 import get_corpus
from ..models.long_context import extend_opt_context, extended_opt_config, opt_from_state_dict
from ..models.opt import OptConfig
from .opt_trainer import OptTrainer, TrainerConfig, build_model, model_configs


def load_student_state(checkpoint: str, device) -> dict:
    """The student's state dict from an `OptTrainer.save` file (or a bare
    state dict saved with `torch.save`)."""
    state = torch.load(checkpoint, map_location=device, weights_only=True)
    return state.get("student", state)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sweep(
    model: str = "tiny",
    contexts: Sequence[int] = (64, 128),
    dynamic_ks: Sequence[int] = (0,),
    query_skips: Sequence[int] = (1, 2),
    checkpoint: str = "",
    n_eval_batches: int = 8,
    device="cuda",
    benchmarking: bool = True,
    data_cache_dir: Optional[str] = None,
) -> List[dict]:
    """The sweep's records (see the module doc); each is printed as it comes."""
    device = torch.device(device)
    _, s_cfg = model_configs(TrainerConfig(model=model))
    if not isinstance(s_cfg, OptConfig):
        raise ValueError(f"the long-context extension is OPT's; model {model!r} is not")
    base = build_model(s_cfg, 0, device)
    if checkpoint:
        base.load_state_dict(load_student_state(checkpoint, device))
    base_state = base.state_dict()
    del base
    results = []
    for ctx in contexts:
        state = extend_opt_context(base_state, ctx)
        corpus = get_corpus(ctx, ctx, "test", vocab_size=s_cfg.vocab_size,
                            cache_dir=data_cache_dir)
        for dk in dynamic_ks:
            for qs in query_skips:
                cfg = extended_opt_config(s_cfg, ctx, dynamic_k=dk, query_skips=qs)
                m = opt_from_state_dict(cfg, state, device)
                tot, toks, ms = 0.0, 0, []
                with torch.no_grad():
                    for i, (ids, mask, labels) in enumerate(corpus.batches(1)):
                        if i >= n_eval_batches:
                            break
                        ids, mask, labels = (torch.as_tensor(a).to(device, torch.long)
                                             for a in (ids, mask, labels))
                        _sync(device)
                        t0 = time.perf_counter()
                        logits = m(ids, mask, benchmarking=benchmarking)["logits"]
                        nll, tk = OptTrainer._eval_nll(logits, labels)
                        tot += float(nll)
                        toks += int(tk)
                        ms.append((time.perf_counter() - t0) * 1e3)
                del m
                rec = {"context": ctx, "dynamic_k": dk, "query_skips": qs,
                       "ppl": round(float(np.exp(tot / max(toks, 1))), 4),
                       "ms_per_window": float(np.mean(ms)) if ms else None}
                results.append(rec)
                print(json.dumps(rec), flush=True)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="tiny")
    p.add_argument("--contexts", default="128,256")
    p.add_argument("--dynamic-ks", default="0")
    p.add_argument("--query-skips", default="1,2")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--eval-batches", type=int, default=8)
    p.add_argument("--dense", action="store_true",
                   help="the dense train path (JAX's sweep) instead of the benchmark path")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; pass --device cpu for the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return sweep(
        model=args.model,
        contexts=[int(x) for x in args.contexts.split(",")],
        dynamic_ks=[int(x) for x in args.dynamic_ks.split(",")],
        query_skips=[int(x) for x in args.query_skips.split(",")],
        checkpoint=args.checkpoint,
        n_eval_batches=args.eval_batches,
        device=device,
        benchmarking=not args.dense,
    )


if __name__ == "__main__":
    main()
