"""sea_tpu_torch — the PyTorch / CUDA port of sea_tpu for NVIDIA Hopper.

A package of its own beside `sea_tpu` (the JAX reference, which it never
imports). Plain tensor code is PyTorch; each Pallas kernel of the reference
becomes a hand-written Hopper kernel under `csrc/`, built with nvcc at first
use. Entry points take a `device` and default to "cuda"; on CPU tensors the
kernel wrappers run their plain PyTorch versions.

Ported so far: the OPT-125m SEA forward to logits on the fused benchmark
path (`models.opt.OptForCausalLM`, `benchmarking=True`) and its task-only
training (`training.longctx`), both also sequence-, head- or ring-sharded
inside `parallel.sharded_attention_scope`, and the BERT-base SEA forward
(`models.bert`), on the fused sparse attention kernels
(`ops.kernels.block_sparse`); the cosformer estimator backend
(`ops.cosformer`); the attention-operator sweep (`benchmarks`, dense,
performer, cosformer and the fused kernel's 'flat_wr' variant); and the
dense train path of the SEA attention with, on it, the OPT-125m
knowledge-distillation trainer (`training.opt_trainer`, `training.distill`);
and decode: the SEA decode cache (`models.state`), OPT's parallel prefill
(kernel K1) and greedy, sampled (`ops.sampling`) and beam generation, and
the continuous-batching serving engine over a paged K/V pool (`serving`);
and the baseline attention methods (`ops.baselines`, OPT's and LLaMA's
students, BERT's methods), BERT's SEA train path with ToMe (`ops.tome`) and
its other heads, and BERT's distillation through the GLUE and LRA trainers
(`training.glue_trainer`, `training.lra_trainer`, `data.glue`, `data.lra`).
"""

from .config import SeaConfig, opt_config

__all__ = ["SeaConfig", "opt_config"]
