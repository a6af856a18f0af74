"""OPT and LLaMA wikitext-2 KD trainer (port of
`sea_tpu/training/opt_trainer.py`).

A dense teacher (optionally CE-pretrained for `pretrain_teacher_steps`
first) distils into a SEA student bootstrapped from its weights: every
micro-step runs `SeaOptKD.kd_loss` (teacher and student interleaved, each
layer pair checkpointed under `use_remat`) and its backward; every
`gradient_accumulation_steps` micro-steps the mean of their gradients takes
one clipped 4-group AdamW update (`training.optimizer`), as
`optax.MultiSteps` does, and the step count advances. Every
`projection_redraw_steps` updates the student's FAVOR+ projections are
redrawn. Evaluation is the strided-window perplexity of the student (the
dense train path, no jitter); metrics go to `{save_dir}/metrics.jsonl` as
JSON lines; `save`/`load` keep the student, the optimizer, the step, the
jitter generator and the layout (`{"scan_kd": 0 | 1}`) in one `torch.save`
file, and `load` raises `CheckpointLayoutError` when the saved layout is
not the trainer's. With `checkpoint_rotation` = n > 0, `save()` keeps the n
newest step-tagged checkpoints (`ckpt_{step:08d}/state.pt`) behind an
atomically flipped `LATEST` pointer, `load("latest")` follows it, and
`training.resilience` resumes from the newest intact one and supervises
`train()` (`Supervisor`: roll back, skip the failed window through
`data_offset`, retry). At each log boundary the trainer writes
`{save_dir}/heartbeat.json` (the step, the time and the logged terms,
through `os.replace`) and raises `TrainingDiverged` on a non-finite term.

`scan_kd` is the JAX trainer's scanned pair (`distill.SeaOptKDScan`): no
jitter is drawn, every pair is checkpointed, and `logit_chunk` (read only
under `scan_kd`, as in JAX) computes the logit losses per chunk of the
sequence. The student is built with `scan_layers`, so that `evaluate`
reads it through the scanned forward, as JAX's `_eval_step_scan_impl`
does (the same layers and state dict: training calls them one by one);
`pretrain_teacher` after construction is refused, as JAX refuses it once
the teacher's layers are stacked; and the projections are not redrawn,
since JAX's scanned step never reads the redrawn ones (ROADMAP §3).

    python -m sea_tpu_torch.training.opt_trainer --model tiny --steps 4 --device cpu
    python -m sea_tpu_torch.training.opt_trainer --model llama-tiny --steps 4 --device cpu
    python -m sea_tpu_torch.training.opt_trainer --model opt-125m --seq-len 512 --steps 2

Models 'tiny', 'opt-125m', 'opt-350m', 'opt-1.3b', 'opt-2.7b', 'llama-tiny',
'llama-7b' and 'llama-13b' (the JAX builders and the JAX trainer's heads and
widths; 1.3b, 2.7b and the LLaMA models compute in bfloat16 by default,
2.7b's heads are 80 wide and LLaMA's 128). The student and teacher are one
family (`distill.causal_lm_for`); a LLaMA teacher checkpoint is read by
`load_llama_params` from a local HF directory. Every model's seeded random
weights are drawn on the trainer's device (a CPU generator on the CPU, so
the CPU's weights do not depend on the card; a CUDA one on the card, where
two 7B models initialised on the host would take minutes and tens of GB of
host memory). LLaMA-13b's bf16 weights, gradients and moments (about 104
GB) need more than one card. The types are the JAX trainer's:
`compute_dtype` overrides the models' own, `param_dtype` casts every
floating parameter and buffer of both models (the teacher's checkpoint
too), and `moment_dtype` is AdamW's first-moment type (optax's `mu_dtype`);
see `models/opt.py` for what each type rounds.

The entry point runs on "cuda" unless `--device` says otherwise, with TF32
off and bfloat16 products reduced in float32. Refused with
NotImplementedError, naming its ROADMAP item: `data_parallel`. The
students are JAX's: 'perlin' and the causal
baselines 'performer', 'reformer', 'sinkhorn' and 'cosformer'
(`models/opt.py`); a reformer student's LSH rotations are drawn each
micro-step from the trainer's generator, as JAX draws them from each
layer's rng. `load(only_additionals=True)` restores the SEA modules alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import SeaConfig, opt_config
from ..data.wikitext2 import get_corpus
from ..models.attention import init_random_
from ..models.llama import CausalLM, LlamaConfig, llama_13b, llama_7b, llama_tiny
from ..models.loader import load_llama_params, load_opt_params, student_from_teacher
from ..models.opt import (COMPUTE_DTYPES, OptConfig, opt_125m, opt_350m, opt_1_3b, opt_2_7b,
                          reformer_draws)
from ..ops.masks import resize_jitter_draws
from ..ops.performer import redraw_projections
from .distill import SeaOptKD, SeaOptKDScan, causal_lm_for
from .optimizer import GroupedAdamW
from .resilience import TrainingDiverged, checkpoint_file, resolve_latest, save_rotating

# the JAX trainer's options still to port, and the ROADMAP item of each
UNPORTED = {"data_parallel": "ROADMAP queue 1 item 8, multi-GPU"}


@dataclasses.dataclass
class TrainerConfig:
    # 'tiny' | 'opt-125m' | 'opt-350m' | 'opt-1.3b' | 'opt-2.7b' |
    # 'llama-tiny' | 'llama-7b' | 'llama-13b'
    model: str = "opt-125m"
    # student attention method
    method: str = "perlin"
    # local dir with the teacher's HF weights (OPT or LLaMA, as `model`)
    teacher_checkpoint: Optional[str] = None
    k: int = 64
    predictor_length: int = 256
    nb_factor: int = 8
    lr: float = 1e-5
    wd: float = 1e-2
    lr_high_scale: float = 10.0
    lr_low_scale: float = 0.2
    max_seq_len: int = 512
    stride: int = 256
    batch_size: int = 1
    gradient_accumulation_steps: int = 8
    num_steps: int = 10_000
    eval_steps: int = 2_000
    log_steps: int = 20
    seed: int = 42
    save_dir: str = "./saves/opt_trainer"
    use_remat: bool = True
    # FAVOR+ projection redraw interval in optimizer steps
    projection_redraw_steps: int = 1000
    # CE-pretrain the random teacher for this many steps before distilling
    # (a stand-in for a finetuned pretrained teacher)
    pretrain_teacher_steps: int = 0
    # student CE weight
    task_loss_scale: float = 0.1
    # train on the task loss alone
    ignore_kd_loss: bool = False
    # raise TrainingDiverged on a non-finite loss at a log boundary or
    # before an evaluation
    halt_on_divergence: bool = True
    # directory of `wikitext2_{split}.npy` token files (None: saves/data)
    data_cache_dir: Optional[str] = None
    # None keeps each model's own ('bfloat16' for opt-1.3b, 'float32' below)
    compute_dtype: Optional[str] = None
    # every floating parameter's type (None: float32)
    param_dtype: Optional[str] = None
    # AdamW's first-moment type (None: the parameters')
    moment_dtype: Optional[str] = None
    # the teacher/student pair as JAX's scanned body (see the module doc)
    scan_kd: bool = False
    # the logit losses per chunk of this many positions (scan_kd only)
    logit_chunk: Optional[int] = None
    # keep this many step-tagged checkpoints behind a LATEST pointer (0: one
    # 'checkpoint' file, overwritten)
    checkpoint_rotation: int = 0
    # SEA fields of the student's config replaced (the trainer CLI's
    # --enable-lora, --attention-predictor-method, --enc-per-layer, ...);
    # None or {} keeps the JAX trainer's student
    sea_overrides: Optional[Dict[str, Any]] = None
    # the JAX trainer's options that the port refuses (see the module doc)
    data_parallel: bool = False


class CheckpointLayoutError(ValueError):
    """A checkpoint saved under another `scan_kd` than the trainer's. The
    checkpoint is intact: the trainer's layout differs."""


# the builders the port has, and each one's heads and head width (the JAX
# trainer's mapping)
MODELS = {"opt-125m": (opt_125m, 12, 64), "opt-350m": (opt_350m, 16, 64),
          "opt-1.3b": (opt_1_3b, 32, 64), "opt-2.7b": (opt_2_7b, 32, 80),
          "llama-7b": (llama_7b, 32, 128), "llama-13b": (llama_13b, 40, 128)}


def _refuse_unported(cfg: TrainerConfig):
    for name, item in UNPORTED.items():
        if getattr(cfg, name) != getattr(TrainerConfig, name):
            raise NotImplementedError(f"TrainerConfig.{name} is not ported yet ({item})")
    if cfg.model not in ("tiny", "llama-tiny", *MODELS):
        raise ValueError(f"model {cfg.model!r}: one of {['tiny', 'llama-tiny', *MODELS]}")
    for name in ("compute_dtype", "param_dtype", "moment_dtype"):
        if getattr(cfg, name) not in (None, *COMPUTE_DTYPES):
            raise ValueError(f"TrainerConfig.{name}: one of {sorted(COMPUTE_DTYPES)} or None")


def tiny_configs(method: str = "perlin") -> Tuple[OptConfig, OptConfig]:
    """(teacher, student) of the JAX trainer's tiny model."""
    sea = SeaConfig(
        num_heads=2, head_dim=8, predictor_length=8, k=2,
        performer_nb_factor=1, causal=True, max_position_embeddings=128,
    ).validate()
    kw = dict(
        vocab_size=256, hidden_size=16, num_layers=2, num_heads=2,
        ffn_dim=32, max_position_embeddings=128, sea=sea,
    )
    return OptConfig(attention_method="none", **kw), OptConfig(attention_method=method, **kw)


def model_configs(cfg: TrainerConfig):
    """(teacher, student) configurations, OPT's or LLaMA's, `compute_dtype`
    applied."""
    _refuse_unported(cfg)
    if cfg.model == "tiny":
        pair = tiny_configs(cfg.method)
    elif cfg.model == "llama-tiny":
        pair = llama_tiny("none"), llama_tiny(cfg.method)
    else:
        builder, heads, head_dim = MODELS[cfg.model]
        sea = opt_config(
            num_heads=heads, head_dim=head_dim, k=cfg.k, predictor_length=cfg.predictor_length,
            performer_nb_factor=cfg.nb_factor,
        )
        pair = builder("none", sea), builder(cfg.method, sea)
    if cfg.sea_overrides:
        t_cfg, s_cfg = pair
        sea = dataclasses.replace(s_cfg.sea, **cfg.sea_overrides).validate()
        pair = t_cfg, dataclasses.replace(s_cfg, sea=sea)
    if cfg.compute_dtype is None:
        return pair
    return tuple(dataclasses.replace(c, compute_dtype=cfg.compute_dtype) for c in pair)


def build_model(cfg, seed: int, device, dtype: Optional[str] = None) -> CausalLM:
    """`cfg`'s causal LM on `device` with seeded random weights drawn there
    (`init_random_` from a generator of `seed` on `device`: on the CPU the
    weights of `OptForCausalLM(cfg, seed=seed)`), then cast to `dtype`
    (every floating leaf, as the JAX trainer casts its trees)."""
    device = torch.device(device)
    with device:
        model = causal_lm_for(cfg, device=device, seed=None)
    init_random_(model, torch.Generator(device=device).manual_seed(seed))
    if dtype is not None:
        model.to(getattr(torch, dtype))
    return model


class OptTrainer:
    """Teacher, student, optimizer and corpora for `cfg`, on `device`.
    Weights are random from seeds (teacher 0, student 1), drawn on `device`,
    unless `cfg.teacher_checkpoint` names a local HF OPT or LLaMA directory,
    in `cfg.param_dtype`; the jitter's draws and the projection redraws come
    from a generator seeded with `cfg.seed` on `device`."""

    def __init__(self, cfg: TrainerConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.t_cfg, self.s_cfg = model_configs(cfg)
        # one model at a time in float32 before its cast (a 7B model's
        # float32 weights alone take 27 GB)
        self.teacher = build_model(self.t_cfg, 0, self.device, cfg.param_dtype)
        # under scan_kd the student evaluates through the scanned forward
        s_model_cfg = (dataclasses.replace(self.s_cfg, scan_layers=True) if cfg.scan_kd
                       else self.s_cfg)
        self.student = build_model(s_model_cfg, 1, self.device, cfg.param_dtype)
        if cfg.teacher_checkpoint:
            # the checkpoint loads into the cast model in its type
            load = load_llama_params if isinstance(self.t_cfg, LlamaConfig) else load_opt_params
            self.teacher.load_state_dict(load(cfg.teacher_checkpoint, self.t_cfg), strict=True)
        self.teacher.requires_grad_(False)
        self.corpus = get_corpus(cfg.max_seq_len, cfg.stride, "train",
                                 vocab_size=self.s_cfg.vocab_size, cache_dir=cfg.data_cache_dir)
        self.eval_corpus = get_corpus(cfg.max_seq_len, cfg.stride, "test",
                                      vocab_size=self.s_cfg.vocab_size,
                                      cache_dir=cfg.data_cache_dir)
        os.makedirs(cfg.save_dir, exist_ok=True)
        self.metrics_path = os.path.join(cfg.save_dir, "metrics.jsonl")
        self.step = 0
        # micro-batches a resumed stream skips past what it has consumed
        # (the Supervisor's rollback moves it past a failed window)
        self.data_offset = 0
        if cfg.pretrain_teacher_steps > 0:
            self.pretrain_teacher(cfg.pretrain_teacher_steps)
        student_from_teacher(self.student, self.teacher)
        self.kd = (SeaOptKDScan(self.teacher, self.student, cfg.logit_chunk) if cfg.scan_kd
                   else SeaOptKD(self.teacher, self.student))
        self.reset_optimizer()

    def reset_optimizer(self):
        """A fresh optimizer, step 0 and the generator reseeded (the
        Supervisor's restart when no checkpoint exists yet; the weights stay
        as they are, as in JAX)."""
        cfg = self.cfg
        self.optimizer = GroupedAdamW(
            self.student, lr=cfg.lr, wd=cfg.wd,
            lr_high_scale=cfg.lr_high_scale, lr_low_scale=cfg.lr_low_scale,
            mu_dtype=cfg.moment_dtype,
        )
        self.optimizer.zero_grad()
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def _tensors(self, *arrays):
        return [torch.as_tensor(a).to(self.device, torch.long) for a in arrays]

    def pretrain_teacher(self, steps: int):
        """CE-train the dense teacher on the corpus (AdamW 3e-4, weight
        decay 1e-2), a stand-in for a pretrained finetuned teacher. Under
        `scan_kd` only the constructor may (`pretrain_teacher_steps`), as
        in JAX, which stacks the teacher's layers into the pair's tree."""
        if self.cfg.scan_kd and hasattr(self, "kd"):
            raise RuntimeError(
                "pretrain_teacher is unavailable after scan_kd layer stacking: set "
                "TrainerConfig.pretrain_teacher_steps so that the constructor pretrains "
                "before stacking")
        self.teacher.requires_grad_(True)
        opt = torch.optim.AdamW(self.teacher.parameters(), lr=3e-4, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=1e-2)
        done = 0
        while done < steps:
            for ids, mask, labels in self.corpus.batches(
                self.cfg.batch_size, shuffle=True, seed=self.cfg.seed + 1000 + done
            ):
                ids, mask, labels = self._tensors(ids, mask, labels)
                loss = self.teacher(ids, mask, labels=labels)["loss"]
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                done += 1
                if done >= steps:
                    break
        self.teacher.requires_grad_(False)
        self.log({"teacher_pretrain_loss": float(loss), "teacher_steps": steps})

    def jitter_draws(self, n: int, t: int):
        """One layer's draws per student layer, for a batch of `n` x `t`
        tokens: a SEA student's resize jitter, a reformer student's LSH
        rotations (none for the other students or under `scan_kd`)."""
        method = self.s_cfg.attention_method
        if self.cfg.scan_kd or method not in ("perlin", "reformer"):
            return None
        if method == "reformer":
            head_dim = self.s_cfg.hidden_size // self.s_cfg.num_heads
            return [reformer_draws(head_dim, t, self.generator, self.device)
                    for _ in range(self.s_cfg.num_layers)]
        return [resize_jitter_draws((n, 1, t, t), self.generator)
                for _ in range(self.s_cfg.num_layers)]

    def micro_step(self, ids, mask, labels) -> Dict[str, torch.Tensor]:
        """One KD forward and backward on one batch; the gradients add up
        in the student's `.grad`. Returns the detached loss terms."""
        ids, mask, labels = self._tensors(ids, mask, labels)
        kw = dict(task_scale=self.cfg.task_loss_scale, ignore_kd=self.cfg.ignore_kd_loss)
        if not self.cfg.scan_kd:
            kw.update(jitter=self.jitter_draws(*ids.shape), use_remat=self.cfg.use_remat)
        loss, details = self.kd.kd_loss(ids, mask, labels, **kw)
        loss.backward()
        return {k: v.detach() for k, v in details.items()}

    def update(self):
        """One clipped update with the mean of the accumulated gradients;
        the step count advances and the projections are redrawn on
        schedule."""
        k = self.cfg.gradient_accumulation_steps
        if k > 1:
            for p in self.student.parameters():
                if p.grad is not None:
                    p.grad.div_(k)
        self.optimizer.step()
        self.optimizer.zero_grad()
        self.step += 1
        every = self.cfg.projection_redraw_steps
        if every > 0 and self.step % every == 0 and not self.cfg.scan_kd:
            redraw_projections(self.student, self.generator)

    def train(self):
        cfg = self.cfg
        k = cfg.gradient_accumulation_steps
        micro_steps = cfg.num_steps * k
        done = self.step * k
        consumed, epoch = 0, 0
        t0 = time.time()
        while done < micro_steps:
            for ids, mask, labels in self.corpus.batches(
                cfg.batch_size, shuffle=True, seed=cfg.seed + epoch
            ):
                if done >= micro_steps:
                    break
                consumed += 1
                if consumed <= done + self.data_offset:  # seen before a resume
                    continue
                details = self.micro_step(ids, mask, labels)
                done += 1
                if done % k:
                    continue
                self.update()
                if self.step % cfg.log_steps == 0:
                    rec = {name: float(v) for name, v in details.items()}
                    rec["steps_per_s"] = self.step / (time.time() - t0)
                    self.log(rec)
                    self._heartbeat(rec)
                    if cfg.halt_on_divergence and not all(map(math.isfinite, rec.values())):
                        raise TrainingDiverged(f"non-finite loss at step {self.step}: {rec}")
                if self.step % cfg.eval_steps == 0:
                    if cfg.halt_on_divergence and not math.isfinite(float(details["loss"])):
                        raise TrainingDiverged(
                            f"non-finite loss at step {self.step} (before the evaluation)")
                    self.log({"eval_ppl": self.evaluate(max_batches=16)})
                    self.save()
                if self.step >= cfg.num_steps:
                    return
            epoch += 1

    @staticmethod
    def _eval_nll(logits: torch.Tensor, labels: torch.Tensor):
        """Summed next-token NLL over the supervised targets, and their
        count."""
        logits = logits[:, :-1].float()
        tgt = labels[:, 1:]
        valid = tgt != -100
        safe = torch.where(valid, tgt, torch.zeros_like(tgt))
        logp = torch.log_softmax(logits, -1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        return torch.where(valid, nll, torch.zeros_like(nll)).sum(), valid.sum()

    @torch.no_grad()
    def evaluate(self, max_batches: Optional[int] = None) -> float:
        """The student's strided-window perplexity on the test split."""
        total_nll, total_tok = 0.0, 0
        for i, (ids, mask, labels) in enumerate(self.eval_corpus.batches(self.cfg.batch_size)):
            if max_batches is not None and i >= max_batches:
                break
            ids, mask, labels = self._tensors(ids, mask, labels)
            nll, tok = self._eval_nll(self.student(ids, mask)["logits"], labels)
            total_nll += float(nll)
            total_tok += int(tok)
        return float(np.exp(total_nll / max(total_tok, 1)))

    def log(self, record: Dict[str, Any]):
        record = {k: (float(v) if isinstance(v, (int, float, torch.Tensor)) else v)
                  for k, v in record.items()}
        record["step"] = self.step
        record["time"] = time.time()
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _heartbeat(self, extra: Optional[Dict[str, Any]] = None):
        """Publish liveness: `{save_dir}/heartbeat.json`, written whole
        through `os.replace` (`resilience.heartbeat_age_s` reads its age)."""
        hb = {"step": self.step, "time": time.time()}
        if extra:
            hb.update({k: float(v) for k, v in extra.items()})
        tmp = os.path.join(self.cfg.save_dir, ".heartbeat.tmp")
        with open(tmp, "w") as f:
            f.write(json.dumps(hb))
        os.replace(tmp, os.path.join(self.cfg.save_dir, "heartbeat.json"))

    def save(self, tag: str = "checkpoint"):
        """The full state under `tag` (`{save_dir}/{tag}.pt`), or, with
        `checkpoint_rotation` and the default tag, a rotating checkpoint."""
        if self.cfg.checkpoint_rotation > 0 and tag == "checkpoint":
            save_rotating(self, keep=self.cfg.checkpoint_rotation)
            return
        self.write_state(os.path.join(self.cfg.save_dir, tag + ".pt"))

    def write_state(self, path: str):
        """The full train state to `path`, whole or not at all (a temporary
        file, then `os.replace`)."""
        tmp = path + ".tmp"
        torch.save({
            "student": self.student.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "generator": self.generator.get_state(),
            "layout": {"scan_kd": int(self.cfg.scan_kd)},
        }, tmp)
        os.replace(tmp, path)

    def load(self, tag: str = "checkpoint", only_additionals: bool = False) -> bool:
        """Restore a checkpoint (`tag="latest"`: the rotating checkpoints'
        LATEST pointer); False when there is none. `only_additionals`
        restores only the SEA modules' parameters (every name with a part
        containing `perlin`, as JAX selects its leaves) and keeps the base
        weights, the projections, the optimizer state, the step and the
        generator (the reference's `--load-only-additionals`)."""
        if tag == "latest":
            tag = resolve_latest(self.cfg.save_dir)
            if tag is None:
                return False
        path = checkpoint_file(self.cfg.save_dir, tag)
        if not os.path.exists(path):
            return False
        state = torch.load(path, map_location=self.device, weights_only=True)
        saved = int(state.get("layout", {"scan_kd": 0})["scan_kd"])
        if saved != int(self.cfg.scan_kd):
            raise CheckpointLayoutError(
                f"checkpoint layout mismatch: saved scan_kd={bool(saved)}, trainer "
                f"scan_kd={self.cfg.scan_kd}")
        if only_additionals:
            with torch.no_grad():
                for n, p in self.student.named_parameters():
                    if any("perlin" in part for part in n.split(".")):
                        p.copy_(state["student"][n])
            return True
        self.student.load_state_dict(state["student"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.optimizer.zero_grad()  # nothing of an interrupted accumulation
        self.step = int(state["step"])
        self.generator.set_state(state["generator"].cpu())
        return True


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="tiny")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--k", type=int, default=64)
    p.add_argument("--predictor-length", type=int, default=256)
    p.add_argument("--teacher-checkpoint", default=None)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; pass --device cpu for the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = TrainerConfig(
        model=args.model,
        num_steps=args.steps,
        batch_size=args.batch_size,
        max_seq_len=args.seq_len,
        stride=args.seq_len // 2,
        k=args.k,
        predictor_length=args.predictor_length,
        teacher_checkpoint=args.teacher_checkpoint,
        eval_steps=max(args.steps // 2, 1),
        log_steps=1,
        gradient_accumulation_steps=2,
    )
    tr = OptTrainer(cfg, device=device)
    if args.eval:
        print("ppl:", tr.evaluate(max_batches=8))
        return
    tr.train()
    print("final ppl:", tr.evaluate(max_batches=8))


if __name__ == "__main__":
    main()
