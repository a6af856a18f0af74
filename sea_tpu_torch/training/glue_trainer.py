"""GLUE / BERT KD trainer (port of `sea_tpu/training/glue_trainer.py`).

The teacher is a dense BERT (`attention_method='none'`), random from seed
0 (no finetuned checkpoint is in the repository) and optionally
task-trained first for `pretrain_teacher_steps` with plain AdamW (every
parameter decayed, no clipping: optax's `adamw` over the whole tree); the
SEA student (seed 1) is bootstrapped from the teacher's weights. Every step
runs `distill.SeaBertKD.kd_loss` (0.1·task + 10·hidden MSE + 0.1·logit KL +
the attention-distill loss; the student on the dense train path) and one
clipped 4-group AdamW update (`training.optimizer`, the base groups at the
full `lr`). Every 20 steps the loss terms go to `{save_dir}/{subset}.jsonl`
as a JSON line, and at `eval_steps` and the end the task's primary GLUE
score (`glue_metrics`) on up to 16 validation batches of the student's
benchmark-free forward.

The data are `data.glue.get_glue`'s: a local tokenised cache, or the
synthetic fallback at min(max_length, 64) tokens.

    python -m sea_tpu_torch.training.glue_trainer --model bert-base --subset mrpc --steps 20
    python -m sea_tpu_torch.training.glue_trainer --model tiny --steps 4 --device cpu

Models 'tiny' (2 layers, hidden 16) and 'bert-base'. The entry point runs
on "cuda" unless `--device` says otherwise, with TF32 off.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import SeaConfig, bert_config
from ..data.glue import TASK_BATCH_SIZE, TASK_NUM_LABELS, get_glue
from ..models.attention import init_random_
from ..models.bert import BertConfig, BertForSequenceClassification, bert_base
from ..models.loader import student_from_teacher
from .distill import SeaBertKD
from .glue_metrics import glue_compute, primary_score
from .optimizer import GroupedAdamW


@dataclasses.dataclass
class GlueTrainerConfig:
    subset: str = "mrpc"
    model: str = "bert-base"  # 'tiny' | 'bert-base'
    k: int = 64
    predictor_length: int = 128
    lr: float = 1e-4
    wd: float = 1e-2
    num_steps: int = 2000
    eval_steps: int = 500
    max_length: int = 256
    batch_size: Optional[int] = None
    seed: int = 42
    save_dir: str = "./saves/glue_trainer"
    # task-train the fresh teacher for this many steps before distilling
    pretrain_teacher_steps: int = 0
    # directory of the tokenised `glue_{subset}_{split}.npz` (None: saves/data/glue)
    data_cache_dir: Optional[str] = None


def tiny_bert_configs(num_labels: int = 2):
    """(teacher, student) of the JAX trainer's tiny BERT."""
    sea = SeaConfig(
        num_heads=2, head_dim=8, predictor_length=8, k=2,
        performer_nb_factor=1, causal=False,
    ).validate()
    kw = dict(vocab_size=30522, hidden_size=16, num_layers=2, num_heads=2, ffn_dim=32,
              max_position_embeddings=128, num_labels=num_labels, sea=sea)
    return BertConfig(attention_method="none", **kw), BertConfig(attention_method="perlin", **kw)


def build_bert(cfg: BertConfig, seed: int, device) -> BertForSequenceClassification:
    """`cfg`'s classifier on `device`, its seeded random weights drawn there
    (a CPU generator on the CPU: `BertForSequenceClassification(cfg,
    seed=seed)`'s weights)."""
    device = torch.device(device)
    with device:
        model = BertForSequenceClassification(cfg, device=device, seed=None)
    init_random_(model, torch.Generator(device=device).manual_seed(seed))
    return model


class GlueTrainer:
    """Teacher, student, optimizer and data for `cfg`, on `device`."""

    def __init__(self, cfg: GlueTrainerConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.num_labels = TASK_NUM_LABELS[cfg.subset]
        if cfg.model == "tiny":
            t_cfg, s_cfg = tiny_bert_configs(self.num_labels)
        elif cfg.model == "bert-base":
            sea = bert_config(k=cfg.k, predictor_length=cfg.predictor_length)
            t_cfg = bert_base("none", sea, num_labels=self.num_labels)
            s_cfg = bert_base("perlin", sea, num_labels=self.num_labels)
        else:
            raise ValueError(f"model {cfg.model!r}: 'tiny' or 'bert-base'")
        self.batch_size = cfg.batch_size or TASK_BATCH_SIZE[cfg.subset]
        self.train_ds = get_glue(cfg.subset, "train", cfg.max_length,
                                 cache_dir=cfg.data_cache_dir)
        self.eval_ds = get_glue(cfg.subset, "validation", cfg.max_length,
                                cache_dir=cfg.data_cache_dir)
        self.teacher = build_bert(t_cfg, 0, self.device)
        self.student = build_bert(s_cfg, 1, self.device)
        student_from_teacher(self.student, self.teacher)
        if cfg.pretrain_teacher_steps > 0:
            self._pretrain_teacher(cfg.pretrain_teacher_steps)
            student_from_teacher(self.student, self.teacher)
        self.teacher.requires_grad_(False)
        self.kd = SeaBertKD(self.teacher, self.student)
        self.optimizer = GroupedAdamW(self.student, lr=cfg.lr, wd=cfg.wd, lr_low_scale=1.0)
        self.step = 0
        os.makedirs(cfg.save_dir, exist_ok=True)
        self.metrics_path = os.path.join(cfg.save_dir, f"{cfg.subset}.jsonl")

    def _tensors(self, ids, mask, tt, labels=None):
        out = [torch.as_tensor(x).to(self.device, torch.long) for x in (ids, mask, tt)]
        if labels is not None:
            dtype = torch.float32 if self.num_labels == 1 else torch.long
            out.append(torch.as_tensor(labels).to(self.device, dtype))
        return out

    def _pretrain_teacher(self, steps: int):
        """Task-train the dense teacher: AdamW at the trainer's lr and wd,
        every parameter decayed, no clipping."""
        self.teacher.requires_grad_(True)
        opt = GroupedAdamW(self.teacher, lr=self.cfg.lr, wd=self.cfg.wd, lr_high_scale=1.0,
                           lr_low_scale=1.0, clip_norm=None, decay_all=True)
        done = 0
        while done < steps:
            for batch in self.train_ds.batches(self.batch_size, shuffle=True,
                                               seed=self.cfg.seed + 500 + done):
                ids, mask, tt, labels = self._tensors(*batch)
                self.teacher(ids, mask, tt, labels=labels)["loss"].backward()
                opt.step()
                opt.zero_grad()
                done += 1
                if done >= steps:
                    break
        self.teacher.requires_grad_(False)

    def train_step(self, ids, mask, tt, labels):
        """One KD step and update on one batch; returns the detached terms."""
        ids, mask, tt, labels = self._tensors(ids, mask, tt, labels)
        loss, details = self.kd.kd_loss(ids, mask, labels, tt)
        loss.backward()
        self.optimizer.step()
        self.optimizer.zero_grad()
        self.step += 1
        return {k: v.detach() for k, v in details.items() if k != "logits"}

    @torch.no_grad()
    def _logits(self, model, batch):
        ids, mask, tt = self._tensors(*batch[:3])
        return model(ids, mask, tt)["logits"].float().cpu().numpy()

    def evaluate_teacher(self, max_batches=None) -> float:
        """The teacher's accuracy on the validation batches."""
        correct = total = 0
        for i, batch in enumerate(self.eval_ds.batches(self.batch_size)):
            if max_batches is not None and i >= max_batches:
                break
            correct += int((self._logits(self.teacher, batch).argmax(-1) == batch[3]).sum())
            total += len(batch[3])
        return correct / max(total, 1)

    def evaluate(self, max_batches=None, return_dict: bool = False):
        """The student's GLUE metric for the task: its primary score, or
        the whole dict with `return_dict`."""
        preds, labels_all = [], []
        for i, batch in enumerate(self.eval_ds.batches(self.batch_size)):
            if max_batches is not None and i >= max_batches:
                break
            logits = self._logits(self.student, batch)
            preds.append(logits[:, 0] if self.num_labels == 1 else logits.argmax(-1))
            labels_all.append(batch[3])
        preds = np.concatenate(preds) if preds else np.zeros((0,))
        labels_all = np.concatenate(labels_all) if labels_all else np.zeros((0,))
        metrics = glue_compute(self.cfg.subset, preds, labels_all)
        return metrics if return_dict else primary_score(self.cfg.subset, metrics)

    def _log(self, record):
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def train(self):
        cfg = self.cfg
        t0 = time.time()
        while self.step < cfg.num_steps:
            for batch in self.train_ds.batches(self.batch_size, shuffle=True,
                                               seed=cfg.seed + self.step):
                details = self.train_step(*batch)
                if self.step % 20 == 0:
                    rec = {k: float(v) for k, v in details.items()}
                    rec.update(step=self.step, time=time.time() - t0)
                    self._log(rec)
                if self.step % cfg.eval_steps == 0 or self.step >= cfg.num_steps:
                    self._log({"step": self.step, "eval": self.evaluate(max_batches=16)})
                if self.step >= cfg.num_steps:
                    return


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--subset", default="mrpc")
    p.add_argument("--model", default="tiny")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--save-dir", default="./saves/glue_trainer")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; pass --device cpu for the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = GlueTrainerConfig(subset=args.subset, model=args.model, num_steps=args.steps,
                            batch_size=args.batch_size, eval_steps=max(args.steps // 2, 1),
                            save_dir=args.save_dir)
    tr = GlueTrainer(cfg, device=device)
    tr.train()
    print("eval score:", tr.evaluate(max_batches=16))


if __name__ == "__main__":
    main()
