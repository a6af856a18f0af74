"""LRA trainer (port of `sea_tpu/training/lra_trainer.py`): first train a
dense BERT on the task (phase 'dense'), checkpoint it, then distil a SEA
student from that teacher (phase 'distill', `distill.SeaBertKD.kd_loss`).

Every optimizer step takes the mean of `accum_steps` micro-batches'
gradients (the micro-batches' forward and backward one at a time, so one
micro-batch's dense attention is live) and one clipped 4-group AdamW
update (`training.optimizer`, the base groups at the full rate), its rate
constant, a linear warm-up over `warmup_steps` then constant, or with
`lr_decay='rsqrt'` the LRA paper's warm-up and rsqrt decay. The models
run `remat_layers` by default (`lra_bert_config`): at LRA's lengths every
dense layer's (N, H, T, T) scores would otherwise stay live to the
backward. The teacher (`{save_dir}/{task}_teacher.pt`) and the student
(`{task}_student_state.pt`) are saved with their parameters, optimizer
state and step (`torch.save`; every `save_every` steps, at each
`eval_every` probe and at the end), and a new trainer resumes from them:
a 'dense' trainer its teacher's whole state, a 'distill' trainer the
teacher's parameters and its student's whole state.

    python -m sea_tpu_torch.training.lra_trainer --task listops --phase dense --steps 50
    python -m sea_tpu_torch.training.lra_trainer --task listops --steps 50
    python -m sea_tpu_torch.training.lra_trainer --task listops --scale 0.05 --steps 2 \\
        --max-length 64 --n-train 64 --device cpu

Tasks 'listops' (6 layers, width 512, 8 heads, T = 512), 'text' (4 layers,
width 256, 4 heads, T = 1024) and 'image' (1 layer, width 32, one head,
T = 1024), from `data.lra.LRA_TASKS`; `scale` shrinks the model for
smoke runs. The entry point runs on "cuda" unless `--device` says
otherwise, with TF32 off.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import torch

from ..config import SeaConfig
from ..data.lra import LRA_TASKS, get_lra
from ..models.bert import BertConfig
from ..models.loader import student_from_teacher
from .distill import SeaBertKD
from .glue_trainer import build_bert
from .optimizer import GroupedAdamW, linear_warmup, rsqrt_schedule


def lra_bert_config(task: str, attention_method: str, k: int = 64, predictor_length: int = 128,
                    remat_layers: bool = True) -> BertConfig:
    """The task's BERT (`LRA_TASKS`) with the non-causal SEA config."""
    spec = LRA_TASKS[task]
    sea = SeaConfig(
        num_heads=spec.num_heads, head_dim=spec.hidden_size // spec.num_heads,
        predictor_length=predictor_length, k=k, performer_nb_factor=1, causal=False,
    ).validate()
    return BertConfig(
        vocab_size=spec.vocab_size, hidden_size=spec.hidden_size, num_layers=spec.num_layers,
        num_heads=spec.num_heads, ffn_dim=spec.ffn_dim,
        max_position_embeddings=spec.max_position_embeddings, num_labels=spec.num_labels,
        attention_method=attention_method, remat_layers=remat_layers, sea=sea,
    )


@dataclasses.dataclass
class LraTrainerConfig:
    task: str = "listops"
    phase: str = "distill"  # 'dense' (train the teacher) | 'distill' (the SEA student)
    num_steps: int = 1000
    eval_steps: int = 250
    batch_size: Optional[int] = None
    max_length: Optional[int] = None
    n_train: int = 2048
    k: int = 64
    predictor_length: int = 128
    seed: int = 42
    save_dir: str = "./saves/lra_trainer"
    scale: float = 1.0  # model-size scale for smoke runs
    lr: Optional[float] = None  # overrides the task's
    wd: Optional[float] = None
    max_depth: int = 6  # ListOps' expression depth
    # linear warm-up steps (0: none), then constant or, with 'rsqrt', the
    # LRA paper's rsqrt decay
    warmup_steps: int = 0
    lr_decay: str = "none"  # 'none' | 'rsqrt'
    log_every: int = 100
    eval_every: int = 0  # 0: only at the end
    # micro-batches per optimizer step
    accum_steps: int = 1
    # checkpoint every this many optimizer steps (0: at probes and the end)
    save_every: int = 0
    # ListOps' generated-data cache (None: saves/lra_data)
    data_cache_dir: Optional[str] = None


class LraTrainer:
    """Teacher, student, optimizers and data for `cfg`, on `device`; weights
    random from seeds (teacher 0, student 1) unless a checkpoint resumes."""

    def __init__(self, cfg: LraTrainerConfig, device="cuda"):
        if cfg.phase not in ("dense", "distill"):
            raise ValueError(f"phase {cfg.phase!r}: 'dense' or 'distill'")
        self.cfg = cfg
        self.device = torch.device(device)
        spec = LRA_TASKS[cfg.task]
        self.batch_size = cfg.batch_size or spec.batch_size
        self.t_cfg = lra_bert_config(cfg.task, "none", cfg.k, cfg.predictor_length)
        self.s_cfg = lra_bert_config(cfg.task, "perlin", cfg.k, cfg.predictor_length)
        if cfg.scale != 1.0:
            self.t_cfg, self.s_cfg = self._scaled(self.t_cfg), self._scaled(self.s_cfg)
        kw = dict(max_depth=cfg.max_depth) if cfg.task == "listops" else {}
        if cfg.data_cache_dir is not None:
            kw["cache_dir"] = cfg.data_cache_dir
        self.train_ds = get_lra(cfg.task, "train", cfg.n_train, cfg.max_length, **kw)
        self.eval_ds = get_lra(cfg.task, "valid", max(cfg.n_train // 4, 64), cfg.max_length, **kw)

        lr = cfg.lr if cfg.lr is not None else spec.lr
        self.wd = cfg.wd if cfg.wd is not None else spec.wd
        if cfg.warmup_steps > 0:
            schedule = rsqrt_schedule if cfg.lr_decay == "rsqrt" else linear_warmup
            lr = schedule(lr, cfg.warmup_steps)
        self.lr = lr
        self.teacher = build_bert(self.t_cfg, 0, self.device)
        self.t_optimizer = self._optimizer(self.teacher)
        self.step = 0
        if self._load_teacher_checkpoint() and cfg.phase == "dense":
            print(f"[{cfg.task}/dense] resumed at step {self.step}", flush=True)
        self.student = build_bert(self.s_cfg, 1, self.device)
        student_from_teacher(self.student, self.teacher)
        self.optimizer = self._optimizer(self.student)
        if cfg.phase == "distill":
            self.teacher.requires_grad_(False)
            if self._load_student_checkpoint():
                print(f"[{cfg.task}/distill] resumed at step {self.step}", flush=True)
        self.kd = SeaBertKD(self.teacher, self.student)
        os.makedirs(cfg.save_dir, exist_ok=True)

    def _optimizer(self, model) -> GroupedAdamW:
        return GroupedAdamW(model, lr=self.lr, wd=self.wd, lr_low_scale=1.0)

    def _scaled(self, c: BertConfig) -> BertConfig:
        s = self.cfg.scale
        sea = dataclasses.replace(
            c.sea,
            num_heads=max(int(c.num_heads * s), 1),
            head_dim=max(int(c.head_dim * s), 8),
            predictor_length=max(int(c.sea.predictor_length * s), 8),
            k=max(int(c.sea.k * s), 2),
        )
        return dataclasses.replace(
            c, num_heads=sea.num_heads, hidden_size=sea.num_heads * sea.head_dim,
            ffn_dim=max(int(c.ffn_dim * s), 16), num_layers=max(int(c.num_layers * s), 1),
            sea=sea,
        )

    def _tensors(self, ids, mask, tt, labels):
        return [torch.as_tensor(x).to(self.device, torch.long) for x in (ids, mask, tt, labels)]

    # -- one optimizer step over a list of micro-batches -----------------
    def _update(self, model, optimizer, n: int):
        """The summed gradients of `n` micro-batches over n (as JAX's scan
        sums them), then one update."""
        if n > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(n)
        optimizer.step()
        optimizer.zero_grad()
        self.step += 1

    def dense_step(self, micro) -> torch.Tensor:
        """The teacher's task loss over the micro-batches, their mean
        gradient and one update; returns the mean loss."""
        total = 0.0
        for batch in micro:
            ids, mask, tt, labels = self._tensors(*batch)
            loss = self.teacher(ids, mask, tt, labels=labels)["loss"]
            loss.backward()
            total = total + loss.detach()
        self._update(self.teacher, self.t_optimizer, len(micro))
        return total / len(micro)

    def kd_step(self, micro):
        """The KD loss over the micro-batches, their mean gradient and one
        update; returns (the mean loss, the last micro-batch's terms)."""
        total, details = 0.0, None
        for batch in micro:
            ids, mask, tt, labels = self._tensors(*batch)
            loss, details = self.kd.kd_loss(ids, mask, labels, tt)
            loss.backward()
            total = total + loss.detach()
        self._update(self.student, self.optimizer, len(micro))
        return total / len(micro), {k: v.detach() for k, v in details.items() if k != "logits"}

    # -- checkpoints -------------------------------------------------------
    def _path(self, who: str) -> str:
        name = "teacher" if who == "teacher" else "student_state"
        return os.path.join(self.cfg.save_dir, f"{self.cfg.task}_{name}.pt")

    def _save(self, who: str, model, optimizer):
        path = self._path(who)
        tmp = path + ".tmp"
        torch.save({"params": model.state_dict(), "opt_state": optimizer.state_dict(),
                    "step": self.step}, tmp)
        os.replace(tmp, path)

    def save_teacher(self):
        self._save("teacher", self.teacher, self.t_optimizer)

    def save_student(self):
        self._save("student", self.student, self.optimizer)

    def _load(self, who: str):
        path = self._path(who)
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location=self.device, weights_only=True)

    def _load_teacher_checkpoint(self) -> bool:
        state = self._load("teacher")
        if state is None:
            return False
        self.teacher.load_state_dict(state["params"])
        if self.cfg.phase == "dense":
            self.t_optimizer.load_state_dict(state["opt_state"])
            self.step = int(state["step"])
        return True

    def _load_student_checkpoint(self) -> bool:
        state = self._load("student")
        if state is None:
            return False
        self.student.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
        return True

    # ---------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, which: str = "student", max_batches=None) -> float:
        """Accuracy of the student or of the dense teacher ('dense') on the
        validation batches."""
        model = self.student if which == "student" else self.teacher
        correct = total = 0
        for i, batch in enumerate(self.eval_ds.batches(self.batch_size)):
            if max_batches is not None and i >= max_batches:
                break
            ids, mask, tt, _ = self._tensors(*batch)
            logits = model(ids, mask, tt)["logits"]
            correct += int((logits.argmax(-1).cpu().numpy() == batch[3]).sum())
            total += len(batch[3])
        return correct / max(total, 1)

    def _checkpoint(self):
        if self.cfg.phase == "dense":
            self.save_teacher()
        else:
            self.save_student()

    def train(self, log=print):
        cfg = self.cfg
        t0 = time.time()
        A = max(cfg.accum_steps, 1)
        if cfg.phase == "distill" and self.step == 0:
            acc = self.evaluate("student", max_batches=8)
            log(f"[{cfg.task}/distill] step 0 bootstrap student acc (256-sample probe) {acc:.3f}")
        pending = []
        while self.step < cfg.num_steps:
            for micro in self.train_ds.batches(self.batch_size, shuffle=True,
                                               seed=cfg.seed + self.step):
                pending.append(micro)
                if len(pending) < A:
                    continue
                if cfg.phase == "dense":
                    loss = self.dense_step(pending)
                else:
                    loss, _ = self.kd_step(pending)
                pending = []
                lv = float(loss)
                if cfg.log_every and self.step % cfg.log_every == 0:
                    log(f"[{cfg.task}/{cfg.phase}] step {self.step}/{cfg.num_steps} "
                        f"loss {lv:.4f} ({time.time() - t0:.0f}s)")
                probe = cfg.eval_every and self.step % cfg.eval_every == 0
                if cfg.save_every and self.step % cfg.save_every == 0 and not probe:
                    self._checkpoint()
                if probe:
                    which = "dense" if cfg.phase == "dense" else "student"
                    acc = self.evaluate(which, max_batches=8)
                    log(f"[{cfg.task}/{cfg.phase}] step {self.step} {which} acc "
                        f"(256-sample probe) {acc:.3f}")
                    self._checkpoint()
                if self.step >= cfg.num_steps:
                    self._checkpoint()
                    return


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--task", default="listops")
    p.add_argument("--phase", default="distill", choices=["dense", "distill"])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-length", type=int, default=None)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--n-train", type=int, default=2048)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--warmup", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--lr-decay", default="none", choices=["none", "rsqrt"])
    p.add_argument("--save-every", type=int, default=0)
    p.add_argument("--save-dir", default="./saves/lra_trainer")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; pass --device cpu for the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = LraTrainerConfig(
        task=args.task, phase=args.phase, num_steps=args.steps, batch_size=args.batch_size,
        max_length=args.max_length, scale=args.scale, n_train=args.n_train,
        max_depth=args.depth, lr=args.lr, warmup_steps=args.warmup, eval_every=args.eval_every,
        accum_steps=args.accum, lr_decay=args.lr_decay, save_every=args.save_every,
        save_dir=args.save_dir,
    )
    tr = LraTrainer(cfg, device=device)
    tr.train()
    which = "dense" if args.phase == "dense" else "student"
    print(f"{args.task} {which} accuracy:", tr.evaluate(which))


if __name__ == "__main__":
    main()
