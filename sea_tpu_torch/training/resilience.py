"""Failure detection and recovery of the KD trainer (PyTorch port of
`sea_tpu/training/resilience.py`).

Built on `OptTrainer`'s full-state checkpoints (the student, the optimizer,
the step, the jitter generator and the layout in one `torch.save` file):

  * rotating step-tagged checkpoints, `{save_dir}/ckpt_{step:08d}/state.pt`,
    with a `LATEST` pointer that flips (`os.replace`) only after the new
    checkpoint is wholly written; the `keep` newest are kept;
  * resume from the newest intact checkpoint: a torn one (unreadable, or its
    directory without its file) is renamed `<tag>.bad`, never deleted, and
    the next older one is tried; a layout mismatch (`CheckpointLayoutError`)
    is raised, since that checkpoint is intact;
  * `TrainingDiverged`, raised by the train loop at a log boundary (or
    before an evaluation) when the loss is not finite;
  * `Supervisor`, which catches divergence and device errors, rolls back
    to the last good checkpoint, moves the data stream past the window that
    failed (`trainer.data_offset`) and retries, a bounded number of times;
  * `heartbeat_age_s`, the age of the trainer's `heartbeat.json` (written
    at each log boundary). The process-level supervisor that watches it
    (`scripts/supervise.py` in the JAX package) is not ported.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import time
from typing import List, Optional

_TAG_RE = re.compile(r"^ckpt_(\d{8})$")
STATE_FILE = "state.pt"


class TrainingDiverged(RuntimeError):
    """The loss went non-finite; the optimizer state is suspect."""


def _step_tags(save_dir: str) -> List[str]:
    """Step-tagged checkpoint directories, oldest first."""
    if not os.path.isdir(save_dir):
        return []
    tags = [d for d in os.listdir(save_dir)
            if _TAG_RE.match(d) and os.path.isdir(os.path.join(save_dir, d))]
    return sorted(tags, key=lambda t: int(_TAG_RE.match(t).group(1)))


def checkpoint_file(save_dir: str, tag: str) -> str:
    """The file of checkpoint `tag`: `<tag>/state.pt` for a rotating
    checkpoint's directory, else `<tag>.pt`."""
    d = os.path.join(save_dir, tag)
    return os.path.join(d, STATE_FILE) if os.path.isdir(d) else d + ".pt"


def save_rotating(trainer, keep: int = 2) -> str:
    """Save under `ckpt_{step:08d}`, flip LATEST, prune to the `keep` newest.
    Returns the tag written."""
    if keep < 1:
        raise ValueError("keep >= 1")
    save_dir = trainer.cfg.save_dir
    tag = f"ckpt_{trainer.step:08d}"
    path = os.path.join(save_dir, tag)
    if os.path.exists(path):  # a re-save at the same step after a rollback
        shutil.rmtree(path)
    os.makedirs(path)
    trainer.write_state(os.path.join(path, STATE_FILE))

    latest = os.path.join(save_dir, "LATEST")
    tmp = latest + ".tmp"
    with open(tmp, "w") as f:
        f.write(tag)
    os.replace(tmp, latest)

    for old in _step_tags(save_dir)[:-keep]:
        shutil.rmtree(os.path.join(save_dir, old), ignore_errors=True)
    return tag


def resolve_latest(save_dir: str) -> Optional[str]:
    """The newest resume tag: the LATEST pointer if it names an existing
    checkpoint, else the newest step tag on disk, else None."""
    latest = os.path.join(save_dir, "LATEST")
    if os.path.exists(latest):
        with open(latest) as f:
            tag = f.read().strip()
        if tag and os.path.isdir(os.path.join(save_dir, tag)):
            return tag
    tags = _step_tags(save_dir)
    return tags[-1] if tags else None


def resume_latest(trainer) -> Optional[int]:
    """Restore the newest intact checkpoint, renaming each torn one on the
    way to `<tag>.bad`. Returns the resumed step, or None when nothing could
    be restored (the trainer's state is then untouched)."""
    from .opt_trainer import CheckpointLayoutError

    save_dir = trainer.cfg.save_dir
    pointed = resolve_latest(save_dir)
    ordered = [pointed] if pointed else []
    ordered += [t for t in reversed(_step_tags(save_dir)) if t != pointed]
    for tag in ordered:
        try:
            if not os.path.exists(checkpoint_file(save_dir, tag)):
                raise FileNotFoundError(f"{tag} has no {STATE_FILE}")
            if trainer.load(tag):
                return trainer.step
        except CheckpointLayoutError:
            # an intact checkpoint of another layout: deleting it would
            # destroy valid state
            raise
        except Exception:
            bad = os.path.join(save_dir, tag)
            quarantined = bad + ".bad"
            if os.path.exists(quarantined):
                shutil.rmtree(quarantined, ignore_errors=True)
            try:
                os.replace(bad, quarantined)
            except OSError:
                pass
    return None


@dataclasses.dataclass
class SupervisorReport:
    restarts: int = 0
    events: List[str] = dataclasses.field(default_factory=list)
    completed: bool = False
    final_step: int = 0


class Supervisor:
    """`trainer.train()` under supervision. On `TrainingDiverged` (or
    another `RuntimeError`, or `FloatingPointError`): roll back to the last
    good checkpoint, advance `trainer.data_offset` by the micro-batches
    between that checkpoint and the failure (so that the resumed stream
    skips the window), and retry, at most `max_restarts` times. The train
    loop's batch stream is seeded per epoch and a resumed run skips what it
    has consumed, so the rollback is exact up to the skipped window."""

    def __init__(self, trainer, max_restarts: int = 3, skip_data_on_divergence: bool = True):
        self.trainer = trainer
        self.max_restarts = max_restarts
        self.skip_data_on_divergence = skip_data_on_divergence

    def run(self) -> SupervisorReport:
        report = SupervisorReport()
        resume_latest(self.trainer)  # a fresh start if None
        while True:
            try:
                self.trainer.train()
                report.completed = True
                report.final_step = self.trainer.step
                return report
            except (TrainingDiverged, FloatingPointError, RuntimeError) as e:
                report.events.append(f"{type(e).__name__}: {e}")
                if report.restarts >= self.max_restarts:
                    raise
                report.restarts += 1
                crash_step = self.trainer.step
                step = resume_latest(self.trainer)
                if step is None:
                    # no checkpoint yet: the optimizer and the step start
                    # over, the window skipped
                    self.trainer.reset_optimizer()
                    step = 0
                if self.skip_data_on_divergence:
                    self.trainer.data_offset += max(crash_step - step, 1) * (
                        self.trainer.cfg.gradient_accumulation_steps)


def heartbeat_age_s(save_dir: str) -> Optional[float]:
    """Seconds since the trainer last published its heartbeat, or None."""
    p = os.path.join(save_dir, "heartbeat.json")
    if not os.path.exists(p):
        return None
    return time.time() - os.path.getmtime(p)
