"""Knowledge distillation of an OPT student from its dense teacher (port of
`sea_tpu/training/distill.py`'s `SeaOptKD`, the loop path).

    loss = task_scale · student CE
         + 5 · mean over the L + 1 hidden states of their float32 MSE
         + 0.2 · logit KL (batchmean over N·T rows, +1e-12 inside the log)
         + mean over layers of the student's attention-distill loss

The teacher and the student run interleaved, layer by layer, so that one
layer's (N, H, T, T) teacher scores are live at a time. The teacher runs
under `torch.no_grad()`: its hidden states and captures carry no graph and
its parameters get no gradient. With `use_remat` each (teacher layer,
student layer) pair runs under `torch.utils.checkpoint`, the counterpart of
the JAX package's `jax.checkpoint(pair)`: the backward recomputes the pair
(the teacher again under no_grad) rather than keep its O(T²) tensors. The
resize jitter's draws are drawn by the caller before the pair and passed in,
so that the recomputation sees the same draws (checkpoint's RNG-state
preservation does not cover an explicit generator).

Not ported yet: `SeaOptKDScan` (the scanned layer-pair body with chunked
logits) and `SeaBertKD` (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models.opt import JitterDraws, OptForCausalLM, cross_entropy_shifted


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a.float() - b.float()) ** 2)


class SeaOptKD:
    """KD of `student` (attention_method 'perlin') from the frozen dense
    `teacher` (attention_method 'none'), both `OptForCausalLM` of the same
    depth."""

    def __init__(self, teacher: OptForCausalLM, student: OptForCausalLM):
        if teacher.cfg.attention_method != "none":
            raise ValueError("the teacher must be dense (attention_method='none')")
        if teacher.cfg.num_layers != student.cfg.num_layers:
            raise ValueError("teacher and student must have the same depth")
        self.teacher = teacher
        self.student = student
        self.n_layers = teacher.cfg.num_layers

    def _pair(self, i: int, h_t: torch.Tensor, h_s: torch.Tensor, causal_mask: torch.Tensor,
              draws: Optional[JitterDraws]):
        with torch.no_grad():
            h_t, _, capture = self.teacher.model.layers[i](h_t, causal_mask)
        h_s, aux, _ = self.student.model.layers[i](
            h_s, causal_mask, capture, training=True, jitter=draws)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=h_s.device)
        return h_t, h_s, aux

    def kd_loss(
        self,
        input_ids: torch.Tensor,
        attention_mask_1d: torch.Tensor,
        labels: torch.Tensor,
        jitter: Optional[Sequence[JitterDraws]] = None,
        use_remat: bool = True,
        task_scale: float = 0.1,
        ignore_kd: bool = False,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The interleaved KD forward: (loss, details). `jitter` holds one
        layer's resize-jitter draws per layer (None: no jitter).
        `task_scale` weighs the student CE; `ignore_kd` makes the loss the
        CE alone (every term is still computed and reported)."""
        with torch.no_grad():
            h_t, causal_mask = self.teacher.model.embed(input_ids, attention_mask_1d)
        h_s, _ = self.student.model.embed(input_ids, attention_mask_1d)
        loss_hidden = _mse(h_t, h_s)
        loss_special = torch.zeros((), dtype=torch.float32, device=h_s.device)
        for i in range(self.n_layers):
            draws = jitter[i] if jitter is not None else None
            if use_remat:
                h_t, h_s, aux = checkpoint(self._pair, i, h_t, h_s, causal_mask, draws,
                                           use_reentrant=False)
            else:
                h_t, h_s, aux = self._pair(i, h_t, h_s, causal_mask, draws)
            loss_hidden = loss_hidden + _mse(h_t, h_s)
            loss_special = loss_special + aux
        loss_hidden = loss_hidden / (self.n_layers + 1) * 5.0
        loss_special = loss_special / self.n_layers

        with torch.no_grad():
            logits_t = self.teacher.logits(self.teacher.model.finalize(h_t))
        logits_s = self.student.logits(self.student.model.finalize(h_s))
        task_loss = cross_entropy_shifted(logits_s, labels)

        lt = logits_t.reshape(-1, logits_t.shape[-1]).float()
        ls = logits_s.reshape(-1, logits_s.shape[-1]).float()
        target = torch.softmax(lt, -1)
        log_input = torch.log_softmax(ls, -1)
        loss_logit_kl = (
            (target * (torch.log(target + 1e-12) - log_input)).sum() / lt.shape[0] * 0.2
        )
        if ignore_kd:
            loss = task_loss
        else:
            loss = task_scale * task_loss + loss_hidden + loss_logit_kl + loss_special
        return loss, {
            "loss": loss,
            "loss_model": task_scale * task_loss,
            "loss_kd_hidden": loss_hidden,
            "loss_kd_logit": loss_logit_kl,
            "loss_sp": loss_special,
            "student_task_loss": task_loss,
        }
