"""Knowledge distillation of an OPT or LLaMA student from its dense teacher
(port of `sea_tpu/training/distill.py`'s `SeaOptKD`, the loop path, with
`causal_lm_for` and `decoder_layer_for`).

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

The wrapper is family-agnostic, as JAX's: it uses only `model.embed`, whose
second return it threads opaquely to every layer (OPT's causal mask,
LLaMA's (mask, cos, sin) position bundle), `model.layers[i]`,
`model.finalize` and `logits`.

`SeaOptKDScan` is the JAX package's scanned pair (`scan_kd`): every pair
runs under its checkpoint, the student layer with `training=True` and no
jitter (the scanned body passes no rng), and with `logit_chunk` the task
cross entropy and the logit KL run per chunk of the sequence, each chunk's
logits under a checkpoint of their own, so one (N, C, V) pair of logits is
live (as JAX's `_chunked_logit_losses` computes them).

Not ported yet: `SeaBertKD` (ROADMAP queue 1 item 3).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Type, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models.llama import CausalLM, LlamaConfig, LlamaDecoderLayer, LlamaForCausalLM
from ..models.opt import (JitterDraws, OptConfig, OptDecoderLayer, OptForCausalLM,
                          chunk_sums, cross_entropy_shifted, masked_nll, next_token_labels)


def causal_lm_for(cfg: Union[OptConfig, LlamaConfig], **kw) -> CausalLM:
    """The causal LM of a model family's config (`kw`: the model's
    `device` and `seed`)."""
    if isinstance(cfg, OptConfig):
        return OptForCausalLM(cfg, **kw)
    if not isinstance(cfg, LlamaConfig):
        raise TypeError(f"no causal LM for {type(cfg).__name__}")
    return LlamaForCausalLM(cfg, **kw)


def decoder_layer_for(cfg: Union[OptConfig, LlamaConfig]) -> Type[nn.Module]:
    """The decoder layer class of a model family's config."""
    return OptDecoderLayer if isinstance(cfg, OptConfig) else LlamaDecoderLayer


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a.float() - b.float()) ** 2)


class SeaOptKD:
    """KD of `student` (attention_method 'perlin') from the frozen dense
    `teacher` (attention_method 'none'), both causal LMs of one family and
    depth."""

    def __init__(self, teacher: CausalLM, student: CausalLM):
        if teacher.cfg.attention_method != "none":
            raise ValueError("the teacher must be dense (attention_method='none')")
        if type(teacher) is not type(student):
            raise ValueError("teacher and student must be of one model family")
        if teacher.cfg.num_layers != student.cfg.num_layers:
            raise ValueError("teacher and student must have the same depth")
        self.teacher = teacher
        self.student = student
        self.n_layers = teacher.cfg.num_layers

    def _pair(self, i: int, h_t: torch.Tensor, h_s: torch.Tensor, positions,
              draws: Optional[JitterDraws]):
        """Teacher and student layer i; `positions` is `embed`'s second
        return, handed to both as it is."""
        with torch.no_grad():
            h_t, _, capture = self.teacher.model.layers[i](h_t, positions)
        h_s, aux, _ = self.student.model.layers[i](
            h_s, positions, capture, training=True, jitter=draws)
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
            h_t, positions = self.teacher.model.embed(input_ids, attention_mask_1d)
        h_s, _ = self.student.model.embed(input_ids, attention_mask_1d)
        loss_hidden = _mse(h_t, h_s)
        loss_special = torch.zeros((), dtype=torch.float32, device=h_s.device)
        for i in range(self.n_layers):
            draws = jitter[i] if jitter is not None else None
            if use_remat:
                h_t, h_s, aux = checkpoint(self._pair, i, h_t, h_s, positions, draws,
                                           use_reentrant=False)
            else:
                h_t, h_s, aux = self._pair(i, h_t, h_s, positions, draws)
            loss_hidden = loss_hidden + _mse(h_t, h_s)
            loss_special = loss_special + aux
        loss_hidden = loss_hidden / (self.n_layers + 1) * 5.0
        loss_special = loss_special / self.n_layers
        task_loss, loss_logit_kl = self._logit_losses(h_t, h_s, labels)
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

    def _logit_losses(self, h_t: torch.Tensor, h_s: torch.Tensor, labels: torch.Tensor):
        """(task CE, 0.2 · logit KL) from the last layers' hidden states."""
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
        return task_loss, loss_logit_kl


class SeaOptKDScan(SeaOptKD):
    """The JAX package's `SeaOptKDScan.kd_loss`: `SeaOptKD`'s interleaved
    pair with every pair checkpointed and no jitter, and with `logit_chunk`
    the logit losses per chunk of the sequence. The parameters stay in the
    two models (the combined JAX tree reads in through
    `weights.kd_state_dicts_from_jax`)."""

    def __init__(self, teacher: CausalLM, student: CausalLM,
                 logit_chunk: Optional[int] = None):
        super().__init__(teacher, student)
        self.logit_chunk = logit_chunk

    def kd_loss(
        self,
        input_ids: torch.Tensor,
        attention_mask_1d: torch.Tensor,
        labels: torch.Tensor,
        task_scale: float = 0.1,
        ignore_kd: bool = False,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, details), as `SeaOptKD.kd_loss` with no jitter and
        `use_remat`."""
        return super().kd_loss(input_ids, attention_mask_1d, labels, jitter=None,
                               use_remat=True, task_scale=task_scale, ignore_kd=ignore_kd)

    def _logit_losses(self, h_t: torch.Tensor, h_s: torch.Tensor, labels: torch.Tensor):
        if not self.logit_chunk:
            return super()._logit_losses(h_t, h_s, labels)
        N, T, _ = h_s.shape
        lab_next = next_token_labels(labels)
        ce_sum, kl_sum = chunk_sums(self._chunk_losses, (h_t, h_s, lab_next), self.logit_chunk)
        task_loss = ce_sum / torch.clamp((lab_next != -100).sum(), min=1)
        return task_loss, kl_sum / (N * T) * 0.2

    def _chunk_losses(self, h_t: torch.Tensor, h_s: torch.Tensor, labels: torch.Tensor):
        """One chunk's summed CE and summed KL (JAX's `chunk_losses`)."""
        with torch.no_grad():
            lt = self.teacher.logits(self.teacher.model.finalize(h_t)).float()
        ls = self.student.logits(self.student.model.finalize(h_s)).float()
        logp = torch.log_softmax(ls, -1)
        tgt = torch.softmax(lt, -1)
        kl_sum = (tgt * (torch.log(tgt + 1e-12) - logp)).sum()
        return masked_nll(logp, labels), kl_sum
