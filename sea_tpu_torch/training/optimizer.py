"""The 4-group AdamW of the KD trainer, with global-norm clipping at 1.0
(port of `sea_tpu/training/optimizer.py`):

  group      parameters                            lr               weight decay
  ---------  ------------------------------------  ---------------  ------------
  low        the base model's                      lr · low_scale   wd
  low_nd     its biases and LayerNorm weights      lr · low_scale   0
  high       the SEA estimator's ('perlin')        lr · high_scale  wd
  high_nd    its biases and LayerNorm weights      lr · high_scale  0

Defaults: lr 1e-5, wd 1e-2, high_scale 10, low_scale 0.2. The JAX package
tells the no-decay leaves by their Flax names `bias` and `scale`; Flax calls
a LayerNorm's weight `scale`, so here the set is every `bias` and every
LayerNorm's `weight`, chosen by the module's type. Each group is
`torch.optim.AdamW` with optax.adamw's defaults (betas 0.9, 0.999, eps
1e-8). Before the update, the gradients are clipped as
`optax.clip_by_global_norm` clips them (g · max_norm / ‖g‖ when ‖g‖ >=
max_norm), and a parameter without a gradient gets a zero one, since
AdamW skips a parameter whose `.grad` is None while optax still decays it.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn


def param_labels(model: nn.Module) -> Dict[str, str]:
    """Each parameter's group: 'low', 'low_nd', 'high' or 'high_nd'."""
    labels = {}
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            high = "perlin" in name.split(".")
            nodecay = p_name == "bias" or isinstance(mod, nn.LayerNorm)
            labels[name] = ("high" if high else "low") + ("_nd" if nodecay else "")
    return labels


class GroupedAdamW:
    """Clip by global norm, then one AdamW update over the four groups."""

    def __init__(self, model: nn.Module, lr: float = 1e-5, wd: float = 1e-2,
                 lr_high_scale: float = 10.0, lr_low_scale: float = 0.2,
                 clip_norm: float = 1.0):
        self.clip_norm = clip_norm
        labels = param_labels(model)
        named = dict(model.named_parameters())
        self.params: List[torch.nn.Parameter] = list(named.values())
        groups = []
        for group, scale, decay in (("low", lr_low_scale, wd), ("low_nd", lr_low_scale, 0.0),
                                    ("high", lr_high_scale, wd), ("high_nd", lr_high_scale, 0.0)):
            ps = [p for n, p in named.items() if labels[n] == group]
            if ps:
                groups.append({"params": ps, "lr": lr * scale, "weight_decay": decay,
                               "name": group})
        self.inner = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def step(self) -> torch.Tensor:
        """Fill missing gradients with zeros, clip, update; returns the
        gradients' global norm before clipping."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        keep = norm < self.clip_norm
        with torch.no_grad():
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.clip_norm))
        self.inner.step()
        return norm

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state) -> None:
        self.inner.load_state_dict(state)

