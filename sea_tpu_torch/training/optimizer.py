"""The 4-group AdamW of the KD trainer, with global-norm clipping at 1.0
(port of `sea_tpu/training/optimizer.py`):

  group      parameters                            lr               weight decay
  ---------  ------------------------------------  ---------------  ------------
  low        the base model's                      lr · low_scale   wd
  low_nd     its biases and norms' scales          lr · low_scale   0
  high       the SEA estimator's ('perlin')        lr · high_scale  wd
  high_nd    its biases and norms' scales          lr · high_scale  0

Defaults: lr 1e-5, wd 1e-2, high_scale 10, low_scale 0.2. The JAX package
tells the no-decay leaves by their Flax names `bias` and `scale`; Flax calls
a LayerNorm's and an RMSNorm's weight `scale`, so here the set is every
`bias` and the `weight` of every `nn.LayerNorm` and every `modules.RMSNorm`
(LLaMA's norms), chosen by the module's type.

The update is optax's, written out, because it keeps its moments in types
`torch.optim.AdamW` cannot: `optax.clip_by_global_norm(1.0)` and then, per
group, `optax.adamw(lr, weight_decay, mu_dtype)` (betas 0.9, 0.999, eps
1e-8), each operation in the type JAX gives it:

  * clipping: ‖g‖ = sqrt(Σ_leaves Σ g²), each leaf's sum in its own type
    (the leaves in module order; JAX sums them in its sorted tree order, so
    a bfloat16 norm may land an ulp apart); when ‖g‖ >= 1, g = g / ‖g‖ · 1
    (the norm cast to the leaf's type);
  * mu = 0.1 · g + 0.9 · mu and nu = 0.001 · g² + 0.999 · nu, in the
    promoted types of the gradient and the stored moments; mû and nû divide
    them by 1 − β^count (computed in float32, cast to each moment's type):
    mû from the updated mu before it is cast back to `mu_dtype` for
    storage, as optax 0.2.6 does;
  * u = mû / (sqrt(nû) + eps) + wd · p, p = (p − lr · u) in p's type.

Each Python constant (β, 1 − β, eps, wd, lr) meets a tensor rounded to that
tensor's type first, as JAX rounds a weakly typed scalar (PyTorch would
multiply a bfloat16 tensor by the float32 constant).

`mu_dtype` (optax's, the trainer's `moment_dtype`) is the first moment's
stored type, the parameters' own type when None; the second moment is
stored in the parameters' type. A parameter without a gradient gets a zero
one, since optax updates (and decays) every leaf.

`lr` is a float or, as optax takes one, a schedule: a function of the
number of updates before this one, evaluated in float32 and multiplied by
each group's scale in float32 (`linear_warmup` and `rsqrt_schedule`, the
LRA trainer's). `clip_norm=None` skips the clipping and `decay_all` decays
every parameter (plain `optax.adamw` over the whole tree, the GLUE
trainer's teacher pretraining).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import torch
from torch import nn

from ..models.modules import RMSNorm

B1, B2, EPS = 0.9, 0.999, 1e-8


def param_labels(model: nn.Module) -> Dict[str, str]:
    """Each parameter's group: 'low', 'low_nd', 'high' or 'high_nd'."""
    labels = {}
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            high = "perlin" in name.split(".")
            nodecay = p_name == "bias" or isinstance(mod, (nn.LayerNorm, RMSNorm))
            labels[name] = ("high" if high else "low") + ("_nd" if nodecay else "")
    return labels


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    return None if name is None else getattr(torch, name)


def _c(x: float, t: torch.Tensor) -> float:
    """The constant x rounded to t's type (JAX's weak typing), as a Python
    float that the operation then carries exactly."""
    return float(torch.tensor(x, dtype=t.dtype))


def linear_warmup(peak: float, warmup: int) -> Callable[[int], torch.Tensor]:
    """optax.linear_schedule(0, peak, warmup): peak · min(step / warmup, 1),
    in float32."""
    def schedule(step: int) -> torch.Tensor:
        frac = 1 - torch.tensor(min(max(step, 0), warmup), dtype=torch.int32) / warmup
        return (0.0 - peak) * frac + peak
    return schedule


def rsqrt_schedule(peak: float, warmup: int) -> Callable[[int], torch.Tensor]:
    """The LRA paper's shape: peak · min(step / warmup, sqrt(warmup /
    max(step, 1))), in float32."""
    def schedule(step: int) -> torch.Tensor:
        sf = torch.tensor(step, dtype=torch.float32)
        return peak * torch.minimum(sf / warmup, torch.sqrt(warmup / torch.clamp(sf, min=1.0)))
    return schedule


class GroupedAdamW:
    """Clip by global norm, then one AdamW update over the four groups, in
    optax's types (see the module doc). `mu_dtype`: "bfloat16", "float32"
    or None (the parameters' type)."""

    def __init__(self, model: nn.Module, lr: Union[float, Callable] = 1e-5, wd: float = 1e-2,
                 lr_high_scale: float = 10.0, lr_low_scale: float = 0.2,
                 clip_norm: Optional[float] = 1.0, mu_dtype: Optional[str] = None,
                 decay_all: bool = False):
        self.clip_norm = clip_norm
        self.lr = lr
        labels = param_labels(model)
        named = dict(model.named_parameters())
        self.names: List[str] = list(named)
        self.params: List[torch.nn.Parameter] = list(named.values())
        nd_wd = wd if decay_all else 0.0
        scale = {"low": (lr_low_scale, wd), "low_nd": (lr_low_scale, nd_wd),
                 "high": (lr_high_scale, wd), "high_nd": (lr_high_scale, nd_wd)}
        self.scales = [scale[labels[n]] for n in self.names]
        mu_t = _dtype(mu_dtype)
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=mu_t or p.dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def _clip(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """optax.clip_by_global_norm in place; returns the norm."""
        total = 0
        for g in grads:
            total = total + torch.sum(g * g)
        norm = torch.sqrt(total)
        if not bool(norm < self.clip_norm):
            for g in grads:
                g.copy_(g / norm.to(g.dtype) * self.clip_norm)
        return norm

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Fill missing gradients with zeros, clip, update; returns the
        gradients' global norm before clipping."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_norm is None:
            norm = torch.sqrt(sum(torch.sum(p.grad * p.grad) for p in self.params))
        else:
            norm = self._clip([p.grad for p in self.params])
        if callable(self.lr):
            base = torch.as_tensor(self.lr(self.count), dtype=torch.float32)

            def rate(scale):
                return float(base * scale)
        else:
            def rate(scale):
                return self.lr * scale
        self.count += 1
        c = torch.tensor(self.count, dtype=torch.float32)
        bc1 = 1 - torch.tensor(B1, dtype=torch.float32) ** c
        bc2 = 1 - torch.tensor(B2, dtype=torch.float32) ** c
        for i, (p, (scale, wd)) in enumerate(zip(self.params, self.scales)):
            lr = rate(scale)
            g, m0, v0 = p.grad, self.mu[i], self.nu[i]
            mu = _c(1 - B1, g) * g + _c(B1, m0) * m0
            g2 = g * g
            nu = _c(1 - B2, g2) * g2 + _c(B2, v0) * v0
            mu_hat = mu / _c(float(bc1), mu)
            nu_hat = nu / _c(float(bc2), nu)
            root = torch.sqrt(nu_hat)
            u = mu_hat / (root + _c(EPS, root))
            u = u + _c(wd, p) * p
            p.copy_(p + _c(-lr, u) * u)
            self.mu[i] = mu.to(self.mu[i].dtype)
            self.nu[i] = nu.to(self.nu[i].dtype)
        return norm

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self):
        return {"count": self.count,
                "state": {n: {"mu": m, "nu": v} for n, m, v in zip(self.names, self.mu, self.nu)}}

    def load_state_dict(self, state) -> None:
        self.count = int(state["count"])
        for i, n in enumerate(self.names):
            self.mu[i] = state["state"][n]["mu"].to(self.mu[i])
            self.nu[i] = state["state"][n]["nu"].to(self.nu[i])
