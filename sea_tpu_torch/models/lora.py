"""LoRA adapters of the SEA student's projections (PyTorch port of
`sea_tpu/models/lora.py` and of the models' LoRA wiring).

`LoraDelta` is the low-rank delta alone, x (..., in) -> x · A · B, with
A (in, r) kaiming-uniform, U(±sqrt(6 / in)), drawn from the caller's
generator, and B (r, out) zero, so that an adapted projection starts at its
frozen base; the output is cast to x's type (the products in the promoted
type of x, A and B, as JAX's). `LoraDense` is a Dense plus an optional delta.

The attention modules of OPT, LLaMA and BERT build their deltas with
`add_lora` and mix them in with `lora_branches`, as the JAX models do:

  * `lora_enabled`: q, k and v each take their delta (`perlin_{q,k,v}_lora`);
  * `lora_in_approx_enabled`: the estimator's inputs take deltas of their own
    on top (`perlin_{q,k,v}_atten_lora` for q_a, k_a, v_a, the performer's;
    `perlin_{q,k}_score_lora` for q_s, k_s, the scores').

Each model maps a delta to its heads as it maps its projection (OPT scales
q's by head_dim^-0.5 before the head split; LLaMA ropes each delta on its
own, scales q's and repeats k's and v's for GQA; BERT splits only). The
names keep `perlin`, so the optimizer puts them in the high-lr group.
Prefill and decode take no deltas, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .modules import Dense, promote

# (name, branch) of every delta: the projection it adapts is its first letter
MAIN = ("perlin_q_lora", "perlin_k_lora", "perlin_v_lora")
APPROX = ("perlin_q_atten_lora", "perlin_k_atten_lora", "perlin_v_atten_lora",
          "perlin_q_score_lora", "perlin_k_score_lora")


class LoraDelta(nn.Module):
    """The low-rank delta x · A · B (see the module doc)."""

    def __init__(self, in_features: int, features: int, rank: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lora_a = nn.Parameter(torch.empty(in_features, rank))
        self.lora_b = nn.Parameter(torch.empty(rank, features))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """A ~ U(±sqrt(6 / in)) from `generator` (on its device), B = 0."""
        bound = (6.0 / self.lora_a.shape[0]) ** 0.5
        device = generator.device if generator is not None else self.lora_a.device
        with torch.no_grad():
            u = torch.rand(self.lora_a.shape, generator=generator, device=device)
            self.lora_a.copy_(u * (2 * bound) - bound)
            self.lora_b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = promote(x, self.lora_a, self.lora_b)
        return ((x.to(dtype) @ self.lora_a.to(dtype)) @ self.lora_b.to(dtype)).to(x.dtype)


class LoraDense(nn.Module):
    """A Dense (`base`) plus, when `enabled`, its LoRA delta (`lora`)."""

    def __init__(self, in_features: int, features: int, rank: int = 32, enabled: bool = True):
        super().__init__()
        self.base = Dense(in_features, features)
        if enabled:
            self.lora = LoraDelta(in_features, features, rank)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.base(x)
        return y + self.lora(x) if hasattr(self, "lora") else y


def add_lora(attn: nn.Module, sea, in_features: int, q_width: int, kv_width: int):
    """The SEA config's deltas as submodules of `attn` (q's `q_width` wide,
    k's and v's `kv_width`)."""
    names = (MAIN if sea.lora_enabled else ()) + (APPROX if sea.lora_in_approx_enabled else ())
    for name in names:
        width = q_width if name.startswith("perlin_q") else kv_width
        setattr(attn, name, LoraDelta(in_features, width, sea.lora_r))


def lora_branches(attn: nn.Module, sea, x: torch.Tensor, q, k, v,
                  q_heads: Callable, k_heads: Callable, v_heads: Callable):
    """(q, k, v, q_a, k_a, v_a, q_s, k_s) of the SEA module's call: the
    projections' heads with the config's deltas mixed in; `q_heads`,
    `k_heads` and `v_heads` map a raw (N, T, width) delta to heads as the
    model maps its projection."""
    if sea.lora_enabled:
        q = q + q_heads(attn.perlin_q_lora(x))
        k = k + k_heads(attn.perlin_k_lora(x))
        v = v + v_heads(attn.perlin_v_lora(x))
    q_a, k_a, v_a, q_s, k_s = q, k, v, q, k
    if sea.lora_in_approx_enabled:
        q_a = q + q_heads(attn.perlin_q_atten_lora(x))
        k_a = k + k_heads(attn.perlin_k_atten_lora(x))
        v_a = v + v_heads(attn.perlin_v_atten_lora(x))
        q_s = q + q_heads(attn.perlin_q_score_lora(x))
        k_s = k + k_heads(attn.perlin_k_score_lora(x))
    return q, k, v, q_a, k_a, v_a, q_s, k_s
