"""Token sampling: temperature, top-k and top-p (nucleus) filtering (PyTorch
port of `sea_tpu/ops/sampling.py`).

HF `generate(do_sample=True)`'s order: scale by the temperature, keep the
top k, keep the smallest prefix of the renormalised survivors that reaches
mass p, draw. Everything is per row, so per-request parameters ride as (N,)
tensors through one step (the serving engine's slots).

Filtering is by position in the descending sort (stable: ties to the lower
index), so top-k keeps exactly k tokens and top-p exactly the prefix even
where logits tie (untrained models tie constantly); the token that crosses
p is kept, and at least one token always survives.

The draw is JAX's `jax.random.categorical`: the argmax of the logits plus
Gumbel noise. The noise comes from an explicit `torch.Generator`, or is
passed in (a test passes JAX's own `jax.random.gumbel` draws).
"""

from __future__ import annotations

from typing import Optional

import torch


def _filters_statically_off(top_k, top_p) -> bool:
    """Both filters disabled by Python constants: the sort is skipped."""
    return (
        isinstance(top_k, (int, float)) and int(top_k) == 0
        and isinstance(top_p, (int, float)) and float(top_p) >= 1.0
    )


def _per_row(x, n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A scalar or (N,) parameter as an (N,) tensor on `device` (a Python
    scalar by a fill, with no copy from the host)."""
    if isinstance(x, torch.Tensor):
        return torch.broadcast_to(x.to(device=device, dtype=dtype), (n,))
    return torch.full((n,), x, dtype=dtype, device=device)


def filter_logits(logits: torch.Tensor, top_k=0, top_p=1.0) -> torch.Tensor:
    """Logits (N, V) outside the top-k / top-p set set to -inf (float32).

    top_k: scalar or (N,), 0 disables; top_p: scalar or (N,), 1.0
    disables. The top-p mass is measured on the distribution renormalised
    over the top-k survivors, and position 0 always survives."""
    logits = logits.float()
    if _filters_statically_off(top_k, top_p):
        return logits
    N, V = logits.shape
    device = logits.device
    top_k = _per_row(top_k, N, torch.int64, device)
    top_p = _per_row(top_p, N, torch.float32, device)

    # descending token ids; `+ 0.0` sorts -0.0 with +0.0, as on the CPU
    order = torch.sort(-logits + 0.0, dim=-1, stable=True).indices
    sorted_desc = torch.gather(logits, -1, order)
    pos = torch.arange(V, device=device)[None, :]

    # top-k: the first k sorted positions
    keep_k = (pos < top_k[:, None]) | (top_k[:, None] <= 0)

    # top-p over the top-k survivors: the smallest prefix reaching p, the
    # crossing token kept, position 0 always
    neg_inf = torch.full((), float("-inf"), device=device)
    probs = torch.softmax(torch.where(keep_k, sorted_desc, neg_inf), dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep_p = ((csum - probs) < top_p[:, None]) | (pos == 0)
    keep_p = keep_p | (top_p[:, None] >= 1.0)

    # the sorted positions' decisions scattered back to token ids
    keep = torch.zeros((N, V), dtype=torch.bool, device=device).scatter(
        -1, order, keep_k & keep_p)
    return torch.where(keep, logits, neg_inf)


def gumbel_noise(shape, generator: Optional[torch.Generator] = None,
                 device="cuda") -> torch.Tensor:
    """-log(-log(U)), U uniform in [tiny, 1), float32: JAX's `gumbel`."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_logits(logits: torch.Tensor, temperature=1.0, top_k=0, top_p=1.0, *,
                  generator: Optional[torch.Generator] = None,
                  gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token id per row (N,), int64.

    temperature: scalar or (N,), <= 0 greedy for that row (so greedy and
    sampled requests share one step). The draw is argmax(filtered + noise),
    the noise `gumbel` (N, V) if given, else drawn from `generator`."""
    logits = logits.float()
    N, V = logits.shape
    temperature = _per_row(temperature, N, torch.float32, logits.device)
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    filtered = filter_logits(scaled, top_k, top_p)
    if gumbel is None:
        gumbel = gumbel_noise((N, V), generator, logits.device)
    sampled = torch.argmax(gumbel + filtered, dim=-1)
    return torch.where(temperature > 0, sampled, greedy)
