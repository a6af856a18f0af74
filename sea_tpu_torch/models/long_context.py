"""Long-context extension by parameter interpolation (PyTorch port of
`sea_tpu/models/long_context.py`).

OPT's learned positional embeddings and every SEA layer's identity-value
table (`v_eye_learned_causal`) are stretched to a longer window by linear
interpolation along time; the model is then rebuilt with the new
`max_position_embeddings`. With `SeaConfig.dynamic_k` and `query_skips`
these are the knobs of the long-context sweep
(`training/exp_long_context.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .opt import OptForCausalLM


def interp_positions(old_len: int, new_len: int, device=None) -> torch.Tensor:
    """`jnp.linspace(0, old_len - 1, new_len)` in float32, bit for bit as
    XLA evaluates it on the CPU: its division by n − 1 becomes a product by
    the float32 reciprocal, reassociated, so position i is
    i · (stop · (1 / (n − 1))), each product rounded to float32, and the
    last position the stop itself. The floor of each picks JAX's rows."""
    stop = torch.full((), float(old_len - 1), dtype=torch.float32, device=device)
    if new_len == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    div = torch.full((), float(new_len - 1), dtype=torch.float32, device=device)
    i = torch.arange(new_len - 1, dtype=torch.float32, device=device)
    return torch.cat([i * (stop * (torch.ones_like(div) / div)), stop.reshape(1)])


def _interp_rows(table: torch.Tensor, new_len: int) -> torch.Tensor:
    """Linear interpolation along axis 0 of (L, E) to (new_len, E)."""
    old_len = table.shape[0]
    if old_len == new_len:
        return table
    pos = interp_positions(old_len, new_len, table.device)
    lo = torch.clamp(torch.floor(pos).long(), 0, old_len - 1)
    hi = torch.clamp(lo + 1, 0, old_len - 1)
    frac = (pos - lo.to(pos.dtype))[:, None].to(table.dtype)
    return table[lo] * (1 - frac) + table[hi] * frac


def extend_opt_context(state_dict: Dict[str, torch.Tensor], new_max_pos: int
                       ) -> Dict[str, torch.Tensor]:
    """`state_dict` with the positional tables stretched to `new_max_pos`:
    `model.embed_positions.weight` (max_pos + 2, E) keeps OPT's two offset
    rows and interpolates the rest; every `...v_eye_learned_causal`
    (1, 1, max_pos, D) interpolates along time. Other entries are kept."""
    out = {}
    for name, x in state_dict.items():
        if name.endswith("embed_positions.weight"):
            x = torch.cat([x[:2], _interp_rows(x[2:], new_max_pos)], dim=0)
        elif name.endswith("v_eye_learned_causal"):
            x = _interp_rows(x[0, 0], new_max_pos)[None, None]
        out[name] = x
    return out


def extended_opt_config(cfg, new_max_pos: int, **sea_overrides):
    """`cfg` with `max_position_embeddings` set to `new_max_pos` on the model
    and its SEA config, and any other SEA fields replaced (`dynamic_k=`,
    `query_skips=`, ...)."""
    sea = dataclasses.replace(cfg.sea, max_position_embeddings=new_max_pos, **sea_overrides)
    return dataclasses.replace(cfg, sea=sea, max_position_embeddings=new_max_pos)


def opt_from_state_dict(cfg, state_dict: Dict[str, torch.Tensor], device, dtype=torch.float32
                        ) -> OptForCausalLM:
    """`cfg`'s OPT model on `device` in `dtype`, holding `state_dict`."""
    with torch.device(device):
        model = OptForCausalLM(cfg, device=device, seed=None).to(dtype)
    model.load_state_dict(state_dict)
    return model


def extend_opt_model(model: OptForCausalLM, new_max_pos: int, **sea_overrides
                     ) -> OptForCausalLM:
    """A new OPT model on `model`'s device and in its type, with its weights
    stretched to `new_max_pos` positions (`extend_opt_context`) and its
    config extended (`extended_opt_config`)."""
    param = next(model.parameters())
    return opt_from_state_dict(
        extended_opt_config(model.cfg, new_max_pos, **sea_overrides),
        extend_opt_context(model.state_dict(), new_max_pos), param.device, param.dtype)
