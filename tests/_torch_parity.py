"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

Both sides get the same inputs as numpy arrays; the JAX side runs on the
CPU (Pallas in interpret mode, as the JAX package's own tests run it), the
PyTorch side with device="cpu", which takes each kernel's plain version.
"""

import dataclasses

import numpy as np
import torch

import sea_tpu_torch.config as torch_config
import sea_tpu_torch.models.opt as torch_opt


def t(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor (copied)."""
    out = torch.tensor(np.asarray(x))
    return out.to(dtype) if dtype is not None else out


def torch_sea_config(cfg):
    """The port's SeaConfig with every field of a JAX SeaConfig."""
    return torch_config.SeaConfig(**dataclasses.asdict(cfg))


def torch_opt_config(cfg):
    """The port's OptConfig from a JAX OptConfig (the JAX compiler's scan
    fields have no counterpart and must be at their defaults)."""
    names = {f.name for f in dataclasses.fields(torch_opt.OptConfig)}
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name in set(d) - names:
        assert d.pop(name) is False, name
    d["sea"] = torch_sea_config(cfg.sea)
    return torch_opt.OptConfig(**d)


def topk_near_ties(masked_probs_list, budgets, margin=1e-4):
    """Per layer, an (N, T) bool array: True where the row's top-k cut is a
    near tie on the given (JAX side's) estimates, the gap between the
    values ranked budget-1 and budget being nonzero and at most `margin`.
    An exact tie is broken by index on both sides (the upsample-and-area-
    resize CNN head makes such ties by construction), while a gap of a few
    ulps could flip a pick."""
    ties = []
    for probs, budget in zip(masked_probs_list, budgets):
        p = np.asarray(probs)
        N, H, T, T_M = p.shape
        flat = -np.sort(-np.transpose(p, (0, 2, 1, 3)).reshape(N, T, H * T_M), -1)
        b = np.broadcast_to(np.asarray(budget).astype(np.int64)[..., 0], (N, T))
        cut = np.minimum(b, H * T_M - 1)[..., None]
        gap = (np.take_along_axis(flat, cut - 1, -1) - np.take_along_axis(flat, cut, -1))[..., 0]
        ties.append((b < H * T_M) & (gap != 0.0) & (gap <= margin))
    return ties


def assert_topk_margin(masked_probs_list, budgets, margin=1e-4):
    """Top-k near-tie guard, on the JAX side's captured estimates: no row's
    cut may be a near tie (`topk_near_ties`), or the test would be a coin
    toss. A failure here is a fault of the test's inputs (pick another
    seed), not of the port."""
    for layer, ties in enumerate(topk_near_ties(masked_probs_list, budgets, margin)):
        assert not ties.any(), (layer, np.argwhere(ties)[:5])
