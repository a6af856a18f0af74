"""HF OPT checkpoint -> the port's state dict, and the student bootstrap.

Port of `sea_tpu/models/loader.py`'s OPT half:

  * `opt_params_from_state_dict`: an HF-layout OPT state dict (numpy arrays
    or tensors, keys `model.decoder.layers.N.self_attn.q_proj.weight` and
    so on, with or without the `model.decoder.` prefix) becomes the state
    dict of `OptForCausalLM`. HF `Linear` weights are already (out, in), as
    `nn.Linear` keeps them, so nothing is transposed;
  * `load_opt_params`: the same from a local directory holding
    `*.safetensors` or `*.bin` files. There is no download branch;
  * `student_from_teacher`: the student takes its own copy of every tensor
    the teacher has and keeps its fresh SEA estimator ('perlin').
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from .opt import OptConfig


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path} is not a local checkpoint directory")
    safes = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    bins = sorted(glob.glob(os.path.join(path, "*.bin")))
    sd: Dict[str, np.ndarray] = {}
    if safes:
        from safetensors import safe_open

        for f in safes:
            with safe_open(f, framework="np") as fh:
                for k in fh.keys():
                    sd[k] = fh.get_tensor(k)
        return sd
    if bins:
        for f in bins:
            part = torch.load(f, map_location="cpu", weights_only=True)
            sd.update({k: v.numpy() for k, v in part.items()})
        return sd
    raise FileNotFoundError(f"no checkpoint files in {path}")


def opt_params_from_state_dict(sd, cfg: OptConfig) -> Dict[str, torch.Tensor]:
    """The port's `OptForCausalLM` state dict (without the student's
    'perlin' modules) from an HF OPT state dict."""

    def g(key):
        for prefix in ("model.decoder.", "decoder.", ""):
            if prefix + key in sd:
                return torch.as_tensor(np.asarray(sd[prefix + key]), dtype=torch.float32)
        raise KeyError(key)

    names = ["embed_tokens.weight", "embed_positions.weight"]
    if cfg.do_layer_norm_before:
        names += ["final_layer_norm.weight", "final_layer_norm.bias"]
    for i in range(cfg.num_layers):
        for mod in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                    "self_attn.out_proj", "self_attn_layer_norm", "fc1", "fc2",
                    "final_layer_norm"):
            names += [f"layers.{i}.{mod}.weight", f"layers.{i}.{mod}.bias"]
    return {f"model.{n}": g(n).clone() for n in names}


def load_opt_params(path: str, cfg: OptConfig) -> Dict[str, torch.Tensor]:
    return opt_params_from_state_dict(_load_state_dict(path), cfg)


def student_from_teacher(student: nn.Module, teacher: nn.Module) -> nn.Module:
    """Copy every teacher tensor into the student's tensor of the same name
    (the student keeps its own storage); the rest, the 'perlin' estimator,
    stays at its fresh init. Returns the student."""
    teacher_sd = teacher.state_dict()
    with torch.no_grad():
        for name, tensor in student.state_dict().items():
            if name in teacher_sd:
                tensor.copy_(teacher_sd[name])
    return student
