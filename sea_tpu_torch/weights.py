"""Carry weights from the JAX package's variable trees into the port.

`state_dict_from_jax(variables)` maps a `{"params": ..., "performer": ...}`
tree of nested dicts of arrays (as the JAX modules' `init` returns them, or
as numpy arrays) to a `state_dict` for the matching port module:

  * Dense `kernel` (in, out) -> `weight` (out, in), the cosformer
    backend's `q_proj`/`k_proj`/`v_proj` among them, and LLaMA's bias-free
    projections (a Dense without `bias` gives `weight` alone);
  * LayerNorm and RMSNorm `scale` -> `weight`; Embed `embedding` -> `weight`
    (OPT's, BERT's and LLaMA's trees alike);
  * conv `weight` (OIHW), `bias` and `v_eye_learned_causal` keep their names
    and layouts;
  * the `performer` collection's `projection` -> the SEA module's
    `performer_proj` buffer;
  * a module list `layers_<i>` -> `layers.<i>`.

Each leaf keeps its type. A bfloat16 leaf (an `ml_dtypes` array, which
`torch.tensor` does not take) comes over through float32, which holds
every bfloat16 value exactly, and back to bfloat16.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

_LAYER = re.compile(r"^layers_(\d+)$")


def _leaves(tree, path: List[str]) -> Iterator[Tuple[List[str], object]]:
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _leaves(val, path + [key])
        else:
            yield path + [key], val


def _module_path(names: List[str]) -> List[str]:
    out = []
    for n in names:
        m = _LAYER.match(n)
        out.extend(["layers", m.group(1)] if m else [n])
    return out


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU copy of `arr` in its own type (bfloat16 by way of float32)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(arr)


def state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a JAX variables tree (see module doc)."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(variables["params"], []):
        *mods, leaf = path
        arr = np.asarray(arr)
        if leaf == "kernel":
            name, arr = "weight", arr.T
        elif leaf in ("scale", "embedding"):
            name = "weight"
        else:
            name = leaf
        key = ".".join(_module_path(mods) + [name])
        out[key] = _tensor(arr)
    for path, arr in _leaves(variables.get("performer", {}), []):
        *mods, leaf = path
        if leaf != "projection":
            raise ValueError(f"unexpected performer variable {'/'.join(path)}")
        key = ".".join(_module_path(mods) + ["performer_proj"])
        out[key] = _tensor(np.asarray(arr))
    return out
