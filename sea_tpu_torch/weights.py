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
  * the `performer` collection's `projection` -> the `performer_proj`
    buffer of the module that holds it (the SEA module's, or a baseline
    performer or scatterbrain attention's); a baseline cosformer's and a
    synthesizer's Dense layers, and BERT's masked-LM `decoder_bias`, by the
    rules above;
  * a module list `layers_<i>` -> `layers.<i>`, and the scan layout's
    stacked `layers_scan/layer/...` (each leaf with a leading layer axis,
    in both collections; OPT's and LLaMA's alike) -> `layers.<i>` for each
    index of that axis.

`stack_layer_params` and `unstack_layer_params` turn a loop-layout tree
into the scan layout and back, as the JAX package's do (`sea_tpu/models/
opt.py:934-956`), over trees of numpy arrays. `kd_state_dicts_from_jax`
reads the KD pair's combined tree (`SeaOptKDScan.combine_params`:
`{collection: {teacher: shell, student: shell, pairs: {teacher: stacked
layers, student: stacked layers}}}`) into the teacher's and the student's
state dicts.

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
_SCAN = ("layers_scan", "layer")


def _tree_map(fn, *trees):
    """`fn` over the leaves of nested dicts of one structure."""
    first = trees[0]
    if hasattr(first, "items"):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def stack_layer_params(params, num_layers: int):
    """Loop layout (`model/layers_<i>/...`) -> scan layout
    (`model/layers_scan/layer/...`, stacked on axis 0)."""
    model = dict(params["model"])
    per_layer = [model.pop(f"layers_{i}") for i in range(num_layers)]
    model["layers_scan"] = {"layer": _tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs], axis=0), *per_layer)}
    return {**params, "model": model}


def unstack_layer_params(params, num_layers: int):
    """The inverse of `stack_layer_params`."""
    model = dict(params["model"])
    stacked = model.pop("layers_scan")["layer"]
    for i in range(num_layers):
        model[f"layers_{i}"] = _tree_map(lambda x, _i=i: np.asarray(x)[_i], stacked)
    return {**params, "model": model}


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


def _per_layer(mods: List[str], arr) -> Iterator[Tuple[List[str], np.ndarray]]:
    """(module path, array) of a leaf: one per layer for a scan-layout leaf
    (`.../layers_scan/layer/...`), else the leaf itself."""
    arr = np.asarray(arr)
    for j in range(len(mods) - 1):
        if tuple(mods[j:j + 2]) == _SCAN:
            for i in range(arr.shape[0]):
                yield mods[:j] + ["layers", str(i)] + mods[j + 2:], arr[i]
            return
    yield _module_path(mods), arr


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU copy of `arr` in its own type (bfloat16 by way of float32)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(arr)


def state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a JAX variables tree (see module doc)."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf_arr in _leaves(variables["params"], []):
        *mods, leaf = path
        for mod_path, arr in _per_layer(mods, leaf_arr):
            if leaf == "kernel":
                name, arr = "weight", arr.T
            elif leaf in ("scale", "embedding"):
                name = "weight"
            else:
                name = leaf
            out[".".join(mod_path + [name])] = _tensor(arr)
    for path, leaf_arr in _leaves(variables.get("performer", {}), []):
        *mods, leaf = path
        if leaf != "projection":
            raise ValueError(f"unexpected performer variable {'/'.join(path)}")
        for mod_path, arr in _per_layer(mods, leaf_arr):
            out[".".join(mod_path + ["performer_proj"])] = _tensor(arr)
    return out


def kd_state_dicts_from_jax(combined) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(teacher, student) state dicts of a `SeaOptKDScan.combine_params`
    tree: each model's shell with its stacked layers put back under
    `model/layers_scan/layer`."""
    out = []
    for who in ("teacher", "student"):
        variables = {}
        for coll, entry in combined.items():
            if who not in entry:
                continue
            shell = dict(entry[who])
            stacked = entry.get("pairs", {}).get(who)
            if stacked is not None:
                shell["model"] = {**shell.get("model", {}), "layers_scan": {"layer": stacked}}
            variables[coll] = shell
        out.append(state_dict_from_jax(variables))
    return out[0], out[1]
