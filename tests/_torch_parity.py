"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

Both sides get the same inputs as numpy arrays; the JAX side runs on the
CPU (Pallas in interpret mode, as the JAX package's own tests run it), the
PyTorch side with device="cpu", which takes each kernel's plain version.
"""

import dataclasses

import numpy as np
import torch

import sea_tpu_torch.config as torch_config
import sea_tpu_torch.models.llama as torch_llama
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


def torch_llama_config(cfg):
    """The port's LlamaConfig from a JAX LlamaConfig (the same fields)."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["sea"] = torch_sea_config(cfg.sea)
    return torch_llama.LlamaConfig(**d)


def jax_variables_from_state_dict(template, state_dict):
    """A JAX variables tree shaped like `template` (e.g. `jax.eval_shape` of
    a module's `init`, which compiles nothing) filled from a port state
    dict, or from any name -> tensor map such as gradients: the inverse of
    `weights.state_dict_from_jax` on a loop-layout tree (Dense kernels
    transposed back, `scale`/`embedding` from `weight`, the `performer`
    collection's `projection` from `performer_proj`). A template without
    collections is read as a `params` tree."""
    import re

    import jax.numpy as jnp

    def port_name(path, leaf, coll):
        mods = []
        for n in path:
            m = re.match(r"^layers_(\d+)$", n)
            mods.extend(["layers", m.group(1)] if m else [n])
        if coll == "performer":
            name = "performer_proj"
        else:
            name = "weight" if leaf in ("kernel", "scale", "embedding") else leaf
        return ".".join(mods + [name])

    def fill(tree, path, coll):
        out = {}
        for key, val in tree.items():
            if hasattr(val, "items"):
                out[key] = fill(val, path + [key], coll)
                continue
            # a copy: jnp.asarray may alias a numpy buffer, which the port's
            # in-place updates would then change under JAX
            x = state_dict[port_name(path, key, coll)].detach().float().numpy().copy()
            if key == "kernel" and coll == "params":
                x = x.T
            assert x.shape == tuple(val.shape), (path, key)
            out[key] = jnp.asarray(x, val.dtype)
        return out

    if "params" not in template:
        return fill(template, [], "params")
    return {coll: fill(tree, [], coll) for coll, tree in template.items()}


def sharpen_port(model, scale=30.0):
    """Scale every non-causal SEA module's last conv (`cnn_conv3`) by
    `scale` in place, as tests/test_torch_bert.py's `sharpen` does on the
    JAX side: the estimator then no longer ties at random init."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".cnn_conv3." in f".{name}":
                p.mul_(scale)
    return model


def port_topk_guard(run, margin=1e-7):
    """`run()` with the port's buffer registry on; asserts that no top-k
    cut of the port's estimates is a near tie (`assert_topk_margin`), as
    the JAX side's eager guard would, without an eager JAX run."""
    from sea_tpu_torch.utils.profiler import get_bench

    bench = get_bench()
    bench.activate_temp_buffers(True)
    try:
        out = run()
        probs = [x.detach().numpy() for x in bench.buffers.get("masked_estimated_attention_probs", [])]
        budget = [x.detach().numpy() for x in bench.buffers.get("per_item_top_k", [])]
    finally:
        bench.activate_temp_buffers(False)
        bench.reset()
    assert_topk_margin(probs, budget, margin)
    return out
