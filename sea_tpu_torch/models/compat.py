"""The reference-checkpoint bridge (PyTorch port of `sea_tpu/models/compat.py`).

Maps a reference perlin-OPT PyTorch state dict (gmlwns2000/sea-attention's
module paths) straight onto the port's `OptForCausalLM` state dict, and
back. Both sides are PyTorch, so no leaf changes layout: Linear weights stay
(out, in), conv weights OIHW, LayerNorm weights and biases as they are.

  model.decoder.embed_tokens.weight            -> model.embed_tokens.weight
  model.decoder.embed_positions.weight         -> model.embed_positions.weight
  model.decoder.final_layer_norm               -> model.final_layer_norm
  ...layers.{i}.self_attn.{q,k,v,out}_proj     -> model.layers.{i}.self_attn....
  ...layers.{i}.{self_attn_layer_norm,final_layer_norm,fc1,fc2}
  ...self_attn.perlin_self_attention.attention. (= P below)
    P attention_predictor_enc.0                -> ...self_attn.perlin.enc_dense
    P attention_predictor_enc.1                -> ...perlin.enc_ln
    P attention_predictor_dec_row.0            -> ...perlin.dec_row
    P attention_predictor_cnn.0.module         -> ...perlin.cnn_ln1
    P attention_predictor_cnn.1.module.net.0.module -> ...perlin.cnn_conv1
    P attention_predictor_cnn.1.module.net.2.module -> ...perlin.cnn_conv2
    P attention_predictor_cnn.1.module.net.5.module -> ...perlin.cnn_conv4
    P attention_predictor_cnn.2.module         -> ...perlin.cnn_ln2
    P attention_predictor_dec_scaler.0         -> ...perlin.dec_scaler
    P v_eye_learned_causal                     -> ...perlin.v_eye_learned_causal
    P performer(.fast_attention).projection_matrix -> ...perlin.performer_proj

Keys the map does not name are left out on import, as in JAX (the tied LM
head, a deeper CNN's third conv); the result loads with `strict=True` into
a student whose reference checkpoint had every mapped key.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_PERFORMER = ("performer.fast_attention.projection_matrix", "performer.projection_matrix")


def _layer_map(i: int) -> Dict[str, str]:
    """Reference module prefix -> the port's, for layer i."""
    L = f"model.decoder.layers.{i}."
    A = L + "self_attn."
    P = A + "perlin_self_attention.attention."
    me = f"model.layers.{i}."
    sa = me + "self_attn."
    pe = sa + "perlin."
    return {
        A + "q_proj": sa + "q_proj",
        A + "k_proj": sa + "k_proj",
        A + "v_proj": sa + "v_proj",
        A + "out_proj": sa + "out_proj",
        L + "self_attn_layer_norm": me + "self_attn_layer_norm",
        L + "final_layer_norm": me + "final_layer_norm",
        L + "fc1": me + "fc1",
        L + "fc2": me + "fc2",
        P + "attention_predictor_enc.0": pe + "enc_dense",
        P + "attention_predictor_enc.1": pe + "enc_ln",
        P + "attention_predictor_dec_row.0": pe + "dec_row",
        P + "attention_predictor_cnn.0.module": pe + "cnn_ln1",
        P + "attention_predictor_cnn.1.module.net.0.module": pe + "cnn_conv1",
        P + "attention_predictor_cnn.1.module.net.2.module": pe + "cnn_conv2",
        P + "attention_predictor_cnn.1.module.net.5.module": pe + "cnn_conv4",
        P + "attention_predictor_cnn.2.module": pe + "cnn_ln2",
        P + "attention_predictor_dec_scaler.0": pe + "dec_scaler",
    }


def _key_map(num_layers: int) -> Dict[str, str]:
    """Every reference key the bridge knows -> the port's."""
    out = {"model.decoder.embed_tokens.weight": "model.embed_tokens.weight",
           "model.decoder.embed_positions.weight": "model.embed_positions.weight",
           "model.decoder.final_layer_norm.weight": "model.final_layer_norm.weight",
           "model.decoder.final_layer_norm.bias": "model.final_layer_norm.bias"}
    for i in range(num_layers):
        for ref, port in _layer_map(i).items():
            for leaf in ("weight", "bias"):
                out[f"{ref}.{leaf}"] = f"{port}.{leaf}"
        P = f"model.decoder.layers.{i}.self_attn.perlin_self_attention.attention."
        pe = f"model.layers.{i}.self_attn.perlin."
        out[P + "v_eye_learned_causal"] = pe + "v_eye_learned_causal"
    return out


def _tensor(x) -> torch.Tensor:
    """A tensor as it is; an array copied into one."""
    return x if torch.is_tensor(x) else torch.tensor(np.asarray(x))


def import_reference_opt_state_dict(sd: Dict[str, object], cfg) -> Dict[str, torch.Tensor]:
    """The port's `OptForCausalLM(cfg)` state dict (the keys the reference
    checkpoint has) from a reference state dict of tensors or arrays."""
    out = {}
    for ref, port in _key_map(cfg.num_layers).items():
        if ref in sd:
            out[port] = _tensor(sd[ref])
    for i in range(cfg.num_layers):
        P = f"model.decoder.layers.{i}.self_attn.perlin_self_attention.attention."
        for cand in _PERFORMER:
            if P + cand in sd:
                out[f"model.layers.{i}.self_attn.perlin.performer_proj"] = _tensor(sd[P + cand])
                break
    return out


def export_reference_style_state_dict(state_dict: Dict[str, torch.Tensor], cfg
                                      ) -> Dict[str, torch.Tensor]:
    """The inverse: a reference-style state dict of the port's (the
    performer projection under `performer.fast_attention.projection_matrix`)."""
    out = {}
    for ref, port in _key_map(cfg.num_layers).items():
        if port in state_dict:
            out[ref] = state_dict[port]
    for i in range(cfg.num_layers):
        port = f"model.layers.{i}.self_attn.perlin.performer_proj"
        if port in state_dict:
            P = f"model.decoder.layers.{i}.self_attn.perlin_self_attention.attention."
            out[P + _PERFORMER[0]] = state_dict[port]
    return out
