"""Port parity: the reference-checkpoint bridge (sea_tpu_torch.models.compat
vs sea_tpu.models.compat) on a synthetic state dict in the reference's key
layout (no reference checkpoint is in the repository): JAX's export of the
port's seeded tiny perlin-OPT.

The port's import equals JAX's import read through `weights.
state_dict_from_jax`, leaf for leaf and bit for bit, and loads with
`strict=True`; the port's export equals JAX's; import after export is the
identity; the logits of the imported model equal the original's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sea_tpu.config import SeaConfig
from sea_tpu.models import compat as jcompat
from sea_tpu.models import opt as jopt
from sea_tpu_torch.models import compat as tcompat
from sea_tpu_torch.models import opt as topt
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import jax_variables_from_state_dict, t, torch_opt_config


def tiny_opt(layers=2):
    sea = SeaConfig(num_heads=2, head_dim=16, predictor_length=16, k=4, performer_nb_factor=1,
                    causal=True, max_position_embeddings=64).validate()
    return jopt.OptConfig(vocab_size=64, hidden_size=32, num_layers=layers, num_heads=2,
                          ffn_dim=64, max_position_embeddings=64, attention_method="perlin",
                          sea=sea)


def port_and_reference(seed=3):
    cfg = tiny_opt()
    port = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=seed)
    ids = jnp.zeros((1, 16), jnp.int32)
    shapes = jax.eval_shape(jopt.OptForCausalLM(cfg).init, jax.random.key(0), ids,
                            jnp.ones_like(ids))
    variables = jax_variables_from_state_dict(shapes, port.state_dict())
    ref = {k: np.asarray(v) for k, v in
           jcompat.export_reference_style_state_dict(variables, cfg).items()}
    return cfg, port, variables, ref


def test_import_matches_jax_and_loads_strict():
    cfg, port, _, ref = port_and_reference()
    assert any(k.endswith("perlin_self_attention.attention.v_eye_learned_causal") for k in ref)
    want = state_dict_from_jax(jcompat.import_reference_opt_state_dict(ref, cfg))
    got = tcompat.import_reference_opt_state_dict(ref, torch_opt_config(cfg))
    assert set(got) == set(want) == set(port.state_dict())
    for name, w in want.items():
        assert torch.equal(got[name], w), name
    fresh = topt.OptForCausalLM(torch_opt_config(cfg), device="cpu", seed=None)
    fresh.load_state_dict(got, strict=True)
    ids = torch.randint(0, 64, (1, 48), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = fresh(ids, torch.ones_like(ids), benchmarking=True)["logits"]
        b = port(ids, torch.ones_like(ids), benchmarking=True)["logits"]
    assert torch.equal(a, b)


def test_export_matches_jax_and_round_trips():
    cfg, port, variables, ref = port_and_reference(seed=5)
    got = tcompat.export_reference_style_state_dict(port.state_dict(), torch_opt_config(cfg))
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    back = tcompat.import_reference_opt_state_dict(got, torch_opt_config(cfg))
    sd = port.state_dict()
    assert set(back) == set(sd)
    for name in sd:
        assert torch.equal(back[name], sd[name]), name


@pytest.mark.parametrize("drop_final_ln", [False, True])
def test_partial_and_alternative_keys_match_jax(drop_final_ln):
    """The older `performer.projection_matrix` key, an unknown key (left
    out, as JAX leaves it), and (optionally) no final LayerNorm."""
    cfg, _, _, ref = port_and_reference(seed=7)
    P = "model.decoder.layers.1.self_attn.perlin_self_attention.attention."
    ref[P + "performer.projection_matrix"] = ref.pop(P + "performer.fast_attention."
                                                         "projection_matrix")
    ref["lm_head.weight"] = ref["model.decoder.embed_tokens.weight"]
    if drop_final_ln:
        del ref["model.decoder.final_layer_norm.weight"], ref["model.decoder.final_layer_norm.bias"]
    want = state_dict_from_jax(jcompat.import_reference_opt_state_dict(ref, cfg))
    got = tcompat.import_reference_opt_state_dict(
        {k: t(v) for k, v in ref.items()}, torch_opt_config(cfg))
    assert set(got) == set(want)
    for name, w in want.items():
        assert torch.equal(got[name], w), name
    assert ("model.final_layer_norm.weight" in got) is not drop_final_ln
