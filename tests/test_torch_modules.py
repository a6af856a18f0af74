"""Port parity: predictor CNN blocks (sea_tpu_torch.models.modules vs
sea_tpu.models.modules), float32, <= 1e-5 abs. Conv weights come from the
JAX module's init through `state_dict_from_jax`."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sea_tpu.models import modules as jmod
from sea_tpu_torch.models import modules as tmod
from sea_tpu_torch.weights import state_dict_from_jax
from tests._torch_parity import t

ATOL = 1e-5


@pytest.mark.parametrize(
    "c_in,c_out,k,padding,dilation,width",
    [
        (4, 4, 3, 2, 2, 8),  # the 5x3 dilated causal conv (cnn_conv1/2)
        (4, 2, 1, 1, 1, 64),  # the 1x1 causal conv with padding 1 (cnn_conv4)
    ],
)
def test_causal_conv2d_matches(c_in, c_out, k, padding, dilation, width):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, c_in, 40, width)).astype(np.float32)
    jm = jmod.CausalConv2d(c_in, c_out, k, padding=padding, dilation=dilation, causal=True)
    variables = jm.init(jax.random.key(0), jnp.asarray(x))
    want = jm.apply(variables, jnp.asarray(x))
    tm = tmod.CausalConv2d(c_in, c_out, k, padding=padding, dilation=dilation, causal=True)
    tm.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        got = tm(t(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_causal_conv2d_reads_no_later_row():
    tm = tmod.CausalConv2d(2, 2, 3, padding=2, dilation=2, causal=True)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(1, 2, 32, 8, generator=torch.Generator().manual_seed(1))
    x2 = x.clone()
    x2[:, :, 20:] += 1.0
    with torch.no_grad():
        assert torch.equal(tm(x)[:, :, :20], tm(x2)[:, :, :20])


def test_interpolate_area_downscale_matches():
    """The conv4 output's T_M+2 -> T_M area resize on the main path."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 12, 16, 258)).astype(np.float32)
    want = jmod.interpolate(jnp.asarray(x), (16, 256))
    got = tmod.interpolate(t(x), (16, 256))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize(
    "shape,size",
    [
        ((2, 3, 75, 64), (75, 128)),  # the non-causal CNN's width, 64 -> 128
        ((2, 3, 102, 64), (101, 128)),  # an odd T: T + 1 rows shrink to T
        ((1, 2, 7, 5), (13, 11)),  # both axes grow, by ratios that are not whole
    ],
    ids=["width_64_128", "odd_height", "both_grow"],
)
def test_interpolate_linear_upscale_matches(shape, size):
    """The linear branch against jax.image.resize, borders included (JAX
    renormalises the weights that fall outside the input), within 1e-6."""
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = jmod.interpolate(jnp.asarray(x), size)
    got = tmod.interpolate(t(x), size)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_keep_res_matches():
    x = np.random.default_rng(4).standard_normal((1, 2, 9, 16)).astype(np.float32)
    want = jmod.KeepRes(layers=(jax.nn.relu,), output_width=32).apply({}, jnp.asarray(x))
    got = tmod.KeepRes([torch.nn.ReLU()], output_width=32)(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_upsample_and_channel_split_exact():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tmod.upsample_nearest(t(x), (1, 4)).numpy(),
        np.asarray(jmod.upsample_nearest(jnp.asarray(x), (1, 4))),
    )
    np.testing.assert_array_equal(
        tmod.ChannelSplit(2)(t(x)).numpy(),
        np.asarray(jmod.ChannelSplit(2)(jnp.asarray(x))),
    )
