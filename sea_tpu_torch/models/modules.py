"""Predictor CNN building blocks (PyTorch port of `sea_tpu/models/modules.py`).

  * `interpolate` — area (adaptive-average) downscale or linear upscale of
    each of the last two axes, height first, as `jax.image.resize(...,
    "linear")` computes it (half-pixel centres, triangle weights that fall
    outside the input dropped and the rest renormalised);
  * `CausalConv2d` — a (2k-1, k) kernel whose bottom half is zeroed, with
    height padding (k-1)·dilation on both sides, so the convolution along
    the query-time axis never reads a later row;
  * `upsample_nearest` — integer nearest-neighbour upsample in float32;
  * `KeepRes` — run a stack of layers, then resize back to the input height;
  * `ChannelSplit` — (N, C, H, W) -> (N, C·s, H, W/s);
  * `Dense`, `LayerNorm` and `RMSNorm` — flax's `nn.Dense`, `nn.LayerNorm`
    and `nn.RMSNorm` type rule (`promote`, `einsum`): a layer computes in the
    promoted type of its input and its parameters, so a bfloat16 input meets
    float32 parameters in float32 and only bfloat16 parameters compute in
    bfloat16 (the norms' statistics in float32 always).

The convolutions and resizes compute in float32 whatever the input and
parameter types, and return the input's type, as the JAX modules do.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def promote(*xs: torch.Tensor) -> torch.dtype:
    """The type JAX computes a mixed-type operation in
    (`jnp.promote_types`): bfloat16 with float32 is float32."""
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return dtype


def einsum(equation: str, *xs: torch.Tensor) -> torch.Tensor:
    """`jnp.einsum`: operands of mixed floating types are multiplied in
    their promoted type (`torch.einsum` takes one type only)."""
    dtype = promote(*xs)
    return torch.einsum(equation, *(x.to(dtype) for x in xs))


class Dense(nn.Linear):
    """`nn.Linear` with flax `nn.Dense`'s types: input, weight and bias
    promoted to one type first, the output in that type. Below float32 the
    bias is added to the product after it is rounded, as XLA adds it.
    `bias=False` is flax's `use_bias=False` (LLaMA's projections)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = promote(x, self.weight)
        x, w = x.to(dtype), self.weight.to(dtype)
        if self.bias is None:
            return F.linear(x, w)
        b = self.bias.to(dtype)
        if dtype == torch.float32:
            return F.linear(x, w, b)
        return F.linear(x, w) + b


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu(x, approximate=False)` in x's type. float32: the erf
    form. bfloat16: JAX's 0.5·x · erfc(−x · 1/√2) with the constant and
    every operation's result rounded to bfloat16 (one rounding of the
    whole expression, as F.gelu takes, differs from it in about half the
    elements by an ulp)."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="none")
    dtype = x.dtype
    half = (x.float() * 0.5).to(dtype)
    inv_sqrt2 = float(torch.tensor(2 ** -0.5, dtype=dtype))
    arg = (-x.float() * inv_sqrt2).to(dtype)
    return (half.float() * torch.special.erfc(arg.float()).to(dtype).float()).to(dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu(x)` in x's type: x · sigmoid(x), with sigmoid as XLA
    expands it, 1 / (1 + exp(−x)). In bfloat16 every operation's result is
    rounded (XLA's expansion rounds exp, the sum and the quotient each; one
    rounding of sigmoid, or F.silu's of the whole, gives other bits)."""
    return x * (1 / (1 + torch.exp(-x)))


class LayerNorm(nn.LayerNorm):
    """flax's `nn.LayerNorm` (epsilon 1e-6): the statistics and the affine
    in float32, the result in the promoted type of the input, scale and
    bias."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(promote(x, self.weight, self.bias))


class RMSNorm(nn.Module):
    """flax's `nn.RMSNorm` (LLaMA's norm; epsilon 1e-6 by default), as flax
    computes it: the mean of squares in float32, the scale multiplied into
    rsqrt(mean + eps) in float32 before x is, and the result cast once to
    the promoted type of the input and the scale. So a bfloat16 input with a
    float32 scale returns float32 (not HF's `weight · (x · rsqrt).to(x's
    type)`)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (xf * mul).to(promote(x, self.weight))


def _area_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Adaptive-average-pooling matrix (out_size, in_size): row i averages
    input cells [floor(i*in/out), ceil((i+1)*in/out)) uniformly."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        s = int(np.floor(i * in_size / out_size))
        e = int(np.ceil((i + 1) * in_size / out_size))
        w[i, s:e] = 1.0 / (e - s)
    return w


def _linear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Linear-upscale matrix (out_size, in_size) of `jax.image.resize`
    (out_size > in_size): sample i sits at (i + 0.5)·in/out − 0.5 and takes
    the triangle weights max(0, 1 − |sample − j|) of the input cells j,
    renormalised to sum 1 (at the borders one of the two cells lies outside
    and drops out). Computed in float32 as JAX computes it."""
    f32 = np.float32
    inv_scale = f32(in_size / out_size)
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(
        sample[None, :] - np.arange(in_size, dtype=f32)[:, None]))
    return (w / w.sum(axis=0, keepdims=True, dtype=f32)).T.astype(f32)


def _resize_matrix(in_size: int, out_size: int, device) -> torch.Tensor:
    """(out, in) float32: area averaging to shrink, linear weights to grow."""
    m = (_area_matrix if out_size < in_size else _linear_matrix)(in_size, out_size)
    return torch.from_numpy(m).to(device)


def interpolate(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize the last two axes of (..., H, W) to `size`, height first, each
    by area averaging (shrink) or linear interpolation (grow), in float32,
    cast back to the input dtype."""
    *_, H, W = x.shape
    H2, W2 = size
    if (H, W) == (H2, W2):
        return x
    y = x.float()
    if H2 != H:
        y = torch.einsum("oh,...hw->...ow", _resize_matrix(H, H2, y.device), y)
    if W2 != W:
        y = torch.einsum("ow,...hw->...ho", _resize_matrix(W, W2, y.device), y)
    return y.to(x.dtype)


def upsample_nearest(x: torch.Tensor, scale: Tuple[int, int]) -> torch.Tensor:
    """Nearest integer upsample of the last two axes, computed in float32."""
    sh, sw = scale
    y = x.float()
    if sh != 1:
        y = torch.repeat_interleave(y, sh, dim=-2)
    if sw != 1:
        y = torch.repeat_interleave(y, sw, dim=-1)
    return y.to(x.dtype)


class CausalConv2d(nn.Module):
    """Conv over (N, C, T, W) maps; when `causal`, output row t reads only
    input rows <= t (kernel height 2k-1 with the bottom k-1 rows zeroed,
    height padding (k-1)·dilation on both sides). Weights are OIHW."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: Any = 1,
        padding: int = 0,
        dilation: int = 1,
        causal: bool = False,
    ):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride if isinstance(stride, tuple) else (stride, stride)
        self.padding = padding
        self.dilation = dilation
        self.causal = causal
        k = kernel_size
        kh = 2 * k - 1 if causal else k
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kh, k))
        self.bias = nn.Parameter(torch.empty(out_channels))
        # torch Conv2d's default bounds: U(±1/sqrt(fan_in)), fan_in = C·k·k
        self.bound = 1.0 / math.sqrt(in_channels * k * k)

    def reset_parameters(self, generator: torch.Generator):
        for p in (self.weight, self.bias):
            with torch.no_grad():
                p.copy_(
                    torch.rand(p.shape, generator=generator, device=generator.device)
                    * (2 * self.bound) - self.bound
                )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        d = self.dilation
        weight = self.weight
        if self.causal:
            keep = torch.zeros_like(weight[:1, :1])
            keep[..., :k, :] = 1.0
            weight = weight * keep
            pad_h = (k - 1) * d
        else:
            pad_h = self.padding
        y = F.conv2d(
            x.float(), weight.float(), self.bias.float(), stride=self.stride,
            padding=(pad_h, self.padding), dilation=(d, d),
        )
        return y.to(x.dtype)


class KeepRes(nn.Module):
    """Run `layers` (callables: modules, activations, resizes), then resize
    back to the input height and `output_width` (default: the input width).
    It holds the layers, it does not own them: their parameters stay where
    they are registered."""

    def __init__(self, layers: Sequence[Callable[[torch.Tensor], torch.Tensor]],
                 output_width: Optional[int] = None):
        super().__init__()
        self.layers = tuple(layers)
        self.output_width = output_width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for layer in self.layers:
            y = layer(y)
        w = self.output_width if self.output_width is not None else x.shape[-1]
        return interpolate(y, (x.shape[-2], w))


class ChannelSplit(nn.Module):
    """(N, C, H, W) -> (N, C*split, H, W//split)."""

    def __init__(self, split: int):
        super().__init__()
        self.split = split

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, C, H, W = x.shape
        s = self.split
        y = x.reshape(N, C, H, s, W // s).permute(0, 1, 3, 2, 4)
        return y.reshape(N, C * s, H, W // s)
