"""Predictor CNN building blocks (PyTorch port of `sea_tpu/models/modules.py`).

  * `interpolate` — area (adaptive-average) downscale of the last two axes.
    The bilinear upscale branch serves only the non-causal CNN and is not
    ported yet;
  * `CausalConv2d` — a (2k-1, k) kernel whose bottom half is zeroed, with
    height padding (k-1)·dilation on both sides, so the convolution along
    the query-time axis never reads a later row;
  * `upsample_nearest` — integer nearest-neighbour upsample in float32;
  * `ChannelSplit` — (N, C, H, W) -> (N, C·s, H, W/s).
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _area_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Adaptive-average-pooling matrix (out_size, in_size): row i averages
    input cells [floor(i*in/out), ceil((i+1)*in/out)) uniformly."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        s = int(np.floor(i * in_size / out_size))
        e = int(np.ceil((i + 1) * in_size / out_size))
        w[i, s:e] = 1.0 / (e - s)
    return w


def interpolate(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize the last two axes of (..., H, W) to `size` by area averaging,
    in float32, cast back to the input dtype."""
    *_, H, W = x.shape
    H2, W2 = size
    if (H, W) == (H2, W2):
        return x
    if H2 > H or W2 > W:
        raise NotImplementedError(
            "the bilinear upscale branch (non-causal CNN) is not ported yet"
        )
    y = x.float()
    if H2 != H:
        m = torch.from_numpy(_area_matrix(H, H2)).to(y.device)
        y = torch.einsum("oh,...hw->...ow", m, y)
    if W2 != W:
        m = torch.from_numpy(_area_matrix(W, W2)).to(y.device)
        y = torch.einsum("ow,...hw->...ho", m, y)
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
                    torch.rand(p.shape, generator=generator) * (2 * self.bound)
                    - self.bound
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
            x.float(), weight, self.bias, stride=self.stride,
            padding=(pad_h, self.padding), dilation=(d, d),
        )
        return y.to(x.dtype)


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
