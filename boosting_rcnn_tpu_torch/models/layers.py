"""Shared building blocks (PyTorch port of ``boosting_rcnn_tpu/models/layers.py``).

Modules compute on NCHW tensors.  Parameter initialisation follows the JAX
package's flax defaults so that a seeded random model behaves alike:
LeCun-normal (truncated) conv and dense kernels, zero biases, unit norm
scales.  Every initialiser draws from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "FrozenBatchNorm",
    "ConvModule",
    "Scale",
    "lecun_normal_",
    "make_conv",
    "make_linear",
    "max_pool",
    "bilinear_resize",
]

# std of a unit normal truncated to [-2, 2]; flax's lecun_normal divides by it
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """Fill ``weight`` from a normal truncated at 2 std with variance
    ``1 / fan_in`` (flax ``lecun_normal``)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        w = torch.empty(weight.shape, dtype=torch.float32)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        weight.copy_(w * std)


def make_conv(cin: int, cout: int, k: int, stride: int, pad: int, bias: bool,
              gen: torch.Generator, bias_value: float = 0.0) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, stride, pad, bias=bias)
    lecun_normal_(conv.weight, cin * k * k, gen)
    if bias:
        nn.init.constant_(conv.bias, bias_value)
    return conv


def make_linear(cin: int, cout: int, gen: torch.Generator) -> nn.Linear:
    fc = nn.Linear(cin, cout)
    lecun_normal_(fc.weight, cin, gen)
    nn.init.zeros_(fc.bias)
    return fc


class FrozenBatchNorm(nn.Module):
    """BatchNorm in permanent eval mode (``norm_eval=True``), eps 1e-5:
    ``x * weight / sqrt(var + eps) + bias - mean * weight / sqrt(var + eps)``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]


class ConvModule(nn.Module):
    """conv + optional GroupNorm (eps 1e-5) + optional ReLU (mmcv
    ``ConvModule``); the conv has a bias only when there is no norm.
    Padding is ``(k - 1) // 2`` on each side, as the JAX module's explicit
    ``(pad, pad)``."""

    def __init__(self, cin: int, cout: int, k: int, gen: torch.Generator,
                 stride: int = 1, num_groups: Optional[int] = None,
                 act: Optional[str] = None):
        super().__init__()
        if act not in (None, "relu"):
            raise NotImplementedError(f"activation {act!r} is not ported")
        self.conv = make_conv(cin, cout, k, stride, (k - 1) // 2,
                              bias=num_groups is None, gen=gen)
        self.norm = nn.GroupNorm(num_groups, cout, eps=1e-5) if num_groups else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.act == "relu":
            x = F.relu(x)
        return x


class Scale(nn.Module):
    """Learnable scalar multiplier (mmcv ``Scale``)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """Max pool with ``-inf`` padding of ``padding`` on each side."""
    return F.max_pool2d(x, window, stride, padding)


def bilinear_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest-neighbour resize of an NCHW tensor with half-pixel centres,
    as ``jax.image.resize(..., "nearest")`` (the FPN top-down upsample)."""
    return F.interpolate(x, size=tuple(out_hw), mode="nearest-exact")
