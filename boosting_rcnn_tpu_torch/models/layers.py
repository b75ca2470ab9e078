"""Shared building blocks (PyTorch port of ``boosting_rcnn_tpu/models/layers.py``).

Modules compute on NCHW tensors.  Parameter initialisation follows the JAX
package's flax defaults so that a seeded random model behaves alike:
LeCun-normal (truncated) conv and dense kernels, zero biases, unit norm
scales.  Every initialiser draws from an explicit ``torch.Generator``.

The compute dtype is flax's policy, written out as explicit casts (no
``torch.autocast``, which decides per op): parameters stay float32; each
``Conv2d``, ``ConvTranspose2d`` and ``Linear`` casts its input, weight
and bias to its ``compute_dtype`` at the call (flax ``promote_dtype``),
which ``set_compute_dtype`` sets for a whole network; the other modules follow
their input's dtype, with their float32 parameters or statistics cast to
it (``FrozenBatchNorm``, ``Scale``) or their arithmetic done in float32 and
cast back once (GroupNorm in ``ConvModule``).  In float32 every cast is a
no-op.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "Conv2d",
    "ConvTranspose2d",
    "make_conv_transpose",
    "Linear",
    "set_compute_dtype",
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


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with float32 parameters that computes in
    ``compute_dtype``: the input, the weight and the bias are cast to it at
    each call (flax ``nn.Conv(dtype=...)``); autograd gives the float32
    parameters float32 gradients through the casts.  In a narrower dtype
    the bias is added to the rounded convolution as a second rounded op, as
    flax adds it (``y += bias``); in float32 the convolution takes it."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return self._conv_forward(x, self.weight, self.bias)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with float32 parameters that computes in
    ``compute_dtype``, cast and with the bias added as ``Conv2d`` does
    (flax ``nn.ConvTranspose(dtype=...)``).  Its weight is ``(in, out, kh,
    kw)``; flax's kernel ``(kh, kw, in, out)`` maps to it with the spatial
    taps flipped (``weights.py``: flax's transpose without
    ``transpose_kernel`` is a fractionally strided convolution, PyTorch's
    the gradient of a convolution)."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return F.conv_transpose2d(x, self.weight, self.bias, self.stride, self.padding)
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class Linear(nn.Linear):
    """``nn.Linear`` with float32 parameters that computes in
    ``compute_dtype``, cast as ``Conv2d`` casts, the bias added as
    ``Conv2d`` adds it (flax ``nn.Dense(dtype=...)``)."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return F.linear(x, self.weight, self.bias)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Make every ``Conv2d``, ``ConvTranspose2d`` and ``Linear`` inside
    ``module`` compute in ``dtype``; the parameters keep their float32."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear)):
            m.compute_dtype = dtype


def make_conv(cin: int, cout: int, k: int, stride: int, pad: int, bias: bool,
              gen: torch.Generator, bias_value: float = 0.0) -> Conv2d:
    conv = Conv2d(cin, cout, k, stride, pad, bias=bias)
    lecun_normal_(conv.weight, cin * k * k, gen)
    if bias:
        nn.init.constant_(conv.bias, bias_value)
    return conv


def make_conv_transpose(cin: int, cout: int, k: int, stride: int,
                        gen: torch.Generator) -> ConvTranspose2d:
    """A ``k x k`` transposed convolution with a bias, LeCun-normal over
    the fan-in ``cin * k * k`` (flax ``nn.ConvTranspose``'s default)."""
    conv = ConvTranspose2d(cin, cout, k, stride)
    lecun_normal_(conv.weight, cin * k * k, gen)
    nn.init.zeros_(conv.bias)
    return conv


def make_linear(cin: int, cout: int, gen: torch.Generator) -> Linear:
    fc = Linear(cin, cout)
    lecun_normal_(fc.weight, cin, gen)
    nn.init.zeros_(fc.bias)
    return fc


class FrozenBatchNorm(nn.Module):
    """BatchNorm in permanent eval mode (``norm_eval=True``), eps 1e-5:
    ``x * weight / sqrt(var + eps) + bias - mean * weight / sqrt(var + eps)``.
    The scale and shift are folded in float32 and cast to ``x.dtype``, then
    applied in it (JAX ``layers.py:56-62``)."""

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
        return x * inv.to(x.dtype)[None, :, None, None] + shift.to(x.dtype)[None, :, None, None]


class ConvModule(nn.Module):
    """conv + optional GroupNorm (eps 1e-5) + optional ReLU (mmcv
    ``ConvModule``); the conv has a bias only when there is no norm.
    Padding is ``(k - 1) // 2`` on each side, as the JAX module's explicit
    ``(pad, pad)``.  GroupNorm computes its statistics and affine map in
    float32 and casts the result once to the input's dtype (flax
    ``GroupNorm``: ``force_float32_reductions``, ``_normalize``)."""

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
            n = self.norm
            x = F.group_norm(x.float(), n.num_groups, n.weight, n.bias, n.eps).to(x.dtype)
        if self.act == "relu":
            x = F.relu(x)
        return x


class Scale(nn.Module):
    """Learnable scalar multiplier (mmcv ``Scale``), cast to ``x.dtype``
    (JAX ``layers.py:276-278``)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """Max pool with ``-inf`` padding of ``padding`` on each side, in the
    input's dtype."""
    return F.max_pool2d(x, window, stride, padding)


def bilinear_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest-neighbour resize of an NCHW tensor with half-pixel centres,
    as ``jax.image.resize(..., "nearest")`` (the FPN top-down upsample), in
    the input's dtype."""
    return F.interpolate(x, size=tuple(out_hw), mode="nearest-exact")
