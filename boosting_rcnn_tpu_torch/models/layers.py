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
cast back once (``LiveBatchNorm``, ``GroupNorm``, ``LayerNorm``).  In
float32 every cast is a no-op.

``LiveBatchNorm`` is the norm that trains (the JAX ``LiveBatchNorm``, flax
``nn.BatchNorm``): in ``train()`` mode it normalises by the batch's
statistics and moves its running averages, in ``eval()`` mode it uses the
running averages.  The detectors keep their networks in ``eval()``; the
train step switches them to ``train()`` for its loss forward, as the JAX
step applies the net with a mutable ``batch_stats`` there.  Under
data-parallel training it is SyncBN: the batch mean and ``E[x^2]`` are
averaged over the ranks (with their gradient) before the variance, as
the JAX step's global batch gives them, and the running averages move by
the global statistics.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.deform_conv import deform_conv2d, split_modulated_offset
from ..parallel.mesh import differentiable_mean

__all__ = [
    "Conv2d",
    "ConvTranspose2d",
    "make_conv_transpose",
    "Linear",
    "set_compute_dtype",
    "FrozenBatchNorm",
    "LiveBatchNorm",
    "GroupNorm",
    "LayerNorm",
    "BN_TYPES",
    "make_norm",
    "make_conv_cfg",
    "ConvModule",
    "Scale",
    "DeformConv",
    "lecun_normal_",
    "make_conv",
    "make_linear",
    "max_pool",
    "avg_pool",
    "nearest_resize",
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
        return self.cast_conv(x, self.weight)

    def cast_conv(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """The convolution of ``x`` by ``weight`` (float32) and the bias,
        in ``compute_dtype``."""
        dt = self.compute_dtype
        if dt == torch.float32:
            return self._conv_forward(x, weight, self.bias)
        y = self._conv_forward(x.to(dt), weight.to(dt), None)
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
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Make every ``Conv2d``, ``ConvTranspose2d``, ``Linear`` and
    ``DeformConv`` inside ``module`` compute in ``dtype``; the parameters
    keep their float32."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear, DeformConv)):
            m.compute_dtype = dtype


def make_conv(cin: int, cout: int, k: int, stride: int, pad: int, bias: bool,
              gen: torch.Generator, bias_value: float = 0.0, groups: int = 1,
              dilation: int = 1) -> Conv2d:
    """A ``k x k`` convolution, LeCun-normal over its fan-in ``cin / groups
    * k * k`` (flax ``nn.Conv(feature_group_count=groups,
    kernel_dilation=dilation)``)."""
    conv = Conv2d(cin, cout, k, stride, pad, dilation=dilation, bias=bias, groups=groups)
    lecun_normal_(conv.weight, cin // groups * k * k, gen)
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


def make_linear(cin: int, cout: int, gen: torch.Generator, bias: bool = True) -> Linear:
    fc = Linear(cin, cout, bias=bias)
    lecun_normal_(fc.weight, cin, gen)
    if bias:
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


def _normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, eps: float, shape=(-1, 1, 1)) -> torch.Tensor:
    """``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in float32 on an
    NCHW ``x`` (channels-last with ``shape`` ``(-1,)``), the statistics
    broadcastable against it, cast once to ``x.dtype`` (flax ``_normalize``)."""
    mul = torch.rsqrt(var + eps) * weight.reshape(shape)
    return ((x.float() - mean) * mul + bias.reshape(shape)).to(x.dtype)


def _fast_stats(x: torch.Tensor, dims):
    """Float32 mean and biased variance over ``dims`` (kept as size-1 dims)
    as ``E[x^2] - E[x]^2``, clipped at 0 (flax ``_compute_stats`` with
    ``use_fast_variance``)."""
    xf = x.float()
    mean = xf.mean(dims, keepdim=True)
    return mean, torch.clamp((xf * xf).mean(dims, keepdim=True) - mean * mean, min=0.0)


class LiveBatchNorm(nn.Module):
    """BatchNorm with live statistics, eps 1e-5 (JAX ``layers.py:65-89``,
    flax ``nn.BatchNorm`` with momentum 0.9).  In ``train()`` mode it
    normalises by the batch's float32 mean and biased variance (``E[x^2] -
    E[x]^2``) over N, H and W, and moves ``running_mean`` / ``running_var``
    to ``0.9 * old + 0.1 * batch`` (the biased variance, where
    ``torch.nn.BatchNorm2d`` keeps the unbiased one); in ``eval()`` mode
    it normalises by the running averages.  The affine map is float32 and
    the result is cast once to the input's dtype.  The running statistics
    are buffers, so the ``state_dict`` and every checkpoint carry them."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            # SyncBN: the mean and E[x^2] over the data-parallel ranks' global
            # batch (equal shapes on every rank; the identity for one process)
            xf = x.float()
            mean = differentiable_mean(xf.mean((0, 2, 3), keepdim=True))
            ex2 = differentiable_mean((xf * xf).mean((0, 2, 3), keepdim=True))
            var = torch.clamp(ex2 - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean.flatten())
                self.running_var.copy_(m * self.running_var + (1 - m) * var.flatten())
        else:
            mean = self.running_mean[:, None, None]
            var = self.running_var[:, None, None]
        return _normalize(x, mean, var, self.weight, self.bias, self.eps)


class GroupNorm(nn.GroupNorm):
    """GroupNorm (eps 1e-5, the JAX package's torch eps) as flax's
    ``GroupNorm``: each sample's group statistics in float32 as ``E[x^2] -
    E[x]^2`` (``use_fast_variance``), the affine map in float32, the result
    cast once to the input's dtype (``force_float32_reductions``,
    ``_normalize``).  The fast variance is what holds the GN backbones' and
    heads' gradients to the JAX package's through ResNet-50 (the two-pass
    variance rounds otherwise).  With ``fast_variance`` False it is one
    fused ``F.group_norm`` on the float32 input, cast once: the ATSS RPN's
    form, which its parity tests hold and which costs a third of the fast
    form's passes (its four GN convs a level run on every predict)."""

    fast_variance = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fast_variance:
            return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                                self.eps).to(x.dtype)
        n, c = x.shape[:2]
        mean, var = _fast_stats(x.reshape(n, self.num_groups, -1), 2)
        size = c // self.num_groups
        mean, var = (t.repeat_interleave(size, 1).reshape(n, c, *([1] * (x.dim() - 2)))
                     for t in (mean, var))
        return _normalize(x, mean, var, self.weight, self.bias, self.eps)


class LayerNorm(nn.Module):
    """LayerNorm over the channels of an NCHW map, eps 1e-6 (flax
    ``nn.LayerNorm``'s default, over its last axis: a ContextBlock's
    ``[planes, 1, 1]`` and a ConvModule's ``LN``), each pixel on its own: float32 statistics as
    ``E[x^2] - E[x]^2`` and affine map, cast once to the input's dtype.
    With ``channels_last`` over the last axis (Swin's tokens)."""

    def __init__(self, channels: int, eps: float = 1e-6, channels_last: bool = False):
        super().__init__()
        self.eps = eps
        self.dim, self.shape = (-1, (-1,)) if channels_last else (1, (-1, 1, 1))
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = _fast_stats(x, self.dim)
        return _normalize(x, mean, var, self.weight, self.bias, self.eps, self.shape)


BN_TYPES = ("BN", "SyncBN", "FrozenBN")


def make_norm(norm_cfg: Optional[dict], channels: int) -> Optional[nn.Module]:
    """The norm of a ``norm_cfg`` inside a ``ConvModule`` (JAX
    ``layers.py:114-131``): BN, SyncBN and FrozenBN are a ``FrozenBatchNorm``
    there (only a backbone's BN lives, ``backbones/resnet.py``), GN a
    ``GroupNorm`` of ``num_groups`` (default 32) with eps 1e-5, LN a
    ``LayerNorm`` over the channels; None gives None."""
    if norm_cfg is None:
        return None
    kind = norm_cfg.get("type")
    if kind in BN_TYPES:
        return FrozenBatchNorm(channels)
    if kind == "GN":
        return GroupNorm(norm_cfg.get("num_groups", 32), channels, eps=1e-5)
    if kind == "LN":
        return LayerNorm(channels)
    raise NotImplementedError(f"norm_cfg type={kind!r} is not ported to PyTorch yet")


def make_conv_cfg(conv_cfg: Optional[dict], cin: int, cout: int, k: int, stride: int, pad: int,
                  bias: bool, gen: torch.Generator, groups: int = 1,
                  dilation: int = 1) -> Conv2d:
    """``make_conv``, or its weight-standardised form for a ``ConvWS``
    ``conv_cfg`` (JAX ``backbones/resnet.py:48-57``); any other type
    raises."""
    if conv_cfg is None:
        return make_conv(cin, cout, k, stride, pad, bias, gen, groups=groups, dilation=dilation)
    if conv_cfg.get("type") != "ConvWS":
        raise NotImplementedError(
            f"conv_cfg type={conv_cfg.get('type')!r} is not ported to PyTorch yet")
    from .plugins import make_ws_conv

    return make_ws_conv(cin, cout, k, stride, pad, bias, gen, groups=groups, dilation=dilation)


class ConvModule(nn.Module):
    """conv + optional norm + optional ReLU (mmcv ``ConvModule``, JAX
    ``layers.py:134-191``); the conv has a bias only when there is no norm.
    Padding is ``dilation * (k - 1) // 2`` on each side, as the JAX module's
    explicit ``(pad, pad)``.  ``conv_cfg`` ``ConvWS`` makes the conv weight-standardised;
    ``norm_cfg`` picks the norm (``make_norm``: GN, LN, or BN as a frozen
    BN).  ``act`` defaults to None here, where the JAX module's defaults to
    ``"relu"``: callers name it."""

    def __init__(self, cin: int, cout: int, k: int, gen: torch.Generator,
                 stride: int = 1, norm_cfg: Optional[dict] = None,
                 act: Optional[str] = None, conv_cfg: Optional[dict] = None,
                 dilation: int = 1):
        super().__init__()
        if act not in (None, "relu"):
            raise NotImplementedError(f"activation {act!r} is not ported")
        self.conv = make_conv_cfg(conv_cfg, cin, cout, k, stride, dilation * (k - 1) // 2,
                                  norm_cfg is None, gen, dilation=dilation)
        self.norm = make_norm(norm_cfg, cout)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.act == "relu":
            x = F.relu(x)
        return x


class DeformConv(nn.Module):
    """Deformable convolution v1 / v2, undilated and without bias (mmcv
    ``DeformConv2dPack`` / ``ModulatedDeformConv2dPack``; JAX
    ``layers.py:194-262``): a
    zero-initialised ``conv_offset`` (a ``k x k`` conv with a bias, in the
    compute dtype) predicts the per-tap offsets, interleaved (dy, dx) per
    tap, and for v2 the modulation logits, passed through the sigmoid; then
    ``ops.deform_conv.deform_conv2d`` samples and contracts.  Zero offsets
    make it the plain convolution.  ``weight`` is ``(Cout, Cin, k, k)``,
    LeCun-normal over ``Cin * k * k``; ``compute_dtype`` is the dtype of
    the sampling and of the contraction's one rounding, the parameters stay
    float32."""

    compute_dtype = torch.float32

    def __init__(self, cin: int, cout: int, k: int, stride: int, gen: torch.Generator,
                 deform_groups: int = 1, modulated: bool = False):
        super().__init__()
        self.k, self.stride, self.pad = k, stride, (k - 1) // 2
        self.deform_groups, self.modulated = deform_groups, modulated
        off_ch = deform_groups * (3 if modulated else 2) * k * k
        self.conv_offset = Conv2d(cin, off_ch, k, stride, self.pad)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        lecun_normal_(self.weight, cin * k * k, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        raw = self.conv_offset(x)
        if self.modulated:
            offset, mask = split_modulated_offset(raw, self.deform_groups, self.k * self.k)
        else:
            offset, mask = raw, None
        return deform_conv2d(x, offset, self.weight.to(dt), mask=mask, stride=self.stride,
                             padding=self.pad, deform_groups=self.deform_groups)


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


def avg_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """Average pool counting the padding (flax ``avg_pool``'s and
    ``F.avg_pool2d``'s default) of a contiguous NCHW copy: on a
    channels-last map (cuDNN's convolutions give them on the card) the CUDA
    ``avg_pool2d`` backward of PyTorch 2.11 gives wrong gradients
    (``backbones/res2net.py``, ``tests/test_torch_cuda.py``)."""
    return F.avg_pool2d(x.contiguous(), window, stride, padding)


def nearest_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest-neighbour resize of an NCHW tensor with half-pixel centres,
    as ``jax.image.resize(..., "nearest")`` (the FPN top-down upsample, the
    JAX package's ``bilinear_resize``, which is this despite its name; the
    HRNet fusion), in the input's dtype.  It equals PyTorch's ``"nearest"``
    only at integer ratios."""
    return F.interpolate(x, size=tuple(out_hw), mode="nearest-exact")


def _linear_weights(n_out: int, n_in: int, device, dtype) -> torch.Tensor:
    """``(n_out, n_in)`` weights of a linear upsampling with half-pixel
    centres along one axis, computed in float64 on ``device`` (no host copy,
    no sync) and cast to ``dtype``: output i samples input ``(i + 0.5) *
    n_in / n_out - 0.5``, clamped at 0, between its two neighbours (the
    last input repeated past the end)."""
    f64 = dict(device=device, dtype=torch.float64)
    src = ((torch.arange(n_out, **f64) + 0.5) * (n_in / n_out) - 0.5).clamp(min=0)
    lo = src.floor().clamp(max=n_in - 1)
    hi = (lo + 1).clamp(max=n_in - 1)
    frac = (src - lo)[:, None]
    cols = torch.arange(n_in, **f64)
    return ((1 - frac) * (cols == lo[:, None]) + frac * (cols == hi[:, None])).to(dtype)


def bilinear_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear upsampling of an NCHW tensor with half-pixel centres, as
    ``jax.image.resize(..., "bilinear")`` where it only upsamples (HRFPN):
    there its triangle kernel's weights, renormalised at the borders, are
    ``F.interpolate``'s with ``align_corners=False``.  It is applied as
    JAX's is, one axis after the other, and as two products with those
    weights in the input's dtype: ``F.interpolate``'s CUDA backward adds
    with atomics, and the train step must repeat bit for bit (ROADMAP C.2).
    A smaller output raises: JAX antialiases a downsampling."""
    (h, w), (hi, wi) = tuple(out_hw), x.shape[-2:]
    if h < hi or w < wi:
        raise ValueError(f"bilinear_resize upsamples only: {(hi, wi)} to {(h, w)}")
    ww = _linear_weights(w, wi, x.device, x.dtype)
    wh = _linear_weights(h, hi, x.device, x.dtype)
    return torch.matmul(wh, torch.matmul(x, ww.t()))
