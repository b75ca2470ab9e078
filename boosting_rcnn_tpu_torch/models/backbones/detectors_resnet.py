"""DetectoRS's ResNet (PyTorch port of
``boosting_rcnn_tpu/models/backbones/detectors_resnet.py``; reference
mmdet ``backbones/detectors_resnet.py`` and mmcv ``SAConv2d``).

``SAConv``, Switchable Atrous Convolution: one 3x3 weight, standardised
as ``gamma * (w - mean) / (std + 1e-5) + beta`` with the mean and the
*biased* std over each filter's (cin, kh, kw) (the JAX module's form, not
``sqrt(var + eps)`` and not ConvWS's), run at dilation 1 and, with the
zero-initialised ``weight_diff`` added, at dilation 3; a 1x1 ``switch``
conv (zero kernel, bias 1) on a 5x5 average pool of the input (padding
counted, at the conv's stride; ``switch_pool``) blends the two through a
sigmoid (``losses.sigmoid``: JAX's roundings in bfloat16).  A
zero-initialised 1x1 ``pre_context`` of the input's spatial mean is added
to the input before the switch and both convs, and a ``post_context`` of
the output's mean to the output.  The configs' ``use_deform=True`` is not
read: mmcv's SAConv2d adds a zero-initialised deformable offset conv to
each branch, the JAX module runs two plain dilated convs, and the port
copies the JAX module (ROADMAP C.5).

``DetBottleneck``: the ResNet bottleneck (``down_conv`` / ``down_bn`` on
its shortcut) with its 3x3 an ``SAConv`` in the stages of
``sac_stages``; the first block of stages 2-4 of a feedback backbone
(``rfp_inplanes`` set) takes the RFP's map through a zero-initialised
1x1 ``rfp_conv`` (with a bias), added after the residual and before the
ReLU.

``DetectoRSResNet``: the 7x7 stem, the 3x3 / stride-2 max pool and the
four stages of depth 50 or 101; ``output_img`` puts the image in front of
the outputs (the RFP neck's input); ``forward(x, rfp_feats)`` routes
``rfp_feats[1:4]`` to stages 2-4.  The activations are detached after the
stem and after each frozen stage, as the JAX module's ``stop_gradient``
does; ``freeze`` also takes those parameters out of training
(``requires_grad=False``), as the JAX optimizer masks them under
``backbone``.  The RFP's own feedback backbone is built with ``freeze``
off: the JAX mask (``engine/train.py::frozen_stages_mask``) reads only
the parameters directly under ``backbone``, so those under
``neck/rfp_backbone`` get a zero gradient but weight decay and momentum
still move them (ROADMAP C.5).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.losses import sigmoid
from ..layers import Conv2d, avg_pool, lecun_normal_, make_conv, max_pool
from .resnet import make_bn

__all__ = ["DEPTH_BLOCKS", "SAConv", "DetBottleneck", "DetectoRSResNet"]

DEPTH_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def _zero_conv(cin: int, cout: int, gen: torch.Generator, bias_value: float = 0.0) -> Conv2d:
    conv = make_conv(cin, cout, 1, 1, 0, True, gen, bias_value=bias_value)
    nn.init.zeros_(conv.weight)
    return conv


def switch_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """The switch's 5x5 average pool at ``stride``, padding 2 counted: in
    float32 ``layers.avg_pool``; in a narrower dtype the 25 taps added one
    after another in that dtype, row by row, then divided by 25, as flax's
    ``avg_pool`` (a ``reduce_window`` sum) rounds on the CPU
    (``F.avg_pool2d`` sums in float32 and rounds once: 70% of its bfloat16
    values differ from the JAX package's by an ulp)."""
    if x.dtype == torch.float32:
        return avg_pool(x, 5, stride, 2)
    xp = F.pad(x, (2, 2, 2, 2))
    h, w = (x.shape[2] - 1) // stride + 1, (x.shape[3] - 1) // stride + 1
    acc = None
    for dy in range(5):
        for dx in range(5):
            tap = xp[:, :, dy:dy + stride * (h - 1) + 1:stride, dx:dx + stride * (w - 1) + 1:stride]
            acc = tap if acc is None else acc + tap
    return acc / 25


def _spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over H and W, summed in float32 and cast back (``jnp.mean``)."""
    return x.float().mean((2, 3), keepdim=True).to(x.dtype)


class SAConv(Conv2d):
    """Switchable Atrous Conv (JAX ``SAConv``): ``weight`` (He-normal),
    ``aws_gamma`` / ``aws_beta`` ``(C, 1, 1, 1)`` (seeded as each filter's
    std and mean, where the JAX module starts at ones and zeros),
    ``weight_diff`` (zeros) and the 1x1 ``pre_context``, ``switch`` and
    ``post_context`` convs.
    Both dilated convs run in ``compute_dtype`` on the standardised float32
    weight cast to it; the blend in the input's dtype."""

    def __init__(self, cin: int, channels: int, stride: int, gen: torch.Generator):
        super().__init__(cin, channels, 3, stride, 1, bias=False)
        lecun_normal_(self.weight, cin * 9 / 2.0, gen)  # flax he_normal
        # the seeded model's standardisation returns the seeded weight, as
        # mmcv's SAConv2d sets it on loading a plain conv's weight (the JAX
        # module's ones and zeros make a random model's activations grow by
        # sqrt(9 * cin / 2) a SAC block; every weight the tests and users
        # load carries its own)
        with torch.no_grad():
            w = self.weight
            self.aws_gamma = nn.Parameter(w.std((1, 2, 3), keepdim=True, unbiased=False) + 1e-5)
            self.aws_beta = nn.Parameter(w.mean((1, 2, 3), keepdim=True))
        self.weight_diff = nn.Parameter(torch.zeros_like(self.weight))
        self.pre_context = _zero_conv(cin, cin, gen)
        self.switch = _zero_conv(cin, 1, gen, bias_value=1.0)
        self.post_context = _zero_conv(channels, channels, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        mean = w.mean((1, 2, 3), keepdim=True)
        std = w.std((1, 2, 3), keepdim=True, unbiased=False) + 1e-5
        w_hat = self.aws_gamma * (w - mean) / std + self.aws_beta
        x = x + self.pre_context(_spatial_mean(x))
        switch = sigmoid(self.switch(switch_pool(x, self.stride[0])))
        dt = self.compute_dtype
        xs = x.to(dt)

        def conv(weight, dilation):
            return F.conv2d(xs, weight.to(dt), None, self.stride, dilation, dilation)

        out = switch * conv(w_hat, 1) + (1 - switch) * conv(w_hat + self.weight_diff, 3)
        return out + self.post_context(_spatial_mean(out))


class DetBottleneck(nn.Module):
    """JAX ``DetBottleneck``: ``conv1`` 1x1, ``bn1``, ReLU, ``conv2`` (3x3 at
    ``stride``, or an ``SAConv``), ``bn2``, ReLU, ``conv3`` 1x1 to ``4 *
    planes``, ``bn3``; the shortcut ``down_conv`` / ``down_bn`` where the
    stride or the width changes; ``rfp_conv`` (from ``rfp_inplanes``
    channels) on the feedback map."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int, gen: torch.Generator,
                 sac: bool = False, rfp_inplanes: Optional[int] = None, live: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = make_conv(cin, planes, 1, 1, 0, False, gen)
        self.bn1 = make_bn(planes, live)
        self.conv2 = (SAConv(planes, planes, stride, gen) if sac
                      else make_conv(planes, planes, 3, stride, 1, False, gen))
        self.bn2 = make_bn(planes, live)
        self.conv3 = make_conv(planes, out, 1, 1, 0, False, gen)
        self.bn3 = make_bn(out, live)
        self.down_conv = None
        if stride != 1 or cin != out:
            self.down_conv = make_conv(cin, out, 1, stride, 0, False, gen)
            self.down_bn = make_bn(out, live)
        self.rfp_conv = _zero_conv(rfp_inplanes, out, gen) if rfp_inplanes else None

    def forward(self, x, rfp_feat=None):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        out = y + identity
        if self.rfp_conv is not None and rfp_feat is not None:
            out = out + self.rfp_conv(rfp_feat)
        return F.relu(out)


class DetectoRSResNet(nn.Module):
    """NCHW images -> the outputs of the stages in ``out_indices`` (with
    the image in front for ``output_img``); ``rfp_inplanes`` gives stages
    2-4's first blocks their ``rfp_conv`` (the RFP's feedback backbone)."""

    def __init__(self, gen: torch.Generator, depth: int = 50, base_channels: int = 64,
                 sac_stages: Sequence[bool] = (False, True, True, True),
                 out_indices: Sequence[int] = (0, 1, 2, 3), frozen_stages: int = 1,
                 norm_eval: bool = True, output_img: bool = False,
                 rfp_inplanes: Optional[int] = None, freeze: bool = True):
        super().__init__()
        if depth not in DEPTH_BLOCKS:
            raise NotImplementedError(f"DetectoRS_ResNet depth {depth} is not ported")
        live = not norm_eval
        self.out_indices, self.frozen_stages = tuple(out_indices), frozen_stages
        self.output_img = output_img
        self.conv1 = make_conv(3, base_channels, 7, 2, 3, False, gen)
        self.bn1 = make_bn(base_channels, live)
        self.stage_names, channels, cin = [], [], base_channels
        for si, n_blocks in enumerate(DEPTH_BLOCKS[depth]):
            planes = base_channels * 2 ** si
            names = []
            for b in range(n_blocks):
                name = f"layer{si + 1}_{b}"
                self.add_module(name, DetBottleneck(
                    cin, planes, 2 if (b == 0 and si > 0) else 1, gen, sac=sac_stages[si],
                    rfp_inplanes=rfp_inplanes if (b == 0 and si > 0) else None, live=live))
                names.append(name)
                cin = planes * DetBottleneck.expansion
            self.stage_names.append(names)
            channels.append(cin)
        self.out_channels = tuple(channels[i] for i in self.out_indices)
        if freeze:
            frozen = [self.conv1, self.bn1] if frozen_stages >= 0 else []
            for names in self.stage_names[:max(frozen_stages, 0)]:
                frozen += [getattr(self, name) for name in names]
            for module in frozen:
                module.requires_grad_(False)

    def forward(self, x, rfp_feats=None):
        img = x
        y = max_pool(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        if self.frozen_stages >= 0:
            y = y.detach()
        outs = []
        for si, names in enumerate(self.stage_names):
            feat = rfp_feats[si] if rfp_feats is not None and si > 0 else None
            for b, name in enumerate(names):
                y = getattr(self, name)(y, feat if b == 0 else None)
            if si + 1 <= self.frozen_stages:
                y = y.detach()
            if si in self.out_indices:
                outs.append(y)
        return ((img,) if self.output_img else ()) + tuple(outs)
