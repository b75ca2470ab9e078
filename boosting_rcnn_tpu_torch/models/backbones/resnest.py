"""ResNeSt backbone (PyTorch port of ``boosting_rcnn_tpu/models/backbones/resnest.py``;
reference ``mmdet/models/backbones/resnest.py``): the ResNet-V1d deep stem
(three 3x3 convs, half, half and full ``stem_channels``, then a 3x3 /
stride-2 max pool), split-attention bottlenecks whose stride is a 3x3
average pool after the split attention (padding counted, flax
``avg_pool``'s and ``F.avg_pool2d``'s default) and whose shortcut pools
first (``avg_down``: a stride x stride pool without padding).

``SplitAttentionConv``: a 3x3 conv of ``radix`` groups to ``radix *
channels``, BN, ReLU; the splits summed and averaged over the map, ``fc1``
(1x1 to ``max(in * radix // 4, 32)``, with a bias), BN, ReLU, ``fc2`` (to
``radix * channels``); with ``radix`` > 1 a softmax over the splits on the
(radix, channels) layout, channel ``r * channels + j``, and the splits
weighted and summed; with ``radix`` 1 a sigmoid gate.  BN frozen, or live
with ``norm_eval=False`` (the ``syncbn`` configs); ``frozen_stages`` as the
port's ResNet (the stem's parameters are ``stem_conv{i}`` / ``stem_bn{i}``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import avg_pool, make_conv, max_pool
from .resnet import make_bn

__all__ = ["DEPTH_BLOCKS", "SplitAttentionConv", "SplAtBottleneck", "ResNeSt"]

DEPTH_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 200: (3, 24, 36, 3)}


class SplitAttentionConv(nn.Module):
    """JAX ``SplitAttentionConv`` (``conv``, ``bn0``, ``fc1``, ``bn1``,
    ``fc2``), at stride 1 as the bottleneck uses it."""

    def __init__(self, cin: int, channels: int, gen: torch.Generator, radix: int = 2,
                 reduction_factor: int = 4, live: bool = False):
        super().__init__()
        self.channels, self.radix = channels, radix
        inter = max(cin * radix // reduction_factor, 32)
        self.conv = make_conv(cin, channels * radix, 3, 1, 1, False, gen, groups=radix)
        self.bn0 = make_bn(channels * radix, live)
        self.fc1 = make_conv(channels, inter, 1, 1, 0, True, gen)
        self.bn1 = make_bn(inter, live)
        self.fc2 = make_conv(inter, channels * radix, 1, 1, 0, True, gen)

    def forward(self, x):
        c, r = self.channels, self.radix
        y = F.relu(self.bn0(self.conv(x)))
        b, _, h, w = y.shape
        splits = y.reshape(b, r, c, h, w)
        gap = splits.sum(1).float().mean((2, 3), keepdim=True).to(y.dtype)
        gap = F.relu(self.bn1(self.fc1(gap)))
        atten = self.fc2(gap)
        if r > 1:
            atten = torch.softmax(atten.float().reshape(b, r, c, 1, 1), dim=1).to(atten.dtype)
            return (atten * splits).sum(1)
        return torch.sigmoid(atten) * y


class SplAtBottleneck(nn.Module):
    """JAX ``SplAtBottleneck``: ``conv1`` 1x1, ``bn1``, ReLU, the split
    attention (``conv2``), the 3x3 average pool at ``stride`` > 1,
    ``conv3`` 1x1 to ``4 * planes``, ``bn3``; the shortcut (where the stride
    or the width changes) a ``stride`` pool, ``down_conv``, ``down_bn``."""

    def __init__(self, cin: int, planes: int, stride: int, gen: torch.Generator,
                 radix: int = 2, live: bool = False):
        super().__init__()
        out = planes * 4
        self.stride = stride
        self.conv1 = make_conv(cin, planes, 1, 1, 0, False, gen)
        self.bn1 = make_bn(planes, live)
        self.conv2 = SplitAttentionConv(planes, planes, gen, radix=radix, live=live)
        self.conv3 = make_conv(planes, out, 1, 1, 0, False, gen)
        self.bn3 = make_bn(out, live)
        if stride != 1 or cin != out:
            self.down_conv = make_conv(cin, out, 1, 1, 0, False, gen)
            self.down_bn = make_bn(out, live)
        else:
            self.down_conv = None

    def forward(self, x):
        y = self.conv2(F.relu(self.bn1(self.conv1(x))))
        if self.stride > 1:
            y = avg_pool(y, 3, self.stride, 1)
        y = self.bn3(self.conv3(y))
        identity = x
        if self.down_conv is not None:
            if self.stride != 1:
                identity = avg_pool(identity, self.stride, self.stride)
            identity = self.down_bn(self.down_conv(identity))
        return F.relu(y + identity)


class ResNeSt(nn.Module):
    """NCHW images -> the outputs of the stages in ``out_indices``."""

    def __init__(self, gen: torch.Generator, depth: int = 50, radix: int = 2,
                 stem_channels: int = 64, base_channels: int = 64,
                 out_indices: Sequence[int] = (0, 1, 2, 3), frozen_stages: int = 1,
                 norm_eval: bool = True):
        super().__init__()
        if depth not in DEPTH_BLOCKS:
            raise NotImplementedError(f"ResNeSt depth {depth} is not ported")
        live = not norm_eval
        self.out_indices, self.frozen_stages = tuple(out_indices), frozen_stages
        half = stem_channels // 2
        cin, stem = 3, []
        for i, (ch, s) in enumerate(((half, 2), (half, 1), (stem_channels, 1))):
            self.add_module(f"stem_conv{i}", make_conv(cin, ch, 3, s, 1, False, gen))
            self.add_module(f"stem_bn{i}", make_bn(ch, live))
            stem += [getattr(self, f"stem_conv{i}"), getattr(self, f"stem_bn{i}")]
            cin = ch
        self.stage_names, channels = [], []
        for si, n_blocks in enumerate(DEPTH_BLOCKS[depth]):
            planes = base_channels * 2 ** si
            names = []
            for b in range(n_blocks):
                name = f"layer{si + 1}_{b}"
                self.add_module(name, SplAtBottleneck(
                    cin, planes, 2 if (b == 0 and si > 0) else 1, gen, radix, live))
                names.append(name)
                cin = planes * 4
            self.stage_names.append(names)
            channels.append(cin)
        self.out_channels = tuple(channels[i] for i in self.out_indices)
        frozen = stem if frozen_stages >= 0 else []
        for names in self.stage_names[:max(frozen_stages, 0)]:
            frozen += [getattr(self, name) for name in names]
        for module in frozen:
            module.requires_grad_(False)

    def forward(self, x):
        for i in range(3):
            x = F.relu(getattr(self, f"stem_bn{i}")(getattr(self, f"stem_conv{i}")(x)))
        x = max_pool(x, 3, 2, 1)
        if self.frozen_stages >= 0:
            x = x.detach()
        outs = []
        for stage, names in enumerate(self.stage_names):
            for name in names:
                x = getattr(self, name)(x)
            if stage + 1 <= self.frozen_stages:
                x = x.detach()
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)
