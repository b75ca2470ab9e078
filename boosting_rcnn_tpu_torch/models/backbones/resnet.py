"""ResNet backbone (PyTorch port of ``boosting_rcnn_tpu/models/backbones/resnet.py``).

Depths 18 (``BasicBlock``) and 50 (``Bottleneck``), ``style='pytorch'``
(stride on the 3x3), frozen BN.  The JAX package computes the 7x7/s2 stem
as a space-to-depth 4x4 conv (``_S2DStemConv``), a TPU-only exact rewrite;
here it is the plain 7x7/s2 conv over the same (7, 7, 3, F) weights.
Submodule names follow the JAX package's (``conv1``, ``bn1``,
``layer{s}_{b}``, ``downsample_conv``) so weights map one to one.
``frozen_stages`` only matters for training and is not consumed here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import FrozenBatchNorm, make_conv, max_pool

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    50: ("bottleneck", (3, 4, 6, 3)),
}


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int, downsample: bool,
                 gen: torch.Generator):
        super().__init__()
        self.conv1 = make_conv(cin, planes, 3, stride, 1, False, gen)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = make_conv(planes, planes, 3, 1, 1, False, gen)
        self.bn2 = FrozenBatchNorm(planes)
        if downsample:
            self.downsample_conv = make_conv(cin, planes, 1, stride, 0, False, gen)
            self.downsample_bn = FrozenBatchNorm(planes)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int, downsample: bool,
                 gen: torch.Generator):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = make_conv(cin, planes, 1, 1, 0, False, gen)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = make_conv(planes, planes, 3, stride, 1, False, gen)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = make_conv(planes, out, 1, 1, 0, False, gen)
        self.bn3 = FrozenBatchNorm(out)
        if downsample:
            self.downsample_conv = make_conv(cin, out, 1, stride, 0, False, gen)
            self.downsample_bn = FrozenBatchNorm(out)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + identity)


class ResNet(nn.Module):
    """NCHW images -> the outputs of the four stages C2-C5 (NCHW), stage
    strides (1, 2, 2, 2)."""

    def __init__(self, gen: torch.Generator, depth: int = 50, base_channels: int = 64):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise NotImplementedError(f"ResNet depth {depth} is not ported")
        kind, blocks = ARCH_SETTINGS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = make_conv(3, base_channels, 7, 2, 3, False, gen)
        self.bn1 = FrozenBatchNorm(base_channels)
        self.stage_names = []
        cin, planes = base_channels, base_channels
        for stage, n_blocks in enumerate(blocks):
            names = []
            for b in range(n_blocks):
                stride = 2 if b == 0 and stage > 0 else 1
                out = planes * block.expansion
                down = b == 0 and (stride != 1 or cin != out)
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, block(cin, planes, stride, down, gen))
                names.append(name)
                cin = out
            self.stage_names.append(names)
            planes *= 2

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool(x, 3, 2, 1)
        outs = []
        for names in self.stage_names:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return tuple(outs)
