"""ResNet backbone (PyTorch port of ``boosting_rcnn_tpu/models/backbones/resnet.py``).

Depths 18 (``BasicBlock``) and 50 (``Bottleneck``), ``style='pytorch'``
(stride on the 3x3), frozen BN.  The JAX package computes the 7x7/s2 stem
as a space-to-depth 4x4 conv (``_S2DStemConv``), a TPU-only exact rewrite;
here it is the plain 7x7/s2 conv over the same (7, 7, 3, F) weights.  In
bfloat16 the JAX stem contracts with ``preferred_element_type=bfloat16``
(``backbones/resnet.py:101-110``): float32 sums, one rounding, as a
bfloat16 convolution here; the tiny flagship's C2-C4 agree with the JAX
package's bit for bit on the CPU (tests/test_torch_bf16.py), and cuDNN's
bfloat16 stem on an H100 gives the CPU's C2-C5 bit for bit too
(``chip_smoke.py``), inside the 2.5% tolerance of those checks.
Submodule names follow the JAX package's (``conv1``, ``bn1``,
``layer{s}_{b}``, ``downsample_conv``) so weights map one to one.
``frozen_stages`` = k freezes the stem and stages 1..k, as the JAX
package does (``resnet.py:320-323``, ``:367-368``): the activations are
detached after the stem and after each frozen stage, so no gradient is
computed there, and those parameters get ``requires_grad=False``, so no
optimizer moves them.
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

    def __init__(self, gen: torch.Generator, depth: int = 50, base_channels: int = 64,
                 frozen_stages: int = -1):
        super().__init__()
        self.frozen_stages = frozen_stages
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
        frozen = [self.conv1, self.bn1] if frozen_stages >= 0 else []
        for names in self.stage_names[:max(frozen_stages, 0)]:
            frozen += [getattr(self, name) for name in names]
        for module in frozen:
            module.requires_grad_(False)

    def forward(self, x):
        # conv1 casts the images to the compute dtype (JAX backbones/resnet.py:89)
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool(x, 3, 2, 1)
        if self.frozen_stages >= 0:
            x = x.detach()
        outs = []
        for stage, names in enumerate(self.stage_names):
            for name in names:
                x = getattr(self, name)(x)
            if stage + 1 <= self.frozen_stages:
                x = x.detach()
            outs.append(x)
        return tuple(outs)
