"""RegNetX backbones (PyTorch port of ``boosting_rcnn_tpu/models/backbones/regnet.py``;
reference ``mmdet/models/backbones/regnet.py``): the quantised linear
width rule (``generate_regnet``) grouped into stages, each stage's group
width capped by its width (``adjust_groups``), a 32-channel 3x3 / stride-2
stem, then per stage X blocks (bottleneck ratio 1: 1x1, grouped 3x3 at
stride 2 in the stage's first block, 1x1; a 1x1 shortcut where the shape
changes).  BN frozen, or live with ``norm_eval=False``; ``frozen_stages``
= k detaches the activations after the stem and after stages 1..k and
freezes their parameters, as the port's ResNet does (the JAX package's
optimizer mask names ``conv1``, ``bn1`` and ``layer{s}_``).  Submodule
names are the JAX package's.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..layers import make_conv
from .resnet import make_bn

__all__ = ["ARCH_SETTINGS", "generate_regnet", "adjust_groups", "XBlock", "RegNet"]

ARCH_SETTINGS = {
    "regnetx_400mf": dict(w0=24, wa=24.48, wm=2.54, group_w=16, depth=22),
    "regnetx_800mf": dict(w0=56, wa=35.73, wm=2.28, group_w=16, depth=16),
    "regnetx_1.6gf": dict(w0=80, wa=34.01, wm=2.25, group_w=24, depth=18),
    "regnetx_3.2gf": dict(w0=88, wa=26.31, wm=2.25, group_w=48, depth=25),
    "regnetx_4.0gf": dict(w0=96, wa=38.65, wm=2.43, group_w=40, depth=23),
    "regnetx_6.4gf": dict(w0=184, wa=60.83, wm=2.07, group_w=56, depth=17),
    "regnetx_8.0gf": dict(w0=80, wa=49.56, wm=2.88, group_w=120, depth=23),
    "regnetx_12gf": dict(w0=168, wa=73.36, wm=2.37, group_w=112, depth=19),
}


def generate_regnet(w0: int, wa: float, wm: float, depth: int, divisor: int = 8):
    """Each stage's width and depth from the quantised linear rule (JAX
    ``generate_regnet``, in float64 numpy as there)."""
    widths_cont = np.arange(depth) * wa + w0
    ks = np.round(np.log(widths_cont / w0) / np.log(wm))
    widths = (np.round(w0 * np.power(wm, ks) / divisor) * divisor).astype(int)
    stage_widths, stage_depths = [], []
    for w in widths:
        if not stage_widths or stage_widths[-1] != w:
            stage_widths.append(int(w))
            stage_depths.append(1)
        else:
            stage_depths[-1] += 1
    return stage_widths, stage_depths


def adjust_groups(widths, group_w: int):
    """Each stage's group width capped at its width, and the width rounded
    to a multiple of it (JAX ``adjust_groups``); returns the widths and the
    group widths, which the JAX package passes as the 3x3's group *count*
    (``feature_group_count``), and so does the port."""
    groups = [min(group_w, w) for w in widths]
    widths = [int(round(w / g) * g) for w, g in zip(widths, groups)]
    return widths, groups


class XBlock(nn.Module):
    """JAX ``XBlock``: ``conv1`` 1x1, ``bn1``, ReLU, ``conv2`` 3x3 of
    ``groups`` groups at ``stride``, ``bn2``, ReLU, ``conv3`` 1x1, ``bn3``;
    ``downsample_conv`` / ``downsample_bn`` where the stride or the width
    changes; the sum through a ReLU."""

    def __init__(self, cin: int, width: int, stride: int, groups: int, gen: torch.Generator,
                 live: bool = False):
        super().__init__()
        self.conv1 = make_conv(cin, width, 1, 1, 0, False, gen)
        self.bn1 = make_bn(width, live)
        self.conv2 = make_conv(width, width, 3, stride, 1, False, gen, groups=groups)
        self.bn2 = make_bn(width, live)
        self.conv3 = make_conv(width, width, 1, 1, 0, False, gen)
        self.bn3 = make_bn(width, live)
        if stride != 1 or cin != width:
            self.downsample_conv = make_conv(cin, width, 1, stride, 0, False, gen)
            self.downsample_bn = make_bn(width, live)
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


class RegNet(nn.Module):
    """NCHW images -> the outputs of the stages in ``out_indices``."""

    def __init__(self, gen: torch.Generator, arch: str = "regnetx_3.2gf",
                 out_indices: Sequence[int] = (0, 1, 2, 3), frozen_stages: int = -1,
                 norm_eval: bool = True):
        super().__init__()
        if arch not in ARCH_SETTINGS:
            raise NotImplementedError(f"RegNet arch {arch!r} is not ported")
        p = ARCH_SETTINGS[arch]
        widths, depths = generate_regnet(p["w0"], p["wa"], p["wm"], p["depth"])
        widths, groups = adjust_groups(widths, p["group_w"])
        live = not norm_eval
        self.out_indices, self.frozen_stages = tuple(out_indices), frozen_stages
        self.conv1 = make_conv(3, 32, 3, 2, 1, False, gen)
        self.bn1 = make_bn(32, live)
        self.stage_names, cin = [], 32
        for stage, (w, d, g) in enumerate(zip(widths, depths, groups)):
            names = []
            for b in range(d):
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, XBlock(cin, w, 2 if b == 0 else 1, g, gen, live))
                names.append(name)
                cin = w
            self.stage_names.append(names)
        self.out_channels = tuple(widths[i] for i in self.out_indices)
        frozen = [self.conv1, self.bn1] if frozen_stages >= 0 else []
        for names in self.stage_names[:max(frozen_stages, 0)]:
            frozen += [getattr(self, name) for name in names]
        for module in frozen:
            module.requires_grad_(False)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
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
