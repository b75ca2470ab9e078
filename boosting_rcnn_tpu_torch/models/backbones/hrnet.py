"""HRNet backbone (PyTorch port of ``boosting_rcnn_tpu/models/backbones/hrnet.py``;
reference ``mmdet/models/backbones/hrnet.py``): two 3x3 / stride-2 convs
of 64 channels, four bottlenecks at 1/4 scale, then stages 2-4, each a
transition (a 3x3 conv where a branch's width changes, a 3x3 / stride-2
conv from the lowest branch to spawn a new one) and HRModules: four basic
blocks a branch, then the all-to-all fusion (to a finer branch a 1x1 conv,
BN and a nearest upsample with half-pixel centres, ``nearest_resize``; to
a coarser one a chain of 3x3 / stride-2 convs with BN, ReLU between them).
Every branch's map comes out (HRFPN consumes them).  Widths w18, w32 and
w40; BN frozen, or live with ``norm_eval=False``.  Submodule names are the
JAX package's.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import make_conv, nearest_resize
from .resnet import make_bn

__all__ = ["ARCH", "HRModule", "HRNet"]

# stage: (num_modules, num_branches, blocks per branch, channels per branch)
ARCH = {
    "w18": dict(stage2=(1, 2, (4, 4), (18, 36)), stage3=(4, 3, (4, 4, 4), (18, 36, 72)),
                stage4=(3, 4, (4, 4, 4, 4), (18, 36, 72, 144))),
    "w32": dict(stage2=(1, 2, (4, 4), (32, 64)), stage3=(4, 3, (4, 4, 4), (32, 64, 128)),
                stage4=(3, 4, (4, 4, 4, 4), (32, 64, 128, 256))),
    "w40": dict(stage2=(1, 2, (4, 4), (40, 80)), stage3=(4, 3, (4, 4, 4), (40, 80, 160)),
                stage4=(3, 4, (4, 4, 4, 4), (40, 80, 160, 320))),
}


class _Basic(nn.Module):
    """JAX ``_Basic``: two 3x3 convs with BN, ``down_conv`` / ``down_bn``
    where the width changes."""

    def __init__(self, cin: int, planes: int, gen: torch.Generator, live: bool = False):
        super().__init__()
        self.conv1 = make_conv(cin, planes, 3, 1, 1, False, gen)
        self.bn1 = make_bn(planes, live)
        self.conv2 = make_conv(planes, planes, 3, 1, 1, False, gen)
        self.bn2 = make_bn(planes, live)
        if cin != planes:
            self.down_conv = make_conv(cin, planes, 1, 1, 0, False, gen)
            self.down_bn = make_bn(planes, live)
        else:
            self.down_conv = None

    def forward(self, x):
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        identity = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return F.relu(y + identity)


class _Bottleneck(nn.Module):
    """JAX ``_Bottleneck``: 1x1, 3x3, 1x1 to ``4 * planes`` with BN, the
    shortcut ``down_conv`` / ``down_bn`` where the width changes."""

    def __init__(self, cin: int, planes: int, gen: torch.Generator, live: bool = False):
        super().__init__()
        out = planes * 4
        self.conv1 = make_conv(cin, planes, 1, 1, 0, False, gen)
        self.bn1 = make_bn(planes, live)
        self.conv2 = make_conv(planes, planes, 3, 1, 1, False, gen)
        self.bn2 = make_bn(planes, live)
        self.conv3 = make_conv(planes, out, 1, 1, 0, False, gen)
        self.bn3 = make_bn(out, live)
        if cin != out:
            self.down_conv = make_conv(cin, out, 1, 1, 0, False, gen)
            self.down_bn = make_bn(out, live)
        else:
            self.down_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return F.relu(y + identity)


class HRModule(nn.Module):
    """JAX ``HRModule``: ``branch{b}_block{k}`` basic blocks, then for each
    output branch i the sum over the branches j of: j itself (i = j);
    ``fuse_{i}_{j}_conv`` (1x1), ``fuse_{i}_{j}_bn`` and a nearest upsample
    to i's size (j > i); ``fuse_{i}_{j}_conv{s}`` / ``_bn{s}`` stride-2 3x3s,
    ReLU between them, at j's width but the last at i's (j < i); the sum
    through a ReLU."""

    def __init__(self, num_branches: int, num_blocks: Sequence[int], channels: Sequence[int],
                 gen: torch.Generator, live: bool = False):
        super().__init__()
        self.num_branches, self.num_blocks = num_branches, tuple(num_blocks)
        for b in range(num_branches):
            for k in range(num_blocks[b]):
                self.add_module(f"branch{b}_block{k}",
                                _Basic(channels[b], channels[b], gen, live))
        for i in range(num_branches):
            for j in range(num_branches):
                if j > i:
                    self.add_module(f"fuse_{i}_{j}_conv",
                                    make_conv(channels[j], channels[i], 1, 1, 0, False, gen))
                    self.add_module(f"fuse_{i}_{j}_bn", make_bn(channels[i], live))
                elif j < i:
                    for s in range(i - j):
                        ch = channels[i] if s == i - j - 1 else channels[j]
                        self.add_module(f"fuse_{i}_{j}_conv{s}",
                                        make_conv(channels[j], ch, 3, 2, 1, False, gen))
                        self.add_module(f"fuse_{i}_{j}_bn{s}", make_bn(ch, live))

    def forward(self, xs):
        ys = []
        for b in range(self.num_branches):
            y = xs[b]
            for k in range(self.num_blocks[b]):
                y = getattr(self, f"branch{b}_block{k}")(y)
            ys.append(y)
        outs = []
        for i in range(self.num_branches):
            acc = None
            for j in range(self.num_branches):
                if j == i:
                    t = ys[j]
                elif j > i:
                    t = getattr(self, f"fuse_{i}_{j}_bn")(getattr(self, f"fuse_{i}_{j}_conv")(ys[j]))
                    t = nearest_resize(t, ys[i].shape[-2:])
                else:
                    t = ys[j]
                    for s in range(i - j):
                        t = getattr(self, f"fuse_{i}_{j}_bn{s}")(
                            getattr(self, f"fuse_{i}_{j}_conv{s}")(t))
                        if s != i - j - 1:
                            t = F.relu(t)
                acc = t if acc is None else acc + t
            outs.append(F.relu(acc))
        return outs


class HRNet(nn.Module):
    """NCHW images -> every branch's map of the last stage, fine to coarse.
    ``frozen_stages`` other than -1 raises: no config sets one, and the JAX
    package's freezing (its activations after the stem) and its optimizer
    mask (``conv1``, ``bn1``, ``layer{s}_``) disagree on HRNet's
    parameters."""

    def __init__(self, gen: torch.Generator, arch: str = "w32", frozen_stages: int = -1,
                 norm_eval: bool = True):
        super().__init__()
        if arch not in ARCH:
            raise NotImplementedError(f"HRNet arch {arch!r} is not ported")
        if frozen_stages != -1:
            raise NotImplementedError(f"HRNet frozen_stages={frozen_stages} is not ported")
        live = not norm_eval
        self.conv1 = make_conv(3, 64, 3, 2, 1, False, gen)
        self.bn1 = make_bn(64, live)
        self.conv2 = make_conv(64, 64, 3, 2, 1, False, gen)
        self.bn2 = make_bn(64, live)
        cin = 64
        for k in range(4):
            self.add_module(f"layer1_{k}", _Bottleneck(cin, 64, gen, live))
            cin = 256
        prev = [256]
        self.stages = []
        for si, key in enumerate(("stage2", "stage3", "stage4")):
            num_modules, num_branches, num_blocks, channels = ARCH[arch][key]
            trans = []
            for b in range(num_branches):
                if b < len(prev) and prev[b] == channels[b]:
                    trans.append(None)
                    continue
                src, stride = (prev[b], 1) if b < len(prev) else (prev[-1], 2)
                self.add_module(f"trans{si}_b{b}_conv",
                                make_conv(src, channels[b], 3, stride, 1, False, gen))
                self.add_module(f"trans{si}_b{b}_bn", make_bn(channels[b], live))
                trans.append(f"trans{si}_b{b}")
            for m in range(num_modules):
                self.add_module(f"{key}_module{m}",
                                HRModule(num_branches, num_blocks, channels, gen, live))
            self.stages.append((key, num_modules, trans))
            prev = list(channels)
        self.out_channels = tuple(prev)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        for k in range(4):
            x = getattr(self, f"layer1_{k}")(x)
        xs = [x]
        for key, num_modules, trans in self.stages:
            new = []
            for b, name in enumerate(trans):
                if name is None:
                    new.append(xs[b])
                else:
                    src = xs[b] if b < len(xs) else xs[-1]
                    new.append(F.relu(getattr(self, f"{name}_bn")(
                        getattr(self, f"{name}_conv")(src))))
            xs = new
            for m in range(num_modules):
                xs = getattr(self, f"{key}_module{m}")(xs)
        return tuple(xs)
