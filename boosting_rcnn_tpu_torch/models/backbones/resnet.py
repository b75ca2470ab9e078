"""ResNet backbone (PyTorch port of ``boosting_rcnn_tpu/models/backbones/resnet.py``).

Depths 18 and 34 (``BasicBlock``), 50, 101 and 152 (``Bottleneck``),
``style='pytorch'`` (a bottleneck's stride on the 3x3) or ``'caffe'`` (on
the first 1x1, JAX ``resnet.py:201-202``; a ``BasicBlock`` keeps it on its
first 3x3 in both styles, and the shortcut keeps it in both; the
parameters are the same in both styles), frozen BN; ResNeXt's grouped 3x3
(``groups``, ``base_width``: its width is ``int(planes * base_width /
base_channels) * groups``, JAX ``resnet.py:194-199``), and a deformable
3x3 (``dcn``, DCN or DCNv2; dense, as the JAX package's, whatever
``groups``) in the stages of ``stage_with_dcn``.  The JAX package
computes the 7x7/s2 stem
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

Norms and plugins (JAX ``resnet.py:28-57``, ``:180-191``, ``:278-317``):
``norm_eval=False`` makes every BN a ``LiveBatchNorm`` (the stem's and the
frozen stages' too, as in the JAX package, where mmdet keeps a frozen
stage's BN in eval mode); a GN ``norm_cfg`` makes the stem's and the
bottlenecks' norms GroupNorm; a ``ConvWS`` ``conv_cfg`` makes the stem's
and the bottlenecks' convs weight-standardised; ``plugins`` (GCNet's
``ContextBlock``, ``GeneralizedAttention``) run inside the bottlenecks of
their stages.  A ``BasicBlock`` reads neither ``norm_cfg`` nor
``conv_cfg``, and plugins need a bottleneck depth, as in the JAX package.

Stages (JAX ``resnet.py:291-375``): ``num_stages`` (1 to 4) of them, at
``strides`` and ``dilations`` (a stage's dilation on its 3x3s, padded by
the dilation: a ``BasicBlock``'s first 3x3 only, as in the JAX package),
the outputs of the stages in ``out_indices``.  The C4 configs run three
stages and hand out C4 (1024 channels at stride 16 for ResNet-50); DC5 runs
stage 4 at stride 1 with its 3x3s dilated by 2 (2048 channels at stride 16).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import (
    BN_TYPES,
    DeformConv,
    FrozenBatchNorm,
    LiveBatchNorm,
    make_conv,
    make_conv_cfg,
    make_norm,
    max_pool,
)
from ..plugins import build_plugin, stage_plugins

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def make_bn(channels: int, live: bool, norm_cfg: dict | None = None) -> nn.Module:
    """A backbone norm (JAX ``resnet.py:28-45``): BN, live
    (``LiveBatchNorm``) when ``norm_eval`` is False and frozen when it is
    True, whatever BN type the ``norm_cfg`` names; another ``norm_cfg``
    (GN) as a ConvModule's (``layers.make_norm``)."""
    if norm_cfg is None or norm_cfg.get("type") in BN_TYPES:
        return LiveBatchNorm(channels) if live else FrozenBatchNorm(channels)
    return make_norm(norm_cfg, channels)


def make_dcn(cin: int, cout: int, stride: int, dcn: dict, gen: torch.Generator) -> DeformConv:
    """The deformable 3x3 of a ``dcn=dict(type='DCN' | 'DCNv2',
    deform_groups=...)`` block (JAX ``Bottleneck``, ``Bottle2neck``)."""
    return DeformConv(cin, cout, 3, stride, gen, deform_groups=dcn.get("deform_groups", 1),
                      modulated=dcn.get("type", "DCNv2") == "DCNv2")


class BasicBlock(nn.Module):
    """Two 3x3 convs (JAX ``resnet.py:118-151``); live or frozen BN by
    ``norm_eval``.  Like the JAX block it reads neither ``norm_cfg`` nor
    ``conv_cfg``, and takes no plugins (the backbone raises)."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int, downsample: bool,
                 gen: torch.Generator, live: bool = False, dilation: int = 1):
        super().__init__()
        self.conv1 = make_conv(cin, planes, 3, stride, dilation, False, gen, dilation=dilation)
        self.bn1 = make_bn(planes, live)
        self.conv2 = make_conv(planes, planes, 3, 1, 1, False, gen)
        self.bn2 = make_bn(planes, live)
        if downsample:
            self.downsample_conv = make_conv(cin, planes, 1, stride, 0, False, gen)
            self.downsample_bn = make_bn(planes, live)
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
    """1x1 -> 3x3 -> 1x1 (x4) with the shortcut (JAX ``resnet.py:154-255``):
    its convs weight-standardised for a ``ConvWS`` ``conv_cfg`` (the 3x3 of a
    ``dcn`` stays deformable), its norms by ``make_bn``, and the stage's
    ``plugins`` (``(cfg, position)`` pairs) run after conv1's and conv2's
    ReLU and after bn3 (``after_conv1/2/3``), each named
    ``{position}_plugin{i}`` by its index in the stage's list."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int, downsample: bool,
                 gen: torch.Generator, groups: int = 1, base_width: int = 4,
                 base_channels: int = 64, dcn: dict | None = None, style: str = "pytorch",
                 live: bool = False, conv_cfg: dict | None = None,
                 norm_cfg: dict | None = None, plugins=(), dilation: int = 1):
        super().__init__()
        out = planes * self.expansion
        width = planes if groups == 1 else int(planes * (base_width / base_channels)) * groups
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        widths = {"after_conv1": width, "after_conv2": width, "after_conv3": out}
        self.plugin_names = {pos: [] for pos in widths}

        def plug(position):
            for i, (cfg, pos) in enumerate(plugins):
                if pos == position:
                    name = f"{pos}_plugin{i}"
                    self.add_module(name, build_plugin(cfg, widths[pos], gen))
                    self.plugin_names[pos].append(name)

        self.conv1 = make_conv_cfg(conv_cfg, cin, width, 1, s1, 0, False, gen)
        self.bn1 = make_bn(width, live, norm_cfg)
        plug("after_conv1")
        if dcn is not None:
            if dilation != 1:  # the port's DeformConv is undilated
                raise NotImplementedError(f"a deformable 3x3 dilated by {dilation} is not ported")
            self.conv2 = make_dcn(width, width, s2, dcn, gen)
        else:
            self.conv2 = make_conv_cfg(conv_cfg, width, width, 3, s2, dilation, False, gen,
                                       groups=groups, dilation=dilation)
        self.bn2 = make_bn(width, live, norm_cfg)
        plug("after_conv2")
        self.conv3 = make_conv_cfg(conv_cfg, width, out, 1, 1, 0, False, gen)
        self.bn3 = make_bn(out, live, norm_cfg)
        plug("after_conv3")
        if downsample:
            self.downsample_conv = make_conv_cfg(conv_cfg, cin, out, 1, stride, 0, False, gen)
            self.downsample_bn = make_bn(out, live, norm_cfg)
        else:
            self.downsample_conv = None

    def _plug(self, y, position: str):
        for name in self.plugin_names[position]:
            y = getattr(self, name)(y)
        return y

    def forward(self, x):
        y = self._plug(F.relu(self.bn1(self.conv1(x))), "after_conv1")
        y = self._plug(F.relu(self.bn2(self.conv2(y))), "after_conv2")
        y = self._plug(self.bn3(self.conv3(y)), "after_conv3")
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + identity)


class ResNet(nn.Module):
    """NCHW images -> the outputs of the stages of ``out_indices`` (NCHW);
    by default the four stages C2-C5, stage strides (1, 2, 2, 2)."""

    def __init__(self, gen: torch.Generator, depth: int = 50, base_channels: int = 64,
                 frozen_stages: int = -1, groups: int = 1, base_width: int = 4,
                 dcn: dict | None = None, stage_with_dcn=(False, False, False, False),
                 style: str = "pytorch", norm_eval: bool = True, conv_cfg: dict | None = None,
                 norm_cfg: dict | None = None, plugins=None, num_stages: int = 4,
                 strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1), out_indices=(0, 1, 2, 3)):
        super().__init__()
        self.frozen_stages = frozen_stages
        if depth not in ARCH_SETTINGS:
            raise NotImplementedError(f"ResNet depth {depth} is not ported")
        if not 1 <= num_stages <= 4 or min(len(strides), len(dilations)) < num_stages:
            raise ValueError(f"{num_stages} stages at strides {tuple(strides)} and dilations "
                             f"{tuple(dilations)}")
        if not out_indices or any(i not in range(num_stages) for i in out_indices):
            raise ValueError(f"out_indices {tuple(out_indices)} of {num_stages} stages")
        self.out_indices = tuple(out_indices)
        if style not in ("pytorch", "caffe"):
            raise NotImplementedError(f"ResNet style={style!r} is not ported")
        kind, blocks = ARCH_SETTINGS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        if kind == "basic" and (groups != 1 or dcn is not None):
            # the JAX package's BasicBlock reads neither (resnet.py:115-148)
            raise NotImplementedError(f"ResNet depth {depth} has no grouped or deformable 3x3")
        if kind == "basic" and plugins:
            # the JAX ResNet asserts the same (resnet.py:347-353)
            raise NotImplementedError(f"ResNet depth {depth}: plugins need a Bottleneck depth")
        live = not norm_eval
        # the stem: a weight-standardised 7x7 for ConvWS, its norm by norm_cfg
        self.conv1 = make_conv_cfg(conv_cfg, 3, base_channels, 7, 2, 3, False, gen)
        self.bn1 = make_bn(base_channels, live, norm_cfg)
        self.stage_names, self.stage_channels = [], []
        cin, planes = base_channels, base_channels
        for stage, n_blocks in enumerate(blocks[:num_stages]):
            names = []
            for b in range(n_blocks):
                stride = strides[stage] if b == 0 else 1
                out = planes * block.expansion
                down = b == 0 and (stride != 1 or cin != out)
                name = f"layer{stage + 1}_{b}"
                extra = dict(live=live, dilation=dilations[stage]) if kind == "basic" else dict(
                    groups=groups, base_width=base_width, base_channels=base_channels,
                    dcn=dcn if stage_with_dcn[stage] else None, style=style, live=live,
                    conv_cfg=conv_cfg, norm_cfg=norm_cfg,
                    plugins=stage_plugins(plugins, stage), dilation=dilations[stage])
                self.add_module(name, block(cin, planes, stride, down, gen, **extra))
                names.append(name)
                cin = out
            self.stage_names.append(names)
            self.stage_channels.append(cin)
            planes *= 2
        # the channels of each output (the neck-less detectors' one level)
        self.out_channels = tuple(self.stage_channels[i] for i in self.out_indices)
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
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)
