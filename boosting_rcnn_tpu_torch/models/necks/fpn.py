"""FPN and PAFPN necks (PyTorch port of ``boosting_rcnn_tpu/models/necks/fpn.py``).

``FPN`` (Mask R-CNN's and the COCO Boosting R-CNN's neck): lateral 1x1
convs, the top-down merge (nearest upsample with half-pixel centres), 3x3
output convs, and the extra levels as ``max_pool(outs[-1], 1, 2)``
(``add_extra_convs=False``) or by stride-2 convs on the last input, its
lateral or its output (``FPN._add_extra_levels``).  ``PAFPN`` (the flagship's): the FPN top-down
merge, then the bottom-up path (``downsample_{i}`` stride-2 convs,
``pafpn_conv_{i}``), then extra levels by stride-2 convs on the last output
(``add_extra_convs='on_output'``).  No activation, as every config has;
the FPN takes a ``norm_cfg`` for every conv (the laterals' not with
``no_norm_on_lateral``; GN, or BN as a frozen BN, ``layers.make_norm``) and
a ``conv_cfg`` (``ConvWS``) for its laterals and output convs, not its extra
convs, as the JAX FPN (``necks/fpn.py:20-100``); the PAFPN neither; the
PAFPN's extra levels by convs on its last output, or by ``max_pool(outs[-1],
1, 2)`` with ``add_extra_convs=False`` (JAX ``necks/fpn.py:225``).

``SPPFPN`` (the fork's, JAX ``necks/fpn.py:102-222``) is the FPN with each
lateral 1x1 replaced by an SPP-type block (``SPPLateral``): ``ASPP``,
``ASPP_share`` (one 3x3 weight and bias at dilations 1, 3, 5 and 7, the
config's), ``SPP`` or ``RFB``.  ``HRFPN`` (JAX ``necks/fpn.py:371-406``)
upsamples HRNet's branches bilinearly to the first, concatenates them,
reduces them by a 1x1 conv and makes ``num_outs`` levels by average pools
of 2^i, each through a 3x3 conv at ``stride``.  ``RFP`` (DetectoRS's
Recursive Feature Pyramid, JAX ``necks/fpn.py:565-638``) runs one FPN on
the backbone's levels, feeds the ASPP of levels 1-3 back through its own
feedback backbone, runs the same FPN again and blends the two pyramids
by a sigmoid gate.  NCHW in and out.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.losses import sigmoid
from ..layers import (ConvModule, Conv2d, avg_pool, bilinear_resize, lecun_normal_, make_conv,
                      max_pool, nearest_resize)


def _top_down(neck: nn.Module, inputs, start_level: int, used: int):
    """The lateral convs and the top-down merge: each lateral plus the
    nearest upsample of the one above it."""
    laterals = [getattr(neck, f"lateral_{i}")(inputs[start_level + i]) for i in range(used)]
    for i in range(used - 1, 0, -1):
        laterals[i - 1] = laterals[i - 1] + nearest_resize(laterals[i],
                                                           laterals[i - 1].shape[-2:])
    return laterals


class FPN(nn.Module):
    """``FPN`` over the backbone levels ``start_level`` to ``end_level``
    (-1: the last), then ``num_outs - used`` extra levels: by
    ``max_pool(outs[-1], 1, 2)`` when ``add_extra_convs`` is False, else by
    stride-2 3x3 convs (``fpn_conv_{used}``, ...), the first on the last
    used input (``"on_input"``, or ``True``), its lateral (``"on_lateral"``)
    or its output (``"on_output"``), each later one on the level before it,
    through a ReLU with ``relu_before_extra_convs`` (JAX ``necks/fpn.py:36-100``)."""

    def __init__(self, gen: torch.Generator, in_channels: Sequence[int],
                 out_channels: int = 256, num_outs: int = 5, start_level: int = 0,
                 end_level: int = -1, add_extra_convs=False,
                 relu_before_extra_convs: bool = False, norm_cfg: dict | None = None,
                 conv_cfg: dict | None = None, no_norm_on_lateral: bool = False,
                 spp_type: str | None = None):
        super().__init__()
        if add_extra_convs is True:
            add_extra_convs = "on_input"
        if add_extra_convs not in (False, "on_input", "on_lateral", "on_output"):
            raise NotImplementedError(f"FPN add_extra_convs={add_extra_convs!r} is not ported")
        end = len(in_channels) if end_level == -1 else end_level
        self.start_level, self.end = start_level, end
        self.used = used = end - start_level
        self.num_outs = num_outs
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        lateral_norm = None if no_norm_on_lateral else norm_cfg
        for i in range(used):
            cin = in_channels[start_level + i]
            self.add_module(f"lateral_{i}", SPPLateral(
                cin, out_channels, gen, spp_type, norm_cfg=lateral_norm) if spp_type else
                ConvModule(cin, out_channels, 1, gen, conv_cfg=conv_cfg, norm_cfg=lateral_norm))
            self.add_module(f"fpn_conv_{i}", ConvModule(out_channels, out_channels, 3, gen,
                                                        conv_cfg=conv_cfg, norm_cfg=norm_cfg))
        if add_extra_convs:
            for i in range(used, num_outs):
                cin = (in_channels[end - 1] if i == used and add_extra_convs == "on_input"
                       else out_channels)
                self.add_module(f"fpn_conv_{i}", ConvModule(cin, out_channels, 3, gen, stride=2,
                                                            norm_cfg=norm_cfg))

    def forward(self, inputs):
        used = self.used
        laterals = _top_down(self, inputs, self.start_level, used)
        outs = [getattr(self, f"fpn_conv_{i}")(laterals[i]) for i in range(used)]
        if not self.add_extra_convs:
            for _ in range(used, self.num_outs):
                outs.append(max_pool(outs[-1], 1, 2, 0))
            return tuple(outs)
        if used < self.num_outs:
            src = {"on_input": inputs[self.end - 1], "on_lateral": laterals[-1],
                   "on_output": outs[-1]}[self.add_extra_convs]
            outs.append(getattr(self, f"fpn_conv_{used}")(src))
        for i in range(used + 1, self.num_outs):
            src = F.relu(outs[-1]) if self.relu_before_extra_convs else outs[-1]
            outs.append(getattr(self, f"fpn_conv_{i}")(src))
        return tuple(outs)


class PAFPN(nn.Module):
    """The FPN top-down merge, the bottom-up path, then the extra levels by
    stride-2 convs on the last output (``add_extra_convs="on_output"``) or
    by ``max_pool(outs[-1], 1, 2)`` (False)."""

    def __init__(self, gen: torch.Generator, in_channels: Sequence[int],
                 out_channels: int = 256, num_outs: int = 5, start_level: int = 0,
                 end_level: int = -1, add_extra_convs="on_output"):
        super().__init__()
        if add_extra_convs not in (False, "on_output"):
            raise NotImplementedError(f"PAFPN add_extra_convs={add_extra_convs!r} is not ported")
        end = len(in_channels) if end_level == -1 else end_level
        self.start_level = start_level
        self.used = used = end - start_level
        self.num_outs = num_outs
        self.add_extra_convs = add_extra_convs
        oc = out_channels
        for i in range(used):
            self.add_module(f"lateral_{i}",
                            ConvModule(in_channels[start_level + i], oc, 1, gen))
            self.add_module(f"fpn_conv_{i}", ConvModule(oc, oc, 3, gen))
        for i in range(used - 1):
            self.add_module(f"downsample_{i}", ConvModule(oc, oc, 3, gen, stride=2))
            self.add_module(f"pafpn_conv_{i}", ConvModule(oc, oc, 3, gen))
        for i in range(used, num_outs if add_extra_convs else used):
            self.add_module(f"fpn_conv_{i}", ConvModule(oc, oc, 3, gen, stride=2))

    def forward(self, inputs):
        used = self.used
        laterals = _top_down(self, inputs, self.start_level, used)
        inter = [getattr(self, f"fpn_conv_{i}")(laterals[i]) for i in range(used)]
        for i in range(used - 1):
            inter[i + 1] = inter[i + 1] + getattr(self, f"downsample_{i}")(inter[i])
        outs = [inter[0]] + [getattr(self, f"pafpn_conv_{i - 1}")(inter[i])
                             for i in range(1, used)]
        for i in range(used, self.num_outs):
            outs.append(getattr(self, f"fpn_conv_{i}")(outs[-1]) if self.add_extra_convs
                        else max_pool(outs[-1], 1, 2, 0))
        return tuple(outs)


SPP_TYPES = ("ASPP", "ASPP_share", "SPP", "RFB")


class SPPLateral(nn.Module):
    """An SPPFPN lateral (JAX ``necks/fpn.py::_SPPLateral``), the ConvModules
    with a ReLU where the JAX ones take their default:

      * ``ASPP``: a ConvModule a dilation (1x1 at 1, else a 3x3 padded by
        its dilation; the neck's ``norm_cfg``), concatenated, a 1x1
        ``fuse`` conv with a bias;
      * ``ASPP_share``: one 3x3 weight and bias (``shared``) at every
        dilation, padded by it, no activation, concatenated, ``fuse``;
      * ``SPP``: a 1x1 ``squeeze`` to half the channels, its max pools of 5,
        9 and 13 at stride 1, concatenated with it, a 1x1 ``expand``;
      * ``RFB``: three branches of growing receptive field (``b0_*``,
        ``b1_*``, ``b2_*``, their last 3x3 dilated by 1, 3 and 5 and
        without activation), concatenated, a 1x1 ``fuse`` without
        activation, plus a 1x1 ``shortcut``, then a ReLU."""

    def __init__(self, cin: int, c: int, gen: torch.Generator, spp_type: str = "ASPP",
                 dilations=(1, 3, 5, 7), norm_cfg: dict | None = None):
        super().__init__()
        if spp_type not in SPP_TYPES:
            raise ValueError(f"unknown SPP_type {spp_type!r}")
        self.spp_type, self.dilations = spp_type, tuple(dilations)
        relu = dict(act="relu")
        if spp_type == "ASPP":
            for i, d in enumerate(self.dilations):
                self.add_module(f"aspp_{i}", ConvModule(cin, c, 1 if d == 1 else 3, gen,
                                                        norm_cfg=norm_cfg, dilation=d, **relu))
        elif spp_type == "ASPP_share":
            # he_normal, as the JAX parameter's initialiser; the taps are the
            # convolution's, applied at each dilation in forward
            self.shared = Conv2d(cin, c, 3)
            lecun_normal_(self.shared.weight, cin * 9 // 2, gen)
            nn.init.zeros_(self.shared.bias)
        if spp_type.startswith("ASPP"):
            self.fuse = make_conv(c * len(self.dilations), c, 1, 1, 0, True, gen)
        elif spp_type == "SPP":
            self.squeeze = ConvModule(cin, c // 2, 1, gen, **relu)
            self.expand = ConvModule(c // 2 * 4, c, 1, gen, **relu)
        else:
            c_ = max(c // 8, 8)
            for name, i, o, k, d, act in (
                    ("b0_0", cin, 2 * c_, 1, 1, relu), ("b0_1", 2 * c_, 2 * c_, 3, 1, {}),
                    ("b1_0", cin, c_, 1, 1, relu), ("b1_1", c_, 2 * c_, 3, 1, relu),
                    ("b1_2", 2 * c_, 2 * c_, 3, 3, {}), ("b2_0", cin, c_, 1, 1, relu),
                    ("b2_1", c_, c_ // 2 * 3, 3, 1, relu),
                    ("b2_2", c_ // 2 * 3, 2 * c_, 3, 1, relu),
                    ("b2_3", 2 * c_, 2 * c_, 3, 5, {}), ("fuse", 6 * c_, c, 1, 1, {}),
                    ("shortcut", cin, c, 1, 1, {})):
                self.add_module(name, ConvModule(i, o, k, gen, dilation=d, **act))

    def forward(self, x):
        if self.spp_type == "ASPP":
            y = torch.cat([getattr(self, f"aspp_{i}")(x) for i in range(len(self.dilations))], 1)
            return self.fuse(y)
        if self.spp_type == "ASPP_share":
            conv = self.shared
            dt = conv.compute_dtype
            w, b = conv.weight.to(dt), conv.bias.to(dt)
            xs = x.to(dt)
            if dt == torch.float32:
                branches = [F.conv2d(xs, w, b, 1, d, d) for d in self.dilations]
            else:  # the bias added to the rounded convolution, as flax adds it
                branches = [F.conv2d(xs, w, None, 1, d, d) + b[:, None, None]
                            for d in self.dilations]
            return self.fuse(torch.cat(branches, 1))
        if self.spp_type == "SPP":
            y = self.squeeze(x)
            y = torch.cat([y] + [max_pool(y, k, 1, k // 2) for k in (5, 9, 13)], 1)
            return self.expand(y)
        b0 = self.b0_1(self.b0_0(x))
        b1 = self.b1_2(self.b1_1(self.b1_0(x)))
        b2 = self.b2_3(self.b2_2(self.b2_1(self.b2_0(x))))
        y = self.fuse(torch.cat([b0, b1, b2], 1))
        return F.relu(y + self.shortcut(x))


class HRFPN(nn.Module):
    """HRNet's neck (JAX ``necks/fpn.py::HRFPN``): the branches ``(B, C_i,
    H_i, W_i)`` upsampled bilinearly to the first's size, concatenated, a
    1x1 ``reduction_conv``, then level i an average pool of 2^i (no
    padding) of it through the 3x3 ``fpn_conv_i`` at ``stride`` (each conv
    with a bias, no norm, no activation)."""

    def __init__(self, gen: torch.Generator, in_channels: Sequence[int],
                 out_channels: int = 256, num_outs: int = 5, stride: int = 1):
        super().__init__()
        self.num_outs, self.stride = num_outs, stride
        self.reduction_conv = make_conv(sum(in_channels), out_channels, 1, 1, 0, True, gen)
        for i in range(num_outs):
            self.add_module(f"fpn_conv_{i}", make_conv(out_channels, out_channels, 3, stride, 1,
                                                       True, gen))

    def forward(self, inputs):
        hw = inputs[0].shape[-2:]
        x = torch.cat([inputs[0]] + [bilinear_resize(t, hw) for t in inputs[1:]], 1)
        x = self.reduction_conv(x)
        outs = []
        for i in range(self.num_outs):
            y = x if i == 0 else avg_pool(x, 2 ** i, 2 ** i)
            outs.append(getattr(self, f"fpn_conv_{i}")(y))
        return tuple(outs)


class RFP(nn.Module):
    """The Recursive Feature Pyramid on ``(img, C2..C5)`` from a
    ``DetectoRSResNet(output_img=True)``: the FPN (``fpn``; extra levels by
    max pool) on C2-C5, then ``rfp_steps - 1`` times: levels 1-3 each
    through the shared ASPP (``aspp_conv{i}``: a 1x1 at dilation 1, else a
    3x3 padded by its dilation, each with a bias and a ReLU; the last
    branch a 1x1 on the level's spatial mean, broadcast), concatenated, go
    to stages 2-4 of ``rfp_backbone`` run on the image again, the same FPN
    runs on its outputs (so the FPN's gradient is the sum over its calls),
    and each new level ``n`` replaces the old ``o`` by ``s * n + (1 - s) *
    o`` with ``s`` the sigmoid (``losses.sigmoid``) of the zero-initialised
    1x1 ``rfp_weight`` on ``n``.  One feedback backbone serves every step (ARCHITECTURE.md
    deviation 9; exact at the configs' ``rfp_steps=2``)."""

    def __init__(self, gen: torch.Generator, in_channels: Sequence[int], rfp_backbone: nn.Module,
                 out_channels: int = 256, num_outs: int = 5, rfp_steps: int = 2,
                 aspp_out_channels: int = 64, aspp_dilations=(1, 3, 6, 1)):
        super().__init__()
        self.rfp_steps, self.dilations = rfp_steps, tuple(aspp_dilations)
        self.fpn = FPN(gen, in_channels, out_channels, num_outs)
        for i, d in enumerate(self.dilations):
            k = 3 if d > 1 else 1
            self.add_module(f"aspp_conv{i}", make_conv(out_channels, aspp_out_channels, k, 1,
                                                       d if d > 1 else 0, True, gen, dilation=d))
        self.rfp_weight = make_conv(out_channels, 1, 1, 1, 0, True, gen)
        nn.init.zeros_(self.rfp_weight.weight)
        self.rfp_backbone = rfp_backbone

    def aspp(self, t: torch.Tensor) -> torch.Tensor:
        last = len(self.dilations) - 1
        outs = [F.relu(getattr(self, f"aspp_conv{i}")(
            t.float().mean((2, 3), keepdim=True).to(t.dtype) if i == last else t))
            for i in range(last + 1)]
        outs[-1] = outs[-1].expand_as(outs[-2])
        return torch.cat(outs, 1)

    def forward(self, inputs):
        img, feats = inputs[0], tuple(inputs[1:])
        x = list(self.fpn(feats))
        for _ in range(self.rfp_steps - 1):
            rfp_feats = [None] + [self.aspp(x[i]) for i in range(1, 4)]
            x_new = self.fpn(self.rfp_backbone(img, rfp_feats=rfp_feats))
            gates = [sigmoid(self.rfp_weight(n)) for n in x_new]
            x = [s * n + (1 - s) * o for s, n, o in zip(gates, x_new, x)]
        return tuple(x)
