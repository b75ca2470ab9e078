"""Res2Net backbone (PyTorch port of ``boosting_rcnn_tpu/models/backbones/res2net.py``).

``Bottle2neck``: a 1x1 conv to ``scales`` splits of ``width = int(planes *
base_width / base_channels)`` channels (along dim 1, in the JAX package's
order along its last axis); split ``i < scales - 1`` goes through its own
3x3 (``conv2_{i}``, deformable where ``dcn`` is set), frozen BN and ReLU,
after adding the previous split's output, except in "stage mode" (the
first block of each stage, which also carries the projection shortcut),
where no sum runs and the last split is average-pooled (3x3, stride,
zero padding counted, as flax's ``avg_pool``) when the stride is above 1
and passes through otherwise; then the concatenated splits go through
the 1x1 ``conv3``.  ``Res2Net``: the deep stem (``stem_conv{1,2,3}``, 3x3
convs of ``base_channels / 2``, ``/ 2`` and ``base_channels`` at strides
2, 1, 1, each with ``stem_bn{i}`` and ReLU), the 3x3/s2 max pool, then
the four stages of ``ARCH_SETTINGS[depth]``'s block counts, all of
``Bottle2neck``.

As in the JAX package (``res2net.py:71-82``), and unlike mmdet 2.17's
``Res2Net`` as far as its defaults go: the shortcut is a strided 1x1
conv (mmdet's ``avg_down=True`` pools before a stride-1 1x1), and the
stage-mode block pools its last split only at a stride above 1 (mmdet
pools it in every stage-mode block).  The port copies the JAX package,
which its tests hold it to; mmdet's Res2Net checkpoints do not load
(``weights.from_mmdet_state_dict`` raises).

``frozen_stages`` = k freezes the stem and stages 1..k (JAX
``resnet_param_prefixes_for_stage`` with the ``stem_`` prefixes): those
parameters get ``requires_grad=False`` and the activations are detached
after them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import FrozenBatchNorm, avg_pool, make_conv, max_pool
from .resnet import ARCH_SETTINGS, make_dcn


class Bottle2neck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int, downsample: bool,
                 gen: torch.Generator, scales: int = 4, base_width: int = 26,
                 base_channels: int = 64, dcn: Optional[dict] = None):
        super().__init__()
        width = int(planes * (base_width / base_channels))
        out = planes * self.expansion
        self.scales, self.width, self.stride = scales, width, stride
        self.stage_mode = stride > 1 or downsample
        self.conv1 = make_conv(cin, width * scales, 1, 1, 0, False, gen)
        self.bn1 = FrozenBatchNorm(width * scales)
        for i in range(scales - 1):
            conv = (make_dcn(width, width, stride, dcn, gen) if dcn is not None
                    else make_conv(width, width, 3, stride, 1, False, gen))
            self.add_module(f"conv2_{i}", conv)
            self.add_module(f"bn2_{i}", FrozenBatchNorm(width))
        self.conv3 = make_conv(width * scales, out, 1, 1, 0, False, gen)
        self.bn3 = FrozenBatchNorm(out)
        if downsample:
            self.downsample_conv = make_conv(cin, out, 1, stride, 0, False, gen)
            self.downsample_bn = FrozenBatchNorm(out)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        splits = torch.split(y, self.width, dim=1)
        outs, prev = [], None
        for i in range(self.scales - 1):
            sp = splits[i]
            if prev is not None and not self.stage_mode:
                sp = sp + prev
            prev = F.relu(getattr(self, f"bn2_{i}")(getattr(self, f"conv2_{i}")(sp)))
            outs.append(prev)
        last = splits[-1]
        if self.stage_mode and self.stride > 1:
            # a contiguous copy (layers.avg_pool): on a channel slice of a
            # channels-last map the CUDA avg_pool2d backward of PyTorch 2.11
            # gives wrong gradients
            # (tests/test_torch_cuda.py::test_cuda_res2net_block_gradient_matches_cpu)
            last = avg_pool(last, 3, self.stride, 1)
        outs.append(last)
        y = self.bn3(self.conv3(torch.cat(outs, dim=1)))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + identity)


class Res2Net(nn.Module):
    """NCHW images -> the outputs of the four stages C2-C5 (NCHW), stage
    strides (1, 2, 2, 2)."""

    def __init__(self, gen: torch.Generator, depth: int = 101, base_channels: int = 64,
                 scales: int = 4, base_width: int = 26, frozen_stages: int = -1,
                 dcn: Optional[dict] = None, stage_with_dcn=(False, False, False, False)):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise NotImplementedError(f"Res2Net depth {depth} is not ported")
        self.frozen_stages = frozen_stages
        stem = base_channels
        cin = 3
        for i, (ch, s) in enumerate(((stem // 2, 2), (stem // 2, 1), (stem, 1))):
            self.add_module(f"stem_conv{i + 1}", make_conv(cin, ch, 3, s, 1, False, gen))
            self.add_module(f"stem_bn{i + 1}", FrozenBatchNorm(ch))
            cin = ch
        self.stage_names = []
        planes = base_channels
        for stage, n_blocks in enumerate(ARCH_SETTINGS[depth][1]):
            names = []
            for b in range(n_blocks):
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, Bottle2neck(
                    cin, planes, 2 if b == 0 and stage > 0 else 1, b == 0, gen, scales=scales,
                    base_width=base_width, base_channels=base_channels,
                    dcn=dcn if stage_with_dcn[stage] else None))
                names.append(name)
                cin = planes * Bottle2neck.expansion
            self.stage_names.append(names)
            planes *= 2
        frozen = ([getattr(self, f"{p}{i}") for p in ("stem_conv", "stem_bn") for i in (1, 2, 3)]
                  if frozen_stages >= 0 else [])
        for names in self.stage_names[:max(frozen_stages, 0)]:
            frozen += [getattr(self, name) for name in names]
        for module in frozen:
            module.requires_grad_(False)

    def forward(self, x):
        for i in (1, 2, 3):
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
            outs.append(x)
        return tuple(outs)
