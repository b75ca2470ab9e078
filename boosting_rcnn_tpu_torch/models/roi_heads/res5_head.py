"""The C4 detectors' shared res5 head (PyTorch port of JAX
``models/detectors/trident.py::Res5BBoxHead`` and its res5 block,
``models/backbones/trident_resnet.py::_Bottleneck``; reference
``roi_heads/shared_heads/res_layer.py`` and the ``with_avg_pool``
``BBoxHead``).

``Res5Bottleneck`` is a ResNet bottleneck with frozen BN (its scale and
bias train, its statistics stay), the stride on ``conv1`` in the caffe
style and on ``conv2`` in the pytorch style, and a ``down_conv`` /
``down_bn`` shortcut where the shape changes.  ``Res5BBoxHead`` runs three
of them, the first at stride 2, from the pooled ``(R, 14, 14, C)`` RoI
features to ``(R, 7, 7, 4 planes)`` (``res5``), then the mean over the
7 x 7 cells and ``fc_cls`` / ``fc_reg``.  The C4 Mask R-CNN's mask branch
runs ``res5`` too, with the same parameters (``TwoStageNet.mask_out``).
``planes`` is 512 (2048 channels out) in both packages; the JAX builder
reads nothing that changes it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import FrozenBatchNorm, make_conv, make_linear

__all__ = ["Res5Bottleneck", "Res5BBoxHead"]


class Res5Bottleneck(nn.Module):
    """NCHW ``(R, cin, H, W)`` -> ``(R, 4 planes, H / stride, W / stride)``."""

    def __init__(self, cin: int, planes: int, stride: int, gen: torch.Generator,
                 style: str = "pytorch"):
        super().__init__()
        out = planes * 4
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        self.conv1 = make_conv(cin, planes, 1, s1, 0, False, gen)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = make_conv(planes, planes, 3, s2, 1, False, gen)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = make_conv(planes, out, 1, 1, 0, False, gen)
        self.bn3 = FrozenBatchNorm(out)
        if stride != 1 or cin != out:
            self.down_conv = make_conv(cin, out, 1, stride, 0, False, gen)
            self.down_bn = FrozenBatchNorm(out)
        else:
            self.down_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return F.relu(y + identity)


class Res5BBoxHead(nn.Module):
    """``(R, 14, 14, C)`` pooled features -> (cls ``(R, K+1)``, reg ``(R,
    4K)`` or ``(R, 4)``) in the compute dtype."""

    num_blocks = 3  # ResNet-50's stage 4

    def __init__(self, gen: torch.Generator, num_classes: int = 80, in_channels: int = 1024,
                 planes: int = 512, reg_class_agnostic: bool = False, style: str = "pytorch"):
        super().__init__()
        self.num_classes = num_classes
        self.out_channels = planes * 4
        cin = in_channels
        for b in range(self.num_blocks):
            self.add_module(f"res5_{b}", Res5Bottleneck(cin, planes, 2 if b == 0 else 1, gen,
                                                        style))
            cin = self.out_channels
        self.fc_cls = make_linear(cin, num_classes + 1, gen)
        self.fc_reg = make_linear(cin, 4 if reg_class_agnostic else 4 * num_classes, gen)

    def res5(self, x: torch.Tensor) -> torch.Tensor:
        """``(R, 14, 14, C)`` -> ``(R, 7, 7, 4 planes)``, NHWC in and out."""
        x = x.permute(0, 3, 1, 2)
        for b in range(self.num_blocks):
            x = getattr(self, f"res5_{b}")(x)
        return x.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.res5(x)
        # jnp.mean: a float32 sum, divided (a tensor divisor: CUDA's division
        # by a Python number multiplies by its reciprocal), cast back
        cells = torch.full((), x.shape[1] * x.shape[2], dtype=torch.float32, device=x.device)
        x = (x.float().sum((1, 2)) / cells).to(x.dtype)
        return self.fc_cls(x), self.fc_reg(x)
