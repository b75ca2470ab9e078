"""FPN and PAFPN necks (PyTorch port of ``boosting_rcnn_tpu/models/necks/fpn.py``).

``FPN`` (Mask R-CNN's neck): lateral 1x1 convs, the top-down merge (nearest
upsample with half-pixel centres), 3x3 output convs, and the extra levels
as ``max_pool(outs[-1], 1, 2)`` (``add_extra_convs=False``,
``FPN._add_extra_levels``).  ``PAFPN`` (the flagship's): the FPN top-down
merge, then the bottom-up path (``downsample_{i}`` stride-2 convs,
``pafpn_conv_{i}``), then extra levels by stride-2 convs on the last output
(``add_extra_convs='on_output'``).  No norm and no activation, as both
configs have.  NCHW in and out.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..layers import ConvModule, bilinear_resize, max_pool


def _top_down(neck: nn.Module, inputs, start_level: int, used: int):
    """The lateral convs and the top-down merge: each lateral plus the
    nearest upsample of the one above it."""
    laterals = [getattr(neck, f"lateral_{i}")(inputs[start_level + i]) for i in range(used)]
    for i in range(used - 1, 0, -1):
        laterals[i - 1] = laterals[i - 1] + bilinear_resize(laterals[i],
                                                            laterals[i - 1].shape[-2:])
    return laterals


class FPN(nn.Module):
    """``FPN`` with ``add_extra_convs=False`` and ``start_level=0``: the
    levels past the inputs are stride-2 subsamples of the last output."""

    def __init__(self, gen: torch.Generator, in_channels: Sequence[int],
                 out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.used = len(in_channels)
        self.num_outs = num_outs
        for i, cin in enumerate(in_channels):
            self.add_module(f"lateral_{i}", ConvModule(cin, out_channels, 1, gen))
            self.add_module(f"fpn_conv_{i}", ConvModule(out_channels, out_channels, 3, gen))

    def forward(self, inputs):
        laterals = _top_down(self, inputs, 0, self.used)
        outs = [getattr(self, f"fpn_conv_{i}")(laterals[i]) for i in range(self.used)]
        for _ in range(self.used, self.num_outs):
            outs.append(max_pool(outs[-1], 1, 2, 0))
        return tuple(outs)


class PAFPN(nn.Module):
    def __init__(self, gen: torch.Generator, in_channels: Sequence[int],
                 out_channels: int = 256, num_outs: int = 5, start_level: int = 0,
                 end_level: int = -1):
        super().__init__()
        end = len(in_channels) if end_level == -1 else end_level
        self.start_level = start_level
        self.used = used = end - start_level
        self.num_outs = num_outs
        oc = out_channels
        for i in range(used):
            self.add_module(f"lateral_{i}",
                            ConvModule(in_channels[start_level + i], oc, 1, gen))
            self.add_module(f"fpn_conv_{i}", ConvModule(oc, oc, 3, gen))
        for i in range(used - 1):
            self.add_module(f"downsample_{i}", ConvModule(oc, oc, 3, gen, stride=2))
            self.add_module(f"pafpn_conv_{i}", ConvModule(oc, oc, 3, gen))
        for i in range(used, num_outs):
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
            outs.append(getattr(self, f"fpn_conv_{i}")(outs[-1]))
        return tuple(outs)
