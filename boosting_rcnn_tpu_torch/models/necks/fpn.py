"""PAFPN neck (PyTorch port of ``boosting_rcnn_tpu/models/necks/fpn.py``).

FPN top-down merge (nearest upsample with half-pixel centres), then the
PAFPN bottom-up path (``downsample_{i}`` stride-2 convs, ``pafpn_conv_{i}``),
then extra levels by stride-2 convs on the last output
(``add_extra_convs='on_output'``, ``FPN._add_extra_levels``).  No norm and
no activation, as the flagship config has.  NCHW in and out.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..layers import ConvModule, bilinear_resize


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
        laterals = [getattr(self, f"lateral_{i}")(inputs[self.start_level + i])
                    for i in range(used)]
        for i in range(used - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + bilinear_resize(
                laterals[i], laterals[i - 1].shape[-2:])
        inter = [getattr(self, f"fpn_conv_{i}")(laterals[i]) for i in range(used)]
        for i in range(used - 1):
            inter[i + 1] = inter[i + 1] + getattr(self, f"downsample_{i}")(inter[i])
        outs = [inter[0]] + [getattr(self, f"pafpn_conv_{i - 1}")(inter[i])
                             for i in range(1, used)]
        for i in range(used, self.num_outs):
            outs.append(getattr(self, f"fpn_conv_{i}")(outs[-1]))
        return tuple(outs)
