"""The FCN mask head and its targets and loss (PyTorch port of
``boosting_rcnn_tpu/models/roi_heads/mask_head.py``).

``FCNMaskHead``: ``num_convs`` 3x3 convs with ReLU, a 2x2 stride-2
transposed conv with ReLU, and a 1x1 ``conv_logits`` with one channel per
class, out in float32; the pooled RoI features ``(R, 14, 14, C)`` in and
the logits ``(R, 28, 28, K)`` out, in the JAX package's NHWC layout (the
convolutions run on NCHW views).  Norms and ``NormedConv2d`` are not
ported (the builder raises).

``resample_mask_targets``: each RoI's ``out_size`` x ``out_size`` binary
target, a bilinear resample of its matched gt's box-relative crop under
the RoI-to-gt-box map, thresholded at 0.5 (the JAX package's fixed-shape
form of mmdet's ``mask_target``).  ``mask_loss``: binary cross entropy on
the gt class's channel, averaged over the positives and the mask cells;
the channel is taken with a one-hot product, whose gradient is
elementwise (a ``gather``'s is a scatter-add with float atomics on the
GPU, which differs from run to run).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import losses as L
from ..layers import make_conv, make_conv_transpose


class FCNMaskHead(nn.Module):
    """``(R, S, S, C)`` pooled features -> ``(R, 2S, 2S, num_classes)``
    float32 logits."""

    def __init__(self, gen: torch.Generator, num_classes: int = 80, in_channels: int = 256,
                 num_convs: int = 4, conv_channels: int = 256):
        super().__init__()
        self.num_convs = num_convs
        cin = in_channels
        for i in range(num_convs):
            self.add_module(f"conv_{i}", make_conv(cin, conv_channels, 3, 1, 1, True, gen))
            cin = conv_channels
        self.upsample = make_conv_transpose(cin, conv_channels, 2, 2, gen)
        self.conv_logits = make_conv(conv_channels, num_classes, 1, 1, 0, True, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv_{i}")(x))
        x = F.relu(self.upsample(x))
        return self.conv_logits(x).float().permute(0, 2, 3, 1)


@torch.no_grad()
def resample_mask_targets(gt_mask_crops: torch.Tensor, gt_boxes: torch.Tensor,
                          roi_boxes: torch.Tensor, roi_gt_idx: torch.Tensor,
                          out_size: int = 28) -> torch.Tensor:
    """Binary ``(R, out, out)`` float32 targets: the crops ``(G, S, S)`` of
    the gt boxes ``(G, 4)`` they are relative to, sampled bilinearly at the
    cell centres of the RoIs ``(R, 4)`` of matched gts ``roi_gt_idx``
    ``(R,)``, then ``>= 0.5``."""
    s = gt_mask_crops.shape[-1]
    dev = roi_boxes.device
    crops = gt_mask_crops.float()[roi_gt_idx]  # (R, S, S)
    gb = gt_boxes[roi_gt_idx]
    gw = torch.clamp(gb[:, 2] - gb[:, 0], min=1e-3)
    gh = torch.clamp(gb[:, 3] - gb[:, 1], min=1e-3)
    # the RoI's cell centres in image coordinates; a tensor divisor, since
    # CUDA's division by a Python number multiplies by its reciprocal
    frac = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) / torch.full(
        (), out_size, dtype=torch.float32, device=dev)
    rx = roi_boxes[:, 0:1] + frac[None, :] * (roi_boxes[:, 2:3] - roi_boxes[:, 0:1])
    ry = roi_boxes[:, 1:2] + frac[None, :] * (roi_boxes[:, 3:4] - roi_boxes[:, 1:2])
    # in crop cells
    cx = (rx - gb[:, 0:1]) / gw[:, None] * s - 0.5  # (R, out)
    cy = (ry - gb[:, 1:2]) / gh[:, None] * s - 0.5
    x = torch.clamp(cx, 0.0, s - 1.0)
    y = torch.clamp(cy, 0.0, s - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=s - 1)
    y1 = torch.clamp(y0 + 1, max=s - 1)
    lx = x - x0
    ly = y - y0
    r = torch.arange(crops.shape[0], device=dev)[:, None, None]

    def at(yy, xx):
        return crops[r, yy[:, :, None], xx[:, None, :]]

    w00 = (1 - ly)[:, :, None] * (1 - lx)[:, None, :]
    w01 = (1 - ly)[:, :, None] * lx[:, None, :]
    w10 = ly[:, :, None] * (1 - lx)[:, None, :]
    w11 = ly[:, :, None] * lx[:, None, :]
    out = at(y0, x0) * w00 + at(y0, x1) * w01 + at(y1, x0) * w10 + at(y1, x1) * w11
    return (out >= 0.5).float()


def mask_loss(mask_logits: torch.Tensor, mask_targets: torch.Tensor, labels: torch.Tensor,
              pos_mask: torch.Tensor, loss_weight: float = 1.0) -> torch.Tensor:
    """Binary cross entropy of the ``(R, m, m, K)`` logits' channel
    ``labels`` ``(R,)`` (clamped to the classes) against ``(R, m, m)``
    targets, summed over the ``pos_mask`` RoIs and divided by their count
    (at least 1) times ``m * m`` (mmdet ``FCNMaskHead.loss``)."""
    r, m, _, c = mask_logits.shape
    onehot = F.one_hot(torch.clamp(labels.long(), 0, c - 1), c).to(mask_logits.dtype)
    logits = (mask_logits * onehot[:, None, None, :]).sum(-1)
    elem = L.binary_cross_entropy_loss(logits, mask_targets, reduction="none")
    posf = pos_mask.float()
    num = torch.clamp(posf.sum(), min=1.0)
    return (elem * posf[:, None, None]).sum() / (num * m * m) * loss_weight
