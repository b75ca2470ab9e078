"""The FCN mask head and its targets and loss (PyTorch port of
``boosting_rcnn_tpu/models/roi_heads/mask_head.py``).

``FCNMaskHead``: ``num_convs`` 3x3 convs with ReLU, a 2x2 stride-2
transposed conv with ReLU, and a 1x1 ``conv_logits`` with one channel per
class, out in float32; the pooled RoI features ``(R, 14, 14, C)`` in and
the logits ``(R, 28, 28, K)`` out, in the JAX package's NHWC layout (the
convolutions run on NCHW views).  With a ``norm_cfg`` its convs are
ConvModules (no bias, the norm, ReLU; JAX ``mask_head.py:51-80``: the GN
heads).  ``NormedConv2d`` is not ported (the builder raises).  HTC's ``HTCMaskHead`` adds the mask
information flow (``conv_res``) and hands out its running feature;
``FusedSemanticHead`` and ``semantic_seg_loss`` are HTC's stuff branch.

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

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import losses as L
from ..layers import ConvModule, bilinear_resize, make_conv, make_conv_transpose


class FCNMaskHead(nn.Module):
    """``(R, S, S, C)`` pooled features -> ``(R, 2S, 2S, num_classes)``
    float32 logits."""

    def __init__(self, gen: torch.Generator, num_classes: int = 80, in_channels: int = 256,
                 num_convs: int = 4, conv_channels: int = 256, norm_cfg: Optional[dict] = None):
        super().__init__()
        self.num_convs = num_convs
        cin = in_channels
        for i in range(num_convs):
            self.add_module(f"conv_{i}", make_conv(cin, conv_channels, 3, 1, 1, True, gen)
                            if norm_cfg is None else
                            ConvModule(cin, conv_channels, 3, gen, norm_cfg=norm_cfg))
            cin = conv_channels
        self.upsample = make_conv_transpose(cin, conv_channels, 2, 2, gen)
        self.conv_logits = make_conv(conv_channels, num_classes, 1, 1, 0, True, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._convs(x.permute(0, 3, 1, 2))
        x = F.relu(self.upsample(x))
        return self.conv_logits(x).float().permute(0, 2, 3, 1)

    def _convs(self, x: torch.Tensor) -> torch.Tensor:
        """The 3x3 convs (and norms), each with its ReLU."""
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv_{i}")(x))
        return x


class HTCMaskHead(FCNMaskHead):
    """HTC's mask head (JAX ``HTCMaskHead``, reference
    ``htc_mask_head.py``): ``FCNMaskHead`` plus, where ``res_channels`` is
    given, a 1x1 ``conv_res`` from the previous stage's running feature to
    the pooled input's channels, whose ReLU is added to the pooled input
    (mask information flow).  The flax module creates ``conv_res`` only
    when it is called with a feature, so a head without one (stage 0, and
    every head of Cascade Mask R-CNN) owns none here either."""

    def __init__(self, gen: torch.Generator, num_classes: int = 80, in_channels: int = 256,
                 num_convs: int = 4, conv_channels: int = 256,
                 res_channels: Optional[int] = None):
        super().__init__(gen, num_classes, in_channels, num_convs, conv_channels)
        self.conv_res = (None if res_channels is None
                         else make_conv(res_channels, in_channels, 1, 1, 0, True, gen))

    def forward(self, x: torch.Tensor, res_feat: Optional[torch.Tensor] = None,
                return_logits: bool = True, return_feat: bool = True):
        """``(R, S, S, C)`` pooled features and the previous head's running
        feature ``(R, S, S, C')`` or None -> the ``(R, 2S, 2S, K)`` float32
        logits and/or this head's running feature ``(R, S, S,
        conv_channels)`` (both as a tuple when both are asked for)."""
        x = x.permute(0, 3, 1, 2)
        if res_feat is not None:
            if self.conv_res is None:
                raise ValueError("this mask head has no conv_res to fuse a running feature")
            x = x + F.relu(self.conv_res(res_feat.permute(0, 3, 1, 2)))
        x = self._convs(x)
        outs = []
        if return_logits:
            y = F.relu(self.upsample(x))
            outs.append(self.conv_logits(y).float().permute(0, 2, 3, 1))
        if return_feat:
            outs.append(x.permute(0, 2, 3, 1))
        return outs[0] if len(outs) == 1 else tuple(outs)


class FusedSemanticHead(nn.Module):
    """HTC's semantic branch (JAX ``FusedSemanticHead``, reference
    ``fused_semantic_head.py``): a 1x1 lateral conv on every neck level,
    each nearest-resized (half-pixel centres) to level ``fusion_level`` and
    summed onto its lateral in level order, ``num_convs`` 3x3 convs with
    ReLU, then the embedding (a 1x1 conv, no ReLU, in the compute dtype)
    and the stuff logits (a 1x1 conv, out in float32).  The JAX package
    resizes by nearest neighbour where mmdet resizes bilinearly; the port
    copies it."""

    def __init__(self, gen: torch.Generator, num_ins: int = 5, in_channels: int = 256,
                 num_classes: int = 183, fusion_level: int = 1, num_convs: int = 4,
                 channels: int = 256):
        super().__init__()
        self.num_ins, self.fusion_level, self.num_convs = num_ins, fusion_level, num_convs
        order = [fusion_level] + [i for i in range(num_ins) if i != fusion_level]
        for i in order:  # flax creates the fusion level's lateral first
            self.add_module(f"lateral_{i}", make_conv(in_channels, channels, 1, 1, 0, True, gen))
        for i in range(num_convs):
            self.add_module(f"conv_{i}", make_conv(channels, channels, 3, 1, 1, True, gen))
        self.conv_embedding = make_conv(channels, channels, 1, 1, 0, True, gen)
        self.conv_seg = make_conv(channels, num_classes, 1, 1, 0, True, gen)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Neck levels L x ``(B, H, W, C)`` -> (stuff logits ``(B, h, w, K)``
        float32, embedding ``(B, h, w, channels)``) at the fusion level's
        ``(h, w)``."""
        if len(feats) != self.num_ins:
            raise ValueError(f"{len(feats)} levels for a semantic head of {self.num_ins}")
        levels = [f.permute(0, 3, 1, 2) for f in feats]
        ref = levels[self.fusion_level]
        x = getattr(self, f"lateral_{self.fusion_level}")(ref)
        for i, f in enumerate(levels):
            if i != self.fusion_level:
                x = x + bilinear_resize(getattr(self, f"lateral_{i}")(f), ref.shape[-2:])
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv_{i}")(x))
        embedding = self.conv_embedding(x).permute(0, 2, 3, 1)
        seg = self.conv_seg(x).float().permute(0, 2, 3, 1)
        return seg, embedding


def semantic_seg_loss(seg_logits: torch.Tensor, gt_seg: torch.Tensor,
                      ignore_index: int = 255) -> torch.Tensor:
    """Pixel cross entropy of the ``(B, h, w, K)`` logits against the stuff
    map ``(B, h, w)``, averaged over the pixels of a class in ``[0, K)``
    (``ignore_index`` and anything else out of range count nowhere; at
    least 1 pixel).  The class's log-probability is taken with a one-hot
    product, whose gradient is elementwise (the JAX package's
    ``take_along_axis``)."""
    c = seg_logits.shape[-1]
    gt = gt_seg.long()
    valid = (gt != ignore_index) & (gt >= 0) & (gt < c)
    onehot = F.one_hot(torch.clamp(gt, 0, c - 1), c).to(seg_logits.dtype)
    ll = (L.log_softmax(seg_logits) * onehot).sum(-1)
    loss = -torch.where(valid, ll, torch.zeros_like(ll))
    return loss.sum() / torch.clamp(valid.float().sum(), min=1.0)


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``(B, H, W)`` integer map nearest-resized to ``out_hw`` with
    half-pixel centres, as ``jax.image.resize(x.astype(float32), ...,
    "nearest")`` (the stuff map to the logit grid, JAX ``htc.py:205-215``)."""
    return bilinear_resize(x[:, None].float(), out_hw)[:, 0].long()


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
