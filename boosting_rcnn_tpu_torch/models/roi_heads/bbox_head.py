"""R-CNN box head, inference (PyTorch port of
``boosting_rcnn_tpu/models/roi_heads/bbox_head.py``).

``ConvFCBBoxHead`` with the flagship's Shared2FC layout: the pooled
``(N, 7, 7, C)`` RoI features are flattened in (H, W, C) order, as in the
JAX package, so the first FC takes the JAX kernel with no column
permutation.  ``bbox_head_decode`` decodes the class-wise deltas and runs
multiclass NMS for one image.  The targets and losses are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops
from ...ops.nms import multiclass_nms_padded
from ..layers import make_linear


class ConvFCBBoxHead(nn.Module):
    """``(N, 7, 7, C)`` pooled features -> (cls logits ``(N, K+1)``, class-wise
    deltas ``(N, 4K)``)."""

    def __init__(self, gen: torch.Generator, num_classes: int, in_channels: int = 256,
                 num_shared_fcs: int = 2, fc_out_channels: int = 1024,
                 roi_feat_size: int = 7):
        super().__init__()
        self.num_shared_fcs = num_shared_fcs
        cin = in_channels * roi_feat_size * roi_feat_size
        for i in range(num_shared_fcs):
            self.add_module(f"shared_fc_{i}", make_linear(cin, fc_out_channels, gen))
            cin = fc_out_channels
        self.fc_cls = make_linear(cin, num_classes + 1, gen)
        self.fc_reg = make_linear(cin, 4 * num_classes, gen)

    def forward(self, x: torch.Tensor):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_shared_fcs):
            x = F.relu(getattr(self, f"shared_fc_{i}")(x))
        return self.fc_cls(x), self.fc_reg(x)


@dataclasses.dataclass(frozen=True)
class BBoxHeadCfg:
    """The inference part of the JAX ``BBoxHeadCfg``: classes and coder."""

    num_classes: int = 4
    target_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)


def bbox_head_decode(
    cfg: BBoxHeadCfg,
    rois: torch.Tensor,
    scores: torch.Tensor,
    bbox_pred: torch.Tensor,
    img_shape: torch.Tensor,
    scale_factor: torch.Tensor,
    rescale: bool,
    score_thr: float,
    nms_iou_thr: float,
    max_per_img: int,
    roi_valid: torch.Tensor,
    pre_nms_top_k: int = 2048,
):
    """Decode + multiclass NMS for one image: ``rois`` ``(R, 4)``, ``scores``
    ``(R, K+1)`` already fused, ``bbox_pred`` ``(R, 4K)`` -> ``(dets
    (max, 5), labels (max,), valid (max,))``."""
    r = rois.shape[0]
    c = cfg.num_classes
    boxes = box_ops.delta2bbox(
        rois, bbox_pred, cfg.target_means, cfg.target_stds, max_shape=img_shape
    ).reshape(r, c, 4)
    if rescale:
        boxes = boxes / scale_factor.reshape(1, 1, 4)
    return multiclass_nms_padded(
        boxes, scores[:, :c], score_thr=score_thr, iou_threshold=nms_iou_thr,
        max_per_img=max_per_img, valid=roi_valid, pre_nms_top_k=pre_nms_top_k,
    )
