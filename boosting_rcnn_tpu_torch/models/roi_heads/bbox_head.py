"""R-CNN box head, inference (PyTorch port of
``boosting_rcnn_tpu/models/roi_heads/bbox_head.py``).

``ConvFCBBoxHead`` with the flagship's Shared2FC layout: the pooled
``(N, 7, 7, C)`` RoI features are flattened in (H, W, C) order, as in the
JAX package, so the first FC takes the JAX kernel with no column
permutation.  ``bbox_head_decode`` decodes the class-wise deltas and runs
multiclass NMS for one image.  ``bbox_targets`` and ``bbox_head_loss`` are
the train side with the flagship's losses, softmax cross entropy and L1 on
encoded class-wise deltas; other loss types raise ``NotImplementedError``.
The head computes in the compute dtype of its ``Linear`` layers, and cls
and reg come out in it (JAX ``roi_heads/bbox_head.py:143-157``); the
losses compute in the predictions' dtype until a float32 weight promotes
them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops
from ...ops import losses as L
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
    """The JAX ``BBoxHeadCfg``, as far as the flagship sets it."""

    num_classes: int = 4
    target_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    reg_class_agnostic: bool = False
    reg_decoded_bbox: bool = False
    loss_cls_weight: float = 2.0
    loss_bbox_weight: float = 2.0
    loss_bbox_type: str = "l1"
    loss_cls_type: str = "ce"


def _check_train_cfg(cfg: BBoxHeadCfg) -> None:
    for what, value, ported in (("reg_class_agnostic", cfg.reg_class_agnostic, False),
                                ("reg_decoded_bbox", cfg.reg_decoded_bbox, False),
                                ("loss_bbox_type", cfg.loss_bbox_type, "l1"),
                                ("loss_cls_type", cfg.loss_cls_type, "ce")):
        if value != ported:
            raise NotImplementedError(f"bbox head {what}={value!r} is not ported")


def bbox_targets(cfg: BBoxHeadCfg, sampled_boxes: torch.Tensor, is_pos: torch.Tensor,
                 valid: torch.Tensor, matched_gt_boxes: torch.Tensor,
                 matched_gt_labels: torch.Tensor):
    """Targets of ``(R,)`` sampled RoIs: labels (background =
    ``num_classes``), unit label weights on valid slots, encoded box
    targets and unit box weights on positives."""
    _check_train_cfg(cfg)
    labels = torch.where(is_pos, matched_gt_labels.long(),
                         torch.full_like(matched_gt_labels.long(), cfg.num_classes))
    label_weights = valid.float()
    t = box_ops.bbox2delta(sampled_boxes, matched_gt_boxes, cfg.target_means,
                           cfg.target_stds, eps=1e-6)
    t = torch.where(is_pos[:, None], t, torch.zeros_like(t))
    bbox_weights = is_pos[:, None].float().expand(-1, 4)
    return labels, label_weights, t, bbox_weights


def bbox_head_loss(cfg: BBoxHeadCfg, cls_score: torch.Tensor, bbox_pred: torch.Tensor,
                   rois: torch.Tensor, labels: torch.Tensor, label_weights: torch.Tensor,
                   bbox_t: torch.Tensor, bbox_w: torch.Tensor,
                   reduction_override: Optional[str] = None):
    """The head loss on ``(R, K+1)`` logits and ``(R, 4K)`` deltas.  With
    ``reduction_override='none'`` the elementwise losses come back, for the
    boosting renormalisation; else cls is averaged over the weighted slots
    and the box loss over all ``R``."""
    _check_train_cfg(cfg)
    r = cls_score.shape[0]
    c = cfg.num_classes
    pos = (labels >= 0) & (labels < c)
    safe_lab = torch.clamp(labels, 0, c - 1)
    # the label's deltas by a one-hot product, exact, with an elementwise
    # gradient (a gather's is a scatter-add with float atomics on the GPU)
    onehot = F.one_hot(safe_lab.long(), c).to(bbox_pred.dtype)
    pred4 = (bbox_pred.reshape(r, c, 4) * onehot[:, :, None]).sum(1)
    elem = (pred4 - bbox_t).abs() * bbox_w * pos.float()[:, None] * cfg.loss_bbox_weight
    ce = L.cross_entropy_loss(cls_score, labels, reduction="none")
    ce = ce * label_weights * cfg.loss_cls_weight
    if reduction_override == "none":
        return {"loss_cls": ce, "loss_bbox": elem, "pos": pos}
    avg_cls = torch.clamp((label_weights > 0).float().sum(), min=1.0)
    return {"loss_cls": ce.sum() / avg_cls, "loss_bbox": elem.sum() / max(r, 1), "pos": pos}


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
