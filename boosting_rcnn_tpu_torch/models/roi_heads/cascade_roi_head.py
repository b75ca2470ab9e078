"""Cascade R-CNN RoI head, plain and probabilistic (PyTorch port of
``boosting_rcnn_tpu/models/roi_heads/cascade_roi_head.py``).

The reference is mmdet's ``CascadeRoIHead`` and the fork's
``ProbCascadeRoIHead`` (``prob_roi_head.py:627-881``): stages with rising
assigner IoU thresholds (0.5 / 0.6 / 0.7), tightening coder stds and stage
loss weights (1, 0.5, 0.25).  In training each stage assigns and samples
the boxes that the stage before it refined; at test every stage refines
all proposals, the stages' logits are averaged, and the last stage's
deltas give the boxes.

As in the JAX package, each stage's coder stds come from a fixed ladder
indexed by ``min(stage, 2)`` (``stage_head_cfg``), whatever the stage
config says, and every stage decodes and takes its losses with stage 0's
``BBoxHeadCfg`` otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ...ops import box_ops
from .bbox_head import BBoxHeadCfg, bbox_head_loss, bbox_targets
from .prob_roi_head import RoISample, norm_loss

# the coder stds of stages 0, 1 and 2 and later (mmdet's cascade configs)
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1), (0.033, 0.033, 0.067, 0.067))


@dataclasses.dataclass(frozen=True)
class CascadeCfg:
    num_stages: int = 3
    stage_loss_weights: Tuple[float, ...] = (1.0, 0.5, 0.25)
    stage_pos_iou: Tuple[float, ...] = (0.5, 0.6, 0.7)
    # ProbCascadeRoIHead: prior fusion at test, boosting loss in training
    prob: bool = False
    boost: bool = False
    gamma: float = 0.1
    # HTC trains each stage's mask branch on the boxes the stage refined,
    # sampled again (``htc_roi_head.py:296``); Cascade Mask R-CNN on the
    # stage's own sample (``cascade_roi_head.py``)
    interleaved: bool = True


def stage_head_cfg(base: BBoxHeadCfg, stage: int) -> BBoxHeadCfg:
    """``base`` with the coder stds of ``stage``."""
    return dataclasses.replace(base, target_stds=STAGE_STDS[min(stage, 2)])


def refine_boxes(head_cfg: BBoxHeadCfg, rois: torch.Tensor, cls_score: torch.Tensor,
                 bbox_pred: torch.Tensor, img_shape: torch.Tensor) -> torch.Tensor:
    """``regress_by_class`` (reference ``bbox_head.py:461``): each of the
    ``(..., R, 4)`` RoIs decoded with the deltas of its argmax foreground
    class (first on ties), or with the one agnostic set, and clipped to
    ``img_shape`` (``(H, W)``, or ``(B, 2)`` for a leading batch axis).
    ``cls_score`` is ``(..., R, K+1)``, ``bbox_pred`` ``(..., R, 4K)`` or
    ``(..., R, 4)``."""
    if head_cfg.reg_class_agnostic:
        pred4 = bbox_pred
    else:
        c = head_cfg.num_classes
        label = torch.argmax(cls_score[..., :c], dim=-1)
        per_class = bbox_pred.reshape(*bbox_pred.shape[:-1], c, 4)
        idx = label[..., None, None].expand(*label.shape, 1, 4)
        pred4 = torch.gather(per_class, -2, idx)[..., 0, :]
    return box_ops.delta2bbox(rois, pred4, head_cfg.target_means, head_cfg.target_stds,
                              max_shape=img_shape)


def cascade_stage_loss(cas_cfg: CascadeCfg, head_cfg: BBoxHeadCfg, stage: int,
                       cls_score: torch.Tensor, bbox_pred: torch.Tensor,
                       sample: RoISample,
                       seesaw_counts: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One stage's losses on a flattened ``(R_total, ...)`` sample (the
    batch's slots, invalid ones included), at the stage's coder stds and
    weighted by its stage loss weight: ``s{stage}.loss_cls`` (boosting:
    the cross entropy weighted by ``(1 - prior)**gamma``, renormalised and
    averaged over ``R_total``; else its mean over the valid slots) and
    ``s{stage}.loss_bbox`` (summed over ``R_total``).  ``seesaw_counts``:
    the stage's Seesaw counts, for a Seesaw head."""
    hc = stage_head_cfg(head_cfg, stage)
    bg = torch.full_like(sample.matched_label, hc.num_classes)
    labels, label_w, bbox_t, bbox_w = bbox_targets(
        hc, sample.boxes, sample.is_pos, sample.valid, sample.matched_gt,
        torch.where(sample.is_pos, sample.matched_label, bg))
    r_total = cls_score.shape[0]
    validf = sample.valid.float()
    raw = bbox_head_loss(hc, cls_score, bbox_pred, sample.boxes, labels, label_w, bbox_t,
                         bbox_w, reduction_override="none", seesaw_counts=seesaw_counts)
    if cas_cfg.boost:
        lw = (1.0 - sample.prior) ** cas_cfg.gamma * validf
        loss_cls = norm_loss(raw["loss_cls"] * validf, lw, float(r_total))
    else:
        loss_cls = (raw["loss_cls"] * validf).sum() / torch.clamp(validf.sum(), min=1.0)
    loss_bbox = raw["loss_bbox"].sum() / float(r_total)
    w = cas_cfg.stage_loss_weights[stage]
    return {f"s{stage}.loss_cls": loss_cls * w, f"s{stage}.loss_bbox": loss_bbox * w}
