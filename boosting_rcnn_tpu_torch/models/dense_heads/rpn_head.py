"""The plain RPN head of Faster and Mask R-CNN (PyTorch port of
``boosting_rcnn_tpu/models/dense_heads/rpn_head.py``).

``RPNConvs``: a 3x3 ``rpn_conv`` + ReLU shared by the pyramid levels, then
the 1x1 ``rpn_cls`` (A objectness logits, in the compute dtype) and
``rpn_reg`` (A*4 deltas, float32).  ``rpn_proposals``: sigmoid scores,
per-level exact top-``nms_pre``, decode within the image, level-aware NMS.
``rpn_loss``: max-IoU assignment (low-quality matches on), a random sample
of ``num_samples`` anchors per image with ``pos_fraction`` positives, the
sampled slots scattered back onto the anchor axis, then binary cross
entropy on the objectness and smooth L1 on the encoded deltas of the
positives, both averaged over the sampled anchors of the batch.  More than
one ``rpn_conv`` and the focal objectness loss raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops
from ...ops import losses as L
from ...ops.assigners import max_iou_assign
from ...ops.samplers import random_sample, random_sample_from_uniforms
from ..layers import make_conv
from .atss_rpn_head import level_topk_nms


class RPNConvs(nn.Module):
    """Per-level NCHW features -> per-level NCHW (cls, reg, None) maps."""

    def __init__(self, gen: torch.Generator, in_channels: int = 256, num_anchors: int = 3,
                 feat_channels: int = 256):
        super().__init__()
        self.rpn_conv = make_conv(in_channels, feat_channels, 3, 1, 1, True, gen)
        self.rpn_cls = make_conv(feat_channels, num_anchors, 1, 1, 0, True, gen)
        self.rpn_reg = make_conv(feat_channels, num_anchors * 4, 1, 1, 0, True, gen)

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_out, reg_out = [], []
        for x in feats:
            y = F.relu(self.rpn_conv(x))
            cls_out.append(self.rpn_cls(y))
            reg_out.append(self.rpn_reg(y).float())  # JAX rpn_head.py:52
        return cls_out, reg_out, None


@dataclasses.dataclass(frozen=True)
class RPNCfg:
    """The JAX ``RPNCfg``: box coder, train assigner and sampler, losses."""

    target_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    pos_iou_thr: float = 0.7
    neg_iou_thr: float = 0.3
    min_pos_iou: float = 0.3
    num_samples: int = 256
    pos_fraction: float = 0.5
    smooth_l1_beta: float = 1.0 / 9.0
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 1.0
    loss_cls_type: str = "bce"


def rpn_proposals(cfg: RPNCfg, cls_logits: torch.Tensor, bbox_preds: torch.Tensor,
                  anchors: torch.Tensor, num_level_anchors: Sequence[int],
                  img_shapes: torch.Tensor, nms_pre: int = 1000, max_per_img: int = 1000,
                  nms_iou_thr: float = 0.7, min_bbox_size: float = 0.0):
    """Proposals for a batch (``_get_bboxes_single`` per image):
    ``cls_logits`` ``(B, A)``, ``bbox_preds`` ``(B, A, 4)``, ``anchors``
    ``(A, 4)``, ``img_shapes`` ``(B, 2)``.  Returns ``(boxes (B, max, 4),
    scores (B, max), valid)``, the scores the float32 sigmoid of the
    objectness."""
    scores = torch.sigmoid(cls_logits.float())
    return level_topk_nms(scores, bbox_preds, anchors, num_level_anchors, img_shapes,
                          cfg.target_means, cfg.target_stds, nms_pre, max_per_img, nms_iou_thr,
                          min_bbox_size)


def rpn_targets(cfg: RPNCfg, anchors: torch.Tensor, valid: torch.Tensor,
                gt_bboxes: torch.Tensor, gt_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[torch.Tensor] = None):
    """Targets of one image: (positive mask ``(A,)``, sample weights
    ``(A,)``, 1 on the sampled anchors, encoded box targets ``(A, 4)``, zero
    off the positives).  The sampler ranks by ``uniforms`` ``(2, A)``
    (positives, negatives) when given, else by draws from ``generator``.
    Only the sampled slots are scattered onto the anchor axis: the JAX
    package scatters the padding slots too, onto anchor 0, where they add
    a zero weight and set no positive."""
    if cfg.loss_cls_type != "bce":
        raise NotImplementedError(f"RPN loss_cls_type={cfg.loss_cls_type!r} is not ported")
    assign = max_iou_assign(anchors, valid, gt_bboxes, gt_mask, pos_iou_thr=cfg.pos_iou_thr,
                            neg_iou_thr=cfg.neg_iou_thr, min_pos_iou=cfg.min_pos_iou,
                            match_low_quality=True)
    kw = dict(num=cfg.num_samples, pos_fraction=cfg.pos_fraction)
    if uniforms is not None:
        res = random_sample_from_uniforms(assign, valid, uniforms[0], uniforms[1], **kw)
    else:
        res = random_sample(assign, valid, generator=generator, **kw)
    a = anchors.shape[0]
    inds = res.inds[res.valid]
    weight = torch.zeros(a, device=anchors.device).index_put_(
        (inds,), torch.ones_like(inds, dtype=torch.float32))
    pos = torch.zeros(a, dtype=torch.bool, device=anchors.device).index_put_(
        (inds,), res.is_pos[res.valid])
    safe = torch.clamp(assign.gt_inds - 1, 0, gt_bboxes.shape[0] - 1)
    enc = box_ops.bbox2delta(anchors, box_ops.take_small_table(gt_bboxes, safe),
                             cfg.target_means, cfg.target_stds, eps=1e-6)
    return pos, weight, torch.where(pos[:, None], enc, torch.zeros_like(enc))


def rpn_loss(cfg: RPNCfg, cls_logits: torch.Tensor, bbox_preds: torch.Tensor,
             anchors: torch.Tensor, valid: torch.Tensor, gt_bboxes: torch.Tensor,
             gt_mask: torch.Tensor, generator: Optional[torch.Generator] = None,
             uniforms: Optional[torch.Tensor] = None):
    """RPN losses of a batch: ``cls_logits`` ``(B, A)``, ``bbox_preds``
    ``(B, A, 4)``, ``anchors`` ``(A, 4)``, ``valid`` ``(B, A)``,
    ``gt_bboxes`` ``(B, G, 4)``, ``gt_mask`` ``(B, G)``; the samplers' draws
    from ``generator``, or the given ``uniforms`` ``(B, 2, A)`` (the JAX
    package's: per image, the uniforms of the two halves of its key)."""
    b = cls_logits.shape[0]
    with torch.no_grad():
        targets = [rpn_targets(cfg, anchors, valid[i], gt_bboxes[i], gt_mask[i], generator,
                               None if uniforms is None else uniforms[i])
                   for i in range(b)]
    pos, weight, box_t = (torch.stack(x) for x in zip(*targets))
    num_total = torch.clamp(weight.sum(), min=1.0)
    loss_cls = L.binary_cross_entropy_loss(
        cls_logits.reshape(-1), pos.reshape(-1).float(), weight=weight.reshape(-1),
        avg_factor=num_total) * cfg.loss_cls_weight
    loss_bbox = L.smooth_l1_loss(
        bbox_preds.reshape(-1, 4), box_t.reshape(-1, 4), weight=pos.reshape(-1, 1).float(),
        beta=cfg.smooth_l1_beta, avg_factor=num_total) * cfg.loss_bbox_weight
    return {"loss_rpn_cls": loss_cls, "loss_rpn_bbox": loss_bbox}
