"""ATSSRPNHead (PyTorch port of
``boosting_rcnn_tpu/models/dense_heads/atss_rpn_head.py``).

``ATSSRPNConvs``: a GN(32) + ReLU conv tower shared by the five FPN levels,
then ``rpn_cls`` (A objectness logits), ``rpn_reg`` (A*4 deltas through a
per-level learnable ``Scale``) and ``rpn_iou`` (A IoU logits).
``atss_rpn_proposals``: fused score ``sqrt(sigmoid(cls) * sigmoid(iou))``,
per-level exact top-``nms_pre``, decode, level-aware NMS, keep
``max_per_img``.

Training (``atss_rpn_targets``, ``atss_rpn_loss``): max-IoU assignment
(``atss=False``) or ATSS assignment over the levels' anchors
(``atss=True``, the ensemble configs' ``cascade_atss``), sigmoid focal
loss on objectness, and one of two box regressions, each with the IoU,
GIoU or CIoU loss (``loss_bbox_type``):

  * on decoded boxes (``reg_decoded_bbox=True``, the flagship's): the box
    loss weighted by ``max(iou_target**gamma, EPS)``; with an
    ``aug_reg_loss`` in the config (``with_aug_loss``, the flagship's) the
    MSE on deltas with the same weights is added and the sum halved;
  * on the encoded deltas (``reg_decoded_bbox=False``, the COCO configs'):
    the IoU target still comes from the decoded prediction against the
    decoded target, but the box loss is applied to the raw delta vectors,
    read as boxes, against the encoded targets, with ``(N, 4)`` weights
    ``max(iou_target**gamma, EPS)`` on the positives (the reference's
    ``loss_single`` else-branch, CIoU on deltas included, copied as the
    JAX package copies it); no MSE term.

Either is divided by ``max(sum iou_target, 1)``; the IoU branch's BCE
against the IoU target is averaged over the positives.  The JAX package's
``lax.pmean`` normalisers become plain sums over the batch on one card.
Varifocal loss and the other box losses (DIoU, EIoU, L1) raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn

from ...ops import box_ops
from ...ops import losses as L
from ...ops.assigners import atss_assign, max_iou_assign
from ...ops.nms import batched_nms_padded
from ...ops.topk import select_topk
from ..layers import ConvModule, Scale, make_conv

PRIOR_BIAS = -4.595  # rpn_cls bias init: prior probability 0.01
EPS = 1e-12


class ATSSRPNConvs(nn.Module):
    """Per-level NCHW features -> per-level (cls, reg, iou) NCHW maps; cls
    and iou in the compute dtype, reg in float32."""

    def __init__(self, gen: torch.Generator, in_channels: int = 256,
                 num_anchors: int = 9, feat_channels: int = 256,
                 stacked_convs: int = 4, num_levels: int = 5):
        super().__init__()
        self.stacked_convs = stacked_convs
        self.num_levels = num_levels
        cin = in_channels
        for i in range(stacked_convs):
            conv = ConvModule(cin, feat_channels, 3, gen,
                              norm_cfg={"type": "GN", "num_groups": 32}, act="relu")
            conv.norm.fast_variance = False
            self.add_module(f"rpn_conv_{i}", conv)
            cin = feat_channels
        self.rpn_cls = make_conv(cin, num_anchors, 3, 1, 1, True, gen, PRIOR_BIAS)
        self.rpn_reg = make_conv(cin, num_anchors * 4, 3, 1, 1, True, gen)
        self.rpn_iou = make_conv(cin, num_anchors, 3, 1, 1, True, gen)
        for lvl in range(num_levels):
            self.add_module(f"scale_{lvl}", Scale())

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_out, reg_out, iou_out = [], [], []
        for lvl, x in enumerate(feats):
            for i in range(self.stacked_convs):
                x = getattr(self, f"rpn_conv_{i}")(x)
            cls_out.append(self.rpn_cls(x))
            # reg leaves the compute dtype after its Scale (JAX atss_rpn_head.py:174)
            reg_out.append(getattr(self, f"scale_{lvl}")(self.rpn_reg(x)).float())
            iou_out.append(self.rpn_iou(x))
        return cls_out, reg_out, iou_out


def flatten_levels(per_level: Sequence[torch.Tensor], last_dim: int) -> torch.Tensor:
    """Per-level NCHW ``(B, A*D, H, W)`` -> ``(B, sum HWA, D)`` in (H, W, A)
    order within a level, level-major, matching ``flat_anchors``."""
    b = per_level[0].shape[0]
    return torch.cat(
        [x.permute(0, 2, 3, 1).reshape(b, -1, last_dim) for x in per_level], dim=1)


@dataclasses.dataclass(frozen=True)
class ATSSRPNCfg:
    """The JAX ``ATSSRPNCfg``: box coder, losses and train assigner."""

    gamma: float = 0.5
    atss: bool = False
    atss_topk: int = 9
    reg_decoded_bbox: bool = True
    target_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    # losses
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 1.0
    loss_bbox_type: str = "iou"
    loss_cls_type: str = "focal"
    loss_iou_weight: float = 1.0
    with_aug_loss: bool = True
    aug_loss_weight: float = 1.0
    # train assigner
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.5
    min_pos_iou: float = 0.0
    match_low_quality: bool = True


_BOX_LOSSES = {"iou": L.iou_loss, "giou": L.giou_loss, "ciou": L.ciou_loss}


def _check_train_cfg(cfg: ATSSRPNCfg) -> None:
    for what, value, ported in (("loss_cls_type", cfg.loss_cls_type, ("focal",)),
                                ("loss_bbox_type", cfg.loss_bbox_type, tuple(_BOX_LOSSES))):
        if value not in ported:
            raise NotImplementedError(f"ATSS RPN {what}={value!r} is not ported")


def _encode(cfg: ATSSRPNCfg, anchors, boxes):
    return box_ops.bbox2delta(anchors, boxes, cfg.target_means, cfg.target_stds, eps=1e-6)


def _decode(cfg: ATSSRPNCfg, anchors, deltas, max_shape=None):
    return box_ops.delta2bbox(anchors, deltas, cfg.target_means, cfg.target_stds,
                              max_shape=max_shape)


def atss_rpn_proposals(
    cfg: ATSSRPNCfg,
    cls_logits: torch.Tensor,
    bbox_preds: torch.Tensor,
    iou_logits: torch.Tensor,
    anchors: torch.Tensor,
    num_level_anchors: Sequence[int],
    img_shapes: torch.Tensor,
    nms_pre: int = 1000,
    max_per_img: int = 256,
    nms_iou_thr: float = 0.7,
    min_bbox_size: float = 0.0,
):
    """Proposals for a batch: ``cls_logits``/``iou_logits`` ``(B, A)``,
    ``bbox_preds`` ``(B, A, 4)``, ``anchors`` ``(A, 4)``, ``img_shapes``
    ``(B, 2)``.  Returns ``(boxes (B, max, 4), scores (B, max), valid)``;
    the score is the fused prior ``sqrt(sigmoid(cls) * sigmoid(iou))``, in
    float32 whatever the logits' dtype (JAX ``atss_rpn_head.py:423-424``)."""
    fused = torch.sqrt(torch.sigmoid(cls_logits.float()) * torch.sigmoid(iou_logits.float()))
    return level_topk_nms(fused, bbox_preds, anchors, num_level_anchors, img_shapes,
                          cfg.target_means, cfg.target_stds, nms_pre, max_per_img, nms_iou_thr,
                          min_bbox_size)


def level_topk_nms(scores: torch.Tensor, bbox_preds: torch.Tensor, anchors: torch.Tensor,
                   num_level_anchors: Sequence[int], img_shapes: torch.Tensor, means, stds,
                   nms_pre: int, max_per_img: int, nms_iou_thr: float, min_bbox_size: float):
    """The proposal steps after the score, shared by both RPN heads:
    per-level exact top-``nms_pre`` of ``scores`` ``(B, A)``, decode of
    their ``bbox_preds`` ``(B, A, 4)`` within ``img_shapes`` ``(B, 2)``,
    boxes wider and taller than ``min_bbox_size``, then NMS with the level
    as the class id, keeping ``max_per_img``.  Returns ``(boxes (B, max,
    4), scores (B, max), valid)``, scores zero off the valid slots."""
    sel_scores, sel_deltas, sel_anchors, sel_ids = [], [], [], []
    start = 0
    for lvl, na in enumerate(num_level_anchors):
        k = min(nms_pre, na) if nms_pre > 0 else na
        top_s, top_i = select_topk(scores[:, start:start + na], k)
        idx = top_i + start
        sel_scores.append(top_s)
        sel_deltas.append(torch.gather(bbox_preds, 1, idx[..., None].expand(-1, -1, 4)))
        sel_anchors.append(anchors[idx])
        sel_ids.append(torch.full_like(top_i, lvl))
        start += na
    scores = torch.cat(sel_scores, dim=1)
    deltas = torch.cat(sel_deltas, dim=1)
    ancs = torch.cat(sel_anchors, dim=1)
    ids = torch.cat(sel_ids, dim=1)

    proposals = box_ops.delta2bbox(ancs, deltas, means, stds, max_shape=img_shapes)
    w = proposals[..., 2] - proposals[..., 0]
    h = proposals[..., 3] - proposals[..., 1]
    ok = (w > min_bbox_size) & (h > min_bbox_size)

    out_boxes, out_scores, out_valid = [], [], []
    for i in range(proposals.shape[0]):
        boxes, sc, valid, _ = batched_nms_padded(
            proposals[i], scores[i], ids[i], nms_iou_thr, max_per_img, valid=ok[i])
        out_boxes.append(boxes)
        out_scores.append(torch.where(valid, sc, torch.zeros_like(sc)))
        out_valid.append(valid)
    return torch.stack(out_boxes), torch.stack(out_scores), torch.stack(out_valid)


def atss_rpn_targets(cfg: ATSSRPNCfg, anchors: torch.Tensor, valid: torch.Tensor,
                     gt_bboxes: torch.Tensor, gt_mask: torch.Tensor,
                     num_level_anchors: Sequence[int] = ()):
    """Targets of one image: ``anchors`` ``(A, 4)``, ``valid`` ``(A,)``,
    padded ``gt_bboxes`` ``(G, 4)`` and ``gt_mask`` ``(G,)`` -> (positive
    mask, label weights, box targets ``(A, 4)``: the matched gt boxes, or
    with ``reg_decoded_bbox=False`` their deltas from the anchors; zero off
    the positives).  ATSS (``cfg.atss``) takes each level's anchor count,
    ``num_level_anchors``."""
    _check_train_cfg(cfg)
    if cfg.atss:
        if sum(num_level_anchors) != anchors.shape[0]:
            raise ValueError(f"ATSS needs the anchors of each level: num_level_anchors "
                             f"{tuple(num_level_anchors)} for {anchors.shape[0]} anchors")
        assign = atss_assign(anchors, valid, num_level_anchors, gt_bboxes, gt_mask,
                             topk=cfg.atss_topk)
    else:
        assign = max_iou_assign(anchors, valid, gt_bboxes, gt_mask,
                                pos_iou_thr=cfg.pos_iou_thr, neg_iou_thr=cfg.neg_iou_thr,
                                min_pos_iou=cfg.min_pos_iou,
                                match_low_quality=cfg.match_low_quality)
    pos = assign.gt_inds > 0
    label_weights = (pos | (assign.gt_inds == 0)).float()
    safe_gt = torch.clamp(assign.gt_inds - 1, 0, gt_bboxes.shape[0] - 1)
    matched = box_ops.take_small_table(gt_bboxes, safe_gt)
    if not cfg.reg_decoded_bbox:
        matched = _encode(cfg, anchors, matched)
    bbox_targets = torch.where(pos[:, None], matched, torch.zeros_like(matched))
    return pos, label_weights, bbox_targets


def atss_rpn_loss(cfg: ATSSRPNCfg, cls_logits: torch.Tensor, bbox_preds: torch.Tensor,
                  iou_logits: torch.Tensor, anchors: torch.Tensor, valid: torch.Tensor,
                  gt_bboxes: torch.Tensor, gt_mask: torch.Tensor,
                  num_level_anchors: Sequence[int] = ()):
    """RPN losses of a batch: ``cls_logits``/``iou_logits`` ``(B, A)``,
    ``bbox_preds`` ``(B, A, 4)``, ``anchors`` ``(A, 4)``, ``valid``
    ``(B, A)``, ``gt_bboxes`` ``(B, G, 4)``, ``gt_mask`` ``(B, G)``; each
    level's anchor count for ATSS."""
    _check_train_cfg(cfg)
    b, a = cls_logits.shape
    targets = [atss_rpn_targets(cfg, anchors, valid[i], gt_bboxes[i], gt_mask[i],
                                num_level_anchors)
               for i in range(b)]
    pos, label_weights, bbox_targets = (torch.stack(x) for x in zip(*targets))
    num_total = torch.clamp(pos.float().sum(), min=1.0)

    loss_cls = L.sigmoid_focal_loss(
        cls_logits.reshape(-1, 1), pos.reshape(-1, 1).float(),
        weight=label_weights.reshape(-1), gamma=cfg.focal_gamma, alpha=cfg.focal_alpha,
        avg_factor=num_total) * cfg.loss_cls_weight

    anchors_b = anchors.expand(b, a, 4)
    posf = pos.reshape(-1).float()
    pos_flat = posf[:, None] > 0
    decoded = _decode(cfg, anchors_b, bbox_preds).reshape(-1, 4)
    box_loss = _BOX_LOSSES[cfg.loss_bbox_type]
    if cfg.reg_decoded_bbox:
        # the regression target of a non-positive is the prediction itself,
        # with zero weight (so that its IoU and deltas stay finite)
        safe_t = torch.where(pos_flat, bbox_targets.reshape(-1, 4), decoded)
    else:
        dec_t = _decode(cfg, anchors_b, bbox_targets).reshape(-1, 4)
        safe_t = torch.where(pos_flat, dec_t, decoded)
    with torch.no_grad():
        iou_target = torch.where(pos_flat[:, 0], box_ops.bbox_overlaps_aligned(decoded, safe_t),
                                 torch.zeros_like(posf))
        w = torch.clamp(iou_target ** cfg.gamma, min=EPS) * posf
    if cfg.reg_decoded_bbox:
        loss_box = box_loss(decoded, safe_t, weight=w, avg_factor=1.0)
        if cfg.with_aug_loss:
            enc_t = _encode(cfg, anchors_b.reshape(-1, 4), safe_t)
            loss_aug = L.mse_loss(bbox_preds.reshape(-1, 4), enc_t,
                                  weight=w[:, None].expand_as(enc_t),
                                  avg_factor=1.0) * cfg.aug_loss_weight
            loss_box = (loss_box + loss_aug) * 0.5
    else:
        # the deltas read as boxes (JAX atss_rpn_head.py:348-372)
        flat_pred = bbox_preds.reshape(-1, 4)
        flat_t = torch.where(pos_flat, bbox_targets.reshape(-1, 4), flat_pred)
        loss_box = box_loss(flat_pred, flat_t, weight=w[:, None].expand(-1, 4), avg_factor=1.0)
    loss_bbox = loss_box * cfg.loss_bbox_weight / torch.clamp(iou_target.sum(), min=1.0)

    loss_rpn_iou = L.binary_cross_entropy_loss(
        iou_logits.reshape(-1), iou_target, weight=posf, avg_factor=num_total,
    ) * cfg.loss_iou_weight
    return {"loss_rpn_cls": loss_cls, "loss_rpn_bbox": loss_bbox, "loss_rpn_iou": loss_rpn_iou}
