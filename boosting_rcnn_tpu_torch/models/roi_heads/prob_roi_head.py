"""ProbRoIHead: prior fusion and the boosting-reweighted loss (PyTorch port
of ``boosting_rcnn_tpu/models/roi_heads/prob_roi_head.py``).

At test time the R-CNN class probabilities are fused with the RPN prior:
``sqrt(softmax(cls) * prior)``.

Training, per image: max-IoU assignment of the proposals (0.6 / 0.6 /
min 0.6, no low-quality matching), then ``num_samples`` slots drawn by the
random sampler with the gt boxes prepended as candidates.  Each sampled
RoI carries a prior from its proposal score: a positive its score, a
negative ``1 - score``, a gt-added box 0.  The boosting loss weighs the
cross entropy by ``(1 - prior)**gamma``, rescaled (with the scale
detached) so that the weighted sum equals the unweighted one, and
averages over the valid slots; the box loss is summed and averaged over
the valid slots too.  The builder rejects what is not ported: the
``quality``, ISR and CARL variants, ``alpha``, ``reg_norm='mean'`` and
sampling without the gt boxes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ...ops.assigners import AssignResult, max_iou_assign
from ...ops.samplers import random_sample, random_sample_from_uniforms
from .bbox_head import BBoxHeadCfg, bbox_head_loss, bbox_targets


@dataclasses.dataclass(frozen=True)
class ProbRoICfg:
    """The JAX ``ProbRoICfg``, as far as the flagship sets it."""

    gamma: float = 0.1
    boost: bool = False
    prob: bool = True
    # rcnn train cfg (the gt boxes are always added as candidates)
    num_samples: int = 512
    pos_fraction: float = 0.25
    neg_pos_ub: int = -1
    pos_iou_thr: float = 0.6
    neg_iou_thr: float = 0.6
    min_pos_iou: float = 0.6
    match_low_quality: bool = False


class RoISample(NamedTuple):
    """Fixed-shape sampling output: each field ``(R, ...)`` for one image,
    ``(B, R, ...)`` for a batch or ``(B*R, ...)`` flattened."""

    boxes: torch.Tensor  # (R, 4)
    is_pos: torch.Tensor  # (R,) bool
    valid: torch.Tensor  # (R,) bool
    prior: torch.Tensor  # (R,) extracted prior
    iou: torch.Tensor  # (R,) assigned max IoU (1 - IoU for negatives)
    matched_gt: torch.Tensor  # (R, 4)
    matched_label: torch.Tensor  # (R,) int64, -1 off the positives
    gt_idx: torch.Tensor  # (R,) 0-based matched gt index
    cand_idx: torch.Tensor  # (R,) index into the gt-prepended candidates
    is_gt: torch.Tensor  # (R,) bool: the slot is a gt-added proposal


def sample_rois(
    cfg: ProbRoICfg,
    proposals: torch.Tensor,
    prop_scores: torch.Tensor,
    prop_valid: torch.Tensor,
    gt_bboxes: torch.Tensor,
    gt_mask: torch.Tensor,
    gt_labels: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> RoISample:
    """Assign and sample one image's RoIs, with prior extraction.

    ``proposals`` ``(P, 4)``, ``prop_scores`` ``(P,)`` (the prior column),
    ``prop_valid`` ``(P,)``; padded ``gt_bboxes`` ``(G, 4)``, ``gt_mask``,
    ``gt_labels``.  The sampler's randomness comes from ``generator``, or
    is the given pair of ``(G + P,)`` uniforms (positives, negatives)."""
    g = gt_bboxes.shape[0]
    dev = proposals.device
    assign = max_iou_assign(
        proposals, prop_valid, gt_bboxes, gt_mask,
        pos_iou_thr=cfg.pos_iou_thr, neg_iou_thr=cfg.neg_iou_thr,
        min_pos_iou=cfg.min_pos_iou, match_low_quality=cfg.match_low_quality)
    # the gt boxes are prepended as candidates assigned to themselves
    gt_self = torch.where(gt_mask, torch.arange(1, g + 1, device=dev),
                          torch.full((g,), -1, device=dev))
    cand_boxes = torch.cat([gt_bboxes, proposals])
    cand_valid = torch.cat([gt_mask, prop_valid])
    cand_gt_inds = torch.cat([gt_self, assign.gt_inds])
    cand_overlap = torch.cat([gt_mask.float(), assign.max_overlaps])
    cand_is_gt = torch.cat([torch.ones((g,), dtype=torch.bool, device=dev),
                            torch.zeros_like(prop_valid)])
    cand_score = torch.cat([torch.zeros((g,), device=dev), prop_scores])

    cand = AssignResult(cand_gt_inds, cand_overlap, torch.zeros_like(cand_gt_inds))
    kw = dict(num=cfg.num_samples, pos_fraction=cfg.pos_fraction, neg_pos_ub=cfg.neg_pos_ub)
    if uniforms is not None:
        res = random_sample_from_uniforms(cand, cand_valid, *uniforms, **kw)
    else:
        res = random_sample(cand, cand_valid, generator=generator, **kw)
    boxes = cand_boxes[res.inds]
    score = cand_score[res.inds]
    is_gt = cand_is_gt[res.inds]
    overlap = cand_overlap[res.inds]

    prior = torch.where(is_gt, torch.zeros_like(score),
                        torch.where(res.is_pos, score, 1.0 - score))
    prior = torch.where(res.valid, prior, torch.zeros_like(prior))
    iou = torch.where(res.is_pos, overlap, 1.0 - overlap)
    safe_gt = torch.clamp(res.gt_inds, 0, g - 1)
    matched_label = torch.where(res.is_pos, gt_labels.long()[safe_gt],
                                torch.full_like(safe_gt, -1))
    return RoISample(boxes, res.is_pos, res.valid, prior.detach(), iou.detach(),
                     gt_bboxes[safe_gt], matched_label, safe_gt, res.inds, is_gt)


def norm_loss(loss: torch.Tensor, weights: torch.Tensor, avg_factor) -> torch.Tensor:
    """Boosting renormalisation (reference ``norm_loss:151``): rescale the
    weights so that the weighted loss sums to the unweighted sum, with the
    rescaled weights detached, then average."""
    denom = (weights * loss).sum()
    scale = loss.sum() / torch.where(denom == 0, torch.ones_like(denom), denom)
    return (loss * (weights * scale).detach()).sum() / avg_factor


def prob_roi_loss(cfg: ProbRoICfg, head_cfg: BBoxHeadCfg, cls_score: torch.Tensor,
                  bbox_pred: torch.Tensor, sample: RoISample):
    """Boosting-reweighted R-CNN loss on a flattened ``(B*R, ...)`` sample
    (``_bbox_forward_train_boost:107``).  Both losses are averaged over the
    valid slots, not over the slot count."""
    labels, label_w, bbox_t, bbox_w = bbox_targets(
        head_cfg, sample.boxes, sample.is_pos, sample.valid, sample.matched_gt,
        torch.where(sample.is_pos, sample.matched_label,
                    torch.full_like(sample.matched_label, head_cfg.num_classes)))
    raw = bbox_head_loss(head_cfg, cls_score, bbox_pred, sample.boxes, labels, label_w,
                         bbox_t, bbox_w, reduction_override="none")
    validf = sample.valid.float()
    n_valid = torch.clamp(validf.sum(), min=1.0)
    if cfg.boost:
        lw = (1.0 - sample.prior) ** cfg.gamma
        loss_cls = norm_loss(raw["loss_cls"] * validf, lw * validf, n_valid)
    else:
        loss_cls = (raw["loss_cls"] * validf).sum() / n_valid
    return {"loss_cls": loss_cls, "loss_bbox": raw["loss_bbox"].sum() / n_valid}


def prob_fuse_scores(cls_score: torch.Tensor, prior: torch.Tensor) -> torch.Tensor:
    """``sqrt(softmax(cls) * prior)`` over ``(..., R, K+1)`` logits and
    ``(..., R)`` priors."""
    p = torch.softmax(cls_score.float(), dim=-1)
    return torch.sqrt(torch.clamp(p * prior[..., None], min=0.0))
