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
the valid slots too, or with ``reg_norm='mean'`` divided by four times the
positives (at least one).  The builder rejects what is not ported: the
``quality`` variant, ``alpha`` and sampling without the gt boxes.

PISA (JAX ``prob_roi_head.py:257-287``), on the loss without boosting
(``PISARoIHead``'s configs and the fork's ``ProbPISARoIHead``): ISR-P
reweights the cross entropy of the positives by the IoU of the current
decoded predictions (detached) with their gts, and CARL adds
``loss_carl``, averaged over the valid slots like the other two.  As in
the JAX package, a slot's gt is its index within its own image, so ISR-P
groups gt k of one image with gt k of another where their labels agree
(mmdet offsets each image's gt ids).  ``BoostRoIHead`` is this head with prior fusion and, unless its
config says ``boost``, no boosting loss, as the JAX builder reads it.

Dynamic R-CNN (JAX ``prob_roi_head.py:344-439``): its detector samples
with a ``ProbRoICfg`` whose three assigner thresholds are the working IoU
threshold, a scalar tensor (JAX ``sample_rois_dynamic``);
``prob_roi_loss(..., beta_override=)`` takes the working smooth-L1 beta,
and ``dynamic_rcnn_batch_stats`` gives a step's two statistics, which
``ConvFCBBoxHead.update_dynamic`` records.

``sample_rois_boost`` and ``boost_fuse_scores`` are the reference
``BoostRoIHead``'s multi-class priors (JAX ``prob_roi_head.py:157-212``),
plain functions: no JAX detector path calls them either.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ...ops import box_ops
from ...ops.assigners import AssignResult, max_iou_assign
from ...ops.pisa import carl_loss, isr_p_weights
from ...ops.samplers import random_sample, random_sample_from_uniforms
from ...parallel.mesh import all_reduce_mean, global_count
from .bbox_head import BBoxHeadCfg, bbox_head_loss, bbox_targets


@dataclasses.dataclass(frozen=True)
class ProbRoICfg:
    """The JAX ``ProbRoICfg``, as far as the flagship sets it."""

    gamma: float = 0.1
    boost: bool = False
    prob: bool = True
    # the box loss's normaliser: the valid slots ("bbox_num") or four times
    # the positives ("mean")
    reg_norm: str = "bbox_num"
    # rcnn train cfg (the gt boxes are always added as candidates)
    num_samples: int = 512
    pos_fraction: float = 0.25
    neg_pos_ub: int = -1
    pos_iou_thr: float = 0.6
    neg_iou_thr: float = 0.6
    min_pos_iou: float = 0.6
    match_low_quality: bool = False
    # PISA on the R-CNN stage (the non-boosting loss only): ISR-P's and
    # CARL's ``k`` and ``bias``, as ``((key, value), ...)`` pairs
    isr: Optional[tuple] = None
    carl: Optional[tuple] = None


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


def dynamic_rcnn_batch_stats(max_overlaps: torch.Tensor, prop_valid: torch.Tensor,
                             bbox_targets: torch.Tensor, pos_valid: torch.Tensor,
                             iou_topk: int = 75, beta_topk: int = 10):
    """Dynamic R-CNN's statistics of a step (JAX
    ``dynamic_rcnn_batch_stats``): the IoU statistic, per image the
    ``iou_topk``-th largest assigner max IoU over all its valid proposals
    (``max_overlaps``, ``prop_valid`` ``(B, P)``; invalid ones count as
    -1), meaned over the batch; the beta statistic, the ``min(beta_topk *
    B, num_pos)``-th smallest ``mean(|dx|, |dy|)`` of the positives'
    encoded targets (``bbox_targets`` ``(R, 4)``, ``pos_valid`` ``(R,)``),
    NaN without a positive.  Both float32 scalar tensors, on the device."""
    b, p = max_overlaps.shape
    masked = torch.where(prop_valid, max_overlaps, max_overlaps.new_full((), -1.0))
    batch_iou = masked.topk(min(iou_topk, p), dim=1).values[:, -1].mean()
    mean_xy = bbox_targets[:, :2].abs().mean(-1)
    r = mean_xy.shape[0]
    num_pos = pos_valid.sum()
    vals = torch.where(pos_valid, mean_xy, mean_xy.new_full((), torch.inf)).sort().values
    kb = torch.clamp(torch.clamp(num_pos, max=min(beta_topk * b, r)), 1, r)
    kth = vals.index_select(0, (kb - 1).reshape(1))[0]  # no read to the host
    batch_beta = torch.where(num_pos > 0, kth, vals.new_full((), torch.nan))
    return batch_iou, batch_beta


def sample_rois_boost(cfg: ProbRoICfg, proposals: torch.Tensor, prop_cls_scores: torch.Tensor,
                      prop_valid: torch.Tensor, gt_bboxes: torch.Tensor, gt_mask: torch.Tensor,
                      gt_labels: torch.Tensor, **kw) -> RoISample:
    """``BoostRoIHead``'s sampling with multi-class priors (JAX
    ``sample_rois_boost``): ``prop_cls_scores`` ``(P, C)``, the
    proposals' per-class scores; the slots are sampled as ``sample_rois``
    samples them ranked by each proposal's largest score, and each takes
    the prior of its label: a positive its proposal's score at the matched
    gt's label, a negative its largest score, a gt-added box 0.  ``kw`` as
    ``sample_rois``'s."""
    g, c = gt_bboxes.shape[0], prop_cls_scores.shape[1]
    base = sample_rois(cfg, proposals, prop_cls_scores.max(1).values, prop_valid, gt_bboxes,
                       gt_mask, gt_labels, **kw)
    rows = torch.cat([prop_cls_scores.new_zeros((g, c)), prop_cls_scores])[base.cand_idx]
    safe_lab = torch.clamp(base.matched_label, 0, c - 1)
    pos_prior = torch.gather(rows, 1, safe_lab[:, None])[:, 0]
    prior = torch.where(base.is_pos, pos_prior, rows.max(1).values)
    prior = torch.where(base.is_gt | ~base.valid, torch.zeros_like(prior), prior)
    return base._replace(prior=prior.detach())


def boost_fuse_scores(cls_score: torch.Tensor, prior_cls: torch.Tensor) -> torch.Tensor:
    """``BoostRoIHead``'s test fusion (JAX ``boost_fuse_scores``):
    ``sqrt(softmax(cls) * prior)`` elementwise over ``(R, K+1)`` logits and
    the multi-class prior ``(R, K)`` with a background column of ones."""
    p = torch.softmax(cls_score.float(), dim=-1)
    prior = torch.cat([prior_cls.to(p.dtype), p.new_ones((prior_cls.shape[0], 1))], dim=1)
    return torch.sqrt(torch.clamp(p * prior, min=0.0))


def norm_loss(loss: torch.Tensor, weights: torch.Tensor, avg_factor) -> torch.Tensor:
    """Boosting renormalisation (reference ``norm_loss:151``): rescale the
    weights so that the weighted loss sums to the unweighted sum, with the
    rescaled weights detached, then average."""
    # both sums over the global batch (their ratio: means over the ranks)
    denom = all_reduce_mean((weights * loss).sum())
    scale = all_reduce_mean(loss.sum()) / torch.where(denom == 0, torch.ones_like(denom), denom)
    return (loss * (weights * scale).detach()).sum() / avg_factor


def prob_roi_loss(cfg: ProbRoICfg, head_cfg: BBoxHeadCfg, cls_score: torch.Tensor,
                  bbox_pred: torch.Tensor, sample: RoISample,
                  beta_override: Optional[torch.Tensor] = None,
                  seesaw_counts: Optional[torch.Tensor] = None):
    """Boosting-reweighted R-CNN loss on a flattened ``(B*R, ...)`` sample
    (``_bbox_forward_train_boost:107``).  The cross entropy is averaged over
    the valid slots, not over the slot count; the box loss too, or with
    ``reg_norm='mean'`` over four times the positives (JAX
    ``prob_roi_head.py:308-311``).  ``beta_override`` (Dynamic R-CNN's
    working beta) and ``seesaw_counts`` (the Seesaw loss's cumulative
    counts) go to ``bbox_head_loss``."""
    labels, label_w, bbox_t, bbox_w = bbox_targets(
        head_cfg, sample.boxes, sample.is_pos, sample.valid, sample.matched_gt,
        torch.where(sample.is_pos, sample.matched_label,
                    torch.full_like(sample.matched_label, head_cfg.num_classes)))
    raw = bbox_head_loss(head_cfg, cls_score, bbox_pred, sample.boxes, labels, label_w,
                         bbox_t, bbox_w, reduction_override="none",
                         beta_override=beta_override, seesaw_counts=seesaw_counts)
    validf = sample.valid.float()
    n_valid = global_count(validf.sum())  # over the global batch
    extra = {}
    if cfg.boost:
        lw = (1.0 - sample.prior) ** cfg.gamma
        loss_cls = norm_loss(raw["loss_cls"] * validf, lw * validf, n_valid)
    else:
        cls_w = validf
        pos = sample.is_pos & sample.valid
        if cfg.isr is not None:
            isr = dict(cfg.isr)
            cur_iou = _current_iou(head_cfg, bbox_pred, labels, sample)
            cls_w = isr_p_weights(labels, sample.gt_idx, cur_iou, validf, pos,
                                  raw["loss_cls"].detach(), k=isr.get("k", 2.0),
                                  bias=isr.get("bias", 0.0)) * validf
        if cfg.carl is not None:
            carl = dict(cfg.carl)
            extra["loss_carl"] = carl_loss(cls_score, labels, pos, raw["loss_bbox"],
                                           k=carl.get("k", 1.0), bias=carl.get("bias", 0.2),
                                           avg_factor=n_valid)
        loss_cls = (raw["loss_cls"] * cls_w).sum() / n_valid
    if cfg.reg_norm == "mean":
        loss_bbox = raw["loss_bbox"].sum() / (global_count(sample.is_pos.float().sum()) * 4.0)
    else:
        loss_bbox = raw["loss_bbox"].sum() / n_valid
    return {"loss_cls": loss_cls, "loss_bbox": loss_bbox, **extra}


def _current_iou(head_cfg: BBoxHeadCfg, bbox_pred: torch.Tensor, labels: torch.Tensor,
                 sample: RoISample) -> torch.Tensor:
    """ISR-P's IoU: each slot's deltas of its label (class-agnostic: its
    one set), detached, decoded on its RoI, against its matched gt box."""
    r, c = bbox_pred.shape[0], head_cfg.num_classes
    pred = bbox_pred.detach()
    if head_cfg.reg_class_agnostic:
        pred4 = pred.reshape(r, 4)
    else:
        onehot = torch.nn.functional.one_hot(torch.clamp(labels, 0, c - 1).long(), c)
        pred4 = (pred.reshape(r, c, 4) * onehot.to(pred.dtype)[:, :, None]).sum(1)
    dec = box_ops.delta2bbox(sample.boxes, pred4, head_cfg.target_means, head_cfg.target_stds)
    return box_ops.bbox_overlaps_aligned(dec, sample.matched_gt)


def prob_fuse_scores(cls_score: torch.Tensor, prior: torch.Tensor) -> torch.Tensor:
    """``sqrt(softmax(cls) * prior)`` over ``(..., R, K+1)`` logits and
    ``(..., R)`` priors."""
    p = torch.softmax(cls_score.float(), dim=-1)
    return torch.sqrt(torch.clamp(p * prior[..., None], min=0.0))
