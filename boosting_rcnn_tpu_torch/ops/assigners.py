"""Max-IoU and ATSS target assignment on padded tensors (PyTorch port).

Counterpart of ``AssignResult``, ``max_iou_assign``,
``assign_wrt_overlaps`` and ``atss_assign`` in
``boosting_rcnn_tpu/ops/assigners.py``.  One
image carries ``(N,)`` candidate boxes with a validity mask and ``(G,)``
padded gt boxes with a gt mask.  The encoding is the reference's: ``-1``
ignore, ``0`` negative, ``i + 1`` matched to gt ``i``.  The details that
decide the result are kept: argmax ties go to the first index, padded gts
never win, in low-quality matching each box takes the *last* eligible gt
(the reference's loop over gts, later ones overwriting), and invalid
boxes end at ``-1``.  ATSS picks each level's nearest anchors by a stable
sort, so that anchors at the same distance go in index order, as
``lax.top_k`` takes them (``torch.topk`` orders ties differently on the
CPU and the GPU).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .box_ops import bbox_overlaps

__all__ = ["AssignResult", "max_iou_assign", "assign_wrt_overlaps", "atss_assign"]


class AssignResult(NamedTuple):
    gt_inds: torch.Tensor  # (N,) int64: -1 ignore / 0 negative / i+1 positive
    max_overlaps: torch.Tensor  # (N,) float32
    labels: torch.Tensor  # (N,) int64 assigned class or -1


def max_iou_assign(
    boxes: torch.Tensor,
    box_valid: torch.Tensor,
    gt_bboxes: torch.Tensor,
    gt_mask: torch.Tensor,
    gt_labels: Optional[torch.Tensor] = None,
    pos_iou_thr: float = 0.5,
    neg_iou_thr: float = 0.5,
    min_pos_iou: float = 0.0,
    match_low_quality: bool = True,
) -> AssignResult:
    """MaxIoUAssigner for one image: ``boxes`` ``(N, 4)``, ``box_valid``
    ``(N,)``, padded ``gt_bboxes`` ``(G, 4)``, ``gt_mask`` ``(G,)``."""
    return assign_wrt_overlaps(
        bbox_overlaps(gt_bboxes, boxes), boxes, box_valid, gt_bboxes, gt_mask,
        gt_labels, pos_iou_thr, neg_iou_thr, min_pos_iou, match_low_quality)


def assign_wrt_overlaps(
    overlaps: torch.Tensor,
    boxes: torch.Tensor,
    box_valid: torch.Tensor,
    gt_bboxes: torch.Tensor,
    gt_mask: torch.Tensor,
    gt_labels: Optional[torch.Tensor] = None,
    pos_iou_thr: float = 0.5,
    neg_iou_thr: float = 0.5,
    min_pos_iou: float = 0.0,
    match_low_quality: bool = True,
) -> AssignResult:
    """The assignment rules on a given ``(G, N)`` IoU matrix (the
    reference's ``gt_max_assign_all=True``, no ignore regions)."""
    n = boxes.shape[0]
    g = gt_bboxes.shape[0]
    dev = boxes.device
    zero = overlaps.new_zeros(())
    overlaps = torch.where(gt_mask[:, None], overlaps, zero)
    overlaps_boxmasked = torch.where(box_valid[None, :], overlaps, zero - 1.0)

    # torch.max over a dim returns the first index of a tie
    max_overlaps, argmax_overlaps = overlaps.max(dim=0)
    gt_max_overlaps = overlaps_boxmasked.max(dim=1).values

    assigned = torch.full((n,), -1, dtype=torch.int64, device=dev)
    assigned = torch.where((max_overlaps >= 0) & (max_overlaps < neg_iou_thr),
                           torch.zeros_like(assigned), assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr, argmax_overlaps + 1, assigned)

    if match_low_quality:
        eligible = ((overlaps == gt_max_overlaps[:, None])
                    & (gt_max_overlaps >= min_pos_iou)[:, None] & gt_mask[:, None])
        gt_idx = torch.arange(g, dtype=torch.int64, device=dev)
        last_eligible = torch.where(eligible, gt_idx[:, None],
                                    torch.full_like(gt_idx[:, None], -1)).max(dim=0).values
        assigned = torch.where(last_eligible >= 0, last_eligible + 1, assigned)

    assigned = torch.where(box_valid, assigned, torch.full_like(assigned, -1))
    if gt_labels is not None:
        safe = torch.clamp(assigned - 1, 0, g - 1)
        labels = torch.where(assigned > 0, gt_labels.long()[safe],
                             torch.full_like(assigned, -1))
    else:
        labels = torch.full((n,), -1, dtype=torch.int64, device=dev)
    return AssignResult(assigned, max_overlaps, labels)


def atss_assign(
    boxes: torch.Tensor,
    box_valid: torch.Tensor,
    num_level_anchors: Sequence[int],
    gt_bboxes: torch.Tensor,
    gt_mask: torch.Tensor,
    gt_labels: Optional[torch.Tensor] = None,
    topk: int = 9,
) -> AssignResult:
    """ATSS assignment for one image (reference ``atss_assigner.py``):
    per gt, the ``topk`` anchors of each level nearest to its centre
    (ties in index order) are its candidates; its threshold is the mean
    plus the unbiased standard deviation of their IoUs; a candidate at or
    above it whose centre lies inside the gt by more than 0.01 is
    positive; an anchor claimed by several gts goes to the one with the
    highest IoU (the first of equals)."""
    n = boxes.shape[0]
    g = gt_bboxes.shape[0]
    dev = boxes.device
    zero = boxes.new_zeros(())
    overlaps = bbox_overlaps(gt_bboxes, boxes)
    overlaps = torch.where(gt_mask[:, None] & box_valid[None, :], overlaps, zero)

    acx = (boxes[:, 0] + boxes[:, 2]) * 0.5
    acy = (boxes[:, 1] + boxes[:, 3]) * 0.5
    gcx = (gt_bboxes[:, 0] + gt_bboxes[:, 2]) * 0.5
    gcy = (gt_bboxes[:, 1] + gt_bboxes[:, 3]) * 0.5
    dist = torch.sqrt((acx[None] - gcx[:, None]) ** 2 + (acy[None] - gcy[:, None]) ** 2)
    dist = torch.where(box_valid[None, :], dist, zero + torch.inf)

    is_cand = torch.zeros((g, n), dtype=torch.bool, device=dev)
    start = 0
    for na in num_level_anchors:
        k = min(topk, na)
        idx = torch.sort(dist[:, start:start + na], dim=1, stable=True).indices[:, :k]
        is_cand[:, start:start + na].scatter_(1, idx, True)
        start += na
    is_cand = is_cand & box_valid[None, :]

    cnt = torch.clamp(is_cand.sum(1), min=1).to(overlaps.dtype)
    mean = torch.where(is_cand, overlaps, zero).sum(1) / cnt
    var = torch.where(is_cand, (overlaps - mean[:, None]) ** 2, zero).sum(1) / torch.clamp(
        cnt - 1, min=1)
    thr = mean + torch.sqrt(var)

    left = acx[None, :] - gt_bboxes[:, 0:1]
    top = acy[None, :] - gt_bboxes[:, 1:2]
    right = gt_bboxes[:, 2:3] - acx[None, :]
    bottom = gt_bboxes[:, 3:4] - acy[None, :]
    inside = torch.minimum(torch.minimum(left, top), torch.minimum(right, bottom)) > 0.01

    pos = is_cand & (overlaps >= thr[:, None]) & inside & gt_mask[:, None]
    claimed = torch.where(pos, overlaps, zero - torch.inf)
    best, best_gt = claimed.max(dim=0)  # the first index of a tie
    has = pos.any(0)
    assigned = torch.where(has, best_gt + 1, torch.zeros_like(best_gt))
    assigned = torch.where(box_valid, assigned, torch.full_like(assigned, -1))
    max_overlaps = torch.where(has, best, overlaps.max(dim=0).values)
    if gt_labels is not None:
        safe = torch.clamp(assigned - 1, 0, g - 1)
        labels = torch.where(assigned > 0, gt_labels.long()[safe],
                             torch.full_like(assigned, -1))
    else:
        labels = torch.full((n,), -1, dtype=torch.int64, device=dev)
    return AssignResult(assigned, max_overlaps, labels)
