"""Max-IoU target assignment on padded tensors (PyTorch port).

Counterpart of ``AssignResult``, ``max_iou_assign`` and
``assign_wrt_overlaps`` in ``boosting_rcnn_tpu/ops/assigners.py``.  One
image carries ``(N,)`` candidate boxes with a validity mask and ``(G,)``
padded gt boxes with a gt mask.  The encoding is the reference's: ``-1``
ignore, ``0`` negative, ``i + 1`` matched to gt ``i``.  The details that
decide the result are kept: argmax ties go to the first index, padded gts
never win, in low-quality matching each box takes the *last* eligible gt
(the reference's loop over gts, later ones overwriting), and invalid
boxes end at ``-1``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .box_ops import bbox_overlaps

__all__ = ["AssignResult", "max_iou_assign", "assign_wrt_overlaps"]


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
