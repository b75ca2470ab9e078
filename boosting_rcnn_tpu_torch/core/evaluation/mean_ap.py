"""VOC-style mean AP (PyTorch port of
``boosting_rcnn_tpu/core/evaluation/mean_ap.py``: the reference's
``eval_map`` with greedy TP/FP matching and area-under-curve or 11-point
AP)."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _box_iou(b1, b2):
    if len(b1) == 0 or len(b2) == 0:
        return np.zeros((len(b1), len(b2)))
    a1 = np.maximum(b1[:, 2] - b1[:, 0], 0) * np.maximum(b1[:, 3] - b1[:, 1], 0)
    a2 = np.maximum(b2[:, 2] - b2[:, 0], 0) * np.maximum(b2[:, 3] - b2[:, 1], 0)
    lt = np.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = np.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(a1[:, None] + a2[None, :] - inter, 1e-10)


def tpfp_default(dets, gt, gt_ignore, iou_thr=0.5):
    """Per-image TP/FP flags (reference ``tpfp_default:168``): dets sorted by
    score greedily match unmatched gts above ``iou_thr``; matches to ignore
    regions don't count either way."""
    nd = len(dets)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    if nd == 0:
        return tp, fp
    if len(gt) == 0 and len(gt_ignore) == 0:
        fp[:] = 1
        return tp, fp
    all_gt = np.concatenate([gt, gt_ignore], axis=0)
    ignore = np.concatenate([np.zeros(len(gt), bool), np.ones(len(gt_ignore), bool)])
    ious = _box_iou(dets[:, :4], all_gt)
    order = np.argsort(-dets[:, 4], kind="stable")
    matched = np.zeros(len(all_gt), bool)
    for i in order:
        best, best_iou = -1, iou_thr
        for j in range(len(all_gt)):
            if ious[i, j] >= best_iou and not (matched[j] and not ignore[j]):
                if best >= 0 and not ignore[best] and ignore[j]:
                    continue
                best, best_iou = j, ious[i, j]
        if best >= 0:
            if ignore[best]:
                continue  # neither tp nor fp
            matched[best] = True
            tp[i] = 1
        else:
            fp[i] = 1
    return tp, fp


def average_precision(recalls, precisions, mode="area"):
    """AP from PR points (reference ``average_precision``): 'area' =
    all-points interpolation, '11points' = VOC07."""
    if mode == "area":
        mrec = np.concatenate([[0.0], recalls, [1.0]])
        mpre = np.concatenate([[0.0], precisions, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    ap = 0.0
    for thr in np.arange(0, 1.1, 0.1):
        p = precisions[recalls >= thr]
        ap += (p.max() if len(p) else 0.0) / 11.0
    return float(ap)


def eval_map(
    results: List[Tuple[np.ndarray, np.ndarray]],
    annotations: List[Dict],
    iou_thr: float = 0.5,
    num_classes: Optional[int] = None,
    mode: str = "area",
):
    """VOC-style mAP over per-image ``(dets (N,5), labels)`` results.

    annotations[i]: dict with ``bboxes``, ``labels``, ``bboxes_ignore``.
    Returns (mAP, per-class list of dicts).
    """
    if num_classes is None:
        num_classes = (
            int(max((a["labels"].max(initial=-1) for a in annotations), default=-1))
            + 1
        )
    per_class = []
    for c in range(num_classes):
        all_scores, all_tp, all_fp = [], [], []
        npos = 0
        for (dets, labels), ann in zip(results, annotations):
            m = labels == c
            d = dets[m]
            gm = ann["labels"] == c
            gt = ann["bboxes"][gm]
            gt_ig = ann.get("bboxes_ignore", np.zeros((0, 4)))
            npos += len(gt)
            tp, fp = tpfp_default(d, gt, gt_ig, iou_thr)
            all_scores.append(d[:, 4])
            all_tp.append(tp)
            all_fp.append(fp)
        scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
        tp = np.concatenate(all_tp) if all_tp else np.zeros(0)
        fp = np.concatenate(all_fp) if all_fp else np.zeros(0)
        order = np.argsort(-scores, kind="stable")
        tp_cum = np.cumsum(tp[order])
        fp_cum = np.cumsum(fp[order])
        recalls = tp_cum / max(npos, 1)
        precisions = tp_cum / np.maximum(tp_cum + fp_cum, 1e-10)
        ap = average_precision(recalls, precisions, mode) if npos > 0 else 0.0
        per_class.append(
            dict(
                num_gts=npos,
                num_dets=len(scores),
                recall=float(recalls[-1]) if len(recalls) else 0.0,
                precision=float(precisions[-1]) if len(precisions) else 0.0,
                ap=ap,
            )
        )
    valid = [p["ap"] for p in per_class if p["num_gts"] > 0]
    return (float(np.mean(valid)) if valid else 0.0), per_class
