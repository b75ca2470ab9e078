"""Exact greedy NMS on fixed-shape padded tensors (PyTorch port).

Counterpart of ``boosting_rcnn_tpu/ops/nms.py`` (``nms_padded``,
``batched_nms_padded``, ``multiclass_nms_padded``, ``soft_nms_padded``).
The hard NMS's survivors and their order equal the JAX package's, padding
included:

  * candidates are sorted by score with a stable sort (``jnp.argsort`` is
    stable), invalid rows carrying ``NEG_INF``;
  * boxes are processed in score order, ``tile`` at a time: a tile is first
    suppressed by every earlier survivor, then a fix-point iteration inside
    the tile resolves the greedy order exactly;
  * the loop stops once ``max_out`` boxes survive.

Soft-NMS runs exactly ``max_out`` argmax-and-decay steps, each a
fixed-shape vector op with no read back to the host.

All functions take one image; the callers loop over the batch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .box_ops import bbox_overlaps

__all__ = ["nms_padded", "batched_nms_padded", "multiclass_nms_padded", "soft_nms_padded",
           "NEG_INF"]

NEG_INF = -1e30


def _pad_rows(x: torch.Tensor, multiple: int, value: float) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    fill = torch.full((pad,) + tuple(x.shape[1:]), value, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, fill], dim=0)


def _self_suppress(over: torch.Tensor, init_alive: torch.Tensor) -> torch.Tensor:
    """Greedy suppression inside one tile.  ``over[j, k]``: box j (earlier in
    score order) overlaps box k above the threshold.  Iterating
    ``a <- init & ~any_j(a_j & over[j, k])`` from ``a = init`` reaches the
    greedy result within the tile's chain depth."""
    alive = init_alive
    for _ in range(over.shape[0]):
        new = init_alive & ~torch.any(over & alive[:, None], dim=0)
        if torch.equal(new, alive):
            break
        alive = new
    return alive


def nms_padded(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
    tile: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over padded ``(N, 4)`` boxes.

    Returns ``(boxes (max_out, 4), scores (max_out,), valid (max_out,),
    idx (max_out,))`` in descending score order; ``idx`` indexes the input,
    invalid slots carry score ``NEG_INF`` and index 0.
    """
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=boxes.device)
    s = torch.where(valid, scores, torch.full_like(scores, NEG_INF))

    tile = min(tile, max(8, n))
    boxes_p = _pad_rows(boxes, tile, 0.0)
    s_p = _pad_rows(s, tile, NEG_INF)
    n_pad = boxes_p.shape[0]

    order = torch.argsort(-s_p, stable=True)
    boxes_s = boxes_p[order]
    s_s = s_p[order]
    alive = s_s > NEG_INF / 2
    tri = torch.ones((tile, tile), dtype=torch.bool, device=boxes.device).triu(1)

    kept = 0
    for start in range(0, n_pad, tile):
        if kept >= max_out:
            # survivors only accumulate in score order: the set is final
            break
        tb = boxes_s[start:start + tile]
        t_alive = alive[start:start + tile]
        if start:
            sup = (bbox_overlaps(tb, boxes_s[:start]) > iou_threshold) & alive[None, :start]
            t_alive = t_alive & ~torch.any(sup, dim=1)
        over = (bbox_overlaps(tb, tb) > iou_threshold) & tri
        t_alive = _self_suppress(over, t_alive)
        alive[start:start + tile] = t_alive
        kept += int(t_alive.sum())

    # compact: survivors (already in score order) first, then the rest
    idx_all = torch.arange(n_pad, device=boxes.device)
    rank = torch.cumsum(alive.to(torch.int64), dim=0) - 1
    key = torch.where(alive, rank, n_pad + idx_all)
    take = torch.argsort(key)[:max_out]
    out_valid = alive[take]
    out_boxes = boxes_s[take]
    out_scores = torch.where(out_valid, s_s[take], torch.full_like(s_s[take], NEG_INF))
    out_idx = torch.where(out_valid, order[take], torch.zeros_like(order[take]))
    return out_boxes, out_scores, out_valid, out_idx


def batched_nms_padded(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
    tile: int = 256,
):
    """Category/level-aware NMS by the coordinate-offset trick (boxes of
    different ``idxs`` never overlap)."""
    if valid is None:
        max_coord = boxes.max()
    else:
        max_coord = torch.where(valid[:, None], boxes, torch.zeros_like(boxes)).max()
    offsets = idxs.to(boxes.dtype) * (max_coord + 1.0)
    shifted = boxes + offsets[:, None]
    _, os_, ov, oi = nms_padded(shifted, scores, iou_threshold, max_out, valid, tile)
    out_boxes = torch.where(ov[:, None], boxes[oi], torch.zeros_like(boxes[oi]))
    return out_boxes, os_, ov, oi


def multiclass_nms_padded(
    bboxes: torch.Tensor,
    scores: torch.Tensor,
    score_thr: float,
    iou_threshold: float,
    max_per_img: int,
    valid: Optional[torch.Tensor] = None,
    pre_nms_top_k: int = 2048,
    tile: int = 256,
    nms_type: str = "nms",
    soft_sigma: float = 0.5,
    soft_min_score: float = 1e-3,
    soft_method: str = "linear",
):
    """Per-class NMS over ``(N, C)`` foreground scores.

    ``bboxes``: ``(N, C, 4)``, one box per class.  Candidates
    above ``score_thr`` are cut to the top ``pre_nms_top_k`` (ties to the
    lower flat index, as ``lax.top_k``), then class-offset NMS keeps
    ``max_per_img``: hard (``nms_type="nms"``) or soft (``"soft_nms"``,
    ``soft_nms_padded`` with the ``soft_*`` options; the boxes shifted by
    the class times one more than the largest coordinate of the valid
    ones, so that no decay crosses classes, JAX ``nms.py:239-252``).
    Returns ``(dets (max_per_img, 5), labels, valid)``.
    """
    n, c = scores.shape
    flat_boxes = bboxes.reshape(n * c, 4)
    flat_scores = scores.reshape(n * c)
    flat_labels = torch.arange(c, device=scores.device).repeat(n)

    ok = flat_scores > score_thr
    if valid is not None:
        ok = ok & torch.repeat_interleave(valid, c)
    k = min(pre_nms_top_k, n * c)
    masked = torch.where(ok, flat_scores, torch.full_like(flat_scores, NEG_INF))
    order = torch.argsort(masked, descending=True, stable=True)[:k]
    top_scores = masked[order]
    top_boxes = flat_boxes[order]
    top_labels = flat_labels[order]
    top_valid = top_scores > NEG_INF / 2

    if nms_type == "soft_nms":
        max_coord = torch.where(top_valid[:, None], top_boxes, torch.zeros_like(top_boxes)).max()
        shifted = top_boxes + (top_labels.to(top_boxes.dtype) * (max_coord + 1.0))[:, None]
        _, os_, ov, oi = soft_nms_padded(
            shifted, top_scores, max_per_img, iou_threshold=iou_threshold, sigma=soft_sigma,
            min_score=soft_min_score, method=soft_method, valid=top_valid)
        ob = torch.where(ov[:, None], top_boxes[oi], torch.zeros_like(top_boxes[oi]))
    elif nms_type == "nms":
        ob, os_, ov, oi = batched_nms_padded(
            top_boxes, top_scores, top_labels, iou_threshold, max_per_img,
            top_valid, tile,
        )
    else:
        raise NotImplementedError(f"nms type {nms_type!r} is not ported")
    out_labels = torch.where(ov, top_labels[oi], torch.zeros_like(top_labels[oi]))
    dets = torch.cat(
        [ob, torch.where(ov, os_, torch.zeros_like(os_))[:, None]], dim=-1)
    return dets, out_labels, ov


def soft_nms_padded(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_out: int,
    iou_threshold: float = 0.3,
    sigma: float = 0.5,
    min_score: float = 1e-3,
    method: str = "linear",
    valid: Optional[torch.Tensor] = None,
):
    """Soft-NMS over ``(N, 4)`` boxes (mmcv ``soft_nms``; JAX
    ``nms.py:263-305``), truncated to its first ``max_out`` picks: exactly
    ``max_out`` steps, each picking the highest current score (the first
    on ties, as ``jnp.argmax``), taking it out of the pool and multiplying
    every score by the decay of its IoU with the pick: ``1 - iou`` above
    ``iou_threshold`` (``"linear"``) or ``exp(-iou**2 / sigma)``
    (``"gaussian"``).  A pick is kept when its decayed score is above
    ``max(min_score, 0)``.  Returns ``(boxes (max_out, 4), scores
    (max_out,) decayed, NEG_INF where not kept, valid, idx)``, the index 0
    where not kept."""
    if method not in ("linear", "gaussian"):
        raise NotImplementedError(f"soft-NMS method {method!r} is not ported")
    n = boxes.shape[0]
    idx = torch.arange(n, device=boxes.device)
    s = scores if valid is None else torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    picks, picked = [], []
    for _ in range(max_out):
        i = torch.argmax(s).reshape(1)
        picks.append(i)
        picked.append(s.index_select(0, i))
        ious = bbox_overlaps(boxes.index_select(0, i), boxes)[0]
        if method == "gaussian":
            decay = torch.exp(-(ious ** 2) / sigma)
        else:
            decay = torch.where(ious > iou_threshold, 1.0 - ious, torch.ones_like(ious))
        s = torch.where(idx == i, torch.full_like(s, NEG_INF), s * decay)
    oi, os_ = torch.cat(picks), torch.cat(picked)
    ov = os_ > max(min_score, 0.0)
    return (boxes[oi], torch.where(ov, os_, torch.full_like(os_, NEG_INF)), ov,
            torch.where(ov, oi, torch.zeros_like(oi)))
