"""Box primitives: IoU, delta encoding and decoding, clipping (PyTorch port).

Counterpart of ``boosting_rcnn_tpu/ops/box_ops.py``.  Functions work on
tensors of any leading shape; where the JAX package adds a batch axis with
``vmap``, these take it as a leading dimension.  ``take_small_table`` (a
one-hot matmul that keeps a TPU gather on the matrix unit) is a plain index
gather on the GPU.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

# largest |log(w / w_anchor)| the coder decodes (mmdet ``wh_ratio_clip``)
MAX_LOG_RATIO = abs(math.log(16.0 / 1000.0))

__all__ = [
    "bbox_area",
    "bbox_overlaps",
    "bbox_overlaps_aligned",
    "bbox_center_wh",
    "bbox2delta",
    "delta2bbox",
    "clip_boxes",
    "hflip_boxes",
    "take_small_table",
]


def take_small_table(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: (G, D) table, (A,) indices -> (A, D)."""
    return table[idx]


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of ``(..., 4)`` xyxy boxes, clamped at 0."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def bbox_overlaps(
    boxes1: torch.Tensor,
    boxes2: torch.Tensor,
    mode: str = "iou",
    eps: float = 1e-6,
) -> torch.Tensor:
    """Pairwise overlaps between ``(..., N, 4)`` and ``(..., M, 4)`` xyxy
    boxes -> ``(..., N, M)``.  ``mode``: ``iou`` | ``iof`` | ``giou``."""
    if mode not in ("iou", "iof", "giou"):
        raise ValueError(f"unknown overlap mode {mode!r}")
    area1 = bbox_area(boxes1)
    area2 = bbox_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    overlap = wh[..., 0] * wh[..., 1]
    if mode == "iof":
        union = area1[..., :, None]
    else:
        union = area1[..., :, None] + area2[..., None, :] - overlap
    union = torch.clamp(union, min=eps)
    ious = overlap / union
    if mode != "giou":
        return ious
    enc_lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    enc_rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    enc_wh = torch.clamp(enc_rb - enc_lt, min=0.0)
    enc_area = torch.clamp(enc_wh[..., 0] * enc_wh[..., 1], min=eps)
    return ious - (enc_area - union) / enc_area


def bbox_overlaps_aligned(boxes1: torch.Tensor, boxes2: torch.Tensor,
                          eps: float = 1e-6, mode: str = "iou") -> torch.Tensor:
    """Element-wise IoU (``mode="iou"``) or GIoU (``"giou"``) of two equally
    shaped ``(..., 4)`` box tensors -> ``(...)``, the union and the
    enclosing box's area floored at ``eps``."""
    if mode not in ("iou", "giou"):
        raise ValueError(f"unknown overlap mode {mode!r}")
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    overlap = wh[..., 0] * wh[..., 1]
    union = torch.clamp(bbox_area(boxes1) + bbox_area(boxes2) - overlap, min=eps)
    ious = overlap / union
    if mode == "iou":
        return ious
    enc_lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    enc_rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    enc_wh = torch.clamp(enc_rb - enc_lt, min=0.0)
    enc_area = torch.clamp(enc_wh[..., 0] * enc_wh[..., 1], min=eps)
    return ious - (enc_area - union) / enc_area


def bbox_center_wh(boxes: torch.Tensor):
    """(cx, cy, w, h) of ``(..., 4)`` xyxy boxes."""
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return cx, cy, w, h


def bbox2delta(
    proposals: torch.Tensor,
    gt: torch.Tensor,
    means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
    stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
    eps: float = 1e-6,
) -> torch.Tensor:
    """Encode ``gt`` relative to ``proposals``, both ``(..., 4)`` xyxy.
    Widths and heights are floored at ``eps``, so that padded zero-size
    rows give finite deltas (they are masked downstream)."""
    px, py, pw, ph = bbox_center_wh(proposals)
    gx, gy, gw, gh = bbox_center_wh(gt)
    pw, ph = torch.clamp(pw, min=eps), torch.clamp(ph, min=eps)
    gw, gh = torch.clamp(gw, min=eps), torch.clamp(gh, min=eps)
    deltas = torch.stack(
        [(gx - px) / pw, (gy - py) / ph, torch.log(gw / pw), torch.log(gh / ph)], dim=-1)
    means_t = torch.tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds_t = torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    return (deltas - means_t) / stds_t


def delta2bbox(
    rois: torch.Tensor,
    deltas: torch.Tensor,
    means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
    stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
    max_shape: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode ``deltas`` (``(..., K*4)``) on top of ``rois`` (``(..., 4)``).

    ``max_shape`` is ``(H, W)``, or ``(B, 2)`` for a leading batch axis of
    ``rois``; the boxes are clipped to it.  The log-ratio clamp
    ``|dw|, |dh| <= MAX_LOG_RATIO`` matches the reference coder.
    """
    k4 = deltas.shape[-1]
    if k4 % 4:
        raise ValueError(f"delta width {k4} is not a multiple of 4")
    reps = k4 // 4
    means_t = torch.tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds_t = torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    denorm = deltas * stds_t.repeat(reps) + means_t.repeat(reps)
    denorm = denorm.reshape(denorm.shape[:-1] + (reps, 4))
    dx, dy, dw, dh = denorm.unbind(-1)

    px, py, pw, ph = (v[..., None] for v in bbox_center_wh(rois))
    dw = torch.clamp(dw, -MAX_LOG_RATIO, MAX_LOG_RATIO)
    dh = torch.clamp(dh, -MAX_LOG_RATIO, MAX_LOG_RATIO)

    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    boxes = torch.stack(
        [gx - gw * 0.5, gy - gh * 0.5, gx + gw * 0.5, gy + gh * 0.5], dim=-1
    )
    if max_shape is not None:
        boxes = clip_boxes(boxes, max_shape)
    return boxes.reshape(deltas.shape)


def clip_boxes(boxes: torch.Tensor, max_shape: torch.Tensor) -> torch.Tensor:
    """Clip ``(..., 4)`` xyxy boxes to ``(H, W)`` (inclusive).  A
    ``max_shape`` of shape ``(B, 2)`` applies per leading batch index."""
    max_shape = torch.as_tensor(max_shape, device=boxes.device)
    lead = max_shape.shape[:-1]
    view = lead + (1,) * (boxes.ndim - 1 - len(lead))
    h = max_shape[..., 0].to(boxes.dtype).reshape(view)
    w = max_shape[..., 1].to(boxes.dtype).reshape(view)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def hflip_boxes(boxes: torch.Tensor, img_w) -> torch.Tensor:
    """Mirror ``(..., 4)`` xyxy boxes inside a width ``img_w`` (a number,
    or a tensor broadcast against the boxes' leading axes): ``x1' = w -
    x2``, ``x2' = w - x1`` (JAX ``two_stage.py::_hflip_boxes``)."""
    return torch.stack([img_w - boxes[..., 2], boxes[..., 1], img_w - boxes[..., 0],
                        boxes[..., 3]], dim=-1)
