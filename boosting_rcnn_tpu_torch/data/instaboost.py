"""InstaBoost without its matting (PyTorch port of
``boosting_rcnn_tpu/data/instaboost.py``; the loader's ``instaboost``
option, every config of ``configs/instaboost/`` with ``hflag=False``).

With probability ``aug_ratio`` an image (one gate for the whole image) has
each polygon instance, in turn, drawn an action (``normal``,
``horizontal`` or ``skip`` by ``action_prob``); an instance not skipped
is cut out (its mask dilated by 3 x 3 and TELEA-inpainted over the whole
image, ``cv_ops.inpaint_telea``) and pasted back under an affine about its
box centre: translation ``U(-w / dx, w / dx) x U(-h / dy, h / dy)``,
scale ``U(*scale)``, rotation ``U(*theta)`` degrees, mirrored about its
own vertical axis for ``horizontal``; the mask is warped by nearest
neighbour and the pixels linearly (only over the part of the frame the
mask can reach: the same pixels as the JAX function's whole-frame
warps), with a colour jitter
(``x * U(0.8, 1.2) + U(-16, 16)``) at ``color_prob``.  An instance warped
out of the frame keeps the image as it was.  Boxes follow the warped mask,
polygons the affine; labels never change.  The draws are the JAX
function's, in its order.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from . import cv_ops
from .mask_utils import polygons_to_bitmap

__all__ = ["instaboost"]


def _affine_about(cx, cy, angle_deg, scale, tx, ty) -> np.ndarray:
    m = cv_ops.get_rotation_matrix_2d((float(cx), float(cy)), float(angle_deg), float(scale))
    m[0, 2] += tx
    m[1, 2] += ty
    return m


def _landing_window(mask: np.ndarray, m: np.ndarray, w: int, h: int):
    """``(x0, y0, x1, y1)``: the part of the ``w`` x ``h`` frame that the
    nonzero pixels of ``mask`` can reach through the affine ``m`` (empty
    where they leave the frame)."""
    ys, xs = np.nonzero(mask)
    bx0, by0, bx1, by1 = xs.min() - 1, ys.min() - 1, xs.max() + 1, ys.max() + 1
    corners = np.array([[bx0, by0], [bx1, by0], [bx1, by1], [bx0, by1]], np.float64)
    pts = corners @ m[:, :2].T + m[:, 2]
    x0, y0 = np.floor(pts.min(0)).astype(int) - 2
    x1, y1 = np.ceil(pts.max(0)).astype(int) + 3
    x0, y0 = min(max(x0, 0), w), min(max(y0, 0), h)
    return x0, y0, max(min(x1, w), x0), max(min(y1, h), y0)


def _color_jitter(patch: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    alpha = rng.uniform(0.8, 1.2)
    beta = rng.uniform(-16, 16)
    return np.clip(patch.astype(np.float32) * alpha + beta, 0, 255).astype(patch.dtype)


def instaboost(img: np.ndarray, bboxes: np.ndarray, labels: np.ndarray, segs: Optional[list],
               rng: np.random.RandomState,
               action_candidate: Sequence[str] = ("normal", "horizontal", "skip"),
               action_prob: Sequence[float] = (1, 0, 0), scale: Tuple[float, float] = (0.8, 1.2),
               dx: float = 15, dy: float = 15, theta: Tuple[float, float] = (-1, 1),
               color_prob: float = 0.5, hflag: bool = False, aug_ratio: float = 0.5):
    """``(img, bboxes, segs)`` after the jitter-paste (``labels`` unread,
    as in the JAX function)."""
    del labels, hflag  # heatmap placement: every config turns it off
    if segs is None or not len(bboxes):
        return img, bboxes, segs
    if rng.rand() >= aug_ratio:
        return img, bboxes, segs
    h, w = img.shape[:2]
    out = img.copy()
    new_boxes = bboxes.astype(np.float32).copy()
    new_segs = list(segs)
    probs = np.asarray(action_prob, np.float64)
    probs = probs / max(probs.sum(), 1e-12)
    for i in range(len(bboxes)):
        seg = segs[i]
        if seg is None or isinstance(seg, dict):  # crowd RLE: left as it is
            continue
        action = action_candidate[int(rng.choice(len(probs), p=probs))]
        if action == "skip":
            continue
        x1, y1, x2, y2 = bboxes[i]
        bw, bh = max(x2 - x1, 1.0), max(y2 - y1, 1.0)
        mask = polygons_to_bitmap(seg, h, w).astype(np.uint8)
        if mask.sum() < 4:
            continue
        cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
        tx = rng.uniform(-bw / dx, bw / dx)
        ty = rng.uniform(-bh / dy, bh / dy)
        sc = rng.uniform(*scale)
        ang = rng.uniform(*theta)
        m = _affine_about(cx, cy, ang, sc, tx, ty)
        if action in ("horizontal", "vertical"):
            # the mirror about the instance's own axis, folded into the affine
            fx, fy = (-1.0, 1.0) if action == "horizontal" else (1.0, -1.0)
            f = np.array([[fx, 0, cx - fx * cx], [0, fy, cy - fy * cy]], np.float64)
            m = (np.vstack([m, [0, 0, 1]]) @ np.vstack([f, [0, 0, 1]]))[:2]
        # the warps only where the mask can land: the mask's box (1 px more)
        # through the affine, 2 px more; the JAX function warps the whole
        # image and keeps the same pixels
        win = _landing_window(mask, m, w, h)
        wmask = cv_ops.warp_affine(mask, m, (w, h), linear=False, window=win)
        wpatch = cv_ops.warp_affine(out, m, (w, h), linear=True, window=win)
        if rng.rand() < color_prob:
            wpatch = _color_jitter(wpatch, rng)
        sel = wmask.astype(bool)
        if not sel.any():  # warped out of the frame: the image stays
            continue
        out = cv_ops.inpaint_telea(out, cv_ops.dilate3(mask), 3)
        wx0, wy0, wx1, wy1 = win
        out[wy0:wy1, wx0:wx1][sel] = wpatch[sel]
        new_segs[i] = [(np.asarray(p, np.float64).reshape(-1, 2) @ m[:, :2].T
                        + m[:, 2]).reshape(-1) for p in seg]
        ys, xs = np.nonzero(wmask)
        xs, ys = xs + wx0, ys + wy0
        new_boxes[i] = [max(xs.min(), 0), max(ys.min(), 0), min(xs.max() + 1, w),
                        min(ys.max() + 1, h)]
    return np.ascontiguousarray(out), new_boxes, new_segs
