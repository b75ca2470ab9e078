"""Instance mask utilities on the host (PyTorch port of
``boosting_rcnn_tpu/data/mask_utils.py``), in numpy alone.

Each gt instance carries a fixed-size binary crop rasterised relative to
its own box: a crop is scale-invariant, so a resize needs no new
rasterisation and a flip is a left-right mirror.  Predicted masks are
box-relative probability crops, pasted into the image for evaluation.

The JAX package rasterises and resizes with OpenCV; the port writes the
three primitives it uses in numpy, to the same bytes:

  * ``fill_poly``: ``cv2.fillPoly`` (OpenCV 5.0) with integer points,
    ``shift=0`` and ``LINE_8``: each edge's 8-connected outline, clipped
    to the image, then each row filled between pairs of the edges that
    cross it, in 16.16 fixed point, from the left crossing rounded up to
    the right one rounded down; an edge whose outline leaves the image
    takes the x of its clipped ends (and their y unless the clipped line
    is flat).  The rule was fitted to cv2's output on random polygons;
    OpenCV 4's (a half-pixel offset, both crossings rounded down) differs;
  * ``resize_nearest``: ``cv2.resize(..., INTER_NEAREST)``, the source
    index ``min(floor(d * (1 / (dst / src))), src - 1)`` in double;
  * ``resize_linear``: ``cv2.resize(..., INTER_LINEAR)`` of float32, with
    half-pixel centres, edge clamping, the horizontal pass then the
    vertical one.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["MASK_CROP_SIZE", "fill_poly", "resize_nearest", "resize_linear",
           "polygons_to_box_crop", "rle_to_box_crop", "paste_mask", "polygons_to_bitmap",
           "crop_mask_iou", "mask_iou_matrix"]

MASK_CROP_SIZE = 112

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """``cv::clipLine`` on the image ``[0, w) x [0, h)``: the clipped
    endpoints and whether any part of the line is inside."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return x1, y1, x2, y2, (c1 | c2) == 0


def _line_params(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """``cv::LineIterator`` with 8-connectivity from one point to the other,
    left to right, clipped to the image: ``(x1, y1, sy, vert, major,
    minor)``, or None where no part of the line is inside."""
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        x1, y1, x2, y2, inside = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return None
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, sy = x2 - x1, y2 - y1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    return (x1, y1, sy, int(vert)) + ((dy, dx) if vert else (dx, dy))


def _line_pixels(lines) -> tuple:
    """The pixels ``(xs, ys)`` of every line of ``_line_params``: Bresenham
    with the error starting at ``major - 2 minor``, so that the minor axis
    has moved ``(2 minor k + major - 1) // (2 major)`` after ``k`` steps of
    the major one."""
    x1, y1, sy, vert, major, minor = np.asarray(lines, np.int64).T
    n = major + 1
    idx = np.repeat(np.arange(len(n)), n)
    k = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    mj, mn = major[idx], minor[idx]
    m = np.where(mj > 0, (2 * mn * k + mj - 1) // np.maximum(2 * mj, 1), 0)
    v = vert[idx].astype(bool)
    return x1[idx] + np.where(v, m, k), y1[idx] + sy[idx] * np.where(v, k, m)


def fill_poly(img: np.ndarray, polygons: Sequence[np.ndarray], value: int = 1) -> np.ndarray:
    """``cv2.fillPoly(img, polygons, value)`` for integer ``(P, 2)`` point
    arrays (``shift=0``, ``LINE_8``), in place on the 2-D ``img``; returns
    ``img``."""
    h, w = img.shape[:2]
    edges = []  # (y0, y1, x at y0 in 16.16, dx a row in 16.16)
    lines = []
    for poly in polygons:
        v = np.asarray(poly, np.int64).reshape(-1, 2)
        n = len(v)
        for i in range(n):
            (ax, ay), (bx, by) = (int(c) for c in v[i - 1]), (int(c) for c in v[i])
            line = _line_params(w, h, ax, ay, bx, by)
            if line is not None:
                lines.append(line)
            if ay == by:
                continue
            # the edge in 16.16 fixed point; where the outline leaves the image,
            # its x from the clipped endpoints (and its y too unless the clipped
            # line is flat)
            p0x, p0y, p1x, p1y = ax << XY_SHIFT, ay, bx << XY_SHIFT, by
            if not (0 <= ax < w and 0 <= bx < w and 0 <= ay < h and 0 <= by < h):
                cx0, cy0, cx1, cy1, _ = _clip_line(w, h, ax, ay, bx, by)
                p0x, p1x = cx0 << XY_SHIFT, cx1 << XY_SHIFT
                if cy0 != cy1:
                    p0y, p1y = cy0, cy1
            num, den = p1x - p0x, p1y - p0y
            dx = abs(num) // abs(den) * (1 if (num >= 0) == (den > 0) else -1)  # C's /
            if ay < by:
                edges.append((ay, by, p0x + (ay - p0y) * dx, dx))
            else:
                edges.append((by, ay, p1x + (by - p1y) * dx, dx))
    if lines:
        xs, ys = _line_pixels(lines)
        img[ys, xs] = value
    if len(edges) < 2:
        return img
    e = np.asarray(edges, np.int64)
    y0, y1 = np.maximum(e[:, 0], 0), np.minimum(e[:, 1], h)
    rows = np.maximum(y1 - y0, 0)
    if not rows.sum():
        return img
    # every edge's x on every row it crosses (rows y0 <= y < y1 in the image)
    idx = np.repeat(np.arange(len(e)), rows)
    ys = np.arange(rows.sum()) - np.repeat(np.cumsum(rows) - rows, rows) + y0[idx]
    xs = e[idx, 2] + (ys - e[idx, 0]) * e[idx, 3]
    order = np.lexsort((xs, ys))
    ys, xs = ys[order], xs[order]
    # pairs of consecutive crossings on a row bound a span: the pixels from
    # the left crossing rounded up to the right one rounded down
    left, right = (xs[0::2] + XY_ONE - 1) >> XY_SHIFT, xs[1::2] >> XY_SHIFT
    yrow = ys[0::2]
    keep = (left < w) & (right >= 0)
    left, right, yrow = np.maximum(left[keep], 0), np.minimum(right[keep], w - 1), yrow[keep]
    if len(yrow):
        diff = np.zeros((h, w + 1), np.int32)
        np.add.at(diff, (yrow, left), 1)
        np.add.at(diff, (yrow, right + 1), -1)
        img[np.cumsum(diff[:, :w], axis=1) > 0] = value
    return img


def resize_nearest(src: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(src, (width, height), interpolation=INTER_NEAREST)``."""
    sh, sw = src.shape[:2]
    xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / sw))), sw - 1).astype(np.int64)
    ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / sh))), sh - 1).astype(np.int64)
    return src[ys[:, None], xs[None, :]]


def _linear_taps(n_dst: int, n_src: int):
    """cv2's linear taps along one axis: source index pairs and float32
    weights, at half-pixel centres, clamped at the edges."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    f[s < 0] = 0
    s[s < 0] = 0
    hi = s >= n_src - 1
    f[hi] = 0
    s[hi] = n_src - 1
    return s, np.minimum(s + 1, n_src - 1), (np.float32(1) - f).astype(np.float32), f


def resize_linear(src: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(src, (width, height), interpolation=INTER_LINEAR)`` of a
    2-D float32 array."""
    src = np.asarray(src, np.float32)
    x0, x1, a0, a1 = _linear_taps(width, src.shape[1])
    y0, y1, b0, b1 = _linear_taps(height, src.shape[0])
    rows = src[:, x0] * a0 + src[:, x1] * a1
    return (rows[y0] * b0[:, None] + rows[y1] * b1[:, None]).astype(np.float32)


def _rle_full(rle) -> np.ndarray:
    """The ``(h, w)`` uint8 bitmap of an uncompressed COCO RLE
    (column-major counts, starting with a run of zeros)."""
    counts = rle["counts"]
    h, w = rle["size"]
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape(w, h).T


def polygons_to_box_crop(polygons: Sequence[np.ndarray], box: np.ndarray,
                         size: int = MASK_CROP_SIZE) -> np.ndarray:
    """Rasterise instance polygons into a ``(size, size)`` crop of ``box``
    (xyxy, in the polygons' coordinates)."""
    x1, y1, x2, y2 = box
    w = max(x2 - x1, 1e-3)
    h = max(y2 - y1, 1e-3)
    out = np.zeros((size, size), np.uint8)
    pts = []
    for poly in polygons:
        p = np.asarray(poly, np.float64).reshape(-1, 2).copy()
        p[:, 0] = (p[:, 0] - x1) / w * size
        p[:, 1] = (p[:, 1] - y1) / h * size
        pts.append(np.round(p).astype(np.int32))
    if pts:
        fill_poly(out, pts, 1)
    return out


def rle_to_box_crop(rle, box, img_h, img_w, size: int = MASK_CROP_SIZE) -> np.ndarray:
    """An uncompressed COCO RLE -> the ``(size, size)`` crop of ``box``;
    compressed (string) counts give an all-zero crop, as in the JAX
    package (crowd annotations are ignore-only)."""
    if isinstance(rle, dict) and isinstance(rle.get("counts"), list):
        full = _rle_full(rle)
        x1, y1, x2, y2 = [int(round(v)) for v in box]
        x2, y2 = max(x2, x1 + 1), max(y2, y1 + 1)
        crop = full[y1:y2, x1:x2]
        if crop.size:
            return resize_nearest(crop, size, size)
    return np.zeros((size, size), np.uint8)


def paste_mask(mask28: np.ndarray, box: np.ndarray, img_h: int, img_w: int,
               thr: float = 0.5) -> np.ndarray:
    """Paste a predicted box-relative probability mask into the
    ``(img_h, img_w)`` image: bilinearly resized to the box's pixel
    extent, then thresholded."""
    x1, y1, x2, y2 = box
    x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
    x2i, y2i = int(np.ceil(x2)), int(np.ceil(y2))
    x1i, y1i = max(x1i, 0), max(y1i, 0)
    x2i, y2i = min(max(x2i, x1i + 1), img_w), min(max(y2i, y1i + 1), img_h)
    out = np.zeros((img_h, img_w), np.uint8)
    if x2i <= x1i or y2i <= y1i:
        return out
    resized = resize_linear(mask28, x2i - x1i, y2i - y1i)
    out[y1i:y2i, x1i:x2i] = (resized > thr).astype(np.uint8)
    return out


def polygons_to_bitmap(segmentation, h: int, w: int) -> np.ndarray:
    """A COCO segmentation (a polygon list or an uncompressed RLE) -> an
    ``(h, w)`` uint8 bitmap; polygon parts of fewer than 6 coordinates
    are dropped, compressed RLE gives an empty bitmap."""
    out = np.zeros((h, w), np.uint8)
    if segmentation is None:
        return out
    if isinstance(segmentation, dict):
        if isinstance(segmentation.get("counts"), list):
            return _rle_full(segmentation)[:h, :w]
        return out
    pts = [np.round(np.asarray(p, np.float64).reshape(-1, 2)).astype(np.int32)
           for p in segmentation if len(p) >= 6]
    if pts:
        fill_poly(out, pts, 1)
    return out


def crop_mask_iou(boxes1: np.ndarray, crops1: List[np.ndarray], boxes2: np.ndarray,
                  bitmaps2: List[np.ndarray], iscrowd: np.ndarray, img_h: int, img_w: int,
                  thr: float = 0.5) -> np.ndarray:
    """``(N, M)`` mask IoU of detections given as box crops (or full-image
    masks, which pass straight through) against full gt bitmaps; a crowd
    gt's union is the detection's area."""
    n, m = len(boxes1), len(bitmaps2)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    det_full = [crops1[i] if crops1[i].shape == (img_h, img_w)
                else paste_mask(crops1[i], boxes1[i], img_h, img_w, thr) for i in range(n)]
    a1 = np.array([d.sum() for d in det_full], np.float64)
    a2 = np.array([g.sum() for g in bitmaps2], np.float64)
    out = np.zeros((n, m))
    for i in range(n):
        for j in range(m):
            inter = np.logical_and(det_full[i], bitmaps2[j]).sum()
            union = a1[i] if iscrowd[j] else a1[i] + a2[j] - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def mask_iou_matrix(masks1: List[np.ndarray], masks2: List[np.ndarray]) -> np.ndarray:
    """``(N, M)`` IoU between two lists of binary bitmaps."""
    n, m = len(masks1), len(masks2)
    out = np.zeros((n, m))
    a1 = [m_.sum() for m_ in masks1]
    a2 = [m_.sum() for m_ in masks2]
    for i in range(n):
        for j in range(m):
            inter = np.logical_and(masks1[i], masks2[j]).sum()
            union = a1[i] + a2[j] - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out
