"""The albumentations transforms of the config zoo (PyTorch port of
``boosting_rcnn_tpu/data/albu.py``; the loader's ``albu`` option):
``ShiftScaleRotate``, ``RandomBrightnessContrast``, ``RGBShift``,
``HueSaturationValue``, ``ChannelShuffle``, ``Blur``, ``MedianBlur`` and
``OneOf``, with the JAX functions' draws in their order and ``cv2``'s
bytes through ``cv_ops``.

Each transform fires with its ``p``; ``OneOf`` picks one child by the
normalised children's ``p``.  ``ShiftScaleRotate`` warps the image with
reflect-101 borders, boxes by their four corners (then clipped; the
visible share of the warped box is kept for ``min_visibility``), polygons
point by point, and full-image bitmaps (and uncompressed RLE, decoded to
one) by nearest neighbour.  Boxes at or below ``min_visibility``, or
thinner than 1e-3, are dropped with their labels and masks.
``JpegCompression`` (which needs a JPEG codec held to libjpeg's bytes; no
config uses it) and unknown types raise.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import cv_ops

__all__ = ["SUPPORTED", "apply_albu"]

PIXEL_TYPES = ("RandomBrightnessContrast", "RGBShift", "HueSaturationValue", "ChannelShuffle",
               "Blur", "MedianBlur")
SUPPORTED = PIXEL_TYPES + ("ShiftScaleRotate", "OneOf")


def _u(rng: np.random.RandomState, lim, center: float = 0.0) -> float:
    """A scalar ``lim`` draws ``U(center - lim, center + lim)``, a pair
    ``[lo, hi]`` ``U(center + lo, center + hi)``."""
    if isinstance(lim, (list, tuple)):
        lo, hi = float(lim[0]), float(lim[1])
    else:
        lo, hi = -float(lim), float(lim)
    return float(rng.uniform(center + lo, center + hi))


def _brightness_contrast(img, t, rng):
    alpha = 1.0 + _u(rng, t.get("contrast_limit", 0.2))
    beta = _u(rng, t.get("brightness_limit", 0.2))
    x = img.astype(np.float32) * alpha + beta * 255.0
    return np.clip(x, 0, 255).astype(img.dtype)


def _rgb_shift(img, t, rng):
    shifts = [_u(rng, t.get("r_shift_limit", 20)), _u(rng, t.get("g_shift_limit", 20)),
              _u(rng, t.get("b_shift_limit", 20))]
    x = img.astype(np.float32) + np.asarray(shifts, np.float32)
    return np.clip(x, 0, 255).astype(img.dtype)


def _hsv(img, t, rng):
    hsv = cv_ops.rgb_to_hsv(img).astype(np.int32)
    hsv[..., 0] = (hsv[..., 0] + int(_u(rng, t.get("hue_shift_limit", 20)))) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + int(_u(rng, t.get("sat_shift_limit", 30))), 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] + int(_u(rng, t.get("val_shift_limit", 20))), 0, 255)
    return cv_ops.hsv_to_rgb(hsv.astype(np.uint8))


def _channel_shuffle(img, t, rng):
    return img[..., rng.permutation(img.shape[-1])]


def _blur(img, t, rng, median: bool = False):
    lim = int(t.get("blur_limit", 7))
    sizes = list(range(3, max(lim, 3) + 1, 2))
    k = int(sizes[rng.randint(0, len(sizes))])
    return cv_ops.median_blur(img, k) if median else cv_ops.blur(img, k)


def _rle_bitmap(seg) -> np.ndarray:
    """An uncompressed RLE's ``(h, w)`` bitmap (column-major counts)."""
    counts, (rh, rw) = seg["counts"], seg["size"]
    flat = np.zeros(rh * rw, np.uint8)
    pos, val = 0, 0
    for c in counts:
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape(rw, rh).T


def _shift_scale_rotate(img, bboxes, segs, t, rng):
    h, w = img.shape[:2]
    angle = _u(rng, t.get("rotate_limit", 45))
    scale = 1.0 + _u(rng, t.get("scale_limit", 0.1))
    dx = _u(rng, t.get("shift_limit", 0.0625))
    dy = _u(rng, t.get("shift_limit", 0.0625))
    m = cv_ops.get_rotation_matrix_2d((w / 2.0, h / 2.0), angle, scale)
    m[0, 2] += dx * w
    m[1, 2] += dy * h
    out = cv_ops.warp_affine(img, m, (w, h), linear=True,
                             border_mode=cv_ops.BORDER_REFLECT_101)

    def warp_pts(pts):  # (N, 2)
        return pts @ m[:, :2].T + m[:, 2]

    new_boxes = bboxes.copy().astype(np.float32)
    vis = np.ones(len(bboxes), np.float32)
    if len(bboxes):
        x1, y1, x2, y2 = (bboxes[:, i] for i in range(4))
        corners = np.stack([np.stack([x1, y1], -1), np.stack([x2, y1], -1),
                            np.stack([x2, y2], -1), np.stack([x1, y2], -1)], axis=1)
        wc = warp_pts(corners.reshape(-1, 2)).reshape(-1, 4, 2)
        nb = np.concatenate([wc.min(1), wc.max(1)], axis=1)
        clipped = nb.copy()
        clipped[:, 0::2] = np.clip(clipped[:, 0::2], 0, w)
        clipped[:, 1::2] = np.clip(clipped[:, 1::2], 0, h)
        full = (np.maximum(nb[:, 2] - nb[:, 0], 1e-6) * np.maximum(nb[:, 3] - nb[:, 1], 1e-6))
        visible = (np.maximum(clipped[:, 2] - clipped[:, 0], 0)
                   * np.maximum(clipped[:, 3] - clipped[:, 1], 0))
        vis = visible / full
        new_boxes = clipped
    new_segs = None
    if segs is not None:
        new_segs = []
        for seg in segs:
            if seg is None:
                new_segs.append(None)
            elif isinstance(seg, np.ndarray) and seg.ndim == 2:
                new_segs.append(cv_ops.warp_affine(seg, m, (w, h), linear=False))
            elif isinstance(seg, dict):
                new_segs.append(cv_ops.warp_affine(_rle_bitmap(seg), m, (w, h), linear=False))
            else:  # polygons: each point through the affine
                new_segs.append([warp_pts(np.asarray(p, np.float64).reshape(-1, 2)).reshape(-1)
                                 for p in seg])
    return out, new_boxes, new_segs, vis


def _apply_one(img, bboxes, segs, t, rng):
    """One transform: ``(img, bboxes, segs, visibility)``."""
    tt = t["type"]
    if tt == "ShiftScaleRotate":
        return _shift_scale_rotate(img, bboxes, segs, t, rng)
    if tt == "RandomBrightnessContrast":
        img = _brightness_contrast(img, t, rng)
    elif tt == "RGBShift":
        img = _rgb_shift(img, t, rng)
    elif tt == "HueSaturationValue":
        img = _hsv(img, t, rng)
    elif tt == "ChannelShuffle":
        img = _channel_shuffle(img, t, rng)
    elif tt == "Blur":
        img = _blur(img, t, rng)
    elif tt == "MedianBlur":
        img = _blur(img, t, rng, median=True)
    elif tt == "JpegCompression":
        raise NotImplementedError("albu transform 'JpegCompression' is not ported to PyTorch: "
                                  "it needs a JPEG codec held to libjpeg's bytes")
    else:
        raise NotImplementedError(f"albu transform {tt!r} is not implemented (supported: "
                                  f"{SUPPORTED})")
    return img, bboxes, segs, np.ones(len(bboxes), np.float32)


def apply_albu(img: np.ndarray, bboxes: np.ndarray, labels: np.ndarray, segs: Optional[list],
               transforms: Sequence[dict], rng: np.random.RandomState,
               min_visibility: float = 0.0):
    """``(img, bboxes, labels, segs)`` after the transform list."""
    vis_all = np.ones(len(bboxes), np.float32)
    for t in transforms:
        if rng.rand() >= float(t.get("p", 0.5)):
            continue
        if t["type"] == "OneOf":
            children = t.get("transforms", [])
            if not children:
                continue
            cps = np.asarray([float(c.get("p", 1.0)) for c in children])
            cps = cps / max(cps.sum(), 1e-12)
            pick = children[int(rng.choice(len(children), p=cps))]
            img, bboxes, segs, vis = _apply_one(img, bboxes, segs, pick, rng)
        else:
            img, bboxes, segs, vis = _apply_one(img, bboxes, segs, t, rng)
        vis_all = np.minimum(vis_all, vis)
    if len(bboxes):
        keep = ((vis_all > max(min_visibility, 1e-6)) & ((bboxes[:, 2] - bboxes[:, 0]) > 1e-3)
                & ((bboxes[:, 3] - bboxes[:, 1]) > 1e-3))
        if not keep.all():
            bboxes = bboxes[keep]
            labels = labels[keep]
            if segs is not None:
                segs = [s for s, k in zip(segs, keep) if k]
    return np.ascontiguousarray(img), bboxes, labels, segs
