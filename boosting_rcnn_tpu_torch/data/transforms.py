"""Large-scale jitter (PyTorch port of ``boosting_rcnn_tpu/data/transforms.py::
large_scale_jitter``; the strong baselines' ``lsj_range``): a keep-ratio
resize to ``canvas * r`` for a drawn ratio ``r``, then a random crop to at
most the canvas.  The image is resized with the numpy copy of
``cv2.resize`` (``cv_ops.resize_linear``).  Polygons are scaled and
shifted with the boxes; RLE entries become ``None`` (dropped, as in the
JAX function); boxes whose centre leaves the crop are dropped.  As there,
polygons are shifted only where the image has boxes."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .cv_ops import resize_linear

__all__ = ["large_scale_jitter"]


def large_scale_jitter(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray, segs,
                       rng: np.random.RandomState, canvas: Tuple[int, int],
                       ratio_range: Tuple[float, float] = (0.1, 2.0)):
    """``(img, boxes, labels, segs)`` after LSJ; the image is no larger than
    ``canvas`` ``(H, W)``.  Draws ``r``, then the crop's top and left."""
    h0, w0 = img.shape[:2]
    r = rng.uniform(*ratio_range)
    f = min(canvas[0] * r / max(h0, 1), canvas[1] * r / max(w0, 1))
    nh = max(int(h0 * f + 0.5), 1)
    nw = max(int(w0 * f + 0.5), 1)
    img = resize_linear(img, nw, nh)
    boxes = boxes.astype(np.float32).copy()
    if len(boxes):
        boxes *= f
    if segs is not None:
        segs = [None if (s is None or isinstance(s, dict))
                else [np.asarray(p, np.float32) * f for p in s] for s in segs]
    top = rng.randint(0, max(nh - canvas[0], 0) + 1)
    left = rng.randint(0, max(nw - canvas[1], 0) + 1)
    ch, cw = min(canvas[0], nh), min(canvas[1], nw)
    img = img[top:top + ch, left:left + cw]
    if len(boxes):
        b = boxes
        b[:, [0, 2]] -= left
        b[:, [1, 3]] -= top
        cx = (b[:, 0] + b[:, 2]) / 2
        cy = (b[:, 1] + b[:, 3]) / 2
        keep = (cx >= 0) & (cx < cw) & (cy >= 0) & (cy < ch)
        b[:, [0, 2]] = b[:, [0, 2]].clip(0, cw)
        b[:, [1, 3]] = b[:, [1, 3]].clip(0, ch)
        boxes, labels = b[keep], labels[keep]
        if segs is not None:
            shift = lambda p: p - np.tile([left, top], p.shape[0] // 2).astype(np.float32)
            segs = [None if s is None else [shift(p) for p in s]
                    for s, k in zip(segs, keep) if k]
    return img, boxes, labels, segs
