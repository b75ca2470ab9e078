"""Deterministic synthetic COCO dataset of drawn shapes (the port's numpy
copy of ``scripts/make_synthetic_coco.py``).

Four classes, named as the flagship's UTDAC classes so that its config's
``classes`` filter passes them: echinus = red circle, holothurian = green
square, scallop = blue triangle, starfish = yellow ellipse, on a dark
noisy background.  The random draws are the JAX script's, in its order;
the shapes are rasterised with numpy and the images written as binary PPM,
which the port decodes without cv2 or PIL.

``frame_sizes`` (``(W, H)`` pairs, taken in turn) and ``n_portrait`` (the
last images of each split, drawn on the transposed frame) make sets at
other frame sizes; the shapes then scale by ``object_scale`` times the
frame's short side over 160.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .image_io import write_ppm

__all__ = ["CLASSES", "IMG_H", "IMG_W", "generate"]

CLASSES = ("echinus", "holothurian", "scallop", "starfish")
IMG_H, IMG_W = 160, 200
_COLORS = [(40, 40, 230), (40, 220, 40), (230, 60, 40), (40, 220, 230)]  # BGR


def _ngon(cx, cy, a, b, n=24):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + a * np.cos(t), cy + b * np.sin(t)], axis=1)


def _fill(img, inside, x0, y0, x1, y1, color):
    """Paint ``color`` where ``inside(xx, yy)`` holds in the pixel window
    ``[x0, x1] x [y0, y1]`` (clipped to the image)."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, w - 1), min(y1, h - 1)
    if x1 < x0 or y1 < y0:
        return
    yy, xx = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    img[y0:y1 + 1, x0:x1 + 1][inside(xx, yy)] = color


def _draw_shape(img, cls, cx, cy, s, rng):
    """Draw one shape; returns (x1, y1, x2, y2, polygon (P, 2))."""
    color = tuple(int(c + rng.randint(-20, 20)) for c in _COLORS[cls])
    r = s // 2
    if cls == 0:
        _fill(img, lambda x, y: (x - cx) ** 2 + (y - cy) ** 2 <= r * r,
              cx - r, cy - r, cx + r, cy + r, color)
        return cx - r, cy - r, cx + r, cy + r, _ngon(cx, cy, s / 2, s / 2)
    if cls == 1:
        _fill(img, lambda x, y: np.ones(x.shape, bool), cx - r, cy - r, cx + r, cy + r, color)
        poly = np.array([[cx - s / 2, cy - s / 2], [cx + s / 2, cy - s / 2],
                         [cx + s / 2, cy + s / 2], [cx - s / 2, cy + s / 2]], np.float64)
        return cx - r, cy - r, cx + r, cy + r, poly
    if cls == 2:
        pts = np.array([[cx, cy - r], [cx - r, cy + r], [cx + r, cy + r]], np.int32)

        def inside(x, y):
            # on the inner side of the edges left -> top and top -> right, above the base
            left = r * (y - cy - r) + 2 * r * (x - cx + r) >= 0
            right = r * (y - cy + r) - 2 * r * (x - cx) >= 0
            return left & right & (y <= cy + r)

        _fill(img, inside, cx - r, cy - r, cx + r, cy + r, color)
        return cx - r, cy - r, cx + r, cy + r, pts.astype(np.float64)
    b = s // 3
    _fill(img, lambda x, y: ((x - cx) / max(r, 1)) ** 2 + ((y - cy) / max(b, 1)) ** 2 <= 1.0,
          cx - r, cy - b, cx + r, cy + b, color)
    return cx - r, cy - b, cx + r, cy + b, _ngon(cx, cy, s / 2, s / 3)


def generate(out_dir: str, n_train: int = 200, n_val: int = 50, seed: int = 0,
             frame_sizes: Optional[Sequence[Tuple[int, int]]] = None,
             n_portrait: int = 0, object_scale: float = 1.0) -> None:
    """Write ``train/``, ``val/`` (PPM images) and ``train.json``,
    ``val.json`` (COCO format) under ``out_dir``."""
    frame_sizes = list(frame_sizes or [(IMG_W, IMG_H)])
    rng = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        img_dir = os.path.join(out_dir, split)
        os.makedirs(img_dir, exist_ok=True)
        images, annotations = [], []
        ann_id = 1
        for i in range(n):
            fw, fh = frame_sizes[i % len(frame_sizes)]
            if i >= n - n_portrait:
                fw, fh = min(fw, fh), max(fw, fh)
            k = object_scale * min(fw, fh) / IMG_H
            img = rng.randint(0, 40, (fh, fw, 3)).astype(np.uint8)
            placed = []
            for _ in range(rng.randint(1, 4)):
                cls = int(rng.randint(0, 4))
                s = int(rng.randint(26, 60))
                if k != 1:
                    s = int(round(s * k))
                cx = int(rng.randint(s // 2 + 2, fw - s // 2 - 2))
                cy = int(rng.randint(s // 2 + 2, fh - s // 2 - 2))
                # keep shapes apart so boxes are unambiguous
                if any(abs(cx - px) < (s + ps) // 2 + 4 and abs(cy - py) < (s + ps) // 2 + 4
                       for px, py, ps in placed):
                    continue
                placed.append((cx, cy, s))
                x1, y1, x2, y2, poly = _draw_shape(img, cls, cx, cy, s, rng)
                x1, y1 = max(x1, 0), max(y1, 0)
                x2, y2 = min(x2, fw), min(y2, fh)
                poly[:, 0] = poly[:, 0].clip(0, fw)
                poly[:, 1] = poly[:, 1].clip(0, fh)
                px, py = poly[:, 0], poly[:, 1]  # shoelace area (COCO segm area)
                seg_area = 0.5 * abs(float(np.dot(px, np.roll(py, -1))
                                           - np.dot(py, np.roll(px, -1))))
                annotations.append(dict(
                    id=ann_id, image_id=i + 1, category_id=cls + 1,
                    bbox=[x1, y1, x2 - x1, y2 - y1],
                    segmentation=[np.round(poly, 2).reshape(-1).tolist()],
                    area=seg_area, iscrowd=0))
                ann_id += 1
            fn = f"{split}_{i:04d}.ppm"
            write_ppm(os.path.join(img_dir, fn), img)
            images.append(dict(id=i + 1, file_name=fn, width=fw, height=fh))
        coco = dict(images=images, annotations=annotations,
                    categories=[dict(id=c + 1, name=name) for c, name in enumerate(CLASSES)])
        with open(os.path.join(out_dir, f"{split}.json"), "w") as f:
            json.dump(coco, f)
