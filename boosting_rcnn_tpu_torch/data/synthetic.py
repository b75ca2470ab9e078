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

``generate_lvis``, ``generate_cityscapes`` and ``generate_voc`` draw the
same shapes into LVIS (v1 or v0.5), Cityscapes and VOC layouts (see each).
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .image_io import write_png, write_ppm

__all__ = ["CLASSES", "IMG_H", "IMG_W", "generate", "generate_lvis", "generate_cityscapes",
           "generate_voc"]

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


def _draw_objects(rng: np.random.RandomState, img: np.ndarray, k: float):
    """Draw 1-3 shapes (some skipped where they would overlap) on ``img``;
    returns ``(shape class, x1, y1, x2, y2, polygon (P, 2), area)`` of each,
    clipped to the frame, the area the polygon's (COCO's segm area)."""
    fh, fw = img.shape[:2]
    placed, objects = [], []
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
        px, py = poly[:, 0], poly[:, 1]  # shoelace area
        area = 0.5 * abs(float(np.dot(px, np.roll(py, -1)) - np.dot(py, np.roll(px, -1))))
        objects.append((cls, x1, y1, x2, y2, poly, area))
    return objects


def _annotation(ann_id: int, image_id: int, category_id: int, obj) -> dict:
    _, x1, y1, x2, y2, poly, area = obj
    return dict(id=ann_id, image_id=image_id, category_id=category_id,
                bbox=[x1, y1, x2 - x1, y2 - y1],
                segmentation=[np.round(poly, 2).reshape(-1).tolist()], area=area, iscrowd=0)


def generate(out_dir: str, n_train: int = 200, n_val: int = 50, seed: int = 0,
             frame_sizes: Optional[Sequence[Tuple[int, int]]] = None,
             n_portrait: int = 0, object_scale: float = 1.0,
             classes: Sequence[str] = CLASSES) -> None:
    """Write ``train/``, ``val/`` (PPM images) and ``train.json``,
    ``val.json`` (COCO format) under ``out_dir``; the categories are named
    ``classes`` (a dataset type's, such as Brackish's), whose first four
    the four shapes are."""
    if len(classes) < len(CLASSES):
        raise ValueError(f"{len(classes)} class names for {len(CLASSES)} shapes")
    frame_sizes = list(frame_sizes or [(IMG_W, IMG_H)])
    rng = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        img_dir = os.path.join(out_dir, split)
        os.makedirs(img_dir, exist_ok=True)
        images, annotations = [], []
        for i in range(n):
            fw, fh = frame_sizes[i % len(frame_sizes)]
            if i >= n - n_portrait:
                fw, fh = min(fw, fh), max(fw, fh)
            img = rng.randint(0, 40, (fh, fw, 3)).astype(np.uint8)
            for obj in _draw_objects(rng, img, object_scale * min(fw, fh) / IMG_H):
                annotations.append(_annotation(len(annotations) + 1, i + 1, obj[0] + 1, obj))
            fn = f"{split}_{i:04d}.ppm"
            write_ppm(os.path.join(img_dir, fn), img)
            images.append(dict(id=i + 1, file_name=fn, width=fw, height=fh))
        coco = dict(images=images, annotations=annotations,
                    categories=[dict(id=c + 1, name=name) for c, name in enumerate(classes)])
        with open(os.path.join(out_dir, f"{split}.json"), "w") as f:
            json.dump(coco, f)


LVIS_V1_CLASSES = 1203
LVIS_V05_CLASSES = 1230


def generate_lvis(out_dir: str, n_train: int = 40, n_val: int = 8, seed: int = 0,
                  frame: Tuple[int, int] = (IMG_W, IMG_H), version: str = "v1",
                  zipf: float = 1.2) -> None:
    """An LVIS-format set of drawn shapes: ``annotations/lvis_{v1,v0.5}_
    {train,val}.json`` and the images (PPM bytes under the COCO file names).

    1203 categories (1230 for v0.5); each shape's category is drawn
    long-tailed, ``P(c) ~ 1 / (c + 1) ** zipf``, so that most categories
    are rare and, over more than ``1 / oversample_thr`` images, get repeat
    factors above 1.  v1 image records carry a ``coco_url``
    (``http://images.cocodataset.org/<split>2017/<id>.jpg``) and no file
    name, v0.5 ones a ``file_name``; every record lists
    ``neg_category_ids`` (categories verified absent) and
    ``not_exhaustive_category_ids``.  Annotations are polygons."""
    n_cat = LVIS_V1_CLASSES if version == "v1" else LVIS_V05_CLASSES
    p = 1.0 / np.arange(1, n_cat + 1) ** zipf
    p /= p.sum()
    rng = np.random.RandomState(seed)
    fw, fh = frame
    os.makedirs(os.path.join(out_dir, "annotations"), exist_ok=True)
    for split, n in (("train", n_train), ("val", n_val)):
        folder = f"{split}2017"
        os.makedirs(os.path.join(out_dir, folder), exist_ok=True)
        images, annotations = [], []
        for i in range(n):
            img = rng.randint(0, 40, (fh, fw, 3)).astype(np.uint8)
            present = []
            for obj in _draw_objects(rng, img, min(fw, fh) / IMG_H):
                cat = int(rng.choice(n_cat, p=p)) + 1
                present.append(cat)
                annotations.append(_annotation(len(annotations) + 1, i + 1, cat, obj))
            neg = sorted({int(c) + 1 for c in rng.choice(n_cat, 3)} - set(present))
            fn = f"{folder}/{i + 1:012d}.jpg"
            write_ppm(os.path.join(out_dir, fn), img)
            rec = dict(id=i + 1, width=fw, height=fh, neg_category_ids=neg,
                       not_exhaustive_category_ids=present[:1] if rng.rand() < 0.3 else [])
            if version == "v1":
                rec["coco_url"] = "http://images.cocodataset.org/" + fn
            else:
                rec["file_name"] = fn
            images.append(rec)
        cats = [dict(id=c + 1, name=f"lvis_{c + 1:04d}", frequency="rcf"[min(c // 400, 2)])
                for c in range(n_cat)]
        with open(os.path.join(out_dir, "annotations", f"lvis_{version}_{split}.json"), "w") as f:
            json.dump(dict(images=images, annotations=annotations, categories=cats), f)


CITYSCAPES_CITIES = {"train": ("aachen", "bremen"), "val": ("frankfurt",)}


def generate_cityscapes(out_dir: str, n_train: int = 4, n_val: int = 2, seed: int = 0,
                        frame: Tuple[int, int] = (2048, 1024)) -> None:
    """A Cityscapes-format set: PNG frames at ``leftImg8bit/<split>/<city>/
    <city>_000000_<n>_leftImg8bit.png`` (2048 x 1024 by default) and
    ``annotations/instancesonly_filtered_gtFine_<split>.json`` (COCO format,
    the 8 thing classes, polygons)."""
    from .coco import CITYSCAPES_CLASSES

    rng = np.random.RandomState(seed)
    fw, fh = frame
    os.makedirs(os.path.join(out_dir, "annotations"), exist_ok=True)
    for split, n in (("train", n_train), ("val", n_val)):
        images, annotations = [], []
        for i in range(n):
            city = CITYSCAPES_CITIES[split][i % len(CITYSCAPES_CITIES[split])]
            img = rng.randint(0, 40, (fh, fw, 3)).astype(np.uint8)
            for obj in _draw_objects(rng, img, min(fw, fh) / IMG_H / 4):
                cat = int(rng.randint(0, len(CITYSCAPES_CLASSES))) + 1
                annotations.append(_annotation(len(annotations) + 1, i + 1, cat, obj))
            fn = f"{city}/{city}_000000_{i:06d}_leftImg8bit.png"
            os.makedirs(os.path.join(out_dir, "leftImg8bit", split, city), exist_ok=True)
            write_png(os.path.join(out_dir, "leftImg8bit", split, fn), img)
            images.append(dict(id=i + 1, file_name=fn, width=fw, height=fh))
        cats = [dict(id=c + 1, name=name) for c, name in enumerate(CITYSCAPES_CLASSES)]
        path = os.path.join(out_dir, "annotations",
                            f"instancesonly_filtered_gtFine_{split}.json")
        with open(path, "w") as f:
            json.dump(dict(images=images, annotations=annotations, categories=cats), f)


VOC_SHAPE_CLASSES = ("bird", "boat", "car", "cat")  # the four shapes' VOC names


def generate_voc(out_dir: str, n_train: int = 6, n_test: int = 4, seed: int = 0,
                 frame: Tuple[int, int] = (IMG_W, IMG_H), years=("2007", "2012")) -> None:
    """A pair of VOC-format sets under ``out_dir/VOC<year>``: XML
    annotations, ``ImageSets/Main/{trainval,test}.txt`` and the images at
    ``JPEGImages/<id>.jpg`` (PPM bytes under the VOC file names; both
    packages' decoders go by the bytes).  The shapes take VOC class names;
    every third shape is marked ``difficult``."""
    rng = np.random.RandomState(seed)
    fw, fh = frame
    for year in years:
        root = os.path.join(out_dir, f"VOC{year}")
        for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        for split, n in (("trainval", n_train), ("test", n_test)):
            ids = []
            for i in range(n):
                img_id = f"{year}_{split}_{i:06d}"
                img = rng.randint(0, 40, (fh, fw, 3)).astype(np.uint8)
                objs = []
                for j, obj in enumerate(_draw_objects(rng, img, min(fw, fh) / IMG_H)):
                    cls, x1, y1, x2, y2 = obj[:5]
                    objs.append(f"<object><name>{VOC_SHAPE_CLASSES[cls]}</name>"
                                f"<difficult>{int(j % 3 == 2)}</difficult><bndbox>"
                                f"<xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax>"
                                f"<ymax>{y2}</ymax></bndbox></object>")
                with open(os.path.join(root, "Annotations", f"{img_id}.xml"), "w") as f:
                    f.write(f"<annotation><filename>{img_id}.jpg</filename><size><width>{fw}"
                            f"</width><height>{fh}</height><depth>3</depth></size>"
                            + "".join(objs) + "</annotation>")
                write_ppm(os.path.join(root, "JPEGImages", f"{img_id}.jpg"), img)
                ids.append(img_id)
            with open(os.path.join(root, "ImageSets", "Main", f"{split}.txt"), "w") as f:
                f.write("\n".join(ids) + "\n")
