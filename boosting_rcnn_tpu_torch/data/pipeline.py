"""Preprocessing to fixed-shape padded batches (PyTorch port of
``boosting_rcnn_tpu/data/pipeline.py``): keep-ratio resize, horizontal
flip, BGR -> RGB, mean/std normalisation and zero padding into the canvas,
with the boxes scaled, flipped and clipped to match.

The image work is the formula of the JAX package's fused native pass
(``native/preprocess.cc::preprocess_image``), run with torch on the
loader's device: the uint8 image is uploaded, then each output pixel
samples the source at ``f = (o + 0.5) * (src / new) - 0.5`` (float32,
rounded once), clamped to ``[0, src - 1]``, blends its four neighbours
with the weights ``(1 - l)`` and ``l`` of each axis, and is normalised as
``(v - mean) * (1 / std)``; a flipped image samples column
``new_w - 1 - o``.  The boxes and the per-image arrays (``img_shape``
``(H, W)`` resized, ``scale_factor`` ``(w_s, h_s, w_s, h_s)``,
``ori_shape``) are numpy, as there.

With ``segmentations`` each kept instance gets a ``(S, S)`` uint8 crop of
its box (``gt_mask_crops``, ``S`` = ``mask_crop_size``, default
``MASK_CROP_SIZE`` = 112), rasterised in original-image coordinates
against the original box and mirrored when the image is flipped (a crop
is box-relative, so a resize needs no new rasterisation); with a
``semantic_map`` (a stuff map of class ids, 255 ignored) the batch gets
``gt_semantic_seg``: the map resized by nearest neighbour as the image
is, flipped, padded with 255 to the canvas and rescaled by nearest
neighbour to ``ceil(canvas / semantic_stride)``.  Both stay numpy.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .mask_utils import MASK_CROP_SIZE, polygons_to_box_crop, resize_nearest, rle_to_box_crop

__all__ = ["DEFAULT_MEAN", "DEFAULT_STD", "rescale_size", "resize_normalize", "preprocess",
           "collate"]

DEFAULT_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
DEFAULT_STD = np.array([58.395, 57.12, 57.375], np.float32)


def rescale_size(w: int, h: int, scale: Tuple[int, int]) -> Tuple[int, int, float]:
    """Keep-ratio target size for a max-side / min-side ``scale``: factor
    ``min(long / max(w, h), short / min(w, h))``."""
    long_side, short_side = max(scale), min(scale)
    f = min(long_side / max(w, h), short_side / min(w, h))
    return int(w * f + 0.5), int(h * f + 0.5), f


def _taps(n_out: int, n_src: int, flip: bool, device):
    """Source index pair and weight of the second one along one axis.  The
    coordinate ``(o + 0.5) * scale - 0.5`` is rounded to float32 once, as
    the native pass's fused multiply-add rounds it (``o + 0.5`` and the
    product are exact in float64); rounding twice moves the large
    coordinates of a full-size frame by an ulp, and their pixels by up to
    5e-4 after normalisation."""
    scale = float(np.float32(n_src) / np.float32(n_out))
    o = torch.arange(n_out, device=device)
    if flip:
        o = n_out - 1 - o
    f = ((o.to(torch.float64) + 0.5) * scale - 0.5).to(torch.float32)
    f = f.clamp(0.0, float(n_src - 1))
    i0 = f.to(torch.int64)
    return i0, (i0 + 1).clamp(max=n_src - 1), f - i0.to(torch.float32)


def resize_normalize(img: np.ndarray, canvas: Tuple[int, int], new_h: int, new_w: int,
                     mean: np.ndarray, std: np.ndarray, to_rgb: bool = True,
                     flip: bool = False, device="cpu") -> torch.Tensor:
    """``(canvas_h, canvas_w, 3)`` float32 on ``device``: the BGR uint8
    ``img`` resized bilinearly to ``(new_h, new_w)`` at the top left,
    flipped, RGB when ``to_rgb``, normalised; zeros elsewhere."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise TypeError(f"expected an (H, W, 3) uint8 image, got {img.dtype} {img.shape}")
    src = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    x0, x1, lx = _taps(new_w, img.shape[1], flip, device)
    y0, y1, ly = _taps(new_h, img.shape[0], False, device)
    lx, ly = lx[None, :, None], ly[:, None, None]
    row0, row1 = src[y0], src[y1]
    v = ((1 - ly) * (1 - lx) * row0[:, x0] + (1 - ly) * lx * row0[:, x1]
         + ly * (1 - lx) * row1[:, x0] + ly * lx * row1[:, x1])
    mean = torch.from_numpy(np.asarray(mean, np.float32)).to(device)
    inv_std = torch.from_numpy(np.float32(1.0) / np.asarray(std, np.float32)).to(device)
    if to_rgb:
        v = v.flip(-1)
    out = torch.zeros((*canvas, 3), dtype=torch.float32, device=device)
    out[:new_h, :new_w] = (v - mean) * inv_std
    return out


def preprocess(
    img: np.ndarray,  # (H, W, 3) BGR uint8
    bboxes: np.ndarray,  # (N, 4) xyxy
    labels: np.ndarray,  # (N,)
    canvas: Tuple[int, int],  # (H, W) padded canvas
    scale: Tuple[int, int] = (1333, 800),
    flip: bool = False,
    max_gt: int = 100,
    mean: np.ndarray = DEFAULT_MEAN,
    std: np.ndarray = DEFAULT_STD,
    to_rgb: bool = True,
    short_side_override: Optional[int] = None,
    segmentations: Optional[list] = None,
    mask_crop_size: Optional[int] = None,
    semantic_map: Optional[np.ndarray] = None,
    semantic_stride: int = 8,
    device="cpu",
) -> Dict[str, object]:
    """One sample: ``images`` a tensor on ``device``, the rest numpy."""
    h0, w0 = img.shape[:2]
    sc = (max(scale), short_side_override) if short_side_override else scale
    nw, nh, f = rescale_size(w0, h0, sc)
    if nh > canvas[0] or nw > canvas[1]:
        # cap the factor so that the resized image fits the canvas with its
        # aspect ratio (a portrait image on a landscape canvas)
        f = min(f * canvas[0] / max(nh, 1), f * canvas[1] / max(nw, 1), f)
        nw, nh = int(w0 * f + 0.5), int(h0 * f + 0.5)
        nw, nh = min(nw, canvas[1]), min(nh, canvas[0])
    out = resize_normalize(img, canvas, nh, nw, mean, std, to_rgb, flip, device)

    w_scale = nw / w0
    h_scale = nh / h0
    b = bboxes.copy().astype(np.float32)
    if len(b):
        b[:, [0, 2]] *= w_scale
        b[:, [1, 3]] *= h_scale
        if flip:
            b2 = b.copy()
            b2[:, 0] = nw - b[:, 2]
            b2[:, 2] = nw - b[:, 0]
            b = b2
        b[:, [0, 2]] = b[:, [0, 2]].clip(0, nw)
        b[:, [1, 3]] = b[:, [1, 3]].clip(0, nh)

    n = min(len(b), max_gt)
    gt_bboxes = np.zeros((max_gt, 4), np.float32)
    gt_labels = np.zeros((max_gt,), np.int32)
    gt_mask = np.zeros((max_gt,), bool)
    gt_bboxes[:n] = b[:n]
    gt_labels[:n] = labels[:n]
    gt_mask[:n] = True

    extra = {}
    if semantic_map is not None:
        sem = semantic_map
        if sem.dtype != np.uint8:
            sem = np.clip(sem, 0, 255).astype(np.uint8)
        sem_r = resize_nearest(sem, nw, nh)
        if flip:
            sem_r = sem_r[:, ::-1]
        sem_canvas = np.full(canvas, 255, np.uint8)
        sem_canvas[:nh, :nw] = sem_r
        st = semantic_stride
        sh, sw = (canvas[0] + st - 1) // st, (canvas[1] + st - 1) // st
        extra["gt_semantic_seg"] = resize_nearest(sem_canvas, sw, sh).astype(np.int32)
    if segmentations is not None:
        s = mask_crop_size or MASK_CROP_SIZE
        crops = np.zeros((max_gt, s, s), np.uint8)
        for i in range(n):
            seg = segmentations[i]
            if seg is None:
                continue
            if isinstance(seg, dict):
                crops[i] = rle_to_box_crop(seg, bboxes[i], h0, w0, s)
            elif isinstance(seg, np.ndarray) and seg.ndim == 2:
                # a full-image bitmap: its box region, resized as an RLE crop is
                x1, y1, x2, y2 = [int(round(v)) for v in bboxes[i]]
                x2, y2 = max(x2, x1 + 1), max(y2, y1 + 1)
                region = seg[max(y1, 0):y2, max(x1, 0):x2]
                if region.size:
                    crops[i] = resize_nearest(region.astype(np.uint8), s, s)
            else:
                crops[i] = polygons_to_box_crop(seg, bboxes[i], s)
            if flip:
                crops[i] = crops[i][:, ::-1]
        extra["gt_mask_crops"] = crops

    return dict(
        **extra,
        images=out,
        gt_bboxes=gt_bboxes,
        gt_labels=gt_labels,
        gt_mask=gt_mask,
        img_shape=np.array([nh, nw], np.float32),
        scale_factor=np.array([w_scale, h_scale, w_scale, h_scale], np.float32),
        ori_shape=np.array([h0, w0], np.int32),
    )


def collate(samples: Sequence[Dict[str, object]]) -> Dict[str, object]:
    """Stack the samples' fields: tensors with ``torch.stack``, arrays with
    ``np.stack``."""
    return {k: (torch.stack([s[k] for s in samples]) if torch.is_tensor(samples[0][k])
                else np.stack([s[k] for s in samples])) for k in samples[0]}
