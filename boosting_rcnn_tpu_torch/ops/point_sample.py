"""Point sampling (PyTorch port of ``boosting_rcnn_tpu/ops/point_sample.py``,
mmcv's ``point_sample`` and ``rel_roi_point_to_rel_img_point``).

``point_sample`` is bilinear sampling at normalised points with half-pixel
centres (``F.grid_sample(align_corners=False)``: a coordinate ``p`` in
[0, 1] is pixel ``p * size - 0.5``), the four corners' indices clamped to
the map (so a point past the border takes the border's value).  It copies
the JAX function's arithmetic (the weights of the four corners, summed in
that order) rather than calling ``F.grid_sample``, so that the borders and
the roundings agree by construction.  The weights are float32, so a
bfloat16 map gives float32 samples, as ``jnp``'s promotion does.

The corners are taken by advanced indexing, whose gradient is
``index_put_`` with ``accumulate=True``: on the GPU a sort-based sum in a
fixed order, so the backward is bitwise repeatable (as in
``ops/deform_conv.py``).
"""
from __future__ import annotations

import torch

__all__ = ["point_sample", "rel_roi_point_to_rel_img_point"]


def point_sample(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Sample ``feat`` ``(N, H, W, C)`` at ``points`` ``(N, P, 2)``
    normalised ``(x, y)`` in [0, 1] -> ``(N, P, C)`` (the JAX function
    under ``vmap`` over ``N``)."""
    n, h, w, _ = feat.shape
    x = points[..., 0] * w - 0.5
    y = points[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    rows = torch.arange(n, device=feat.device)[:, None]

    def g(yy, xx):
        yi = torch.clamp(yy.to(torch.int32), 0, h - 1).long()
        xi = torch.clamp(xx.to(torch.int32), 0, w - 1).long()
        return feat[rows, yi, xi]

    return (g(y0, x0) * ((1 - wy1) * (1 - wx1))[..., None]
            + g(y0, x0 + 1) * ((1 - wy1) * wx1)[..., None]
            + g(y0 + 1, x0) * (wy1 * (1 - wx1))[..., None]
            + g(y0 + 1, x0 + 1) * (wy1 * wx1)[..., None])


def rel_roi_point_to_rel_img_point(rois: torch.Tensor, rel_points: torch.Tensor,
                                   img_hw) -> torch.Tensor:
    """RoI-relative normalised points ``(..., P, 2)`` of the RoIs ``(...,
    4)`` (xyxy in image coordinates) -> image-relative normalised points,
    over an image of ``img_hw`` ``(H, W)``."""
    x1, y1 = rois[..., 0:1], rois[..., 1:2]
    ax = x1 + rel_points[..., 0] * (rois[..., 2:3] - x1)
    ay = y1 + rel_points[..., 1] * (rois[..., 3:4] - y1)
    # tensor divisors: CUDA's division by a Python number multiplies by its
    # reciprocal
    hh = torch.full((), float(img_hw[0]), dtype=ax.dtype, device=ax.device)
    ww = torch.full((), float(img_hw[1]), dtype=ax.dtype, device=ax.device)
    return torch.stack([ax / ww, ay / hh], dim=-1)
