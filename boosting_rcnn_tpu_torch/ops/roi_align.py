"""Multi-level RoIAlign over an FPN pyramid: geometry and plain version.

Counterpart of ``boosting_rcnn_tpu/ops/roi_align.py`` (``map_roi_levels``,
``_interp_matrix``, ``multilevel_roi_align_fast``) and of the host-side
preparation of the batched Pallas kernel in
``boosting_rcnn_tpu/ops/pallas_roi_align.py`` (``_batched_geometry``, the
pool fold of ``_fold_and_align``, ``_batched_stack``).

Bilinear RoIAlign is separable: per RoI, the pooled 7x7 output is
``wy @ window @ wx^T`` over a fixed 24-row window of the stacked pyramid,
with per-RoI interpolation matrices ``wy`` and ``wx``.  The documented
deviations of the JAX package are kept: 2 samples per bin axis
(``sampling_ratio=0`` is adaptive in the reference), and samples clamp to
the 24-cell window (RoIs that span more than 23 cells of their level).

``multilevel_roi_align_fast`` is the plain PyTorch version of the CUDA
kernel in ``roi_align_kernel.py``; it gathers the windows and runs the two
contractions with ``einsum``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

__all__ = [
    "RoIGeometry",
    "map_roi_levels",
    "batched_stack",
    "batched_geometry",
    "fold_pool",
    "multilevel_roi_align_fast",
]

WIN = 24


def map_roi_levels(rois: torch.Tensor, num_levels: int, finest_scale: int = 56):
    """FPN level per RoI: ``floor(log2(sqrt(wh) / finest_scale + 1e-6))``
    clamped to the pyramid."""
    scale = torch.sqrt(
        torch.clamp(rois[..., 2] - rois[..., 0], min=0.0)
        * torch.clamp(rois[..., 3] - rois[..., 1], min=0.0)
    )
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return torch.clamp(lvl, 0, num_levels - 1).to(torch.int64)


def _interp_matrix(start, bin_sz, win_origin, hi, out_size, s, win):
    """Per-RoI 1-D interpolation matrix ``(R, out*s, win)``: hat weights of
    each sample position against the window's grid, positions clamped to
    ``[0, hi]`` (the level border, or the window end)."""
    dev = start.device
    j = torch.arange(out_size * s, device=dev)
    frac = (j // s).to(torch.float32) + ((j % s).to(torch.float32) + 0.5) / s
    pos = start[:, None] + frac[None, :] * bin_sz[:, None]
    rel = pos - win_origin[:, None]
    rel = torch.minimum(torch.clamp(rel, min=0.0), hi[:, None])
    k = torch.arange(win, dtype=torch.float32, device=dev)
    return torch.clamp(1.0 - torch.abs(rel[..., None] - k), min=0.0)


class RoIGeometry(NamedTuple):
    """Window origins and interpolation matrices of flat ``(B*R,)`` RoIs.

    ``row0``: first window row in the stacked pyramid, image base included;
    ``x0``: first window column; ``wy`` ``(n, out*s, WIN)`` and ``wx``
    ``(n, out*s, win_w)`` before the 2x2 pool fold."""

    row0: torch.Tensor
    x0: torch.Tensor
    wy: torch.Tensor
    wx: torch.Tensor


def batched_stack(feats: Sequence[torch.Tensor], num_levels: int, win: int = WIN):
    """Stack the first ``num_levels`` ``(B, H, W, C)`` levels along rows,
    zero-pad W to the widest level and append ``win`` zero rows per image,
    so that every window lies inside the buffer.  Returns
    ``(stacked (B*rows_img, max_w, C), rows_img)``."""
    b, c = feats[0].shape[0], feats[0].shape[-1]
    max_w = max(f.shape[2] for f in feats[:num_levels])
    rows = [
        torch.nn.functional.pad(f, (0, 0, 0, max_w - f.shape[2]))
        for f in feats[:num_levels]
    ]
    rows.append(feats[0].new_zeros((b, win, max_w, c)))
    stacked = torch.cat(rows, dim=1)
    rows_img = stacked.shape[1]
    return stacked.reshape(b * rows_img, max_w, c), rows_img


def batched_geometry(
    level_hw: Sequence[Tuple[int, int]],
    rois_flat: torch.Tensor,
    batch: int,
    strides: Sequence[int],
    finest_scale: int = 56,
    out_size: int = 7,
    s: int = 2,
    win: int = WIN,
) -> RoIGeometry:
    """Geometry of ``(B*R, 4)`` RoIs over a per-image stacked pyramid of
    levels ``level_hw`` (port of ``_batched_geometry``)."""
    nl = len(level_hw)
    dev = rois_flat.device
    max_w = max(w for _, w in level_hw)
    win_w = min(win, max_w)
    r = rois_flat.shape[0] // batch
    offs, acc = [], 0
    for h, _ in level_hw:
        offs.append(acc)
        acc += h
    rows_img = acc + win
    row_off = torch.tensor(offs, dtype=torch.int64, device=dev)
    hs = torch.tensor([h for h, _ in level_hw], dtype=torch.int64, device=dev)
    ws = torch.tensor([w for _, w in level_hw], dtype=torch.int64, device=dev)
    inv_strides = torch.tensor(
        [1.0 / strides[i] for i in range(nl)], dtype=torch.float32, device=dev)

    lvl = map_roi_levels(rois_flat, nl, finest_scale)
    scale = inv_strides[lvl]
    x1 = rois_flat[:, 0] * scale - 0.5
    y1 = rois_flat[:, 1] * scale - 0.5
    bin_w = (rois_flat[:, 2] * scale - 0.5 - x1) / out_size
    bin_h = (rois_flat[:, 3] * scale - 0.5 - y1) / out_size
    h_l, w_l = hs[lvl], ws[lvl]
    wy0 = torch.minimum(
        torch.clamp(torch.floor(y1).to(torch.int64), min=0),
        torch.clamp(h_l - win, min=0))
    wx0 = torch.minimum(
        torch.clamp(torch.floor(x1).to(torch.int64), min=0),
        torch.clamp(w_l - win_w, min=0))
    img_base = torch.arange(batch, device=dev).repeat_interleave(r) * rows_img
    row0 = img_base + row_off[lvl] + wy0
    hi_y = torch.clamp((h_l - 1 - wy0).to(torch.float32), max=float(win - 1))
    hi_x = torch.clamp((w_l - 1 - wx0).to(torch.float32), max=float(win_w - 1))
    wy = _interp_matrix(y1, bin_h, wy0.to(torch.float32), hi_y, out_size, s, win)
    wx = _interp_matrix(x1, bin_w, wx0.to(torch.float32), hi_x, out_size, s, win_w)
    return RoIGeometry(row0.to(torch.int32), wx0.to(torch.int32), wy, wx)


def fold_pool(w: torch.Tensor, out_size: int, s: int) -> torch.Tensor:
    """Fold the mean over ``s`` samples per bin into an interpolation
    matrix: ``(n, out*s, win) -> (n, out, win)``."""
    return w.reshape(w.shape[0], out_size, s, w.shape[-1]).mean(dim=2)


def multilevel_roi_align_fast(
    feats: Sequence[torch.Tensor],
    rois: torch.Tensor,
    roi_valid: torch.Tensor,
    strides: Sequence[int],
    out_size: int = 7,
    sample_num: int = 2,
    finest_scale: int = 56,
    num_route_levels: int | None = None,
) -> torch.Tensor:
    """Plain batched RoIAlign: ``feats`` L x ``(B, H, W, C)``, ``rois``
    ``(B, R, 4)``, ``roi_valid`` ``(B, R)`` -> ``(B, R, out, out, C)``,
    invalid RoIs zero.  Same function as the JAX package's vmapped
    ``multilevel_roi_align_fast``: sample with ``wy``/``wx``, then average
    the ``s x s`` samples of each bin."""
    b, r = rois.shape[:2]
    nl = num_route_levels or len(feats)
    c = feats[0].shape[-1]
    s = sample_num
    stacked, _ = batched_stack(feats, nl)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats[:nl]]
    g = batched_geometry(level_hw, rois.reshape(b * r, 4), b, strides,
                         finest_scale, out_size, s)
    win_w = g.wx.shape[-1]
    dev = stacked.device
    rows = g.row0.to(torch.int64)[:, None] + torch.arange(WIN, device=dev)
    cols = g.x0.to(torch.int64)[:, None] + torch.arange(win_w, device=dev)
    windows = stacked[rows[:, :, None], cols[:, None, :]]  # (n, WIN, win_w, C)
    t = torch.einsum("rik,rkmc->rimc", g.wy, windows)
    sampled = torch.einsum("rimc,rjm->rijc", t, g.wx)
    pooled = sampled.reshape(b * r, out_size, s, out_size, s, c).mean(dim=(2, 4))
    pooled = pooled * roi_valid.reshape(b * r)[:, None, None, None].to(pooled.dtype)
    return pooled.reshape(b, r, out_size, out_size, c)
