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
forward kernel in ``roi_align_kernel.py``; it gathers the windows and runs
the two contractions with ``einsum``, and autograd through it is the plain
gradient.  It follows the Pallas kernels' arithmetic (``_kernel_flat``,
``_bwd_kernel``): the pool fold of ``_fold_and_align`` (``:740``) in the
weights, in a bfloat16 pyramid each sample weight rounded to bfloat16
(``pallas_roi_align.py:797``) and each folded weight again
(``fold_pool_rounded``), the contractions rows first in float32 on the
widened window, one rounding of the output; its autograd widens the
cotangent, sums in float32 with the same weights and rounds each level's
gradient once (``:894``, ``:919``).  ``sample_taps`` is the plain
mirror of the kernels' per-RoI geometry (``csrc/roi_geometry.cuh``),
``bin_taps`` of the bfloat16 7 x 7 forward's per-bin tap lists (the pool
fold written out per cell, ``csrc/roi_align_fwd.cu``), ``tile_keys`` and
``tile_bitmap`` of the gradient kernel's tile lists
(``csrc/roi_align_bwd.cu``), and ``tile_lists`` spells out the per-tile
lists, in the kernel's order; ``tile_counts`` and ``tile_spread`` read
the lists' lengths off a bitmap, per level.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

__all__ = [
    "RoIGeometry",
    "RoIWindow",
    "SampleTaps",
    "map_roi_levels",
    "roi_window",
    "sample_taps",
    "taps_to_dense",
    "bin_taps",
    "batched_stack",
    "batched_geometry",
    "fold_pool",
    "fold_pool_rounded",
    "multilevel_roi_align_fast",
    "tile_grid",
    "tile_keys",
    "tile_lists",
    "tile_bitmap",
    "tile_counts",
    "tile_spread",
]

WIN = 24
TILE = 8  # the gradient kernel's tiles: TILE x TILE cells of one level
TILES_PER_AXIS = 4  # a span of WIN cells meets at most 4 tiles
NO_TILE = 2**31 - 1  # key of an unused slot; sorts last


def _true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded once, on every device: PyTorch's CUDA division by
    a Python number multiplies by its rounded reciprocal instead, which
    moves a RoI's bins by an ulp against the CPU, the JAX package and the
    kernels' geometry."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def map_roi_levels(rois: torch.Tensor, num_levels: int, finest_scale: int = 56):
    """FPN level per RoI: ``floor(log2(sqrt(wh) / finest_scale + 1e-6))``
    clamped to the pyramid."""
    scale = torch.sqrt(
        torch.clamp(rois[..., 2] - rois[..., 0], min=0.0)
        * torch.clamp(rois[..., 3] - rois[..., 1], min=0.0)
    )
    lvl = torch.floor(torch.log2(_true_div(scale, finest_scale) + 1e-6))
    return torch.clamp(lvl, 0, num_levels - 1).to(torch.int64)


def _sample_rel(start, bin_sz, win_origin, hi, out_size, s):
    """Per-RoI sample positions ``(R, out*s)`` in window coordinates,
    clamped to ``[0, hi]`` (the level border, or the window end)."""
    j = torch.arange(out_size * s, device=start.device)
    frac = (j // s).to(torch.float32) + ((j % s).to(torch.float32) + 0.5) / s
    pos = start[:, None] + frac[None, :] * bin_sz[:, None]
    rel = pos - win_origin[:, None]
    return torch.minimum(torch.clamp(rel, min=0.0), hi[:, None])


def _interp_matrix(start, bin_sz, win_origin, hi, out_size, s, win):
    """Per-RoI 1-D interpolation matrix ``(R, out*s, win)``: hat weights of
    each sample position against the window's grid."""
    rel = _sample_rel(start, bin_sz, win_origin, hi, out_size, s)
    k = torch.arange(win, dtype=torch.float32, device=start.device)
    return torch.clamp(1.0 - torch.abs(rel[..., None] - k), min=0.0)


class RoIWindow(NamedTuple):
    """The window of flat ``(n,)`` RoIs: ``level``, origin ``wy0``/``wx0``
    (int64, level cells), the RoI start ``y1``/``x1`` and bin size
    ``bin_h``/``bin_w`` in level cells, and the last usable window row and
    column ``hi_y``/``hi_x`` (float32)."""

    level: torch.Tensor
    wy0: torch.Tensor
    wx0: torch.Tensor
    y1: torch.Tensor
    x1: torch.Tensor
    bin_h: torch.Tensor
    bin_w: torch.Tensor
    hi_y: torch.Tensor
    hi_x: torch.Tensor


def roi_window(
    rois_flat: torch.Tensor,
    level_hw: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    finest_scale: int = 56,
    out_size: int = 7,
    win: int = WIN,
) -> RoIWindow:
    """Level and window of ``(n, 4)`` RoIs over levels ``level_hw`` (the
    per-RoI part of ``_batched_geometry``): the window starts at the RoI's
    first cell, pulled back to stay inside the level where it fits."""
    nl = len(level_hw)
    dev = rois_flat.device
    win_w = min(win, max(w for _, w in level_hw))
    hs = torch.tensor([h for h, _ in level_hw], dtype=torch.int64, device=dev)
    ws = torch.tensor([w for _, w in level_hw], dtype=torch.int64, device=dev)
    inv_strides = torch.tensor(
        [1.0 / strides[i] for i in range(nl)], dtype=torch.float32, device=dev)
    lvl = map_roi_levels(rois_flat, nl, finest_scale)
    scale = inv_strides[lvl]
    x1 = rois_flat[:, 0] * scale - 0.5
    y1 = rois_flat[:, 1] * scale - 0.5
    bin_w = _true_div(rois_flat[:, 2] * scale - 0.5 - x1, out_size)
    bin_h = _true_div(rois_flat[:, 3] * scale - 0.5 - y1, out_size)
    h_l, w_l = hs[lvl], ws[lvl]
    wy0 = torch.minimum(
        torch.clamp(torch.floor(y1).to(torch.int64), min=0),
        torch.clamp(h_l - win, min=0))
    wx0 = torch.minimum(
        torch.clamp(torch.floor(x1).to(torch.int64), min=0),
        torch.clamp(w_l - win_w, min=0))
    hi_y = torch.clamp((h_l - 1 - wy0).to(torch.float32), max=float(win - 1))
    hi_x = torch.clamp((w_l - 1 - wx0).to(torch.float32), max=float(win_w - 1))
    return RoIWindow(lvl, wy0, wx0, y1, x1, bin_h, bin_w, hi_y, hi_x)


class SampleTaps(NamedTuple):
    """Per RoI and sample: the level and window origin ``(n,)`` of
    ``roi_window``, and along each axis the first tap ``ky``/``kx`` ``(n,
    out*s)`` (int64, window coordinates) and the weights ``wy``/``wx``
    ``(n, out*s, 2)`` of taps ``k`` and ``k + 1``."""

    level: torch.Tensor
    wy0: torch.Tensor
    wx0: torch.Tensor
    ky: torch.Tensor
    wy: torch.Tensor
    kx: torch.Tensor
    wx: torch.Tensor


def _taps(rel):
    k = torch.floor(rel)
    w = torch.stack([torch.clamp(1.0 - torch.abs(rel - k), min=0.0),
                     torch.clamp(1.0 - torch.abs(rel - (k + 1.0)), min=0.0)], -1)
    return k.to(torch.int64), w


def sample_taps(
    rois_flat: torch.Tensor,
    level_hw: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    finest_scale: int = 56,
    out_size: int = 7,
    s: int = 2,
    win: int = WIN,
) -> SampleTaps:
    """The two nonzero bilinear taps of every sample of ``(n, 4)`` RoIs:
    the plain mirror of ``csrc/roi_geometry.cuh`` (``roi_window`` and
    ``sample_tap``), the same float32 operations in the same order.  The
    dense rows of ``_interp_matrix`` are these taps scattered into the
    window (``taps_to_dense``)."""
    g = roi_window(rois_flat, level_hw, strides, finest_scale, out_size, win)
    ky, wy = _taps(_sample_rel(g.y1, g.bin_h, g.wy0.to(torch.float32), g.hi_y, out_size, s))
    kx, wx = _taps(_sample_rel(g.x1, g.bin_w, g.wx0.to(torch.float32), g.hi_x, out_size, s))
    return SampleTaps(g.level, g.wy0, g.wx0, ky, wy, kx, wx)


def taps_to_dense(k: torch.Tensor, w: torch.Tensor, width: int) -> torch.Tensor:
    """Scatter the taps ``k`` ``(n, m)``, weights ``w`` ``(n, m, 2)`` into
    an ``(n, m, width)`` interpolation matrix."""
    dense = torch.zeros((*k.shape, width + 1), dtype=w.dtype, device=w.device)
    dense.scatter_(-1, torch.stack([k, k + 1], -1), w)
    return dense[..., :width]


def bin_taps(
    rois_flat: torch.Tensor,
    level_hw: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    finest_scale: int = 56,
    out_size: int = 7,
    dtype: torch.dtype = torch.bfloat16,
):
    """Plain mirror of the bfloat16 7 x 7 forward's tap lists
    (``bin_taps``/``fold_taps`` in ``csrc/roi_align_fwd.cu``): per RoI, bin
    and axis, the window cells that the bin's two samples weight, ascending,
    and their pool-folded weights, the fold written out per cell rather than
    over the dense window: each cell's weights from the sample of the lower
    cell first, each rounded to ``dtype``, halved and added to zero, the sum
    rounded to ``dtype`` again (``fold_pool_rounded`` gives the same values
    densely).  Returns ``(cells_y, w_y, cells_x, w_x)``: cells ``(n, out,
    4)`` int64, -1 past a bin's list, and weights ``(n, out, 4)`` float32, 0
    past it; zero weights are left out."""
    t = sample_taps(rois_flat, level_hw, strides, finest_scale, out_size, 2)

    def rounded(w):
        return w.to(dtype).to(torch.float32)

    def axis(k, w):
        k = k.reshape(k.shape[0], out_size, 2)
        w = w.reshape(w.shape[0], out_size, 2, 2)
        swap = k[..., 1] < k[..., 0]
        ka = torch.where(swap, k[..., 1], k[..., 0])
        kb = torch.where(swap, k[..., 0], k[..., 1])
        wa = torch.where(swap[..., None], w[:, :, 1], w[:, :, 0])
        wb = torch.where(swap[..., None], w[:, :, 0], w[:, :, 1])
        a0, a1 = rounded(wa[..., 0]) * 0.5, rounded(wa[..., 1]) * 0.5
        b0, b1 = rounded(wb[..., 0]) * 0.5, rounded(wb[..., 1]) * 0.5
        has_a1, has_b1 = wa[..., 1] > 0, wb[..., 1] > 0
        zero = torch.zeros_like(a0)
        same, next_ = kb == ka, kb == ka + 1
        # cells ka, ka + 1, then b's when they are not ka's
        s0 = torch.where(same, a0 + b0, a0)
        s1 = torch.where(has_a1, a1, zero)
        s1 = torch.where(same & has_b1, s1 + b1, s1)
        s1 = torch.where(next_, s1 + b0, s1)
        used1 = has_a1 | (same & has_b1) | next_
        c2 = torch.where(next_, kb + 1, kb)
        s2 = torch.where(next_, torch.where(has_b1, b1, zero), b0)
        used2 = ~same & (has_b1 | ~next_)
        s3 = torch.where(has_b1, b1, zero)
        used3 = ~same & ~next_ & has_b1
        cells = torch.stack([ka, ka + 1, c2, kb + 1], -1)
        ws = rounded(torch.stack([s0, s1, s2, s3], -1))
        keep = torch.stack([torch.ones_like(used1), used1, used2, used3], -1) & (ws != 0)
        order = torch.sort((~keep).to(torch.int8), dim=-1, stable=True).indices
        cells = torch.where(keep, cells, -1).gather(-1, order)
        ws = torch.where(keep, ws, 0.0).gather(-1, order)
        return cells, ws

    return (*axis(t.ky, t.wy), *axis(t.kx, t.wx))


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
    dev = rois_flat.device
    win_w = min(win, max(w for _, w in level_hw))
    r = rois_flat.shape[0] // batch
    offs, acc = [], 0
    for h, _ in level_hw:
        offs.append(acc)
        acc += h
    rows_img = acc + win
    row_off = torch.tensor(offs, dtype=torch.int64, device=dev)
    g = roi_window(rois_flat, level_hw, strides, finest_scale, out_size, win)
    img_base = torch.arange(batch, device=dev).repeat_interleave(r) * rows_img
    row0 = img_base + row_off[g.level] + g.wy0
    wy = _interp_matrix(g.y1, g.bin_h, g.wy0.to(torch.float32), g.hi_y, out_size, s, win)
    wx = _interp_matrix(g.x1, g.bin_w, g.wx0.to(torch.float32), g.hi_x, out_size, s, win_w)
    return RoIGeometry(row0.to(torch.int32), g.wx0.to(torch.int32), wy, wx)


def fold_pool(w: torch.Tensor, out_size: int, s: int) -> torch.Tensor:
    """Fold the mean over ``s`` samples per bin into an interpolation
    matrix: ``(n, out*s, win) -> (n, out, win)``."""
    return w.reshape(w.shape[0], out_size, s, w.shape[-1]).mean(dim=2)


def fold_pool_rounded(w: torch.Tensor, out_size: int, s: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """The pool fold of the Pallas kernels in ``dtype``: each weight of
    ``w`` ``(n, out*s, win)`` rounded to ``dtype``, each bin's ``s`` samples
    averaged in float32 and the mean rounded to ``dtype`` again; returned
    as float32 values ``(n, out, win)``.  With ``s = 2`` it is ``bf16((bf16(w_a)
    + bf16(w_b)) / 2)``, what ``_fold_and_align`` gives bit for bit."""
    w = w.to(dtype).to(torch.float32)
    w = (w.reshape(w.shape[0], out_size, s, w.shape[-1]) / s).sum(dim=2)
    return w.to(dtype).to(torch.float32)


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
    invalid RoIs zero, in the pyramid's dtype, with the Pallas kernels'
    arithmetic: the interpolation weights folded over each bin's ``s x s``
    samples (``fold_pool_rounded``; in a narrow dtype each weight and each
    folded weight rounded to it), the levels widened to float32 (so that
    autograd sums the gradient in float32 and rounds each level once), rows
    then columns contracted in float32, the output rounded once.  In
    float32 it is the JAX package's ``multilevel_roi_align_fast`` (sample,
    then average) with the average folded into the weights."""
    b, r = rois.shape[:2]
    nl = num_route_levels or len(feats)
    dtype, c = feats[0].dtype, feats[0].shape[-1]
    stacked, _ = batched_stack([f.to(torch.float32) for f in feats[:nl]], nl)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats[:nl]]
    g = batched_geometry(level_hw, rois.reshape(b * r, 4), b, strides,
                         finest_scale, out_size, sample_num)
    wy = fold_pool_rounded(g.wy, out_size, sample_num, dtype)
    wx = fold_pool_rounded(g.wx, out_size, sample_num, dtype)
    dev = stacked.device
    rows = g.row0.to(torch.int64)[:, None] + torch.arange(WIN, device=dev)
    cols = g.x0.to(torch.int64)[:, None] + torch.arange(wx.shape[-1], device=dev)
    windows = stacked[rows[:, :, None], cols[:, None, :]]  # (n, WIN, win_w, C)
    t = torch.einsum("rik,rkmc->rimc", wy, windows)
    pooled = torch.einsum("rimc,rjm->rijc", t, wx).to(dtype)
    pooled = pooled * roi_valid.reshape(b * r)[:, None, None, None].to(dtype)
    return pooled.reshape(b, r, out_size, out_size, c)


def tile_grid(level_hw: Sequence[Tuple[int, int]], tile: int = TILE):
    """The gradient kernel's tiles of one image: per level the index of its
    first tile and its tiles per row, and the tiles per image."""
    base, per_row, acc = [], [], 0
    for h, w in level_hw:
        base.append(acc)
        per_row.append(-(-w // tile))
        acc += per_row[-1] * -(-h // tile)
    return base, per_row, acc


def tile_keys(
    rois_flat: torch.Tensor,
    valid_flat: torch.Tensor,
    level_hw: Sequence[Tuple[int, int]],
    rois_per_img: int,
    strides: Sequence[int],
    finest_scale: int = 56,
    out_size: int = 7,
    s: int = 2,
) -> torch.Tensor:
    """Plain mirror of ``roi_tile_keys_kernel``: per RoI ``(n, 16)`` int32
    the keys ``image * tiles_per_img + tile_base[level] + ty * tiles_x +
    tx`` of the tiles that its nonzero taps meet, row-major from the first
    one, ``NO_TILE`` in the unused slots and for invalid RoIs."""
    t = sample_taps(rois_flat, level_hw, strides, finest_scale, out_size, s)
    dev = rois_flat.device
    base, per_row, per_img = tile_grid(level_hw)
    ylo, xlo = t.ky.min(1).values, t.kx.min(1).values
    yhi = torch.where(t.wy[..., 1] > 0, t.ky + 1, t.ky).max(1).values
    xhi = torch.where(t.wx[..., 1] > 0, t.kx + 1, t.kx).max(1).values
    slot = torch.arange(TILES_PER_AXIS ** 2, device=dev)
    ty = ((t.wy0 + ylo) // TILE)[:, None] + slot // TILES_PER_AXIS
    tx = ((t.wx0 + xlo) // TILE)[:, None] + slot % TILES_PER_AXIS
    hit = (ty <= ((t.wy0 + yhi) // TILE)[:, None]) & (tx <= ((t.wx0 + xhi) // TILE)[:, None])
    hit &= valid_flat.bool()[:, None]
    img = torch.arange(rois_flat.shape[0], device=dev) // rois_per_img
    first = img * per_img + torch.tensor(base, device=dev)[t.level]
    keys = first[:, None] + ty * torch.tensor(per_row, device=dev)[t.level][:, None] + tx
    return torch.where(hit, keys, NO_TILE).to(torch.int32)


def tile_lists(keys: torch.Tensor, num_tiles: int):
    """The tile lists that ``(n, 16)`` keys stand for: ``tile_rois``
    (int32), the RoI of every (tile, RoI) pair grouped by tile, RoIs
    ascending within a tile (the order in which the gradient kernel adds
    them), and ``tile_start`` ``(num_tiles + 1,)`` int32, where each tile's
    group starts."""
    sorted_keys, order = torch.sort(keys.reshape(-1), stable=True)
    tile_rois = (order // keys.shape[1]).to(torch.int32)
    bounds = torch.arange(num_tiles + 1, dtype=torch.int32, device=keys.device)
    return tile_rois, torch.searchsorted(sorted_keys, bounds, out_int32=True)


def tile_bitmap(keys: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """Plain mirror of the tile-key kernel's bitmap: ``(num_tiles,
    ceil(n / 32))`` int64 holding the unsigned 32-bit words, bit ``n % 32``
    of word ``n // 32`` in tile ``t``'s row set when RoI ``n`` lists key
    ``t``."""
    n = keys.shape[0]
    roi, slot = torch.nonzero(keys != NO_TILE, as_tuple=True)
    tile = keys[roi, slot].long()
    bitmap = torch.zeros((num_tiles, -(-n // 32)), dtype=torch.int64, device=keys.device)
    bitmap.index_put_((tile, roi // 32), torch.ones_like(roi) << (roi % 32), accumulate=True)
    return bitmap


def tile_counts(bitmap: torch.Tensor) -> torch.Tensor:
    """The length of each tile's RoI list: the set bits of each row of a
    tile bitmap (the kernel's int32 words or the mirror's int64 ones),
    ``(num_tiles,)`` int64."""
    w = bitmap.long() & 0xFFFFFFFF
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    w = ((w * 0x01010101) & 0xFFFFFFFF) >> 24
    return w.sum(1)


def tile_spread(counts: torch.Tensor, level_hw: Sequence[Tuple[int, int]]):
    """How the RoIs spread over the gradient kernel's tiles, per level:
    ``counts`` ``(B * tiles_per_img,)`` list lengths (``tile_counts``) ->
    one dict a level with its ``tiles`` (over the batch), the tiles with
    any RoI (``with_rois``), their ``mean`` list length (0.0 when none)
    and the ``max``."""
    base, per_row, per_img = tile_grid(level_hw)
    by_img = counts.reshape(-1, per_img)
    out = []
    for (h, _), first, tx in zip(level_hw, base, per_row):
        c = by_img[:, first:first + tx * -(-h // TILE)].reshape(-1)
        hit = c[c > 0]
        out.append({"tiles": int(c.numel()), "with_rois": int(hit.numel()),
                    "mean": float(hit.float().mean()) if hit.numel() else 0.0,
                    "max": int(c.max()) if c.numel() else 0})
    return out
