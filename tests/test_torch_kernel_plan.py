"""Host-side logic of the RoIAlign kernels, on the CPU: the list lengths of
the gradient kernel's tile bitmap (``roi_align.tile_counts``) and their
spread over the pyramid levels (``roi_align.tile_spread``), which
``chip_smoke.py`` prints from the tile-key kernel's bitmap on the card; and
the bfloat16 7 x 7 forward's per-bin tap lists, the pool fold written out
per cell (``roi_align.bin_taps``), against the dense fold.  The forward's
launch plans live in the CUDA library (``roi_align_fwd_plan``) and are read
and checked on the card.  No JAX, no card.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from boosting_rcnn_tpu_torch.ops import roi_align  # noqa: E402

LEVEL_HW = [(40, 64), (20, 32), (10, 16), (5, 8)]
STRIDES = (4, 8, 16, 32)


def _keys(seed: int, batch: int, out_size: int):
    """Seeded RoIs of ``batch`` images, 70 each, about 90% valid, and their
    plain tile keys."""
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 240, (batch, 70, 2))
    rois = torch.from_numpy(np.concatenate([xy, xy + rs.uniform(4, 300, (batch, 70, 2))], -1)
                            .astype(np.float32)).reshape(-1, 4)
    valid = torch.from_numpy(rs.rand(batch * 70) < 0.9).to(torch.uint8)
    return roi_align.tile_keys(rois, valid, LEVEL_HW, 70, STRIDES, out_size=out_size)


@pytest.mark.parametrize("seed,out_size", [(0, 7), (1, 7), (2, 14)])
def test_tile_counts_are_the_list_lengths(seed, out_size):
    """``tile_counts`` of the plain bitmap, in its int64 words and as the
    kernel's int32 ones, is the number of (tile, RoI) keys of each tile."""
    keys = _keys(seed, 3, out_size)
    n_tiles = 3 * roi_align.tile_grid(LEVEL_HW)[2]
    bitmap = roi_align.tile_bitmap(keys, n_tiles)
    want = torch.bincount(keys[keys != roi_align.NO_TILE].long(), minlength=n_tiles)
    assert torch.equal(roi_align.tile_counts(bitmap), want)
    assert torch.equal(roi_align.tile_counts(bitmap.to(torch.int32)), want)


def test_tile_spread_by_level():
    """Per level: the tiles over the batch, those with any RoI, their mean
    list length and the largest."""
    level_hw = [(16, 24), (8, 12)]  # 2 x 3 tiles, then 1 x 2
    counts = torch.tensor([0, 3, 1, 0, 0, 8, 5, 0,     # image 0: level 0, level 1
                           2, 0, 0, 0, 0, 0, 0, 0])    # image 1
    assert roi_align.tile_spread(counts, level_hw) == [
        {"tiles": 12, "with_rois": 4, "mean": 3.5, "max": 8},
        {"tiles": 4, "with_rois": 1, "mean": 5.0, "max": 5}]


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("out_size", [7, 14])
def test_tile_spread_of_a_bitmap_matches_its_keys(batch, out_size):
    """The spread read off a bitmap agrees with the keys it was made from,
    each key's level found from the tile grid's level bases: per level the
    tiles over the batch, the tiles hit, the keys (mean x tiles hit) and
    the longest list."""
    keys = _keys(batch + out_size, batch, out_size)
    base, _, per_img = roi_align.tile_grid(LEVEL_HW)
    bitmap = roi_align.tile_bitmap(keys, batch * per_img)
    spread = roi_align.tile_spread(roi_align.tile_counts(bitmap), LEVEL_HW)
    hit = keys[keys != roi_align.NO_TILE].long()
    tile_in_img = hit % per_img
    level = torch.bucketize(tile_in_img, torch.tensor(list(base[1:])), right=True)
    assert len(spread) == len(LEVEL_HW)
    for lvl, x in enumerate(spread):
        mine = hit[level == lvl]
        per_tile = torch.bincount(mine) if mine.numel() else torch.zeros(1, dtype=torch.long)
        first = base[lvl + 1] if lvl + 1 < len(base) else per_img
        assert x["tiles"] == batch * (first - base[lvl])
        assert x["with_rois"] == int((per_tile > 0).sum())
        assert round(x["mean"] * x["with_rois"]) == mine.numel()
        assert x["max"] == int(per_tile.max())


def _fold_rois(seed: int, n: int = 90):
    """Seeded flat RoIs of every kind the forward meets: random ones on
    every level, reversed ones (x2 < x1, y2 < y1: each bin's samples
    descend), wide and thin ones (bins of several cells), degenerate ones,
    ones past the levels' edges, and ones whose sqrt(w*h) sits on the level
    boundaries (112, 224 px) or one float32 ulp either side."""
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 240, (n, 2))
    rand = np.concatenate([xy, xy + rs.uniform(2, 300, (n, 2))], -1)
    rev = np.concatenate([xy[:20] + 60, xy[:20] + 60 - rs.uniform(1, 60, (20, 2))], -1)
    thin = np.stack([rs.uniform(0, 40, 10), rs.uniform(0, 140, 10), rs.uniform(120, 256, 10),
                     np.zeros(10)], -1)
    thin[:, 3] = thin[:, 1] + rs.uniform(2, 20, 10)
    edge = [[200, 120, 256, 160], [0, 0, 256, 160], [5, 5, 5, 5], [250, 150, 400, 300],
            [-50, -20, -5, -1]]
    for side in (112, 224):
        for v in (np.nextafter(np.float32(side), np.float32(0)), np.float32(side),
                  np.nextafter(np.float32(side), np.float32(1e9))):
            edge.append([8, 4, np.float32(8) + v, np.float32(4) + v])
    rois = np.concatenate([rand, rev, thin, np.array(edge)], 0).astype(np.float32)
    return torch.from_numpy(rois)


def _nonzero_lists(dense: torch.Tensor):
    """The nonzero cells of each row of ``dense`` ``(n, out, width)``,
    ascending, and their values: ``(n, out, 4)`` each, -1 and 0 past the
    row's nonzeros (at most 4 a row, asserted)."""
    width = dense.shape[-1]
    nz = dense != 0
    assert int(nz.sum(-1).max()) <= 4
    cells = torch.where(nz, torch.arange(width), width).sort(-1).values[..., :4]
    vals = torch.where(cells < width, dense.gather(-1, cells.clamp(max=width - 1)), 0.0)
    return torch.where(cells < width, cells, -1), vals


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("seed,out_size", [(10, 7), (11, 7), (12, 14), (13, 14)])
def test_bin_taps_match_the_dense_fold(seed, out_size, dtype):
    """The per-bin tap lists written out per cell (the bfloat16 forward's
    ``fold_taps``, mirrored by ``roi_align.bin_taps``) hold exactly the
    nonzero cells, ascending, and the weights of the dense pool fold
    (``fold_pool_rounded`` over ``taps_to_dense``), bit for bit, along both
    axes: the kernel's sums are the plain version's."""
    rois = _fold_rois(seed)
    cy, wy, cx, wx = roi_align.bin_taps(rois, LEVEL_HW, STRIDES, out_size=out_size, dtype=dtype)
    t = roi_align.sample_taps(rois, LEVEL_HW, STRIDES, out_size=out_size)
    win_w = min(roi_align.WIN, max(w for _, w in LEVEL_HW))
    for cells, ws, k, w, width in ((cy, wy, t.ky, t.wy, roi_align.WIN), (cx, wx, t.kx, t.wx, win_w)):
        dense = roi_align.fold_pool_rounded(roi_align.taps_to_dense(k, w, width), out_size, 2,
                                            dtype)
        want_cells, want_ws = _nonzero_lists(dense)
        assert torch.equal(cells, want_cells)
        assert torch.equal(ws, want_ws)
    # the cases the kernel specialises on all occur: 1 to 4 taps a bin
    counts = torch.cat([(cy >= 0).sum(-1).reshape(-1), (cx >= 0).sum(-1).reshape(-1)])
    assert set(counts.tolist()) >= {1, 2, 3}
