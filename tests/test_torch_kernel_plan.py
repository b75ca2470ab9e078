"""Host-side logic that reads the RoIAlign gradient kernel's tile lists, on
the CPU: the list lengths of a tile bitmap (``roi_align.tile_counts``) and
their spread over the pyramid levels (``roi_align.tile_spread``), which
``chip_smoke.py`` prints from the tile-key kernel's bitmap on the card.
The launch plan of the 14 x 14 forward lives in the CUDA library
(``roi_align_fwd_plan``) and is read and checked on the card.  No JAX, no
card.
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
