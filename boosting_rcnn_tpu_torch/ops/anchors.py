"""Anchor generation (numpy, host side; PyTorch port).

Counterpart of ``boosting_rcnn_tpu/ops/anchors.py::AnchorGenerator``.
Anchors depend only on the padded canvas, so they are made once with numpy
and moved to the device by the caller.  Flat anchors are level-major, then
(H, W, A) within a level, matching ``flatten_levels`` of the RPN outputs.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["AnchorGenerator"]


class AnchorGenerator:
    """Standard 2D anchor generator with octave scales.

    ``strides``: per-level stride (int or (w, h)); ``ratios``: h/w ratios;
    ``scales`` explicit, or ``octave_base_scale`` + ``scales_per_octave``;
    ``base_sizes`` default to the strides; ``center_offset`` in units of
    stride (0 in mmdet v2).
    """

    def __init__(
        self,
        strides: Sequence,
        ratios: Sequence[float],
        scales: Optional[Sequence[float]] = None,
        base_sizes: Optional[Sequence[int]] = None,
        scale_major: bool = True,
        octave_base_scale: Optional[int] = None,
        scales_per_octave: Optional[int] = None,
        center_offset: float = 0.0,
    ):
        self.strides = [
            tuple(s) if isinstance(s, (tuple, list)) else (s, s) for s in strides
        ]
        self.base_sizes = (
            [min(s) for s in self.strides] if base_sizes is None else list(base_sizes)
        )
        octave = octave_base_scale is not None and scales_per_octave is not None
        if octave == (scales is not None):
            raise ValueError(
                "give either scales or octave_base_scale + scales_per_octave")
        if scales is not None:
            self.scales = np.asarray(scales, dtype=np.float32)
        else:
            octave_scales = np.array(
                [2 ** (i / scales_per_octave) for i in range(scales_per_octave)]
            )
            self.scales = (octave_scales * octave_base_scale).astype(np.float32)
        self.ratios = np.asarray(ratios, dtype=np.float32)
        self.scale_major = scale_major
        self.center_offset = center_offset
        self.base_anchors = [
            self._single_level_base_anchors(b) for b in self.base_sizes
        ]

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    @property
    def num_base_anchors(self) -> List[int]:
        return [a.shape[0] for a in self.base_anchors]

    def _single_level_base_anchors(self, base_size) -> np.ndarray:
        w = h = float(base_size)
        x_center = self.center_offset * w
        y_center = self.center_offset * h
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        if self.scale_major:
            ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
            hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        else:
            ws = (w * self.scales[:, None] * w_ratios[None, :]).reshape(-1)
            hs = (h * self.scales[:, None] * h_ratios[None, :]).reshape(-1)
        return np.stack(
            [x_center - 0.5 * ws, y_center - 0.5 * hs,
             x_center + 0.5 * ws, y_center + 0.5 * hs],
            axis=-1,
        ).astype(np.float32)

    def grid_anchors(
        self, featmap_sizes: Sequence[Tuple[int, int]]
    ) -> List[np.ndarray]:
        """Per-level anchors ``(H*W*A, 4)`` for the given feature sizes."""
        if len(featmap_sizes) != self.num_levels:
            raise ValueError(
                f"{len(featmap_sizes)} feature sizes for {self.num_levels} levels")
        out = []
        for lvl, (feat_h, feat_w) in enumerate(featmap_sizes):
            sw, sh = self.strides[lvl]
            shift_x = np.arange(feat_w, dtype=np.float32) * sw
            shift_y = np.arange(feat_h, dtype=np.float32) * sh
            xx = np.tile(shift_x, feat_h)
            yy = np.repeat(shift_y, feat_w)
            shifts = np.stack([xx, yy, xx, yy], axis=-1)
            anchors = (
                shifts[:, None, :] + self.base_anchors[lvl][None, :, :]
            ).reshape(-1, 4)
            out.append(anchors.astype(np.float32))
        return out

    def flat_anchors(self, featmap_sizes: Sequence[Tuple[int, int]]) -> np.ndarray:
        """All levels concatenated to one ``(A_total, 4)`` array."""
        return np.concatenate(self.grid_anchors(featmap_sizes), axis=0)
