"""Batched multi-level RoIAlign forward: the CUDA kernel's wrapper.

Replaces the TPU kernel ``_kernel_flat`` (``boosting_rcnn_tpu/ops/
pallas_roi_align.py:586``) reached through
``batched_multilevel_roi_align_pallas`` (``pallas_roi_align.py:766``), which
``TwoStageNet.roi_out`` calls.  The kernel is ``csrc/roi_align_fwd.cu``;
its source notes what bounds it on an H100 (bytes: the function needs few
operations, since each pool-folded interpolation row has at most 4 nonzero
taps) and how its design answers that (coalesced channel-major window
loads, float32 register accumulation, no tensor cores).

The TPU-only layout rules of the Pallas kernel are dropped, none of which
changes the numbers: the ``x0 // align`` split with its one-hot ``wx``
shift, the 128-lane packing of ``wy``/``wx``, the out_y padding to 8 and
the C % 128 fallback.  The geometry stays in PyTorch
(``roi_align.batched_geometry``, ``fold_pool``, ``batched_stack``); the
kernel reads exactly the 24 x win_w window at ``(row0, x0)``.

``batched_multilevel_roi_align`` takes the pyramid of one batch: on CPU
tensors it returns the plain version, ``roi_align.multilevel_roi_align_fast``;
on CUDA tensors it launches the kernel or raises.  ``launches`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import cuda_build
from .roi_align import (
    WIN,
    batched_geometry,
    batched_stack,
    fold_pool,
    multilevel_roi_align_fast,
)

__all__ = ["RoIAlignForward", "batched_multilevel_roi_align"]

KERNEL = "roi_align_fwd"
OUT_SIZE = 7


class RoIAlignForward:
    """Callable wrapper of the RoIAlign forward kernel with a launch count."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            fn = cuda_build.load(KERNEL).roi_align_fwd_f32
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(
        self,
        feats: Sequence[torch.Tensor],
        rois: torch.Tensor,
        roi_valid: torch.Tensor,
        strides: Sequence[int],
        out_size: int = OUT_SIZE,
        sample_num: int = 2,
        finest_scale: int = 56,
        num_route_levels: int | None = None,
    ) -> torch.Tensor:
        """``feats`` L x ``(B, H, W, C)``, ``rois`` ``(B, R, 4)``,
        ``roi_valid`` ``(B, R)`` -> ``(B, R, out, out, C)``, invalid RoIs
        zero."""
        device = feats[0].device
        kw = dict(out_size=out_size, sample_num=sample_num,
                  finest_scale=finest_scale, num_route_levels=num_route_levels)
        if device.type == "cpu":
            return multilevel_roi_align_fast(feats, rois, roi_valid, strides, **kw)
        if device.type != "cuda":
            raise ValueError(f"RoIAlign runs on cpu or cuda tensors, not {device}")
        nl = num_route_levels or len(feats)
        b, r = rois.shape[:2]
        c = feats[0].shape[-1]
        for f in feats[:nl]:
            if f.device != device or f.dtype != torch.float32 or f.ndim != 4:
                raise ValueError("pyramid levels must be float32 (B, H, W, C) on one device")
            if f.shape[0] != b or f.shape[-1] != c:
                raise ValueError("pyramid levels disagree in batch or channels")
        if rois.shape != (b, r, 4) or roi_valid.shape != (b, r):
            raise ValueError(f"rois {tuple(rois.shape)} / valid {tuple(roi_valid.shape)} "
                             "are not (B, R, 4) / (B, R)")
        if rois.device != device or roi_valid.device != device:
            raise ValueError("rois and valid must lie on the pyramid's device")
        if out_size != OUT_SIZE:
            raise NotImplementedError(f"the kernel pools to {OUT_SIZE}x{OUT_SIZE} only")

        stacked, _ = batched_stack(feats, nl)
        level_hw = [(f.shape[1], f.shape[2]) for f in feats[:nl]]
        g = batched_geometry(level_hw, rois.reshape(b * r, 4).float(), b, strides,
                             finest_scale, out_size, sample_num)
        wy = fold_pool(g.wy, out_size, sample_num).contiguous()
        wx = fold_pool(g.wx, out_size, sample_num).contiguous()
        valid = roi_valid.reshape(b * r).to(torch.uint8).contiguous()
        out = self.launch(stacked, g.row0.contiguous(), g.x0.contiguous(), wy, wx, valid)
        return out.reshape(b, r, out_size, out_size, c)

    def launch(self, stacked, row0, x0, wy, wx, valid) -> torch.Tensor:
        """Run the kernel on prepared CUDA inputs: ``stacked``
        ``(rows, W, C)`` f32, ``row0``/``x0`` ``(n,)`` int32, ``wy``
        ``(n, 7, 24)``, ``wx`` ``(n, 7, win_w)`` f32, ``valid`` ``(n,)``
        uint8 -> ``(n, 7, 7, C)``."""
        n = row0.shape[0]
        rows, width, c = stacked.shape
        win_w = wx.shape[-1]
        expect = {
            "stacked": (stacked, torch.float32, (rows, width, c)),
            "row0": (row0, torch.int32, (n,)),
            "x0": (x0, torch.int32, (n,)),
            "wy": (wy, torch.float32, (n, OUT_SIZE, WIN)),
            "wx": (wx, torch.float32, (n, OUT_SIZE, win_w)),
            "valid": (valid, torch.uint8, (n,)),
        }
        for name, (t, dtype, shape) in expect.items():
            if t.device != stacked.device or t.device.type != "cuda":
                raise ValueError(f"{name} is not on the CUDA device of stacked")
            if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
        if not 1 <= win_w <= min(WIN, width):
            raise ValueError(f"window width {win_w} outside [1, {min(WIN, width)}]")
        out = torch.empty((n, OUT_SIZE, OUT_SIZE, c), dtype=torch.float32,
                          device=stacked.device)
        if n == 0:
            return out
        fn = self._kernel()
        with torch.cuda.device(stacked.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(stacked.data_ptr(), row0.data_ptr(), x0.data_ptr(),
                     wy.data_ptr(), wx.data_ptr(), valid.data_ptr(), out.data_ptr(),
                     n, width, c, win_w, OUT_SIZE, WIN, stream)
        if err != 0:
            raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
        self.launches += 1
        return out


batched_multilevel_roi_align = RoIAlignForward()
