"""Batched multi-level RoIAlign, forward and feature gradient: the CUDA
kernels' wrappers.

``csrc/roi_align_fwd.cu`` replaces the TPU kernel ``_kernel_flat``
(``boosting_rcnn_tpu/ops/pallas_roi_align.py:586``, reached through
``batched_multilevel_roi_align_pallas`` :766); ``csrc/roi_align_bwd.cu``
replaces ``_bwd_kernel`` (:244, reached through
``batched_multilevel_roi_align_pallas_bwd`` :828).  Each source notes what
bounds it on an H100 (bytes for both) and how its design answers that.

The TPU-only layout rules of the Pallas kernels are dropped, none of which
changes the numbers: the ``x0 // align`` split with its one-hot ``wx``
shift, the 128-lane packing of ``wy``/``wx``, the out_y padding to 8, the
C % 128 fallback, and in the backward the VMEM accumulator with its row
splits.  The geometry stays in PyTorch (``prepare``: ``batched_stack``,
``batched_geometry``, ``fold_pool``); the kernels read and write exactly
the 24 x win_w window at ``(row0, x0)``.

``batched_multilevel_roi_align`` takes the pyramid of one batch.  On CPU
tensors it is the plain version, ``roi_align.multilevel_roi_align_fast``,
and autograd through its gather and einsum is the plain backward.  On
CUDA tensors it launches the forward kernel, inside a
``torch.autograd.Function`` whose backward launches the gradient kernel
and returns the gradient of the stacked pyramid only; autograd carries it
back through ``batched_stack``'s pad and cat to the levels.  RoIs and the
valid mask get no gradient (mmcv's RoIAlign backward).  Anything else
raises: no CUDA tensor reaches the plain version.

``multilevel_roi_align`` is the per-image entry (the counterpart of
``multilevel_roi_align_pallas`` :170 and
``multilevel_roi_align_pallas_trainable`` :1000, whose kernels ``_kernel``
and ``_bwd_kernel`` are the TPU's per-image forms): the batch-of-one case
of the same kernels, with launch counts of its own.

``launches`` on each wrapper counts its kernel launches.
``roi_align_bwd_plain`` is the plain gradient on prepared inputs.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch

from .. import cuda_build
from .roi_align import (
    WIN,
    batched_geometry,
    batched_stack,
    fold_pool,
    multilevel_roi_align_fast,
)

__all__ = [
    "KernelInputs",
    "RoIAlignForward",
    "RoIAlignBackward",
    "PerImageRoIAlign",
    "batched_multilevel_roi_align",
    "multilevel_roi_align",
    "prepare",
    "roi_align_bwd_plain",
]

OUT_SIZE = 7


class KernelInputs(NamedTuple):
    """The prepared geometry of ``n`` flat RoIs: ``row0``/``x0`` ``(n,)``
    int32, pool-folded ``wy`` ``(n, 7, 24)`` and ``wx`` ``(n, 7, win_w)``
    float32, ``valid`` ``(n,)`` uint8."""

    row0: torch.Tensor
    x0: torch.Tensor
    wy: torch.Tensor
    wx: torch.Tensor
    valid: torch.Tensor


def prepare(feats: Sequence[torch.Tensor], rois: torch.Tensor, roi_valid: torch.Tensor,
            strides: Sequence[int], out_size: int = OUT_SIZE, sample_num: int = 2,
            finest_scale: int = 56, num_route_levels: int | None = None,
            ) -> Tuple[torch.Tensor, KernelInputs]:
    """The stacked pyramid ``(B*rows_img, W, C)`` (differentiable in the
    levels) and the kernels' geometry of ``rois`` ``(B, R, 4)`` (no
    gradient)."""
    nl = num_route_levels or len(feats)
    b, r = rois.shape[:2]
    stacked, _ = batched_stack(feats, nl)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats[:nl]]
    with torch.no_grad():
        g = batched_geometry(level_hw, rois.detach().reshape(b * r, 4).float(), b,
                             strides, finest_scale, out_size, sample_num)
        inputs = KernelInputs(
            g.row0.contiguous(), g.x0.contiguous(),
            fold_pool(g.wy, out_size, sample_num).contiguous(),
            fold_pool(g.wx, out_size, sample_num).contiguous(),
            roi_valid.detach().reshape(b * r).to(torch.uint8).contiguous())
    return stacked, inputs


def _check_inputs(inputs: KernelInputs, device: torch.device, width: int) -> int:
    n = inputs.row0.shape[0]
    win_w = inputs.wx.shape[-1]
    expect = {
        "row0": (torch.int32, (n,)),
        "x0": (torch.int32, (n,)),
        "wy": (torch.float32, (n, OUT_SIZE, WIN)),
        "wx": (torch.float32, (n, OUT_SIZE, win_w)),
        "valid": (torch.uint8, (n,)),
    }
    for name, (dtype, shape) in expect.items():
        t = getattr(inputs, name)
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name} is not on the CUDA device {device}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not 1 <= win_w <= min(WIN, width):
        raise ValueError(f"window width {win_w} outside [1, {min(WIN, width)}]")
    return n


def _check_pyramid(feats, rois, roi_valid, nl, out_size) -> None:
    device = feats[0].device
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
        raise NotImplementedError(f"the kernels pool to {OUT_SIZE}x{OUT_SIZE} only")


class RoIAlignBackward:
    """Callable wrapper of the RoIAlign gradient kernel with a launch count."""

    KERNEL = "roi_align_bwd"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            fn = cuda_build.load(self.KERNEL).roi_align_bwd_f32
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, g: torch.Tensor, inputs: KernelInputs, stacked_shape,
               out: torch.Tensor | None = None) -> torch.Tensor:
        """Gradient of the stacked pyramid ``stacked_shape`` = ``(rows, W,
        C)`` for the cotangent ``g`` ``(n, 7, 7, C)`` float32 on prepared
        CUDA ``inputs``.  The result is a new zeroed tensor that the kernel
        adds into, or ``out`` when given (the kernel then adds to what it
        holds)."""
        rows, width, c = (int(x) for x in stacked_shape)
        device = g.device
        n = _check_inputs(inputs, device, width)
        if g.dtype != torch.float32 or tuple(g.shape) != (n, OUT_SIZE, OUT_SIZE, c) \
                or not g.is_contiguous():
            raise ValueError(f"g: want contiguous float32 {(n, OUT_SIZE, OUT_SIZE, c)}, "
                             f"got {g.dtype} {tuple(g.shape)}")
        if out is None:
            out = torch.zeros((rows, width, c), dtype=torch.float32, device=device)
        elif (out.dtype != torch.float32 or tuple(out.shape) != (rows, width, c)
              or out.device != device or not out.is_contiguous()):
            raise ValueError("out must be a contiguous float32 tensor of stacked_shape "
                             "on g's device")
        if n == 0:
            return out
        fn = self._kernel()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(g.data_ptr(), inputs.row0.data_ptr(), inputs.x0.data_ptr(),
                     inputs.wy.data_ptr(), inputs.wx.data_ptr(), inputs.valid.data_ptr(),
                     out.data_ptr(), n, rows, width, c, inputs.wx.shape[-1],
                     OUT_SIZE, WIN, stream)
        if err != 0:
            raise RuntimeError(f"{self.KERNEL} launch failed with CUDA error {err}")
        self.launches += 1
        return out


class _RoIAlignFunction(torch.autograd.Function):
    """Forward kernel on the stacked pyramid; the backward kernel gives
    the stacked pyramid's gradient.  The geometry gets none."""

    @staticmethod
    def forward(ctx, stacked, row0, x0, wy, wx, valid, wrapper):
        inputs = KernelInputs(row0, x0, wy, wx, valid)
        ctx.save_for_backward(row0, x0, wy, wx, valid)
        ctx.stacked_shape = stacked.shape
        ctx.wrapper = wrapper
        return wrapper.launch(stacked, inputs)

    @staticmethod
    def backward(ctx, g):
        inputs = KernelInputs(*ctx.saved_tensors)
        d_stacked = ctx.wrapper.backward.launch(g.contiguous(), inputs, ctx.stacked_shape)
        return d_stacked, None, None, None, None, None, None


class RoIAlignForward:
    """Callable wrapper of the RoIAlign forward kernel with a launch count;
    ``backward`` is its own wrapper of the gradient kernel, which autograd
    launches through it."""

    KERNEL = "roi_align_fwd"

    def __init__(self):
        self.launches = 0
        self.backward = RoIAlignBackward()
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            fn = cuda_build.load(self.KERNEL).roi_align_fwd_f32
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
        zero; differentiable in ``feats``."""
        device = feats[0].device
        kw = dict(out_size=out_size, sample_num=sample_num,
                  finest_scale=finest_scale, num_route_levels=num_route_levels)
        if device.type == "cpu":
            return multilevel_roi_align_fast(feats, rois.detach(), roi_valid.detach(),
                                              strides, **kw)
        if device.type != "cuda":
            raise ValueError(f"RoIAlign runs on cpu or cuda tensors, not {device}")
        nl = num_route_levels or len(feats)
        _check_pyramid(feats, rois, roi_valid, nl, out_size)
        b, r = rois.shape[:2]
        stacked, inputs = prepare(feats, rois, roi_valid, strides, **kw)
        if torch.is_grad_enabled() and stacked.requires_grad:
            out = _RoIAlignFunction.apply(stacked, *inputs, self)
        else:
            out = self.launch(stacked, inputs)
        return out.reshape(b, r, out_size, out_size, feats[0].shape[-1])

    def launch(self, stacked: torch.Tensor, inputs: KernelInputs) -> torch.Tensor:
        """Run the kernel on prepared CUDA inputs: ``stacked`` ``(rows, W,
        C)`` float32 -> ``(n, 7, 7, C)``."""
        if stacked.dtype != torch.float32 or stacked.ndim != 3 or not stacked.is_contiguous():
            raise ValueError(f"stacked: want contiguous float32 (rows, W, C), got "
                             f"{stacked.dtype} {tuple(stacked.shape)}")
        rows, width, c = stacked.shape
        n = _check_inputs(inputs, stacked.device, width)
        out = torch.empty((n, OUT_SIZE, OUT_SIZE, c), dtype=torch.float32,
                          device=stacked.device)
        if n == 0:
            return out
        fn = self._kernel()
        with torch.cuda.device(stacked.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(stacked.data_ptr(), inputs.row0.data_ptr(), inputs.x0.data_ptr(),
                     inputs.wy.data_ptr(), inputs.wx.data_ptr(), inputs.valid.data_ptr(),
                     out.data_ptr(), n, width, c, inputs.wx.shape[-1], OUT_SIZE, WIN,
                     stream)
        if err != 0:
            raise RuntimeError(f"{self.KERNEL} launch failed with CUDA error {err}")
        self.launches += 1
        return out


class PerImageRoIAlign:
    """The per-image entry: levels L x ``(H, W, C)``, ``rois`` ``(R, 4)``,
    ``valid`` ``(R,)`` -> ``(R, out, out, C)``, the batch-of-one case of
    the batched kernels.  ``batched`` holds its own forward and backward
    wrappers, so that their launch counts are its own."""

    def __init__(self):
        self.batched = RoIAlignForward()

    def __call__(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 roi_valid: torch.Tensor, strides: Sequence[int], **kw) -> torch.Tensor:
        return self.batched([f[None] for f in feats], rois[None], roi_valid[None],
                            strides, **kw)[0]


def roi_align_bwd_plain(g: torch.Tensor, inputs: KernelInputs, stacked_shape) -> torch.Tensor:
    """Plain gradient of the stacked pyramid ``(rows, W, C)`` for the
    cotangent ``g`` ``(n, 7, 7, C)``: the window gradients
    ``wy^T g wx`` of the valid RoIs, added at their windows."""
    rows, width, c = (int(x) for x in stacked_shape)
    dev = g.device
    win_w = inputs.wx.shape[-1]
    g = g * inputs.valid.to(g.dtype)[:, None, None, None]
    dwin = torch.einsum("nok,nopc,npm->nkmc", inputs.wy, g, inputs.wx)
    r_idx = inputs.row0.long()[:, None] + torch.arange(WIN, device=dev)
    c_idx = inputs.x0.long()[:, None] + torch.arange(win_w, device=dev)
    flat = (r_idx[:, :, None] * width + c_idx[:, None, :]).reshape(-1)
    out = torch.zeros((rows * width, c), dtype=g.dtype, device=dev)
    out.index_add_(0, flat, dwin.reshape(-1, c))
    return out.reshape(rows, width, c)


batched_multilevel_roi_align = RoIAlignForward()
multilevel_roi_align = PerImageRoIAlign()
