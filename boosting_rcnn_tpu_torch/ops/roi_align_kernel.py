"""Batched multi-level RoIAlign, forward and feature gradient: the CUDA
kernels' wrappers.

``csrc/roi_align_fwd.cu`` replaces the TPU kernel ``_kernel_flat``
(``boosting_rcnn_tpu/ops/pallas_roi_align.py:586``, reached through
``batched_multilevel_roi_align_pallas`` :766); ``csrc/roi_align_bwd.cu``
replaces ``_bwd_kernel`` (:244, reached through
``batched_multilevel_roi_align_pallas_bwd`` :828).  Each source notes what
bounds it on an H100 (bytes for both) and how its design answers that.

Both kernels take the raw RoIs ``(B*R, 4)``, the valid mask and, per route
level, a descriptor (base pointer, height, width, element strides, the
level's stride in pixels; a host array that the C entry point turns into
a struct passed by value); they compute the level, window and
interpolation taps of each RoI themselves (``csrc/roi_geometry.cuh``) and
read or write the levels in place, NHWC with unit channel stride.  The
wrapper makes each route level contiguous once (the neck's levels reach it
as permuted NCHW views).  There is no stacked pyramid, no geometry pass in
PyTorch and no host-to-device copy.  The gradient is deterministic:
``roi_tile_keys`` stores each RoI's geometry and marks it in the bitmap of
each 8 x 8-cell tile its taps meet, and one block per tile sums the RoIs
of its bitmap in ascending order and stores each cell once.  Beyond the
level gradients it allocates only the bitmap and the geometry, and it
zero-fills only the bitmap.

The TPU-only layout rules of the Pallas kernels are dropped, none of which
changes the numbers: the stacked buffer with its width padding and window
rows, the ``x0 // align`` split with its one-hot ``wx`` shift, the 128-lane
packing of ``wy``/``wx``, the out_y padding to 8, the C % 128 fallback,
and in the backward the VMEM accumulator with its row splits.

``batched_multilevel_roi_align`` takes the pyramid of one batch.  On CPU
tensors it is the plain version, ``roi_align.multilevel_roi_align_fast``,
and autograd through its gather and einsum is the plain gradient
(``roi_align_bwd_plain``).  On CUDA tensors it launches the forward kernel,
inside a ``torch.autograd.Function`` whose backward launches the gradient
kernels and returns one gradient per route level.  RoIs and the valid mask
get no gradient (mmcv's RoIAlign backward).  Anything else raises: no CUDA
tensor reaches the plain version, and a failed build or launch raises.

``multilevel_roi_align`` is the per-image entry (the counterpart of
``multilevel_roi_align_pallas`` :170 and
``multilevel_roi_align_pallas_trainable`` :1000, whose kernels ``_kernel``
and ``_bwd_kernel`` are the TPU's per-image forms): the batch-of-one case
of the same kernels, with launch counts of its own.

Each kernel comes in float32 and bfloat16 (``roi_align_fwd_f32`` /
``_bf16``, ``roi_align_bwd_f32`` / ``_bf16``), chosen by the levels'
dtype; the levels must all have one dtype, the cotangent the levels', and
bfloat16 levels a channel count that is a multiple of 8.  Nothing is cast
on the way: a level of another dtype is a ``ValueError``.  The tile lists
carry the dtype their weights were rounded for (``TileLists.dtype``).
Each also comes at the two pooled sizes the JAX package calls its Pallas
kernels with, 7 (the box branch) and 14 (the mask branch): the entry
points without a size suffix pool to 7 x 7, the ``_o14`` ones (and
``roi_tile_keys_o14``) to 14 x 14, chosen by ``out_size``.  Any other size
is a ``ValueError``; nothing falls back to the plain version.

Each wrapper counts the launches of each of its entry points:
``launches`` (float32, 7 x 7), ``bf16_launches``, ``o14_launches``
(float32, 14 x 14) and ``bf16_o14_launches``; ``RoIAlignBackward``
counts its tile-key kernel's in ``tile_launches`` (7 x 7, either dtype)
and ``o14_tile_launches``.
"""
from __future__ import annotations

import array
import contextlib
import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch

from .. import cuda_build
from .roi_align import multilevel_roi_align_fast, tile_grid

__all__ = [
    "KERNEL_DTYPES",
    "OUT_SIZES",
    "TileLists",
    "RoIAlignForward",
    "RoIAlignBackward",
    "PerImageRoIAlign",
    "batched_multilevel_roi_align",
    "multilevel_roi_align",
    "roi_align_bwd_plain",
]

OUT_SIZES = (7, 14)  # the pooled sizes of the kernels' instantiations
SAMPLE_NUM = 2
MAX_LEVELS = 5
GEOM_BYTES = {7: 1488, 14: 2944}  # sizeof(roi::Geom<k>) in csrc/roi_geometry.cuh
# the kernels' element types: the C entry points' suffix and the channel
# multiple that 16-byte loads need
KERNEL_DTYPES = {torch.float32: ("f32", 4), torch.bfloat16: ("bf16", 8)}


class TileLists(NamedTuple):
    """The gradient kernel's work lists, from the tile-key kernel:
    ``bitmap`` ``(B * tiles_per_img, ceil(B*R / 32))`` int32, bit ``n`` of
    tile ``t``'s row set when valid RoI ``n`` meets tile ``t``
    (``roi_align.tile_bitmap`` is its plain mirror); ``geo`` ``(B*R,
    GEOM_BYTES[out_size])`` uint8, each valid RoI's geometry for the pooled
    size ``out_size``, its weights rounded for levels of ``dtype``."""

    bitmap: torch.Tensor
    geo: torch.Tensor
    dtype: torch.dtype = torch.float32
    out_size: int = 7


def _check_out_size(out_size: int) -> str:
    """The entry-point suffix of the pooled size: '' for 7, '_o14' for 14;
    any other size raises."""
    if out_size not in OUT_SIZES:
        raise ValueError(f"the RoIAlign kernels pool to {' or '.join(map(str, OUT_SIZES))}, "
                         f"not {out_size}")
    return "" if out_size == 7 else f"_o{out_size}"


def _count_name(dtype: torch.dtype, out_size: int, kernel: str = "") -> str:
    """The launch-count attribute of an entry point: ``launches``,
    ``bf16_launches``, ``o14_launches``, ``bf16_o14_launches``; with
    ``kernel='tile'`` the tile-key kernel's (``tile_launches``,
    ``o14_tile_launches``), which does not depend on the dtype."""
    parts = [] if kernel else (["bf16"] if dtype == torch.bfloat16 else [])
    parts += [] if out_size == 7 else [f"o{out_size}"]
    parts += [kernel] if kernel else []
    return "_".join(parts + ["launches"])


_LEVEL_ARGTYPES = [
    ctypes.c_float,  # finest_scale
    ctypes.c_int,  # num_levels
    ctypes.c_void_p,  # levels: a host array of 7 int64 per level
    ctypes.c_void_p,  # stream
]


@functools.lru_cache(maxsize=64)
def _shape_desc(level_shapes: Tuple[Tuple[int, ...], ...], strides: Tuple[int, ...]):
    return array.array("q", [v for (_, h, w, c), stride in zip(level_shapes, strides)
                             for v in (0, h, w, h * w * c, w * c, c, stride)])


def _level_args(levels, strides: Sequence[int], finest_scale: float):
    """The level arguments of the C entry points (``finest_scale``,
    ``num_levels``, the address of 7 int64 per route level: base pointer,
    height, width, the element strides of image, row and column, and the
    level's stride in pixels; the stream), and the host array that must
    outlive the call.  Levels given as shape tuples ``(B, H, W, C)`` pass a
    contiguous layout and null bases."""
    if isinstance(levels[0], torch.Tensor):
        desc = array.array("q")
        for f, stride in zip(levels, strides):
            s = f.stride()
            desc.extend((f.data_ptr(), f.shape[1], f.shape[2], s[0], s[1], s[2], stride))
    else:
        desc = _shape_desc(tuple(map(tuple, levels)), tuple(strides[:len(levels)]))
    args = (finest_scale, len(levels), desc.buffer_info()[0],
            torch.cuda.current_stream().cuda_stream)
    return args, desc


def _kernel_dtype(dtype: torch.dtype) -> Tuple[str, int]:
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"the RoIAlign kernels take float32 or bfloat16 levels, not {dtype}")
    return KERNEL_DTYPES[dtype]


def _check_shapes(level_shapes, dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """1 to ``MAX_LEVELS`` route levels ``(B, H, W, C)`` of one batch and
    one channel count, a multiple of 4 (float32) or 8 (bfloat16); returns
    ``(B, C)``."""
    if not 1 <= len(level_shapes) <= MAX_LEVELS:
        raise ValueError(f"{len(level_shapes)} route levels; the kernels take 1 to {MAX_LEVELS}")
    b, c = level_shapes[0][0], level_shapes[0][-1]
    multiple = _kernel_dtype(dtype)[1]
    if c % multiple:
        raise ValueError(f"{c} channels: the {dtype} kernels take a multiple of {multiple}")
    if any(len(s) != 4 or s[0] != b or s[-1] != c for s in level_shapes):
        raise ValueError("route levels must be (B, H, W, C) of one batch and channel count")
    return b, c


def _check_levels(levels: Sequence[torch.Tensor],
                  device: torch.device) -> Tuple[int, int, torch.dtype]:
    """Route levels ``(B, H, W, C)`` of one dtype, float32 or bfloat16, on
    the CUDA ``device``, unit channel stride, 16-byte aligned rows; returns
    ``(B, C, dtype)``."""
    if device.type != "cuda":
        raise ValueError(f"the RoIAlign kernels run on CUDA tensors, not {device}")
    dtype = levels[0].dtype
    b, c = _check_shapes([f.shape for f in levels], dtype)
    for f in levels:
        s = f.stride()
        if f.device != device or f.dtype != dtype:
            raise ValueError(f"route levels must be of one dtype on the CUDA device; got "
                             f"{[(str(x.dtype), str(x.device)) for x in levels]}")
        step = 16 // f.element_size()
        if s[3] != 1 or s[0] % step or s[1] % step or s[2] % step or f.data_ptr() % 16:
            raise ValueError("route levels need unit channel stride and 16-byte aligned rows")
    return b, c, dtype


def _on(device: torch.device):
    """The context that makes ``device`` current, unless it is already."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _check_rois(rois: torch.Tensor, valid: torch.Tensor, b: int, device) -> int:
    """Flat RoIs ``(B*R, 4)`` float32 and ``valid`` ``(B*R,)`` uint8,
    contiguous on ``device``; returns R."""
    n = rois.shape[0]
    if (rois.dtype != torch.float32 or tuple(rois.shape) != (n, 4) or not rois.is_contiguous()
            or rois.device != device):
        raise ValueError(f"rois: want contiguous float32 (B*R, 4) on {device}, got "
                         f"{rois.dtype} {tuple(rois.shape)} on {rois.device}")
    if (valid.dtype != torch.uint8 or tuple(valid.shape) != (n,) or not valid.is_contiguous()
            or valid.device != device):
        raise ValueError(f"valid: want contiguous uint8 ({n},) on {device}")
    if n % b:
        raise ValueError(f"{n} RoIs do not split into {b} images")
    return n // b


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


class RoIAlignBackward:
    """Callable wrapper of the RoIAlign gradient kernels with launch counts
    by entry point (``_count_name``): ``launches`` / ``bf16_launches`` of
    the 7 x 7 gradient kernels, ``o14_launches`` / ``bf16_o14_launches`` of
    the 14 x 14 ones, ``tile_launches`` / ``o14_tile_launches`` of the
    tile-key kernels."""

    KERNEL = "roi_align_bwd"

    def __init__(self):
        for out_size in OUT_SIZES:
            setattr(self, _count_name(None, out_size, "tile"), 0)
            for dtype in KERNEL_DTYPES:
                setattr(self, _count_name(dtype, out_size), 0)
        self._fns = None

    def _kernels(self):
        """The tile-key entry points by pooled size and the gradient entry
        points by (dtype suffix, pooled size)."""
        if self._fns is None:
            lib = cuda_build.load(self.KERNEL)
            lib.roi_geom_bytes.argtypes = [ctypes.c_int]
            lib.roi_geom_bytes.restype = ctypes.c_int
            keys, bwd = {}, {}
            for out_size in OUT_SIZES:
                o = _check_out_size(out_size)
                fn = getattr(lib, f"roi_tile_keys{o}")
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + _LEVEL_ARGTYPES
                fn.restype = ctypes.c_int
                keys[out_size] = fn
                for suffix, _ in KERNEL_DTYPES.values():
                    fn = getattr(lib, f"roi_align_bwd_{suffix}{o}")
                    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + _LEVEL_ARGTYPES
                    fn.restype = ctypes.c_int
                    bwd[suffix, out_size] = fn
                if lib.roi_geom_bytes(out_size) != GEOM_BYTES[out_size]:
                    raise RuntimeError(
                        f"{self.KERNEL}: the kernels' Geom<{out_size}> is "
                        f"{lib.roi_geom_bytes(out_size)} bytes, the wrapper allocates "
                        f"{GEOM_BYTES[out_size]}")
            self._fns = keys, bwd
        return self._fns

    def tile_lists(self, level_shapes: Sequence[Sequence[int]], rois: torch.Tensor,
                   valid: torch.Tensor, strides: Sequence[int],
                   finest_scale: float = 56, dtype: torch.dtype = torch.float32,
                   out_size: int = 7) -> TileLists:
        """The tile lists of flat CUDA ``rois`` ``(B*R, 4)`` and ``valid``
        ``(B*R,)`` uint8 over route levels of ``level_shapes`` ``(B, H, W,
        C)`` and ``dtype``, for the pooled size ``out_size``: the tile-key
        kernel."""
        if rois.device.type != "cuda":
            raise ValueError(f"the RoIAlign kernels run on CUDA tensors, not {rois.device}")
        _check_out_size(out_size)
        b, _ = _check_shapes(level_shapes, dtype)
        r = _check_rois(rois, valid, b, rois.device)
        _, _, per_img = tile_grid([(s[1], s[2]) for s in level_shapes])
        words = -(-b * r // 32)
        bitmap = torch.empty((b * per_img, words), dtype=torch.int32, device=rois.device)
        geo = torch.empty((b * r, GEOM_BYTES[out_size]), dtype=torch.uint8, device=rois.device)
        keys, _ = self._kernels()
        args, _desc = _level_args(level_shapes, strides, finest_scale)
        with _on(rois.device):
            err = keys[out_size](rois.data_ptr(), valid.data_ptr(), geo.data_ptr(),
                                 bitmap.data_ptr(), b, r, int(dtype == torch.bfloat16), *args)
        _raise_on(err, f"roi_tile_keys{_check_out_size(out_size)}")
        name = _count_name(dtype, out_size, "tile")
        setattr(self, name, getattr(self, name) + 1)
        return TileLists(bitmap, geo, dtype, out_size)

    def launch(self, g: torch.Tensor, level_shapes: Sequence[Sequence[int]],
               rois: torch.Tensor, valid: torch.Tensor, strides: Sequence[int],
               finest_scale: float = 56, tiles: TileLists | None = None,
               dtype: torch.dtype | None = None) -> List[torch.Tensor]:
        """Gradients ``(B, H, W, C)`` of route levels of ``level_shapes``
        and ``dtype`` (float32 or bfloat16; ``g``'s when None) for the
        cotangent ``g`` ``(B*R, k, k, C)`` of that dtype, ``k`` 7 or 14, of
        flat CUDA ``rois`` ``(B*R, 4)`` and ``valid`` ``(B*R,)`` uint8.
        Builds the tile lists unless ``tiles`` (for the same dtype and
        size) are given."""
        if g.device.type != "cuda":
            raise ValueError(f"the RoIAlign kernels run on CUDA tensors, not {g.device}")
        dtype = g.dtype if dtype is None else dtype
        suffix, _ = _kernel_dtype(dtype)
        out_size = g.shape[1] if g.dim() == 4 else 0
        o = _check_out_size(out_size)
        b, c = _check_shapes(level_shapes, dtype)
        r = _check_rois(rois, valid, b, g.device)
        if (g.dtype != dtype or tuple(g.shape) != (b * r, out_size, out_size, c)
                or not g.is_contiguous() or g.data_ptr() % 16):
            raise ValueError(f"g: want contiguous {dtype} {(b * r, out_size, out_size, c)}, "
                             f"got {g.dtype} {tuple(g.shape)}")
        if tiles is not None and (tiles.dtype, tiles.out_size) != (dtype, out_size):
            raise ValueError(f"tile lists made for {tiles.dtype} levels at {tiles.out_size}, "
                             f"not {dtype} at {out_size}")
        if r == 0:
            return [torch.zeros(s, dtype=dtype, device=g.device) for s in level_shapes]
        if tiles is None:
            tiles = self.tile_lists(level_shapes, rois, valid, strides, finest_scale, dtype,
                                    out_size)
        grads = [torch.empty(s, dtype=dtype, device=g.device) for s in level_shapes]
        _, bwd = self._kernels()
        args, _desc = _level_args(grads, strides, finest_scale)
        with _on(g.device):
            err = bwd[suffix, out_size](g.data_ptr(), tiles.geo.data_ptr(),
                                        tiles.bitmap.data_ptr(), b, r, c, *args)
        _raise_on(err, f"{self.KERNEL}_{suffix}{o}")
        name = _count_name(dtype, out_size)
        setattr(self, name, getattr(self, name) + 1)
        return grads


class _RoIAlignFunction(torch.autograd.Function):
    """The forward kernel on the route levels; the gradient kernels give
    one gradient per level.  RoIs and the valid mask get none."""

    @staticmethod
    def forward(ctx, rois, valid, wrapper, strides, finest_scale, out_size, *levels):
        ctx.save_for_backward(rois, valid)
        ctx.meta = (wrapper, strides, finest_scale, [tuple(f.shape) for f in levels],
                    levels[0].dtype)
        return wrapper.launch(levels, rois, valid, strides, finest_scale, out_size)

    @staticmethod
    def backward(ctx, g):
        rois, valid = ctx.saved_tensors
        wrapper, strides, finest_scale, level_shapes, dtype = ctx.meta
        # autograd gives g the output's dtype, the levels'; the kernel reads
        # it as it is, and another dtype is an error, not a cast
        if g.dtype != dtype:
            raise ValueError(f"RoIAlign cotangent is {g.dtype}, the levels are {dtype}")
        grads = wrapper.backward.launch(g.contiguous(), level_shapes, rois, valid, strides,
                                        finest_scale)
        return (None, None, None, None, None, None, *grads)


class RoIAlignForward:
    """Callable wrapper of the RoIAlign forward kernels with launch counts
    by entry point (``launches``, ``bf16_launches``, ``o14_launches``,
    ``bf16_o14_launches``); ``backward`` is its own wrapper of the gradient
    kernels, which autograd launches through it."""

    KERNEL = "roi_align_fwd"

    def __init__(self):
        for out_size in OUT_SIZES:
            for dtype in KERNEL_DTYPES:
                setattr(self, _count_name(dtype, out_size), 0)
        self.backward = RoIAlignBackward()
        self._fns = None

    def _kernel(self, suffix: str, out_size: int):
        if self._fns is None:
            lib = cuda_build.load(self.KERNEL)
            self._fns = {}
            for size in OUT_SIZES:
                for name, _ in KERNEL_DTYPES.values():
                    fn = getattr(lib, f"roi_align_fwd_{name}{_check_out_size(size)}")
                    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + _LEVEL_ARGTYPES
                    fn.restype = ctypes.c_int
                    self._fns[name, size] = fn
        return self._fns[suffix, out_size]

    def __call__(
        self,
        feats: Sequence[torch.Tensor],
        rois: torch.Tensor,
        roi_valid: torch.Tensor,
        strides: Sequence[int],
        out_size: int = 7,
        sample_num: int = SAMPLE_NUM,
        finest_scale: int = 56,
        num_route_levels: int | None = None,
    ) -> torch.Tensor:
        """``feats`` L x ``(B, H, W, C)``, ``rois`` ``(B, R, 4)``,
        ``roi_valid`` ``(B, R)`` -> ``(B, R, out, out, C)``, invalid RoIs
        zero; differentiable in ``feats``."""
        device = feats[0].device
        if device.type == "cpu":
            return multilevel_roi_align_fast(
                feats, rois.detach(), roi_valid.detach(), strides, out_size=out_size,
                sample_num=sample_num, finest_scale=finest_scale,
                num_route_levels=num_route_levels)
        if device.type != "cuda":
            raise ValueError(f"RoIAlign runs on cpu or cuda tensors, not {device}")
        _check_out_size(out_size)
        if sample_num != SAMPLE_NUM:
            raise ValueError(f"the kernels take {SAMPLE_NUM} samples per bin axis, not "
                             f"{sample_num}")
        nl = num_route_levels or len(feats)
        b, r = rois.shape[:2]
        if tuple(rois.shape) != (b, r, 4) or tuple(roi_valid.shape) != (b, r):
            raise ValueError(f"rois {tuple(rois.shape)} / valid {tuple(roi_valid.shape)} "
                             "are not (B, R, 4) / (B, R)")
        levels = [f.contiguous() for f in feats[:nl]]
        rois_flat = rois.detach().reshape(b * r, 4).to(torch.float32).contiguous()
        valid = roi_valid.detach().reshape(b * r).to(torch.uint8).contiguous()
        if torch.is_grad_enabled() and any(f.requires_grad for f in levels):
            out = _RoIAlignFunction.apply(rois_flat, valid, self, tuple(strides),
                                          float(finest_scale), out_size, *levels)
        else:
            out = self.launch(levels, rois_flat, valid, strides, finest_scale, out_size)
        return out.reshape(b, r, out_size, out_size, levels[0].shape[-1])

    def launch(self, levels: Sequence[torch.Tensor], rois: torch.Tensor, valid: torch.Tensor,
               strides: Sequence[int], finest_scale: float = 56,
               out_size: int = 7) -> torch.Tensor:
        """Run the kernel of the levels' dtype and ``out_size`` (7 or 14) on
        CUDA route ``levels`` ``(B, H, W, C)`` (float32 or bfloat16, one
        dtype, unit channel stride), flat ``rois`` ``(B*R, 4)`` float32 and
        ``valid`` ``(B*R,)`` uint8 -> ``(B*R, out, out, C)`` in the levels'
        dtype."""
        o = _check_out_size(out_size)
        b, c, dtype = _check_levels(levels, rois.device)
        r = _check_rois(rois, valid, b, rois.device)
        out = torch.empty((b * r, out_size, out_size, c), dtype=dtype, device=rois.device)
        if r == 0:
            return out
        suffix, _ = _kernel_dtype(dtype)
        fn = self._kernel(suffix, out_size)
        args, _desc = _level_args(levels, strides, finest_scale)
        with _on(rois.device):
            err = fn(rois.data_ptr(), valid.data_ptr(), out.data_ptr(), b, r, c, *args)
        _raise_on(err, f"{self.KERNEL}_{suffix}{o}")
        name = _count_name(dtype, out_size)
        setattr(self, name, getattr(self, name) + 1)
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


def roi_align_bwd_plain(g: torch.Tensor, levels: Sequence[torch.Tensor], rois: torch.Tensor,
                        roi_valid: torch.Tensor, strides: Sequence[int],
                        finest_scale: int = 56) -> List[torch.Tensor]:
    """Plain gradient of the route ``levels`` L x ``(B, H, W, C)`` (their
    shapes only) for the cotangent ``g`` ``(B*R, k, k, C)`` (``k`` the
    pooled size) of ``rois`` ``(B, R, 4)`` or ``(B*R, 4)``: autograd of the
    plain forward, ``multilevel_roi_align_fast``.  Invalid RoIs add
    nothing."""
    b = levels[0].shape[0]
    rois = rois.detach().reshape(b, -1, 4)
    valid = roi_valid.detach().reshape(b, -1).bool()
    with torch.enable_grad():
        leaves = [torch.zeros(f.shape, dtype=g.dtype, device=g.device, requires_grad=True)
                  for f in levels]
        out = multilevel_roi_align_fast(leaves, rois, valid, strides, out_size=g.shape[1],
                                        finest_scale=finest_scale)
        return list(torch.autograd.grad(out, leaves, g.reshape(out.shape)))


batched_multilevel_roi_align = RoIAlignForward()
multilevel_roi_align = PerImageRoIAlign()
