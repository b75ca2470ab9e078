"""Numpy copies of the OpenCV 5.0 calls that the JAX package's train-time
augmentations make (``data/transforms.py``, ``albu.py``, ``instaboost.py``),
each giving ``cv2``'s bytes, so that the port needs no ``cv2`` and its
batches equal the JAX loader's.

What each copies (found by testing against ``cv2`` 5.0, built with the
accurate algorithm hint and AVX2 dispatch):

- ``resize_linear``: ``cv2.resize(..., INTER_LINEAR)`` on uint8, in fixed
  point: the source coordinate ``(d + 0.5) * (src / dst) - 0.5`` in float32,
  weights ``round(w * 2048)`` (``INTER_RESIZE_COEF_BITS`` 11), a horizontal
  pass into int32 rows, then a vertical one that shifts each row right by 4
  and takes ``((b0 * r0) >> 16) + ((b1 * r1) >> 16) + 2 >> 2``.
- ``warp_affine``: ``cv2.warpAffine`` on uint8, 1 or 3 channels, nearest or
  linear, constant or reflect-101 borders.  OpenCV 5.0's warp is
  float32, not the fixed point of 4.x: the inverse matrix rounded to
  float32, the source coordinate of the first ``16 * (width // 16)`` columns
  of a row ``fma(m0, x, y * m1 + m2)`` (its SIMD body), of the rest
  ``fma(x, m0, y * m1) + m2`` (its scalar tail), bilinear taps blended with
  fused multiply-adds ``fma(a, p1 - p0, p0)`` along x, then along y, and
  rounded half to even; nearest rounds the coordinate half to even.
- ``get_rotation_matrix_2d``: the centre rounded to float32 (``Point2f``).
- ``blur`` (box filter, reflect-101 border), ``median_blur`` (replicate
  border), ``dilate3`` (3 x 3 ones, outside ignored): exact integer results.
- ``rgb_to_hsv`` / ``hsv_to_rgb`` (8-bit, hue 0-180): the integer division
  tables of ``RGB2HSV_b``; for the inverse the float32 sector formula with
  fused multiply-adds, truncated in the SIMD body (the first ``32 *
  (width // 32)`` pixels of a row) and rounded in the scalar tail.
- ``inpaint_telea``: ``cv2.inpaint(..., INPAINT_TELEA)``: the fast-marching
  order of OpenCV's sorted-list priority queue (equal ``T`` pop in push
  order), the outward pass that gives the known ring negative distances,
  float32 sums in OpenCV's order, the image gradient's ``* 2.0f`` and its
  edge indices (``k - 1 + (k == 1)``), the value read at the true pixel, and
  ``saturate_cast<uchar>(sat + 0.5f)``.
"""
from __future__ import annotations

import heapq
import math
from typing import Tuple

import numpy as np

__all__ = ["fma32", "get_rotation_matrix_2d", "warp_affine", "resize_linear", "blur",
           "median_blur", "dilate3", "rgb_to_hsv", "hsv_to_rgb", "inpaint_telea",
           "BORDER_CONSTANT", "BORDER_REFLECT_101"]

f32, f64 = np.float32, np.float64
BORDER_CONSTANT, BORDER_REFLECT_101 = "constant", "reflect101"
_WARP_BODY = 16  # columns of a row that cv2's AVX2 warp body takes at a time
_HSV_BODY = 32  # pixels of a row that cv2's AVX2 HSV -> RGB body takes at a time


def fma32(a, b, c) -> np.ndarray:
    """``a * b + c`` rounded once to float32 (a fused multiply-add): the
    product of two float32 values is exact in float64, and the sum rounded
    to float64 then to float32 is the single rounding but where it lands on
    a float32 tie (its 29 dropped mantissa bits 1 then 0s); there the sum's
    own rounding error picks the side."""
    a, b, c = np.broadcast_arrays(*(np.asarray(x, f32).astype(f64) for x in (a, b, c)))
    p = a * b
    s = p + c
    r = s.astype(f32)
    tie = (s.view(np.uint64) & 0x1FFFFFFF) == 0x10000000
    if tie.any():
        st, pt, ct = s[tie], p[tie], c[tie]
        bb = st - pt
        err = (pt - (st - bb)) + (ct - bb)  # st + err == pt + ct exactly
        down = r[tie]
        other = np.where(st > down.astype(f64), np.nextafter(down, f32(np.inf)),
                         np.nextafter(down, f32(-np.inf)))
        toward = (err != 0) & ((err > 0) == (other.astype(f64) > down.astype(f64)))
        r[tie] = np.where(toward, other, down)
    return r


def get_rotation_matrix_2d(center: Tuple[float, float], angle: float,
                           scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: ``(2, 3)`` float64."""
    cx, cy = float(f32(center[0])), float(f32(center[1]))
    rad = angle * (math.pi / 180)  # C++: angle *= CV_PI / 180
    alpha = math.cos(rad) * scale
    beta = math.sin(rad) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], f64)


def _invert_affine(m) -> list:
    m = [float(v) for v in np.asarray(m, f64).reshape(-1)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _border_index(i: np.ndarray, n: int, mode: str) -> np.ndarray:
    if mode != BORDER_REFLECT_101:
        raise ValueError(f"border mode {mode!r}")
    if n == 1:  # cv2 replicates a one-pixel side
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


def _fetch(img: np.ndarray, iy: np.ndarray, ix: np.ndarray, mode: str, value) -> np.ndarray:
    h, w = img.shape[:2]
    if mode == BORDER_CONSTANT:
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        px = img[np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1)]
        return np.where(inside[..., None], px, np.asarray(value, img.dtype))
    return img[_border_index(iy, h, mode), _border_index(ix, w, mode)]


def _warp_coords(m, w: int, h: int, window=None):
    """The float32 source coordinates ``(sx, sy)`` of cv2's warp into a
    ``w`` x ``h`` image, over ``window`` ``(x0, y0, x1, y1)`` of it (the
    whole image by default): a column's formula is set by its place in the
    whole row."""
    x0, y0, x1, y1 = window or (0, 0, w, h)
    mf = np.asarray(_invert_affine(m), f64).astype(f32)
    x = np.arange(x0, x1, dtype=f32)[None, :]
    y = np.arange(y0, y1, dtype=f32)[:, None]
    body = np.arange(x0, x1)[None, :] < (w // _WARP_BODY) * _WARP_BODY
    out = []
    for a, b, c in ((mf[0], mf[1], mf[2]), (mf[3], mf[4], mf[5])):
        yb = (y * b).astype(f32)
        out.append(np.where(body, fma32(a, x, yb + c), fma32(x, a, yb) + c).astype(f32))
    return out


def warp_affine(src: np.ndarray, m, dsize: Tuple[int, int], linear: bool = True,
                border_mode: str = BORDER_CONSTANT, border_value: int = 0,
                window=None) -> np.ndarray:
    """``cv2.warpAffine(src, m, dsize, flags=INTER_LINEAR or INTER_NEAREST,
    borderMode=..., borderValue=border_value)`` for a uint8 ``(H, W)`` or
    ``(H, W, C)`` image; ``dsize`` is ``(width, height)``.  With ``window``
    ``(x0, y0, x1, y1)``, only that part of the output (the same pixels)."""
    if src.dtype != np.uint8:
        raise TypeError(f"warp_affine takes uint8 images, got {src.dtype}")
    w, h = int(dsize[0]), int(dsize[1])
    img = src.reshape(src.shape[0], src.shape[1], -1)
    sx, sy = _warp_coords(m, w, h, window)
    shape = sx.shape + src.shape[2:]
    if not linear:
        ix = np.rint(sx).astype(np.int64)
        iy = np.rint(sy).astype(np.int64)
        return _fetch(img, iy, ix, border_mode, border_value).reshape(shape)
    fx, fy = np.floor(sx), np.floor(sy)
    a = (sx - fx).astype(f32)[..., None]
    b = (sy - fy).astype(f32)[..., None]
    ix, iy = fx.astype(np.int64), fy.astype(np.int64)

    def tap(dy, dx):
        return _fetch(img, iy + dy, ix + dx, border_mode, border_value).astype(f32)

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    v0 = fma32(a, p01 - p00, p00)
    v1 = fma32(a, p11 - p10, p10)
    v = fma32(b, v1 - v0, v0)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8).reshape(shape)


def _resize_taps(n_dst: int, n_src: int):
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(f32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(f32)).astype(f32)


def _resize_coefs(f: np.ndarray):
    return (np.rint((f32(1) - f).astype(f32) * f32(2048)).astype(np.int32),
            np.rint(f * f32(2048)).astype(np.int32))


def resize_linear(src: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(src, (width, height), interpolation=INTER_LINEAR)`` for
    a uint8 image, 1 or more channels.  (An exact halving, which cv2 hands
    to its area resize, gives the same bytes through this path.)"""
    if src.dtype != np.uint8:
        raise TypeError(f"resize_linear takes uint8 images, got {src.dtype}")
    h0, w0 = src.shape[:2]
    img = src.reshape(h0, w0, -1)
    c = img.shape[2]
    sx, fx = _resize_taps(width, w0)
    low = sx < 0
    fx[low], sx[low] = 0, 0
    high = sx >= w0 - 1
    fx[high], sx[high] = 0, w0 - 1
    a0, a1 = _resize_coefs(fx)
    edge = sx + 1 >= w0  # the right edge: the pixel x 2048 (a0 is 2048 there)
    a1[edge] = 0
    # the horizontal pass into int32 rows (every product fits 31 bits), >> 4
    rows = img.take(sx, axis=1).astype(np.int32)
    rows *= a0[None, :, None]
    right = img.take(np.minimum(sx + 1, w0 - 1), axis=1).astype(np.int32)
    right *= a1[None, :, None]
    rows += right
    rows >>= 4
    rows = rows.reshape(h0, width * c)
    sy, fy = _resize_taps(height, h0)
    b0, b1 = _resize_coefs(fy)
    out = rows.take(np.clip(sy, 0, h0 - 1), axis=0)
    out *= b0[:, None]
    out >>= 16
    lower = rows.take(np.clip(sy + 1, 0, h0 - 1), axis=0)
    lower *= b1[:, None]
    lower >>= 16
    out += lower
    out += 2
    out >>= 2
    return out.astype(np.uint8).reshape((height, width) + src.shape[2:])


def _shifted(img: np.ndarray, k: int, index):
    """The ``k * k`` windows' shifted copies of ``img`` (rows then columns),
    their indices mapped by ``index(i, n)``."""
    h, w = img.shape[:2]
    r = k // 2
    rows = [index(np.arange(h) + dy, h) for dy in range(-r, r + 1)]
    cols = [index(np.arange(w) + dx, w) for dx in range(-r, r + 1)]
    return [img[ry][:, cx] for ry in rows for cx in cols]


def blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.blur(img, (k, k))`` on uint8 (reflect-101 border): the window
    sum over ``k * k``, rounded (no ties: ``k`` is odd)."""
    total = sum(s.astype(np.int64) for s in
                _shifted(img, k, lambda i, n: _border_index(i, n, BORDER_REFLECT_101)))
    return np.rint(total / (k * k)).astype(np.uint8)


def median_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.medianBlur(img, k)`` on uint8 (replicate border)."""
    stack = np.stack(_shifted(img, k, lambda i, n: np.clip(i, 0, n - 1)))
    return np.sort(stack, axis=0)[k * k // 2]


def dilate3(mask: np.ndarray) -> np.ndarray:
    """``cv2.dilate(mask, np.ones((3, 3), np.uint8))``: the 3 x 3 maximum,
    pixels outside the image ignored."""
    h, w = mask.shape[:2]
    pad = np.zeros((h + 2, w + 2) + mask.shape[2:], mask.dtype)
    pad[1:-1, 1:-1] = mask
    out = mask.copy()
    for dy in range(3):
        for dx in range(3):
            np.maximum(out, pad[dy:dy + h, dx:dx + w], out=out)
    return out


_SDIV = np.zeros(256, np.int64)
_HDIV = np.zeros(256, np.int64)
_SDIV[1:] = np.rint((255 << 12) / np.arange(1, 256, dtype=f64))
_HDIV[1:] = np.rint((180 << 12) / (6.0 * np.arange(1, 256, dtype=f64)))
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2HSV)`` on uint8 (hue 0-179)."""
    r, g, b = (img[..., c].astype(np.int64) for c in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << 11)) >> 12
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_HSV2RGB)`` on uint8 (hue 0-179)."""
    one = f32(1)
    h = img[..., 0].astype(f32)
    s = img[..., 1].astype(f32) * f32(1 / 255.0)
    v = img[..., 2].astype(f32) * f32(1 / 255.0)
    hh = (h * f32(6.0 / 180)).astype(f32)
    pre = np.trunc(hh).astype(f32)
    frac = (hh - pre).astype(f32)
    sector = (pre - np.trunc(pre * f32(1 / 6.0)).astype(f32) * f32(6)).astype(np.int64)
    tab = np.stack([v, v * (one - s), v * fma32(-s, frac, one),
                    v * fma32(-s, one - frac, one)], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector % 6], -1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr) * f32(255)
    body = np.arange(img.shape[1]) < (img.shape[1] // _HSV_BODY) * _HSV_BODY
    out = np.where(body[None, :, None], np.trunc(bgr), np.rint(bgr))
    return np.clip(out, 0, 255).astype(np.uint8)[..., ::-1]


# --- TELEA inpainting -------------------------------------------------------

_KNOWN, _BAND, _INSIDE, _CHANGE = 0, 1, 2, 3


class _Queue:
    """OpenCV's ``CvPriorityQueueFloat``: a sorted list where an element
    goes after every element of no greater ``T`` and pops come from the
    front, i.e. a heap on ``(T, push order)``."""

    def __init__(self):
        self.heap, self.count = [], 0

    def push(self, i: int, j: int, t: float) -> None:
        heapq.heappush(self.heap, (t, self.count, i, j))
        self.count += 1

    def pop(self):
        return heapq.heappop(self.heap)[2:] if self.heap else None


def _solve(i1, j1, i2, j2, f, t) -> float:
    """``FastMarching_solve`` (float64 inside, float32 out)."""
    a11, a22 = float(t[i1, j1]), float(t[i2, j2])
    if f[i1, j1] != _INSIDE:
        if f[i2, j2] != _INSIDE:
            if abs(a11 - a22) >= 1.0:
                sol = 1 + min(a11, a22)
            else:
                sol = (a11 + a22 + math.sqrt(2 - (a11 - a22) * (a11 - a22))) * 0.5
        else:
            sol = 1 + a11
    elif f[i2, j2] != _INSIDE:
        sol = 1 + a22
    else:
        sol = 1 + min(a11, a22)
    return float(f32(sol))


def _arrival(i: int, j: int, f, t) -> float:
    return min(_solve(i - 1, j, i, j - 1, f, t), _solve(i + 1, j, i, j - 1, f, t),
               _solve(i - 1, j, i, j + 1, f, t), _solve(i + 1, j, i, j + 1, f, t))


def _dilate_cross(m: np.ndarray) -> np.ndarray:
    p = np.pad(m, 1)
    return np.maximum.reduce([m, p[:-2, 1:-1], p[2:, 1:-1], p[1:-1, :-2], p[1:-1, 2:]])


def _dilate_rect(m: np.ndarray, r: int) -> np.ndarray:
    h, w = m.shape
    p = np.pad(m, r)
    out = m.copy()
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            np.maximum(out, p[dy:dy + h, dx:dx + w], out=out)
    return out


def _zero_border(m: np.ndarray) -> None:
    m[0, :] = m[-1, :] = 0
    m[:, 0] = m[:, -1] = 0


def inpaint_telea(img: np.ndarray, mask: np.ndarray, radius: float = 3) -> np.ndarray:
    """``cv2.inpaint(img, mask, radius, INPAINT_TELEA)`` for a uint8 ``(H,
    W)`` or ``(H, W, 3)`` image; ``mask`` nonzero where to inpaint."""
    if img.dtype != np.uint8:
        raise TypeError(f"inpaint_telea takes uint8 images, got {img.dtype}")
    rng = max(min(int(round(radius)), 100), 1)
    ys, xs = np.nonzero(mask)
    if not len(ys):
        return img.copy()
    # every read lies within rng + 2 of the mask, so a crop with that margin
    # (the image's edges kept where it reaches them) gives the same pixels
    margin = rng + 3
    y0, y1 = max(int(ys.min()) - margin, 0), min(int(ys.max()) + margin + 1, img.shape[0])
    x0, x1 = max(int(xs.min()) - margin, 0), min(int(xs.max()) + margin + 1, img.shape[1])
    result = img.copy()
    result[y0:y1, x0:x1] = _inpaint_telea(img[y0:y1, x0:x1], mask[y0:y1, x0:x1], rng)
    return result


def _inpaint_telea(img: np.ndarray, mask: np.ndarray, rng: int) -> np.ndarray:
    h, w = img.shape[:2]
    out = img.reshape(h, w, -1).astype(np.int64)
    # extended (h + 2, w + 2) planes, as cvInpaint's
    inside = np.zeros((h + 2, w + 2), np.uint8)
    inside[1:-1, 1:-1][np.asarray(mask) != 0] = _INSIDE
    t = np.full((h + 2, w + 2), f32(1e6), f32)
    band = _dilate_cross(inside) - inside
    _zero_border(band)
    band_px = [(int(i), int(j)) for i, j in zip(*np.nonzero(band))]
    if not band_px:
        return img.copy()
    t[band != 0] = 0
    # the outward pass: the known ring within `rng` of the mask gets
    # negative distances (icvCalcFMM with negate)
    ring = _dilate_rect(inside, rng) - inside - band
    _zero_border(ring)
    queue = _Queue()
    for i, j in band_px:
        queue.push(i, j, 0.0)
    while True:
        p = queue.pop()
        if p is None:
            break
        ii, jj = p
        ring[ii, jj] = _CHANGE
        for i, j in ((ii - 1, jj), (ii, jj - 1), (ii + 1, jj), (ii, jj + 1)):
            if i <= 0 or j <= 0 or i > h + 2 or j > w + 2 or ring[i, j] != _INSIDE:
                continue
            d = _arrival(i, j, ring, t)
            t[i, j] = d
            ring[i, j] = _BAND
            queue.push(i, j, d)
    changed = ring == _CHANGE
    t[changed] = -t[changed]
    _Telea(inside, t, out, rng).run(band_px)
    return out.astype(np.uint8).reshape(img.shape)


class _Telea:
    """``icvTeleaInpaintFMM``: pixels filled in the fast-marching order, each
    from the known pixels within ``rng`` of it.  The state is kept flat on
    the extended plane padded by ``rng + 1`` (so that no window leaves it):
    ``usable`` (a known plane pixel), ``code_x`` / ``code_y`` (which of a
    pixel's right / left, lower / upper neighbours are known, 2 + 1), the
    arrival times, and the image as float32; ``taps`` holds each plane
    pixel's nine image indices (its value, then cv2's gradient taps at the
    edge-shifted rows and columns ``k - 1 + (k == 1)``, ``k - 1 - (k ==
    h)``)."""

    def __init__(self, f: np.ndarray, t: np.ndarray, out: np.ndarray, rng: int):
        self.f, self.t, self.out, self.rng = f, t, out, rng
        h, w = out.shape[:2]
        self.h, self.w = h, w
        pad = rng + 1
        self.pad = pad
        hp, wp = h + 2 + 2 * pad, w + 2 + 2 * pad
        self.wp = wp
        ky, kx = np.mgrid[-rng:rng + 1, -rng:rng + 1]
        circle = ((ky * ky + kx * kx <= rng * rng) & ((ky != 0) | (kx != 0))).ravel()
        ky, kx = ky.ravel()[circle], kx.ravel()[circle]  # window offsets, row-major
        self.offsets = ky * wp + kx
        self.rx, self.ry = (-kx).astype(f32), (-ky).astype(f32)  # r = (j - l, i - k)
        vl = (self.rx * self.rx + self.ry * self.ry).astype(f32).astype(f64)
        self.dst = (1.0 / (vl * np.sqrt(vl))).astype(f32)
        known = np.ones((hp, wp), np.int64)
        known[pad:pad + h + 2, pad:pad + w + 2] = f != _INSIDE
        usable = np.zeros((hp, wp), bool)
        usable[pad + 1:pad + h + 1, pad + 1:pad + w + 1] = known[pad + 1:pad + h + 1,
                                                                  pad + 1:pad + w + 1]
        code_x = np.zeros((hp, wp), np.int64)
        code_y = np.zeros((hp, wp), np.int64)
        code_x[:, 1:-1] = 2 * known[:, 2:] + known[:, :-2]
        code_y[1:-1] = 2 * known[2:] + known[:-2]
        self.usable, self.code_x, self.code_y = usable.ravel(), code_x.ravel(), code_y.ravel()
        tp = np.zeros((hp, wp), f32)
        tp[pad:pad + h + 2, pad:pad + w + 2] = t
        self.tp = tp.ravel()
        self.img = out.reshape(h * w, -1).astype(f32)
        # image indices of each plane pixel (k, l), 1 <= k <= h, 1 <= l <= w
        k = np.arange(hp)[:, None] - pad
        l = np.arange(wp)[None, :] - pad
        kc, lc = np.clip(k, 1, h), np.clip(l, 1, w)
        km, kp = kc - 1 + (kc == 1), kc - 1 - (kc == h)
        lm, lp = lc - 1 + (lc == 1), lc - 1 - (lc == w)
        c = lambda v, n: np.clip(v, 0, n - 1)  # noqa: E731 (only a frame of one pixel clips)
        taps = [(kc - 1, lc - 1),
                (km, c(lp + 1, w)), (km, lp), (km, c(lm - 1, w)), (km, lm),  # x: a1, a0, b1, b0
                (c(kp + 1, h), lm), (kp, lm), (c(km - 1, h), lm), (km, lm)]  # y: a1, a0, b1, b0
        self.taps = np.stack([(np.broadcast_to(c(r, h), (hp, wp)) * w
                               + np.broadcast_to(c(q, w), (hp, wp))).ravel() for r, q in taps])

    def _flat(self, i: int, j: int) -> int:
        return (i + self.pad) * self.wp + (j + self.pad)

    def _mark_known(self, i: int, j: int) -> None:
        q = self._flat(i, j)
        if 1 <= i <= self.h and 1 <= j <= self.w:
            self.usable[q] = True
        self.code_x[q - 1] += 2
        self.code_x[q + 1] += 1
        self.code_y[q - self.wp] += 2
        self.code_y[q + self.wp] += 1

    def run(self, band_px) -> None:
        f, t, out = self.f, self.t, self.out
        h, w = self.h, self.w
        queue = _Queue()
        for i, j in band_px:
            queue.push(i, j, 0.0)
        while True:
            p = queue.pop()
            if p is None:
                return
            ii, jj = p
            f[ii, jj] = _KNOWN  # a band pixel: known already
            for i, j in ((ii - 1, jj), (ii, jj - 1), (ii + 1, jj), (ii, jj + 1)):
                if i <= 0 or j <= 0 or i > h or j > w or f[i, j] != _INSIDE:
                    continue
                d = _arrival(i, j, f, t)
                t[i, j] = d
                self.tp[self._flat(i, j)] = d
                value = self._value(i, j)
                out[i - 1, j - 1] = value
                self.img[(i - 1) * w + (j - 1)] = value
                f[i, j] = _BAND
                self._mark_known(i, j)
                queue.push(i, j, d)

    def _grad_t(self, i: int, j: int):
        f, t = self.f, self.t
        tij = t[i, j]
        if f[i, j + 1] != _INSIDE:
            gx = ((t[i, j + 1] - t[i, j - 1]) * f32(0.5) if f[i, j - 1] != _INSIDE
                  else t[i, j + 1] - tij)
        else:
            gx = tij - t[i, j - 1] if f[i, j - 1] != _INSIDE else f32(0)
        if f[i + 1, j] != _INSIDE:
            gy = ((t[i + 1, j] - t[i - 1, j]) * f32(0.5) if f[i - 1, j] != _INSIDE
                  else t[i + 1, j] - tij)
        else:
            gy = tij - t[i - 1, j] if f[i - 1, j] != _INSIDE else f32(0)
        return f32(gx), f32(gy)

    _FACTOR = np.array([0, 1, 1, 2], f32)  # the gradient's factor by code: none, one side, both

    def _value(self, i: int, j: int) -> np.ndarray:
        """The inpainted colour of extended pixel ``(i, j)``: Telea's
        weighted sum over the known window, float32 in OpenCV's order."""
        flat = self._flat(i, j) + self.offsets
        use = self.usable[flat]
        sel = flat[use]
        rx, ry = self.rx[use], self.ry[use]
        gx, gy = self._grad_t(i, j)
        lev = (1.0 / (f32(1) + np.abs(self.tp[sel] - self.t[i, j])).astype(f64)).astype(f32)
        dr = (rx * gx).astype(f32) + (ry * gy).astype(f32)
        dr[np.abs(dr) <= f32(0.01)] = f32(1e-6)
        wt = np.abs((self.dst[use] * lev).astype(f32) * dr)
        cx, cy = self.code_x[sel], self.code_y[sel]
        g = self.img[self.taps[:, sel]]  # (9, n, C)
        gix = (np.where((cx >= 2)[:, None], g[1], g[2]) - np.where((cx & 1)[:, None] > 0, g[3], g[4]))
        giy = (np.where((cy >= 2)[:, None], g[5], g[6]) - np.where((cy & 1)[:, None] > 0, g[7], g[8]))
        gix *= self._FACTOR[cx][:, None]
        giy *= self._FACTOR[cy][:, None]
        n, ch = g.shape[1], g.shape[2]
        terms = np.empty((3 * ch + 1, n + 1), f32)
        terms[:, 0] = 0
        terms[-1, 0] = f32(1e-20)
        wc = wt[:, None]
        terms[:ch, 1:] = (wc * g[0]).T
        terms[ch:2 * ch, 1:] = -(wc * (gix * rx[:, None])).T
        terms[2 * ch:3 * ch, 1:] = -(wc * (giy * ry[:, None])).T
        terms[-1, 1:] = wt
        sums = np.cumsum(terms, axis=1, dtype=f32)[:, -1]
        ia, jx, jy, s = sums[:ch], sums[ch:2 * ch], sums[2 * ch:3 * ch], sums[-1]
        norm = np.sqrt(jx * jx + jy * jy) + f32(1e-20)
        sat = (ia / s + (jx + jy) / norm) + f32(0.5)
        return np.clip(np.rint(sat), 0, 255).astype(np.int64)
