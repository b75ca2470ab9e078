"""Image files to BGR uint8 arrays, as ``cv2.imread(path, IMREAD_COLOR)``
gives them (the JAX package's ``data/pipeline.py::load_image``).

Binary PPM (``P6``) and PGM (``P5``) with a maximum value of 255, and
8-bit non-interlaced PNG (grayscale, RGB, RGBA, gray with alpha; zlib and
the five row filters) decode with numpy alone, as ``cv2.imread`` gives
them (gray repeated, alpha dropped, BGR); every other format goes through
``cv2`` where it imports, else PIL where it imports, else the call raises
naming the format.  Lossless formats decode to the same bytes by any
route.

``load_png_gray`` reads the 8-bit grayscale PNG stuff maps of
``seg_prefix`` (COCO-stuff's ``stuffthingmaps`` layout) with zlib and
numpy alone, as ``cv2.imread(path, IMREAD_GRAYSCALE)`` gives them, and
``write_png_gray`` writes them; ``write_png`` writes gray or RGB.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = ["load_image", "write_ppm", "load_png_gray", "write_png", "write_png_gray"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_COLOR_TYPES = {0: "grayscale", 2: "RGB", 3: "palette", 4: "grayscale with alpha",
                    6: "RGBA"}


def _netpbm_header(data: bytes):
    """``(magic, width, height, maxval, offset of the pixels)`` of a binary
    PPM/PGM file (comments after ``#`` skipped)."""
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        if end == pos:
            raise ValueError("truncated PPM/PGM header")
        fields.append(data[pos:end])
        pos = end
    return fields[0], int(fields[1]), int(fields[2]), int(fields[3]), pos + 1


def _read_netpbm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    magic, w, h, maxval, off = _netpbm_header(data)
    if maxval != 255:
        raise ValueError(f"{path}: PPM/PGM with maximum value {maxval}; only 255 decodes "
                         f"without cv2 or PIL")
    ch = 3 if magic == b"P6" else 1
    px = np.frombuffer(data, np.uint8, count=h * w * ch, offset=off).reshape(h, w, ch)
    if ch == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., ::-1])  # RGB on disk, BGR out


def load_image(path: str) -> np.ndarray:
    """``(H, W, 3)`` BGR uint8 image of the file at ``path``."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic[:2] in (b"P5", b"P6"):
        return _read_netpbm(path)
    if magic == PNG_SIGNATURE:
        png = _png_header(path)
        if _decodes_with_numpy(*png[2:5]):
            return _png_to_bgr(_png_samples(path, png))
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"cv2 cannot decode {path}")
        return img
    try:
        from PIL import Image
    except ImportError:
        ext = os.path.splitext(path)[1] or "(no extension)"
        raise RuntimeError(
            f"{path}: decoding {ext} images needs cv2 or PIL, and neither imports; "
            f"binary PPM/PGM decode without them") from None
    with Image.open(path) as im:
        return np.ascontiguousarray(np.asarray(im.convert("RGB"))[..., ::-1])


def write_ppm(path: str, bgr: np.ndarray) -> None:
    """Write an ``(H, W, 3)`` BGR uint8 image as binary PPM (``P6``)."""
    h, w = bgr.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(bgr[..., ::-1], np.uint8).tobytes())


def _png_chunks(data: bytes, path: str):
    """``(type, payload)`` of each chunk of a PNG file's bytes."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _unfilter_row(ftype: int, raw: np.ndarray, prior: np.ndarray) -> np.ndarray:
    """One scanline of one byte a pixel with its PNG filter (None, Sub or
    Up) undone."""
    if ftype == 0:
        return raw
    if ftype == 1:  # Sub: a running sum mod 256
        return np.cumsum(raw, dtype=np.uint8)
    return raw + prior  # Up


_PREDICTORS = None  # see _predictor_table


def _predictor_table() -> np.ndarray:
    """``table[f * 511**2 + (a - c + 255) * 511 + (b - c + 255)]``: PNG
    filter ``f``'s (1-4) predictor less ``c``, from the left byte ``a``,
    the upper ``b`` and the upper-left ``c`` (filter 0's entries are 0;
    its predictor, 0, is handled by the caller).  Every predictor is ``c``
    plus a function of ``a - c`` and ``b - c``, Average's
    ``floor((a + b) / 2)`` too."""
    global _PREDICTORS
    if _PREDICTORS is None:
        da = np.arange(-255, 256)[:, None]
        db = np.arange(-255, 256)[None, :]
        pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)  # |p - a|, |p - b|, |p - c|
        paeth = np.where((pa <= pb) & (pa <= pc), da, np.where(pb <= pc, db, 0))
        zero = np.zeros_like(paeth)
        _PREDICTORS = np.stack([zero, da + zero, db + zero, (da + db) >> 1, paeth]).astype(
            np.int32).ravel()
    return _PREDICTORS


def _unfilter_diagonals(types: np.ndarray, raw: np.ndarray, prior: np.ndarray) -> np.ndarray:
    """Rows ``raw`` ``(k, w)`` of PNG filter types ``types`` (0-4) under the
    decoded row ``prior``, with their filters undone along anti-diagonals.
    A byte's predictor reads its left, upper and upper-left neighbours
    only, which lie on the two diagonals before its own, so each of the
    ``k + w - 1`` diagonals is a few vector operations whatever the rows'
    filters (Average and Paeth rows need a step a byte along a row).  The
    bytes are kept skewed: with the prior row above and a zero column on
    the left, byte ``(y, x)`` of the padded rows sits at ``[x + y, y]``,
    so each diagonal is one contiguous row."""
    k, w = raw.shape
    table = _predictor_table()
    skewed = np.zeros((k + w + 1, k + 1), np.int32)
    src = np.zeros_like(skewed)

    def padded(a: np.ndarray) -> np.ndarray:  # the (k + 1, w + 1) padded rows' view
        step = a.itemsize
        return np.lib.stride_tricks.as_strided(a, shape=(k + 1, w + 1),
                                               strides=((k + 2) * step, (k + 1) * step))

    padded(skewed)[0, 1:] = prior
    padded(src)[1:, 1:] = raw
    base = np.zeros(k + 1, np.int32)
    base[1:] = types * 511 ** 2 + 255 * 511 + 255
    keep_c = np.zeros(k + 1, np.int32)  # 0 on a None row, whose predictor is 0, not c
    keep_c[1:] = types != 0
    all_c = bool(keep_c[1:].all())
    da, db = np.empty(min(k, w), np.int32), np.empty(min(k, w), np.int32)
    for d in range(2, k + w + 1):
        lo, hi = max(1, d - w), min(k, d - 1) + 1
        a, b, c = skewed[d - 1, lo:hi], skewed[d - 1, lo - 1:hi - 1], skewed[d - 2, lo - 1:hi - 1]
        x, y = da[:hi - lo], db[:hi - lo]
        np.subtract(a, c, out=x)
        np.subtract(b, c, out=y)
        x *= 511
        x += y
        x += base[lo:hi]
        out = skewed[d, lo:hi]
        table.take(x, out=out)
        out += src[d, lo:hi]
        if all_c:
            out += c
        else:
            np.multiply(c, keep_c[lo:hi], out=y)
            out += y
        out &= 255
    return padded(skewed)[1:, 1:].astype(np.uint8)


_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # 8-bit colour types numpy decodes


def _png_header(path: str):
    """``(width, height, depth, colour type, interlace, zlib stream)`` of a
    PNG file."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, payload in _png_chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload[:13])
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    return w, h, depth, color, interlace, b"".join(idat)


def _decodes_with_numpy(depth: int, color: int, interlace: int) -> bool:
    return depth == 8 and color in _PNG_CHANNELS and not interlace


def _unfilter_plane(types: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """One byte plane ``(h, w)`` with its rows' PNG filters undone: rows from
    the first Average or Paeth row to the last along diagonals
    (``_unfilter_diagonals``), the others a row at a time."""
    h, w = rows.shape
    slow = np.flatnonzero(types >= 3)
    first, last = (int(slow[0]), int(slow[-1]) + 1) if slow.size else (h, h)
    out = np.zeros((h, w), np.uint8)
    prior = out[0]
    for y in range(first):
        out[y] = prior = _unfilter_row(int(types[y]), rows[y], prior)
    if slow.size:
        out[first:last] = _unfilter_diagonals(types[first:last], rows[first:last], prior)
        prior = out[last - 1]
    for y in range(last, h):
        out[y] = prior = _unfilter_row(int(types[y]), rows[y], prior)
    return out


def _png_samples(path: str, png) -> np.ndarray:
    """The ``(H, W, C)`` uint8 samples of the PNG whose ``_png_header`` is
    ``png``, an 8-bit non-interlaced one of colour type 0, 2, 4 or 6 (any
    of the five filter types): each of the ``C`` interleaved byte planes is
    unfiltered on its own, a byte's left neighbour being the pixel before
    it."""
    w, h, depth, color, interlace, stream = png
    c = _PNG_CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(stream), np.uint8)
    if rows.size != h * (w * c + 1):
        raise ValueError(f"{path}: {rows.size} bytes of scanlines for {w} x {h} x {c}")
    rows = rows.reshape(h, w * c + 1)
    types = rows[:, 0].astype(np.int32)
    if types.max(initial=0) > 4:
        raise ValueError(f"{path}: PNG filter type {types.max()} is not one of 0-4")
    planes = rows[:, 1:].reshape(h, w, c)
    return np.stack([_unfilter_plane(types, np.ascontiguousarray(planes[..., k]))
                     for k in range(c)], axis=-1)


def load_png_gray(path: str) -> np.ndarray:
    """The ``(H, W)`` uint8 pixels of an 8-bit grayscale, non-interlaced PNG
    (colour type 0, any of the five filter types); other PNGs raise,
    naming their type."""
    png = _png_header(path)
    _, _, depth, color, interlace, _ = png
    if color != 0 or depth != 8:
        kind = _PNG_COLOR_TYPES.get(color, f"colour type {color}")
        raise ValueError(f"{path}: a {depth}-bit {kind} PNG (colour type {color}); only 8-bit "
                         f"grayscale (colour type 0) decodes without cv2 or PIL")
    if interlace:
        raise ValueError(f"{path}: an interlaced PNG; only non-interlaced ones decode")
    return _png_samples(path, png)[..., 0]


def _png_to_bgr(px: np.ndarray) -> np.ndarray:
    """``cv2.imread(..., IMREAD_COLOR)``'s BGR of decoded PNG samples: gray
    repeated, alpha dropped."""
    if px.shape[2] <= 2:
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., 2::-1])


def _filter_row(ftype: int, row: np.ndarray, prior: np.ndarray) -> np.ndarray:
    """One scanline filtered with PNG filter ``ftype`` (0-4)."""
    left = np.concatenate([[0], row[:-1]]).astype(np.int32)
    up, r = prior.astype(np.int32), row.astype(np.int32)
    if ftype == 0:
        pred = np.zeros_like(r)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) >> 1
    else:
        upleft = np.concatenate([[0], up[:-1]])
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    return ((r - pred) & 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filters=(0,)) -> None:
    """Write an ``(H, W)`` uint8 image as 8-bit grayscale PNG, or an ``(H,
    W, 3)`` BGR one as 8-bit RGB (the byte order ``cv2.imwrite`` writes);
    row ``y`` takes the filter type ``filters[y % len(filters)]`` (0-4)."""
    img = np.ascontiguousarray(img, np.uint8)
    planes = [img] if img.ndim == 2 else [img[..., 2], img[..., 1], img[..., 0]]
    h, w = planes[0].shape
    if all(int(f) == 0 for f in filters):  # no filter: the rows as they are, a 0 byte each
        rows = np.stack(planes, axis=-1).reshape(h, -1)
        scan = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    else:
        priors = [np.zeros(w, np.uint8) for _ in planes]
        scan = bytearray()
        for y in range(h):
            ftype = int(filters[y % len(filters)])
            scan.append(ftype)
            # a byte's left neighbour is the pixel before it: filter each plane, interleave
            rows = [_filter_row(ftype, pl[y], pr) for pl, pr in zip(planes, priors)]
            scan += np.stack(rows, axis=-1).tobytes()
            priors = [pl[y] for pl in planes]

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    color = 0 if img.ndim == 2 else 2
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(scan), 1)) + chunk(b"IEND", b""))


def write_png_gray(path: str, img: np.ndarray, filters=(0,)) -> None:
    """Write an ``(H, W)`` uint8 image as an 8-bit grayscale PNG; row ``y``
    takes the filter type ``filters[y % len(filters)]`` (0-4)."""
    write_png(path, np.asarray(img, np.uint8).reshape(np.shape(img)[:2]), filters)
