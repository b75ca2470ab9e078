"""Image files to BGR uint8 arrays, as ``cv2.imread(path, IMREAD_COLOR)``
gives them (the JAX package's ``data/pipeline.py::load_image``).

Binary PPM (``P6``) and PGM (``P5``) with a maximum value of 255 decode
with numpy alone; every other format goes through ``cv2`` where it
imports, else PIL where it imports, else the call raises naming the
format.  Lossless formats decode to the same bytes by either route.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["load_image", "write_ppm"]


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
        magic = f.read(2)
    if magic in (b"P5", b"P6"):
        return _read_netpbm(path)
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
