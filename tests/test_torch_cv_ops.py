"""The port's numpy copies of OpenCV (``data/cv_ops.py``) and its PNG decoder
(``data/image_io.py``) against ``cv2`` 5.0 on the CPU, byte for byte.

Each op runs on seeded inputs (20 or more a case): odd sizes, 1 and 3
channels, every border mode the augmentations use, and rotations, scales
and shifts from the configs' ranges (ShiftScaleRotate's and InstaBoost's).
TELEA inpainting runs on dilated polygon masks (InstaBoost's cut) and on
scattered pixels, at and away from the image's edges.  No JAX.
"""
import os
import sys
import zlib

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

cv2 = pytest.importorskip("cv2")

from boosting_rcnn_tpu_torch.data import cv_ops  # noqa: E402
from boosting_rcnn_tpu_torch.data.image_io import (_filter_row, load_image,  # noqa: E402
                                                   load_png_gray, write_png)

CASES = 20
BORDERS = {cv_ops.BORDER_CONSTANT: cv2.BORDER_CONSTANT,
           cv_ops.BORDER_REFLECT_101: cv2.BORDER_REFLECT_101}


def _image(rs, h, w, channels, smooth=False):
    img = rs.randint(0, 256, (h, w, channels) if channels > 1 else (h, w)).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 0) if smooth else img


def test_fma32_rounds_once():
    rs = np.random.RandomState(0)
    a, b, c = (rs.randn(100000).astype(np.float32) * 100 for _ in range(3))
    got = cv_ops.fma32(a, b, c)
    exact = np.array([float(x) * float(y) + float(z) for x, y, z in zip(a, b, c)])
    # correctly rounded: no float32 lies closer to the exact value
    err = np.abs(got.astype(np.float64) - exact)
    for other in (np.nextafter(got, np.float32(np.inf)), np.nextafter(got, np.float32(-np.inf))):
        assert (err <= np.abs(other.astype(np.float64) - exact)).all()


def test_fma32_at_float32_ties():
    """Products on a float32 midpoint (odd multiples of 2^-24 in [1, 2),
    ``u * (v * 2^-24)``) plus +-2^-60, which the float64 sum drops: the
    exact value lies past the tie, on the addend's side."""
    rs = np.random.RandomState(3)
    u, v = rs.randint(1 << 11, 1 << 12, (2, 20000)) * 2 + 1
    keep = (u * v >= 1 << 24) & (u * v < 1 << 25)
    u, v = u[keep], v[keep]
    sign = rs.choice([-1.0, 1.0], len(u))
    a = u.astype(np.float32)
    b = (v * 2.0 ** -24).astype(np.float32)
    c = (sign * 2.0 ** -60).astype(np.float32)
    mid = u.astype(np.float64) * v * 2.0 ** -24
    assert len(u) > 1000 and np.array_equal(a.astype(np.float64) * b + c, mid)  # every sum a tie
    want = mid + sign * 2.0 ** -24  # the float32 neighbour on the addend's side
    np.testing.assert_array_equal(cv_ops.fma32(a, b, c).astype(np.float64), want)


def test_rotation_matrix_matches_cv2():
    rs = np.random.RandomState(1)
    for _ in range(200):
        c = (rs.uniform(0, 2048), rs.uniform(0, 1024))
        a, s = rs.uniform(-180, 180), rs.uniform(0.5, 2.0)
        np.testing.assert_array_equal(cv_ops.get_rotation_matrix_2d(c, a, s),
                                      cv2.getRotationMatrix2D(c, a, s))


@pytest.mark.parametrize("channels", [1, 3])
def test_resize_linear_matches_cv2(channels):
    rs = np.random.RandomState(2 + channels)
    sizes = [(rs.randint(3, 90), rs.randint(3, 90), rs.randint(2, 150), rs.randint(2, 150))
             for _ in range(CASES)] + [(40, 60, 20, 30), (33, 47, 66, 94), (1, 5, 3, 7)]
    for h, w, nh, nw in sizes:
        img = _image(rs, h, w, channels)
        np.testing.assert_array_equal(cv_ops.resize_linear(img, nw, nh),
                                      cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR),
                                      err_msg=str((h, w, nh, nw)))


def test_resize_linear_full_frames():
    """LSJ's resizes of a full Cityscapes frame, down and up."""
    img = _image(np.random.RandomState(4), 1024, 2048, 3, smooth=True)
    for nw, nh in ((1111, 555), (2867, 1434)):
        np.testing.assert_array_equal(cv_ops.resize_linear(img, nw, nh),
                                      cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("linear", [True, False])
@pytest.mark.parametrize("border", sorted(BORDERS))
@pytest.mark.parametrize("channels", [1, 3])
def test_warp_affine_matches_cv2(linear, border, channels):
    rs = np.random.RandomState(10 + 2 * linear + channels)
    for k in range(CASES):
        h, w = rs.randint(5, 140, 2)
        img = _image(rs, h, w, channels, smooth=k % 2 == 0)
        if k % 2:  # ShiftScaleRotate's: about the centre, shifts of 0.0625 of the frame
            m = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), rs.uniform(-45, 45),
                                        1 + rs.uniform(-0.1, 0.1))
            m[0, 2] += rs.uniform(-0.0625, 0.0625) * w
            m[1, 2] += rs.uniform(-0.0625, 0.0625) * h
        else:  # InstaBoost's: about an instance's centre, scale 0.8-1.2, 1 degree
            cx, cy = np.float32(rs.uniform(0, w)), np.float32(rs.uniform(0, h))
            m = cv2.getRotationMatrix2D((float(cx), float(cy)), rs.uniform(-1, 1),
                                        rs.uniform(0.8, 1.2))
            m[0, 2] += rs.uniform(-3, 3)
            m[1, 2] += rs.uniform(-3, 3)
        ref = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR if linear
                             else cv2.INTER_NEAREST, borderMode=BORDERS[border])
        got = cv_ops.warp_affine(img, m, (w, h), linear=linear, border_mode=border)
        np.testing.assert_array_equal(got, ref, err_msg=f"case {k}: {h} x {w}")


@pytest.mark.parametrize("k", [3, 5, 7])
def test_blur_matches_cv2(k):
    rs = np.random.RandomState(20 + k)
    for _ in range(CASES):
        img = _image(rs, rs.randint(4, 70), rs.randint(4, 70), [1, 3][rs.randint(2)])
        np.testing.assert_array_equal(cv_ops.blur(img, k), cv2.blur(img, (k, k)))


@pytest.mark.parametrize("k", [3, 5])
def test_median_blur_matches_cv2(k):
    rs = np.random.RandomState(30 + k)
    for _ in range(CASES):
        img = _image(rs, rs.randint(3, 70), rs.randint(3, 70), [1, 3][rs.randint(2)])
        np.testing.assert_array_equal(cv_ops.median_blur(img, k), cv2.medianBlur(img, k))


def test_dilate3_matches_cv2():
    rs = np.random.RandomState(40)
    for _ in range(CASES):
        mask = (rs.rand(rs.randint(2, 60), rs.randint(2, 60)) < 0.08).astype(np.uint8)
        np.testing.assert_array_equal(cv_ops.dilate3(mask),
                                      cv2.dilate(mask, np.ones((3, 3), np.uint8)))


def test_hsv_round_trip_matches_cv2():
    """RGB -> HSV, and HSV -> RGB at widths with and without a SIMD tail."""
    rs = np.random.RandomState(41)
    for k in range(CASES):
        h, w = rs.randint(1, 40), [rs.randint(1, 130), 32, 64, 33][k % 4]
        img = _image(rs, h, w, 3)
        np.testing.assert_array_equal(cv_ops.rgb_to_hsv(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
        hsv = img.copy()
        hsv[..., 0] %= 180
        np.testing.assert_array_equal(cv_ops.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def _telea_cases(seed, edges):
    rs = np.random.RandomState(seed)
    for k in range(CASES):
        h, w = rs.randint(12, 48, 2)
        img = _image(rs, h, w, [1, 3][k % 2], smooth=k % 3 > 0)
        mask = np.zeros((h, w), np.uint8)
        if edges:  # a blob across a corner or an edge of the frame
            corner = np.array([[-6, -6], [w - 14, -6], [-6, h - 14], [w - 14, h - 14]][k % 4])
            pts = rs.rand(6, 2) * [20, 20] + corner
        else:
            pts = rs.rand(6, 2) * [w * 0.5, h * 0.5] + [w * 0.25, h * 0.25]
        cv2.fillPoly(mask, [cv2.convexHull(pts.astype(np.int32))], 1)
        if k % 4 == 1:  # scattered single pixels: protrusions and diagonal neighbours
            mask[rs.rand(h, w) < 0.05] = 1
            yield img, mask
        else:  # InstaBoost's cut: the mask dilated by 3 x 3
            yield img, cv2.dilate(mask, np.ones((3, 3), np.uint8))


@pytest.mark.parametrize("edges", [False, True])
def test_inpaint_telea_matches_cv2(edges):
    inpainted = 0
    for img, mask in _telea_cases(50 + edges, edges):
        ref = cv2.inpaint(img, mask, 3, cv2.INPAINT_TELEA)
        np.testing.assert_array_equal(cv_ops.inpaint_telea(img, mask, 3), ref)
        inpainted += int(mask.sum())
    assert inpainted > 2000


def test_inpaint_telea_radius_and_empty_mask():
    rs = np.random.RandomState(60)
    img = _image(rs, 30, 40, 3, smooth=True)
    mask = np.zeros((30, 40), np.uint8)
    np.testing.assert_array_equal(cv_ops.inpaint_telea(img, mask, 3), img)
    mask[10:18, 12:25] = 1
    for radius in (1, 2, 5):
        np.testing.assert_array_equal(cv_ops.inpaint_telea(img, mask, radius),
                                      cv2.inpaint(img, mask, radius, cv2.INPAINT_TELEA))


def _png_with_filters(path, img, filters):
    """An 8-bit PNG of ``img`` (gray, RGB or RGBA samples as given) whose row
    ``y`` takes filter ``filters[y % len(filters)]``."""
    import struct

    px = img if img.ndim == 3 else img[..., None]
    h, w, c = px.shape
    prior = np.zeros((w, c), np.uint8)
    scan = bytearray()
    for y in range(h):
        f = filters[y % len(filters)]
        scan.append(f)
        scan += np.stack([_filter_row(f, px[y, :, k], prior[:, k]) for k in range(c)],
                         -1).tobytes()
        prior = px[y]

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                                                  0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(scan))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_decoder_matches_cv2_imread(tmp_path, channels):
    """Gray, gray + alpha, RGB and RGBA PNGs, each row filter and mixes of
    them, and cv2's own PNGs: ``load_image`` gives ``cv2.imread``'s BGR."""
    rs = np.random.RandomState(70 + channels)
    for k, filters in enumerate([(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 3, 1)]):
        h, w = rs.randint(1, 40, 2)
        img = rs.randint(0, 256, (h, w, channels)).astype(np.uint8)[..., :channels]
        if channels == 1:
            img = img[..., 0]
        path = str(tmp_path / f"f{k}.png")
        _png_with_filters(path, img, filters)
        np.testing.assert_array_equal(load_image(path), cv2.imread(path, cv2.IMREAD_COLOR))
    if channels in (1, 3, 4):  # libpng's adaptive filters
        img = _image(rs, 37, 53, channels)
        path = str(tmp_path / "cv2.png")
        cv2.imwrite(path, img)
        np.testing.assert_array_equal(load_image(path), cv2.imread(path, cv2.IMREAD_COLOR))
        if channels == 1:
            np.testing.assert_array_equal(load_png_gray(path), img)


def test_png_writer_is_read_by_cv2(tmp_path):
    rs = np.random.RandomState(80)
    img = rs.randint(0, 256, (21, 34, 3)).astype(np.uint8)
    path = str(tmp_path / "w.png")
    write_png(path, img, filters=(0, 1, 2, 3, 4))
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR), img)
