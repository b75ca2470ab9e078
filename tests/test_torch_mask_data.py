"""The PyTorch port's mask data path (``data/mask_utils.py``, the PNG
stuff maps of ``data/image_io.py``, ``preprocess`` with segmentations and
a stuff map) against the JAX package's, which rasterises, resizes and
reads with OpenCV, on the CPU.

  * ``fill_poly`` through ``polygons_to_box_crop`` and
    ``polygons_to_bitmap``: byte for byte on seeded polygons of every kind
    (convex, concave, self-intersecting, multi-part, two- and one-point,
    horizontal edges, points outside the grid), and ``fill_poly`` itself
    against ``cv2.fillPoly`` on small grids;
  * the nearest resize byte for byte and the linear resize within 5e-6 of
    ``cv2.resize`` over many size pairs (values in [0, 1); cv2 forms its
    weights otherwise, 70% of values differ in their last bits);
  * ``rle_to_box_crop`` byte for byte (boxes inside, across and outside
    the image; compressed counts give an empty crop);
  * ``paste_mask``: bit-equal but at pixels whose cv2 value lies within
    1e-5 of the threshold, which are counted and few;
  * ``crop_mask_iou`` and ``mask_iou_matrix`` equal;
  * the 8-bit grayscale PNG decoder against ``cv2.imread(...,
    IMREAD_GRAYSCALE)`` on files of ``cv2.imwrite`` at compression levels
    0, 1 and 9 and of ``write_png_gray`` with each filter type and with
    seeded per-row mixes of them; other colour types and filter types
    raise naming theirs;
  * ``preprocess`` with polygon, RLE and bitmap segmentations and a stuff
    map, flipped and not, portrait on the landscape canvas: the crops and
    ``gt_semantic_seg`` byte-equal to the JAX ``preprocess``, boxes and
    labels equal.
"""
import os
import sys
import zlib

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

cv2 = pytest.importorskip("cv2")

from boosting_rcnn_tpu.data import mask_utils as j_mu  # noqa: E402
from boosting_rcnn_tpu.data import pipeline as j_pipeline  # noqa: E402
from boosting_rcnn_tpu_torch.data import mask_utils as t_mu  # noqa: E402
from boosting_rcnn_tpu_torch.data import pipeline as t_pipeline  # noqa: E402
from boosting_rcnn_tpu_torch.data.image_io import load_png_gray, write_png_gray  # noqa: E402

POLYGONS_PER_KIND = 90


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread: beside the suite's other pytest
    workers, torch's default of a thread a core oversubscribes the host
    (this file's cases ran several times slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _star(rs, c, r, n, concave):
    ang = np.sort(rs.uniform(0, 2 * np.pi, n))
    rr = r * (rs.uniform(0.3, 1.0, n) if concave else np.ones(n))
    return np.stack([c[0] + rr * np.cos(ang), c[1] + rr * np.sin(ang)], 1)


def _polygons(kind, rs, lo, hi):
    """One instance's polygon parts (float ``(P, 2)``) of ``kind``."""
    c, r = rs.uniform(lo, hi, 2), rs.uniform(2, hi - lo)
    if kind == "convex":
        return [_star(rs, c, r, rs.randint(3, 30), False)]
    if kind == "concave":
        return [_star(rs, c, r, rs.randint(5, 40), True)]
    if kind == "self_intersecting":
        return [rs.uniform(lo, hi, (rs.randint(4, 12), 2))]
    if kind == "multi_part":
        return [_star(rs, rs.uniform(lo, hi, 2), rs.uniform(2, hi - lo), rs.randint(3, 12),
                      rs.rand() < 0.5) for _ in range(rs.randint(2, 5))]
    if kind == "degenerate":  # two- and one-point parts, beside a real one
        return [rs.uniform(lo, hi, (rs.randint(1, 3), 2)), _star(rs, c, r, 6, True)]
    if kind == "horizontal_edges":
        p = rs.uniform(lo, hi, (rs.randint(4, 10), 2))
        p[1::2, 1] = p[0::2, 1][:len(p[1::2])]
        return [p]
    # points far outside the grid
    return [rs.uniform(lo - (hi - lo), hi + (hi - lo), (rs.randint(3, 10), 2))
            for _ in range(rs.randint(1, 3))]


KINDS = ("convex", "concave", "self_intersecting", "multi_part", "degenerate",
         "horizontal_edges", "outside")


@pytest.mark.parametrize("kind", KINDS)
def test_box_crops_and_bitmaps_match_cv2(kind):
    """``polygons_to_box_crop`` (at 28 and 112, boxes tight, loose and
    cutting the polygon) and ``polygons_to_bitmap`` byte for byte."""
    rs = np.random.RandomState(KINDS.index(kind))
    for _ in range(POLYGONS_PER_KIND):
        h, w = rs.randint(20, 200), rs.randint(20, 200)
        parts = _polygons(kind, rs, -0.1 * w, 1.1 * w)
        pts = np.concatenate(parts)
        box = np.array([*pts.min(0), *pts.max(0)], np.float64)
        box += rs.uniform(-0.3, 0.3, 4) * (box[2:] - box[:2]).repeat(2) * (rs.rand() < 0.5)
        size = int(rs.choice([28, 112]))
        flat = [p.reshape(-1).tolist() for p in parts]
        np.testing.assert_array_equal(t_mu.polygons_to_box_crop(parts, box, size),
                                      j_mu.polygons_to_box_crop(parts, box, size))
        np.testing.assert_array_equal(t_mu.polygons_to_bitmap(flat, h, w),
                                      j_mu.polygons_to_bitmap(flat, h, w))


def test_fill_poly_matches_cv2_on_small_grids():
    """``fill_poly`` against ``cv2.fillPoly`` where clipping is the rule:
    grids of 1-14 pixels a side, integer points up to 6 outside."""
    rs = np.random.RandomState(7)
    for _ in range(600):
        h, w = rs.randint(1, 15), rs.randint(1, 15)
        polys = [rs.randint(-6, max(h, w) + 6, (rs.randint(1, 7), 2)).astype(np.int32)
                 for _ in range(rs.randint(1, 3))]
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, polys, 1)
        got = t_mu.fill_poly(np.zeros((h, w), np.uint8), polys, 1)
        np.testing.assert_array_equal(got, want, err_msg=str([p.tolist() for p in polys]))


def test_resizes_match_cv2():
    rs = np.random.RandomState(1)
    worst = 0.0
    for sw in range(1, 41):
        for dw in list(range(1, 41)) + [112, 200]:
            sh, dh = int(rs.randint(1, 60)), int(rs.randint(1, 60))
            src = rs.randint(0, 256, (sh, sw)).astype(np.uint8)
            np.testing.assert_array_equal(
                t_mu.resize_nearest(src, dw, dh),
                cv2.resize(src, (dw, dh), interpolation=cv2.INTER_NEAREST))
            f = rs.rand(sh, sw).astype(np.float32)
            got = t_mu.resize_linear(f, dw, dh)
            want = cv2.resize(f, (dw, dh), interpolation=cv2.INTER_LINEAR)
            assert got.dtype == np.float32 and got.shape == want.shape
            worst = max(worst, float(np.abs(got - want).max()))
    assert worst <= 5e-6, worst


def _rle(rs, h, w):
    """An uncompressed COCO RLE of a random blob on an ``(h, w)`` image."""
    m = np.zeros((h, w), np.uint8)
    y0, x0 = rs.randint(0, h), rs.randint(0, w)
    m[y0:y0 + rs.randint(1, h), x0:x0 + rs.randint(1, w)] = 1
    m[rs.rand(h, w) < 0.1] ^= 1
    flat = m.T.reshape(-1)
    change = np.flatnonzero(np.diff(np.concatenate([[0], flat, [1 - flat[-1]]])))
    counts = np.diff(np.concatenate([[0], change])).tolist()
    return dict(size=[h, w], counts=counts), m


def test_rle_crops_match_cv2():
    rs = np.random.RandomState(2)
    for i in range(120):
        h, w = rs.randint(5, 90), rs.randint(5, 90)
        rle, full = _rle(rs, h, w)
        assert np.array_equal(t_mu._rle_full(rle), full)
        box = np.sort(rs.uniform(-10, max(h, w) + 10, (2, 2)), axis=0).T.reshape(-1)[[0, 2, 1, 3]]
        size = int(rs.choice([28, 112]))
        np.testing.assert_array_equal(t_mu.rle_to_box_crop(rle, box, h, w, size),
                                      j_mu.rle_to_box_crop(rle, box, h, w, size))
        np.testing.assert_array_equal(t_mu.polygons_to_bitmap(rle, h, w),
                                      j_mu.polygons_to_bitmap(rle, h, w))
    compressed = dict(size=[20, 30], counts="PQ0c")
    assert not t_mu.rle_to_box_crop(compressed, np.array([2, 2, 9, 9.0]), 20, 30).any()
    assert not t_mu.polygons_to_bitmap(compressed, 20, 30).any()


def test_paste_mask_matches_cv2():
    """Bit-equal but where cv2's value is within 1e-5 of the threshold."""
    rs = np.random.RandomState(3)
    near = total = 0
    for _ in range(200):
        h, w = rs.randint(10, 200), rs.randint(10, 200)
        m = rs.rand(28, 28).astype(np.float32)
        x1, y1 = rs.uniform(-20, w), rs.uniform(-20, h)
        box = np.array([x1, y1, x1 + rs.uniform(0.5, w), y1 + rs.uniform(0.5, h)])
        got, want = t_mu.paste_mask(m, box, h, w), j_mu.paste_mask(m, box, h, w)
        diff = got != want
        total += want.size
        if diff.any():
            x1i, y1i = max(int(np.floor(box[0])), 0), max(int(np.floor(box[1])), 0)
            x2i = min(max(int(np.ceil(box[2])), x1i + 1), w)
            y2i = min(max(int(np.ceil(box[3])), y1i + 1), h)
            ref = cv2.resize(m, (x2i - x1i, y2i - y1i), interpolation=cv2.INTER_LINEAR)
            ys, xs = np.nonzero(diff)
            assert np.all(np.abs(ref[ys - y1i, xs - x1i] - 0.5) <= 1e-5)
            near += len(ys)
    assert near <= 20, f"{near} of {total} pasted pixels differ"


def test_mask_ious_match():
    rs = np.random.RandomState(4)
    h, w = 60, 80
    boxes1 = np.sort(rs.uniform(0, 60, (6, 2, 2)), axis=1).reshape(6, 4)[:, [0, 2, 1, 3]]
    crops = [rs.rand(28, 28).astype(np.float32) for _ in range(5)] + [
        (rs.rand(h, w) > 0.5).astype(np.uint8)]
    bitmaps = [(rs.rand(h, w) > 0.7).astype(np.uint8) for _ in range(4)]
    iscrowd = np.array([0, 1, 0, 0], bool)
    np.testing.assert_array_equal(
        t_mu.crop_mask_iou(boxes1, crops, boxes1[:4], bitmaps, iscrowd, h, w),
        j_mu.crop_mask_iou(boxes1, crops, boxes1[:4], bitmaps, iscrowd, h, w))
    np.testing.assert_array_equal(t_mu.mask_iou_matrix(bitmaps, bitmaps[:2]),
                                  j_mu.mask_iou_matrix(bitmaps, bitmaps[:2]))


def _stuff(rs, h, w):
    blocks = rs.randint(0, 183, (h // 8 + 1, w // 8 + 1))
    m = np.repeat(np.repeat(blocks, 8, 0), 8, 1)[:h, :w]
    m[rs.rand(h, w) < 0.05] = 255
    return m.astype(np.uint8)


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (61, 90), (480, 640)])
def test_png_decode_matches_cv2(tmp_path, shape):
    rs = np.random.RandomState(shape[0])
    img = _stuff(rs, *shape)
    for level in (0, 1, 9):
        path = str(tmp_path / f"cv2_{level}.png")
        cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        np.testing.assert_array_equal(load_png_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    for filters in ((0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)):
        path = str(tmp_path / "port.png")
        write_png_gray(path, img, filters)
        got = load_png_gray(path)
        np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("shape", [(1, 6), (6, 1), (2, 2), (13, 7), (90, 61), (405, 720)])
def test_png_decode_mixed_filters(tmp_path, shape):
    """Random bytes and stuff maps under seeded per-row filter sequences:
    the diagonal decode of the rows from the first Average or Paeth row to
    the last, with rows of every type inside, before and after them."""
    rs = np.random.RandomState(shape[1])
    for img in (rs.randint(0, 256, shape).astype(np.uint8), _stuff(rs, *shape)):
        for _ in range(6):
            filters = tuple(rs.randint(0, 5, rs.randint(1, 12)))
            path = str(tmp_path / "mixed.png")
            write_png_gray(path, img, filters)
            got = load_png_gray(path)
            np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
            np.testing.assert_array_equal(got, img)
        h = shape[0]  # Average and Paeth rows only between the first two and the last two
        path = str(tmp_path / "inside.png")
        write_png_gray(path, img, ([0, 1] + [2, 4, 3] * h)[:max(h - 2, 0)] + [1, 2])
        np.testing.assert_array_equal(load_png_gray(path), img)


def test_png_other_types_raise(tmp_path):
    rs = np.random.RandomState(0)
    cases = {"RGB": rs.randint(0, 256, (6, 5, 3)).astype(np.uint8),
             "RGBA": rs.randint(0, 256, (6, 5, 4)).astype(np.uint8),
             "16-bit grayscale": rs.randint(0, 65535, (6, 5)).astype(np.uint16)}
    for name, img in cases.items():
        path = str(tmp_path / "x.png")
        cv2.imwrite(path, img)
        with pytest.raises(ValueError, match="colour type [26]" if img.ndim == 3 else "16-bit"):
            load_png_gray(path)
    path = str(tmp_path / "filter5.png")  # a scanline of filter type 5
    write_png_gray(path, np.zeros((2, 3), np.uint8))
    with open(path, "rb") as f:
        data = f.read()
    start = data.index(b"IDAT") + 4
    n = int.from_bytes(data[start - 8:start - 4], "big")
    idat = zlib.compress(b"\x00\x00\x00\x00\x05\x00\x00\x00")
    with open(path, "wb") as f:
        f.write(data[:start - 8] + len(idat).to_bytes(4, "big") + b"IDAT" + idat
                + zlib.crc32(b"IDAT" + idat).to_bytes(4, "big") + data[start + n + 4:])
    with pytest.raises(ValueError, match="filter type 5"):
        load_png_gray(path)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        load_png_gray(str(bad))


CANVAS = (128, 160)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("size", [(150, 200), (210, 90)])  # (H, W): landscape, portrait
def test_preprocess_masks_and_stuff_match_jax(flip, size):
    rs = np.random.RandomState(11 + flip)
    h, w = size
    img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    segs, boxes = [], []
    for i in range(7):
        if i == 3:  # uncompressed RLE
            rle, full = _rle(rs, h, w)
            ys, xs = np.nonzero(full)
            segs.append(rle)
            boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
            continue
        if i == 4:  # a full-image bitmap
            full = (rs.rand(h, w) > 0.6).astype(np.uint8)
            segs.append(full)
            boxes.append([10, 12, 70, 80])
            continue
        parts = _polygons(KINDS[i % len(KINDS)], rs, 0, min(h, w))
        pts = np.concatenate(parts).clip(0, [w, h])
        segs.append([p.reshape(-1).tolist() for p in parts])
        boxes.append([*pts.min(0), *pts.max(0)])
    boxes = np.asarray(boxes, np.float32)
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
    labels = rs.randint(0, 4, len(boxes))
    sem = _stuff(rs, h, w).astype(np.int32)
    kw = dict(canvas=CANVAS, scale=(160, 128), flip=flip, max_gt=6, segmentations=segs,
              semantic_map=sem, semantic_stride=8)
    want = j_pipeline.preprocess(img, boxes, labels, **kw)
    got = t_pipeline.preprocess(img, boxes, labels, **kw)
    assert got["gt_mask_crops"].shape == (6, 112, 112) and got["gt_mask_crops"].any()
    assert got["gt_semantic_seg"].shape == (16, 20) and got["gt_semantic_seg"].dtype == np.int32
    for key in ("gt_mask_crops", "gt_semantic_seg", "gt_bboxes", "gt_labels", "gt_mask",
                "img_shape", "scale_factor", "ori_shape"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    small = t_pipeline.preprocess(img, boxes, labels, **dict(kw, mask_crop_size=28))
    assert small["gt_mask_crops"].shape == (6, 28, 28)
