"""The port's train-time augmentations against the JAX package's, on the CPU:
``large_scale_jitter``, ``apply_albu`` and ``instaboost`` (``data/
transforms.py``, ``albu.py``, ``instaboost.py``; the JAX functions run
with ``cv2``, the port's with ``data/cv_ops.py``).

The same image, boxes, labels, polygons and seeded ``RandomState`` go to
both: the images come out byte-equal, boxes and polygons within 1e-5,
labels equal, and the ``RandomState``s in the same state afterwards, so
that a loader's stream stays in step.  The cases cover each Albu
transform, ``OneOf``, ``min_visibility``, InstaBoost's gate, ``skip`` and
``horizontal`` actions and colour jitter, and LSJ at ratios below and
above 1.  ``JpegCompression`` raises in the port.
"""
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

cv2 = pytest.importorskip("cv2")

from boosting_rcnn_tpu.data.albu import apply_albu as j_albu  # noqa: E402
from boosting_rcnn_tpu.data.instaboost import instaboost as j_instaboost  # noqa: E402
from boosting_rcnn_tpu.data.transforms import large_scale_jitter as j_lsj  # noqa: E402
from boosting_rcnn_tpu_torch.data.albu import apply_albu as t_albu  # noqa: E402
from boosting_rcnn_tpu_torch.data.instaboost import instaboost as t_instaboost  # noqa: E402
from boosting_rcnn_tpu_torch.data.synthetic import _draw_objects  # noqa: E402
from boosting_rcnn_tpu_torch.data.transforms import large_scale_jitter as t_lsj  # noqa: E402

GEOM_TOL = 1e-5


def _scene(seed, h=72, w=96, rle=False, bitmap=False):
    """A smooth image with 1-3 drawn shapes: ``(img, boxes, labels, segs)``
    with each shape's polygon; with ``rle`` an uncompressed-RLE instance,
    with ``bitmap`` a full-frame bitmap instance, and a ``None`` one."""
    rs = np.random.RandomState(seed)
    img = cv2.GaussianBlur(rs.randint(0, 256, (h, w, 3)).astype(np.uint8), (5, 5), 0)
    objs = []
    while not objs:
        objs = _draw_objects(rs, img, min(h, w) / 160 * 1.5)
    boxes = [list(map(float, o[1:5])) for o in objs]
    segs = [[o[5].reshape(-1).tolist()] for o in objs]
    labels = [o[0] for o in objs]
    if rle:
        blob = np.zeros((h, w), np.uint8)
        blob[h // 4:h // 2, w // 5:w // 2] = 1
        flat = blob.T.reshape(-1)
        change = np.flatnonzero(np.diff(np.concatenate([[0], flat, [1 - flat[-1]]])))
        segs.append(dict(size=[h, w], counts=np.diff(np.concatenate([[0], change])).tolist()))
        boxes.append([w / 5, h / 4, w / 2, h / 2])
        labels.append(1)
    if bitmap:
        bmp = np.zeros((h, w), np.uint8)
        bmp[h // 2:h - 4, w // 2:w - 6] = 1
        segs.append(bmp)
        boxes.append([w / 2, h / 2, w - 6, h - 4])
        labels.append(2)
        segs.append(None)
        boxes.append([2.0, 2.0, 12.0, 10.0])
        labels.append(3)
    return (img, np.asarray(boxes, np.float32), np.asarray(labels, np.int64), segs)


def _same_state(ja, ta):
    ja, ta = ja.get_state(), ta.get_state()
    assert ja[0] == ta[0] and ja[2:] == ta[2:]
    np.testing.assert_array_equal(ja[1], ta[1])


def _same_segs(jsegs, tsegs):
    if jsegs is None:
        assert tsegs is None
        return
    assert len(jsegs) == len(tsegs)
    for j, t in zip(jsegs, tsegs):
        if j is None or isinstance(j, dict):
            assert t is None if j is None else t == j
        elif isinstance(j, np.ndarray):
            np.testing.assert_array_equal(t, j)
        else:
            assert len(j) == len(t)
            for jp, tp in zip(j, t):
                np.testing.assert_allclose(np.asarray(tp, np.float64), np.asarray(jp, np.float64),
                                           rtol=0, atol=GEOM_TOL)


ALBU_CASES = {
    "ssr": [dict(type="ShiftScaleRotate", shift_limit=0.0625, scale_limit=0.1, rotate_limit=45,
                 p=1.0)],
    "brightness_contrast": [dict(type="RandomBrightnessContrast", brightness_limit=[0.1, 0.3],
                                 contrast_limit=[0.1, 0.3], p=1.0)],
    "rgb_shift": [dict(type="RGBShift", r_shift_limit=10, g_shift_limit=10, b_shift_limit=10,
                       p=1.0)],
    "hsv": [dict(type="HueSaturationValue", hue_shift_limit=20, sat_shift_limit=30,
                 val_shift_limit=20, p=1.0)],
    "channel_shuffle": [dict(type="ChannelShuffle", p=1.0)],
    "blur": [dict(type="Blur", blur_limit=7, p=1.0)],
    "median_blur": [dict(type="MedianBlur", blur_limit=5, p=1.0)],
    "one_of": [dict(type="OneOf", transforms=[dict(type="Blur", blur_limit=3, p=1.0),
                                              dict(type="MedianBlur", blur_limit=3, p=2.0),
                                              dict(type="RGBShift", p=1.0)], p=1.0)],
    "config": [dict(type="ShiftScaleRotate", shift_limit=0.0625, scale_limit=0.0,
                    rotate_limit=0, p=0.5),
               dict(type="RandomBrightnessContrast", brightness_limit=[0.1, 0.3],
                    contrast_limit=[0.1, 0.3], p=0.2),
               dict(type="ChannelShuffle", p=0.1),
               dict(type="OneOf", transforms=[dict(type="Blur", blur_limit=3, p=1.0),
                                              dict(type="MedianBlur", blur_limit=3, p=1.0)],
                    p=0.1)],
}


@pytest.mark.parametrize("case", sorted(ALBU_CASES))
def test_albu_matches_jax(case):
    transforms = ALBU_CASES[case]
    for seed in range(4 if case != "config" else 12):
        img, boxes, labels, segs = _scene(100 + seed, rle=seed % 2 == 0, bitmap=case == "ssr")
        jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
        j = j_albu(img.copy(), boxes.copy(), labels.copy(), list(segs), transforms, jr)
        t = t_albu(img.copy(), boxes.copy(), labels.copy(), list(segs), transforms, tr)
        np.testing.assert_array_equal(t[0], j[0], err_msg=f"{case} seed {seed}")
        np.testing.assert_allclose(t[1], j[1], rtol=0, atol=GEOM_TOL)
        np.testing.assert_array_equal(t[2], j[2])
        _same_segs(j[3], t[3])
        _same_state(jr, tr)


def test_albu_min_visibility_drops_boxes_as_jax():
    transforms = [dict(type="ShiftScaleRotate", shift_limit=[0.3, 0.45], scale_limit=0.0,
                       rotate_limit=0, p=1.0)]
    dropped = 0
    for seed in range(8):
        img, boxes, labels, segs = _scene(200 + seed)
        jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
        j = j_albu(img, boxes, labels, segs, transforms, jr, min_visibility=0.6)
        t = t_albu(img, boxes, labels, segs, transforms, tr, min_visibility=0.6)
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_allclose(t[1], j[1], rtol=0, atol=GEOM_TOL)
        np.testing.assert_array_equal(t[2], j[2])
        _same_segs(j[3], t[3])
        _same_state(jr, tr)
        dropped += len(boxes) - len(t[1])
    assert dropped > 0


def test_albu_jpeg_compression_raises():
    img, boxes, labels, segs = _scene(300)
    with pytest.raises(NotImplementedError, match="JpegCompression"):
        t_albu(img, boxes, labels, segs, [dict(type="JpegCompression", p=1.0)],
               np.random.RandomState(0))


INSTABOOST_CASES = {
    "normal": dict(aug_ratio=1.0),
    "config": dict(aug_ratio=0.5),
    "horizontal": dict(aug_ratio=1.0, action_prob=(0, 1, 0), color_prob=1.0),
    "skip": dict(aug_ratio=1.0, action_prob=(0, 0, 1)),
    "mixed": dict(aug_ratio=1.0, action_prob=(1, 1, 1), color_prob=0.0, theta=(-10, 10),
                  dx=4, dy=4),
}


@pytest.mark.parametrize("case", sorted(INSTABOOST_CASES))
def test_instaboost_matches_jax(case):
    kwargs = INSTABOOST_CASES[case]
    changed = 0
    for seed in range(6):
        img, boxes, labels, segs = _scene(400 + seed, h=56, w=72, rle=seed % 3 == 0)
        if seed == 5:  # an instance at the frame's edge, half warped out
            segs[0] = [[0.0, 0.0, 9.0, 0.0, 9.0, 9.0, 0.0, 9.0]]
            boxes[0] = [0, 0, 9, 9]
        jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
        j = j_instaboost(img.copy(), boxes.copy(), labels, list(segs), jr, **kwargs)
        t = t_instaboost(img.copy(), boxes.copy(), labels, list(segs), tr, **kwargs)
        np.testing.assert_array_equal(t[0], j[0], err_msg=f"{case} seed {seed}")
        np.testing.assert_allclose(t[1], j[1], rtol=0, atol=GEOM_TOL)
        _same_segs(j[2], t[2])
        _same_state(jr, tr)
        changed += int((t[0] != img).any())
    if case == "skip":
        assert changed == 0
    elif case != "config":
        assert changed >= 5


@pytest.mark.parametrize("ratio_range", [(0.3, 0.7), (1.4, 2.0), (0.1, 2.0)])
def test_large_scale_jitter_matches_jax(ratio_range):
    canvas = (64, 80)
    kept = 0
    for seed in range(6):
        img, boxes, labels, segs = _scene(500 + seed, rle=seed % 2 == 0)
        jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
        j = j_lsj(img, boxes, labels, list(segs), jr, canvas, ratio_range)
        t = t_lsj(img, boxes, labels, list(segs), tr, canvas, ratio_range)
        np.testing.assert_array_equal(t[0], j[0])
        assert t[0].shape[0] <= canvas[0] and t[0].shape[1] <= canvas[1]
        np.testing.assert_allclose(t[1], j[1], rtol=0, atol=GEOM_TOL)
        np.testing.assert_array_equal(t[2], j[2])
        _same_segs(j[3], t[3])
        _same_state(jr, tr)
        kept += len(t[1])
    assert kept > 0
