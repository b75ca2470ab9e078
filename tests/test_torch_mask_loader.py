"""The PyTorch port's loaders with instance masks and stuff maps against the
JAX package's, on the CPU.

A synthetic COCO set (``data/synthetic.py``'s shapes with their exact
polygons, plus an uncompressed-RLE instance, a crowd box and a portrait
frame) with 8-bit PNG stuff maps under a ``seg_prefix`` goes through
both packages' ``CocoDataset`` and train ``DetDataLoader`` with
``with_masks`` and ``with_semantic`` at one seed, two epochs at batch 2:
every batch's ``gt_mask_crops`` and ``gt_semantic_seg`` byte-equal, the
images within 1e-6, the boxes and the rest equal.  Both
``FakeDetLoader``s with masks and stuff maps give equal batches.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

pytest.importorskip("cv2")

from boosting_rcnn_tpu.data.coco import CocoDataset as JCoco  # noqa: E402
from boosting_rcnn_tpu.data.loader import DetDataLoader as JLoader  # noqa: E402
from boosting_rcnn_tpu.data.loader import FakeDetLoader as JFake  # noqa: E402
from boosting_rcnn_tpu_torch.data.builder import build_dataset  # noqa: E402
from boosting_rcnn_tpu_torch.data.image_io import write_png_gray  # noqa: E402
from boosting_rcnn_tpu_torch.data.loader import DetDataLoader as TLoader  # noqa: E402
from boosting_rcnn_tpu_torch.data.loader import FakeDetLoader as TFake  # noqa: E402
from boosting_rcnn_tpu_torch.data.synthetic import generate  # noqa: E402

CANVAS = (128, 160)
IMAGE_TOL = 1e-6


def _rle_of(mask):
    flat = mask.T.reshape(-1)
    change = np.flatnonzero(np.diff(np.concatenate([[0], flat, [1 - flat[-1]]])))
    return dict(size=list(mask.shape), counts=np.diff(np.concatenate([[0], change])).tolist())


@pytest.fixture(scope="module")
def mask_set(tmp_path_factory):
    """The shapes set (6 train images, one portrait) with an RLE instance, a
    crowd box and a stuff map per image."""
    root = str(tmp_path_factory.mktemp("mask_set"))
    generate(root, n_train=6, n_val=1, seed=3, frame_sizes=[(200, 160), (180, 120)],
             n_portrait=1)
    ann = os.path.join(root, "train.json")
    with open(ann) as f:
        coco = json.load(f)
    im = coco["images"][0]
    blob = np.zeros((im["height"], im["width"]), np.uint8)
    blob[100:140, 20:75] = 1
    blob[110:120, 30:40] = 0
    coco["annotations"] += [
        dict(id=900, image_id=im["id"], category_id=2, bbox=[20, 100, 55, 40],
             area=float(blob.sum()), iscrowd=0, segmentation=_rle_of(blob)),
        dict(id=901, image_id=im["id"], category_id=1, bbox=[150, 10, 30, 30], area=900.0,
             iscrowd=1, segmentation=dict(size=[im["height"], im["width"]], counts="abc"))]
    with open(ann, "w") as f:
        json.dump(coco, f)
    seg = os.path.join(root, "stuff")
    os.makedirs(seg)
    rs = np.random.RandomState(5)
    for k, im in enumerate(coco["images"]):
        h, w = im["height"], im["width"]
        m = np.repeat(np.repeat(rs.randint(0, 183, (h // 16 + 1, w // 16 + 1)), 16, 0), 16, 1)
        m = m[:h, :w].astype(np.uint8)
        m[rs.rand(h, w) < 0.02] = 255
        write_png_gray(os.path.join(seg, os.path.splitext(im["file_name"])[0] + ".png"), m,
                       filters=(k % 5, 4, 1))
    return ann, os.path.join(root, "train"), seg


def test_mask_loader_matches_jax(mask_set):
    ann, prefix, seg = mask_set
    jds = JCoco(ann, prefix, seg_prefix=seg)
    tds = build_dataset(dict(type="CocoDataset", ann_file=ann, img_prefix=prefix,
                             seg_prefix=seg))
    assert len(tds) == len(jds) == 6
    np.testing.assert_array_equal(tds.semantic_map(1), jds.semantic_map(1))
    kw = dict(batch_size=2, canvas=CANVAS, train=True, seed=0, with_masks=True,
              with_semantic=True, semantic_stride=8)
    jl, tl = JLoader(jds, **kw), TLoader(tds, **kw)
    shapes, crops = set(), 0
    for epoch in range(2):
        jb, tb = list(jl.epoch_iter(epoch)), list(tl.epoch_iter(epoch))
        assert len(jb) == len(tb) == len(tl) == 4  # 5 landscape images, 1 portrait
        for j, t in zip(jb, tb):
            assert set(t) == set(j)
            np.testing.assert_allclose(t["images"].numpy(), j["images"], rtol=0, atol=IMAGE_TOL)
            for key in ("gt_mask_crops", "gt_semantic_seg", "gt_bboxes", "gt_labels", "gt_mask",
                        "img_shape", "scale_factor", "ori_shape"):
                assert t[key].dtype == j[key].dtype, key
                np.testing.assert_array_equal(t[key], j[key], err_msg=key)
            assert t["gt_mask_crops"].shape == (2, 100, 112, 112)
            assert t["gt_semantic_seg"].shape[1:] == tuple(-(-s // 8) for s in
                                                           t["images"].shape[1:3])
            crops += int(t["gt_mask_crops"].reshape(2, 100, -1).any(-1).sum())
            shapes.add(tuple(t["images"].shape[1:3]))
    assert shapes == {CANVAS, CANVAS[::-1]} and crops > 12


@pytest.mark.parametrize("masks,semantic", [(True, False), (True, True), (False, True)])
def test_fake_loaders_match_jax(masks, semantic):
    kw = dict(batch_size=2, canvas=CANVAS, num_classes=4, max_gt=6, seed=3, num_batches=3,
              with_masks=masks, with_semantic=semantic)
    for j, t in zip(JFake(**kw).epoch_iter(1), TFake(**kw).epoch_iter(1)):
        assert set(t) == set(j)
        assert torch.equal(t["images"], torch.from_numpy(j["images"]))
        for key in set(j) - {"images"}:
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    t_batches = list(TFake(**kw).epoch_iter(1))
    resumed = list(TFake(**kw).epoch_iter(1, start=2))
    assert len(resumed) == 1
    for key in t_batches[2]:
        assert np.array_equal(np.asarray(resumed[0][key]), np.asarray(t_batches[2][key])), key
