"""The PyTorch port's evaluation against the JAX package's, on the CPU.

Seeded random ground truth and detections (ignore regions, a class with no
ground truth, a class with no detections, images with none, more than 100
detections on an image, detections near their gts so every IoU threshold
sees matches) go through both packages:

  * ``CocoStyleEval.summarize()`` (AP, AP50, AP75, APs/m/l, per class):
    within 1e-12 of JAX's, and its ``precision`` / ``recall`` arrays;
  * ``eval_map``: mAP and every class's numbers within 1e-12, in both the
    area and the 11-point mode, at IoU 0.5 and 0.75;
  * ``CocoDataset.results_to_coco_json`` and ``evaluate``: equal / within
    1e-12; ``VOCDataset.evaluate`` (mAP and bbox) on XML annotations.
"""
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from boosting_rcnn_tpu.core.evaluation import coco_eval as j_coco  # noqa: E402
from boosting_rcnn_tpu.core.evaluation import mean_ap as j_map  # noqa: E402
from boosting_rcnn_tpu.data.coco import CocoDataset as JCoco  # noqa: E402
from boosting_rcnn_tpu.data.voc import VOCDataset as JVOC  # noqa: E402
from boosting_rcnn_tpu_torch.core.evaluation import coco_eval as t_coco  # noqa: E402
from boosting_rcnn_tpu_torch.core.evaluation import mean_ap as t_map  # noqa: E402
from boosting_rcnn_tpu_torch.data.coco import CocoDataset as TCoco  # noqa: E402
from boosting_rcnn_tpu_torch.data.voc import VOCDataset as TVOC  # noqa: E402

TOL = 1e-12
NUM_CLASSES = 5  # class 3 has no gt, class 4 no detection


def _case(seed, n_images=6):
    rs = np.random.RandomState(seed)
    gts, results = [], []
    for i in range(n_images):
        g = rs.randint(0, 8) if i != 1 else 0
        xy = rs.uniform(0, 400, (g, 2))
        wh = rs.choice([8.0, 20.0, 60.0, 150.0], (g, 2)) * rs.uniform(0.8, 1.2, (g, 2))
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        labels = rs.choice([0, 1, 2, 4], g).astype(np.int64)
        n_ig = rs.randint(0, 3)
        ig = np.concatenate([xy[:n_ig] + 3, xy[:n_ig] + 50], 1).astype(np.float32).reshape(-1, 4)
        gts.append(dict(bboxes=boxes, labels=labels, bboxes_ignore=ig))
        # detections: jittered gts (some relabelled), near-ignore boxes, noise
        near = boxes + rs.normal(0, 4, boxes.shape).astype(np.float32)
        near_l = np.where(rs.rand(g) < 0.8, labels, rs.randint(0, 4, g))
        n_noise = 130 if i == 2 else rs.randint(0, 20)  # image 2: over 100 detections
        nxy = rs.uniform(0, 400, (n_noise, 2))
        noise = np.concatenate([nxy, nxy + rs.uniform(5, 120, (n_noise, 2))], 1)
        dets = np.concatenate([near, ig + 1, noise]).astype(np.float32)
        labs = np.concatenate([near_l, rs.randint(0, 4, len(ig)),
                               rs.randint(0, 4, n_noise)]).astype(np.int64)
        labs = np.where(labs == 4, 3, labs)  # no class-4 detections
        scores = rs.rand(len(dets)).astype(np.float32)
        if i == 3:
            dets, labs, scores = dets[:0], labs[:0], scores[:0]
        results.append((np.concatenate([dets, scores[:, None]], 1), labs))
    return gts, results


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_style_eval_matches(seed):
    gts, results = _case(seed)
    ref = j_coco.CocoStyleEval(gts, results, NUM_CLASSES)
    got = t_coco.CocoStyleEval(gts, results, NUM_CLASSES)
    rs, gs = ref.summarize(), got.summarize()
    assert set(rs) == set(gs)
    for key in rs:
        np.testing.assert_allclose(gs[key], rs[key], rtol=0, atol=TOL, err_msg=key)
    np.testing.assert_allclose(got.precision, ref.precision, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.recall, ref.recall, rtol=0, atol=TOL)
    assert 0 < gs["AP"] < 1 and np.isnan(gs["per_class_AP"][3])


@pytest.mark.parametrize("mode", ["area", "11points"])
@pytest.mark.parametrize("iou_thr", [0.5, 0.75])
@pytest.mark.parametrize("seed", [0, 1])
def test_eval_map_matches(seed, iou_thr, mode):
    gts, results = _case(seed)
    ref_map, ref_cls = j_map.eval_map(results, gts, iou_thr, NUM_CLASSES, mode)
    got_map, got_cls = t_map.eval_map(results, gts, iou_thr, NUM_CLASSES, mode)
    np.testing.assert_allclose(got_map, ref_map, rtol=0, atol=TOL)
    assert len(got_cls) == len(ref_cls)
    for g, r in zip(got_cls, ref_cls):
        assert g.keys() == r.keys()
        for key in r:
            np.testing.assert_allclose(g[key], r[key], rtol=0, atol=TOL, err_msg=key)
    assert 0 < got_map < 1


def test_coco_dataset_json_and_evaluate(tmp_path):
    gts, results = _case(3)
    images, anns = [], []
    for i, g in enumerate(gts):
        images.append(dict(id=100 + i, file_name=f"{i}.ppm", width=640, height=480))
        for b, lab in zip(g["bboxes"], g["labels"]):
            anns.append(dict(id=len(anns) + 1, image_id=100 + i, category_id=int(lab) + 1,
                             bbox=[float(b[0]), float(b[1]), float(b[2] - b[0]),
                                   float(b[3] - b[1])], iscrowd=0))
        for b in g["bboxes_ignore"]:
            anns.append(dict(id=len(anns) + 1, image_id=100 + i, category_id=1, iscrowd=1,
                             bbox=[float(b[0]), float(b[1]), float(b[2] - b[0]),
                                   float(b[3] - b[1])]))
    cats = [dict(id=c + 1, name=f"c{c}") for c in range(NUM_CLASSES)]
    path = tmp_path / "ann.json"
    path.write_text(json.dumps(dict(images=images, annotations=anns, categories=cats)))
    jds, tds = JCoco(str(path), test_mode=True), TCoco(str(path), test_mode=True)
    assert tds.results_to_coco_json(results) == jds.results_to_coco_json(results)
    ref = jds.evaluate(results, "bbox", classwise=True)
    got = tds.evaluate(results, "bbox", classwise=True)
    for key in ref:
        if key != "classwise":
            np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=TOL, err_msg=key)
    np.testing.assert_allclose(list(got["classwise"].values()),
                               list(ref["classwise"].values()), rtol=0, atol=TOL)
    with pytest.raises(NotImplementedError):
        tds.evaluate(results, "segm")


def test_voc_dataset_evaluate(tmp_path):
    gts, results = _case(4, n_images=4)
    names = ("aeroplane", "bicycle", "bird", "boat", "bottle")
    os.makedirs(tmp_path / "Annotations")
    ids = []
    for i, g in enumerate(gts):
        objs = "".join(
            f"<object><name>{names[int(lab)]}</name><difficult>{d}</difficult><bndbox>"
            f"<xmin>{b[0]}</xmin><ymin>{b[1]}</ymin><xmax>{b[2]}</xmax><ymax>{b[3]}</ymax>"
            f"</bndbox></object>"
            for bs, ls, d in ((g["bboxes"], g["labels"], 0),
                              (g["bboxes_ignore"], np.zeros(len(g["bboxes_ignore"])), 1))
            for b, lab in zip(bs, ls))
        (tmp_path / "Annotations" / f"im{i}.xml").write_text(
            f"<annotation><size><width>640</width><height>480</height></size>{objs}"
            f"</annotation>")
        ids.append(f"im{i}")
    (tmp_path / "ids.txt").write_text("\n".join(ids))
    kw = dict(ann_file=str(tmp_path / "ids.txt"), img_prefix=str(tmp_path), classes=names,
              test_mode=True)
    jds, tds = JVOC(**kw), TVOC(**kw)
    ref = jds.evaluate(results, ["mAP", "bbox"])
    got = tds.evaluate(results, ["mAP", "bbox"])
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=TOL, err_msg=key)
