"""The PyTorch port's segm evaluation against the JAX package's, on the CPU.

Seeded ground truth with polygon, multi-part, short-part and uncompressed
RLE segmentations, crowd and ignore boxes, and detections with 28 x 28
probability crops near their gts (and full-image masks, and mask scores
as a fourth entry) go through both packages:

  * ``SegmCocoStyleEval.summarize()``: every number within 1e-6 of JAX's
    (the masks are pasted and rasterised in numpy against cv2's bytes);
  * ``CocoDataset.evaluate(metric=["bbox", "segm"])`` on a COCO json:
    every bbox and segm number within 1e-6 of JAX's;
  * the bbox evaluator with its hooks split out: within 1e-12 of JAX's on
    the same results, masks and all.
"""
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

pytest.importorskip("cv2")

from boosting_rcnn_tpu.core.evaluation import coco_eval as j_coco  # noqa: E402
from boosting_rcnn_tpu.data.coco import CocoDataset as JCoco  # noqa: E402
from boosting_rcnn_tpu_torch.core.evaluation import coco_eval as t_coco  # noqa: E402
from boosting_rcnn_tpu_torch.data.coco import CocoDataset as TCoco  # noqa: E402

TOL = 1e-6
NUM_CLASSES = 4
H, W = 160, 200


def _ngon(rs, cx, cy, r, n):
    t = np.sort(rs.uniform(0, 2 * np.pi, n))
    rr = r * rs.uniform(0.6, 1.0, n)
    return np.stack([cx + rr * np.cos(t), cy + rr * np.sin(t)], 1).clip(0, [W, H])


def _rle_of(mask):
    flat = mask.T.reshape(-1)
    change = np.flatnonzero(np.diff(np.concatenate([[0], flat, [1 - flat[-1]]])))
    return dict(size=list(mask.shape), counts=np.diff(np.concatenate([[0], change])).tolist())


def _case(seed, n_images=5, full_masks=False, mask_scores=False):
    """Per-image gts (with segmentations and areas) and results (dets,
    labels, mask crops[, mask scores])."""
    rs = np.random.RandomState(seed)
    gts, results = [], []
    for i in range(n_images):
        g = rs.randint(1, 7) if i != 1 else 0
        boxes, labels, segs, areas = [], [], [], []
        for k in range(g):
            cx, cy, r = rs.uniform(20, W - 20), rs.uniform(20, H - 20), rs.choice([6, 20, 45])
            if k == 2:  # uncompressed RLE
                m = np.zeros((H, W), np.uint8)
                y0, x0 = max(int(cy) - r // 2, 0), max(int(cx) - r, 0)
                m[y0:int(cy) + r // 2 + 1, x0:int(cx) + r] = 1
                segs.append(_rle_of(m))
                ys, xs = np.nonzero(m)
                boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
                areas.append(float(m.sum()))
            else:
                parts = [_ngon(rs, cx, cy, r, rs.randint(3, 16))]
                if k == 3:  # a second part, and one too short to count
                    parts += [_ngon(rs, cx + r, cy, r / 2, 5), np.array([[cx, cy], [cx + 1, cy]])]
                pts = np.concatenate(parts[:2])
                boxes.append([*pts.min(0), *pts.max(0)])
                segs.append([np.round(p, 2).reshape(-1).tolist() for p in parts])
                areas.append(float(np.pi * r * r * rs.uniform(0.5, 1.0)))
            labels.append(rs.randint(0, NUM_CLASSES))
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        n_ig = rs.randint(0, 2)
        ig = np.array([[5, 5, 30, 25]] * n_ig, np.float32).reshape(-1, 4)
        gts.append(dict(bboxes=boxes, labels=np.asarray(labels, np.int64), bboxes_ignore=ig,
                        width=W, height=H, segmentations=segs, areas=np.asarray(areas)))
        near = boxes + rs.normal(0, 1, boxes.shape).astype(np.float32)
        n_noise = rs.randint(0, 6)
        nxy = rs.uniform(0, 100, (n_noise, 2))
        noise = np.concatenate([nxy, nxy + rs.uniform(3, 40, (n_noise, 2))], 1)
        dets = np.concatenate([near, ig + 1, noise]).astype(np.float32)
        labs = np.concatenate([np.where(rs.rand(g) < 0.8, labels, rs.randint(0, 4, g)),
                               rs.randint(0, 4, len(ig) + n_noise)]).astype(np.int64)
        crops = rs.uniform(0.2, 1.0, (len(dets), 28, 28)).astype(np.float32)
        crops[:, :4] = rs.uniform(0, 0.6, (len(dets), 4, 28))
        scores = rs.rand(len(dets)).astype(np.float32)
        res = [np.concatenate([dets, scores[:, None]], 1), labs]
        if full_masks:
            res.append(list(crops[:-1]) + [(rs.rand(H, W) > 0.8).astype(np.uint8)]
                       if len(dets) else list(crops))
        else:
            res.append(crops)
        if mask_scores:
            res.append(rs.rand(len(dets)).astype(np.float32))
        results.append(tuple(res))
    return gts, results


@pytest.mark.parametrize("seed,full_masks,mask_scores", [(0, False, False), (1, False, False),
                                                         (2, True, False), (3, False, True)])
def test_segm_eval_matches(seed, full_masks, mask_scores):
    gts, results = _case(seed, full_masks=full_masks, mask_scores=mask_scores)
    ref = j_coco.SegmCocoStyleEval(gts, results, NUM_CLASSES).summarize()
    got = t_coco.SegmCocoStyleEval(gts, results, NUM_CLASSES).summarize()
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=TOL, err_msg=key)
    assert 0 < got["AP"] < 1


@pytest.mark.parametrize("seed", [0, 4])
def test_bbox_eval_unchanged(seed):
    gts, results = _case(seed)
    ref = j_coco.CocoStyleEval(gts, results, NUM_CLASSES)
    got = t_coco.CocoStyleEval(gts, results, NUM_CLASSES)
    rs, gs = ref.summarize(), got.summarize()
    for key in rs:
        np.testing.assert_allclose(gs[key], rs[key], rtol=0, atol=1e-12, err_msg=key)
    np.testing.assert_allclose(got.precision, ref.precision, rtol=0, atol=1e-12)


def test_dataset_evaluate_bbox_segm(tmp_path):
    gts, results = _case(5, n_images=6)
    images, anns = [], []
    for i, g in enumerate(gts):
        images.append(dict(id=10 + i, file_name=f"{i}.ppm", width=W, height=H))
        for b, lab, seg, area in zip(g["bboxes"], g["labels"], g["segmentations"], g["areas"]):
            anns.append(dict(id=len(anns) + 1, image_id=10 + i, category_id=int(lab) + 1,
                             bbox=[float(b[0]), float(b[1]), float(b[2] - b[0]),
                                   float(b[3] - b[1])], area=float(area), iscrowd=0,
                             segmentation=seg))
        for b in g["bboxes_ignore"]:
            anns.append(dict(id=len(anns) + 1, image_id=10 + i, category_id=1, iscrowd=1,
                             bbox=[float(b[0]), float(b[1]), float(b[2] - b[0]),
                                   float(b[3] - b[1])], area=float((b[2] - b[0]) * (b[3] - b[1])),
                             segmentation=dict(size=[H, W], counts="xyz")))
    cats = [dict(id=c + 1, name=f"c{c}") for c in range(NUM_CLASSES)]
    path = tmp_path / "ann.json"
    path.write_text(json.dumps(dict(images=images, annotations=anns, categories=cats)))
    jds, tds = JCoco(str(path), test_mode=True), TCoco(str(path), test_mode=True)
    ref = jds.evaluate(results, metric=["bbox", "segm"])
    got = tds.evaluate(results, metric=["bbox", "segm"])
    assert set(got) == set(ref) and {"segm_mAP", "segm_mAP_50", "segm_mAP_75", "segm_mAP_s",
                                     "segm_mAP_m", "segm_mAP_l"} <= set(got)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=TOL, err_msg=key)
    # --out writes boxes only; the JAX package's takes box results only
    boxes_only = [r[:2] for r in results]
    assert tds.results_to_coco_json(results) == jds.results_to_coco_json(boxes_only)
