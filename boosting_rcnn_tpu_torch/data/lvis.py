"""LVIS v0.5 and v1 with federated evaluation (PyTorch port of
``boosting_rcnn_tpu/data/lvis.py``).

COCO-format json with per-image ``neg_category_ids`` and
``not_exhaustive_category_ids``; a v1 image record carries a ``coco_url``
in place of a ``file_name``, which becomes the url's path after
``http://images.cocodataset.org/`` (``train2017/<id>.jpg``).  Evaluation
is federated: a category's AP counts only the images where it was
verified (a positive annotation of it, or listed in the image's
``neg_category_ids``), at 300 detections an image, and the mean runs over
the categories with a verified gt.

The JAX quirks are kept: the metric is bbox whatever ``metric`` asks for,
each category is scored as class 0 of a one-class evaluation with every
image's ignore boxes passed through, and ``classwise`` names the i-th
scored category by ``CLASSES[i]``.
"""
from __future__ import annotations

import json
from typing import List

import numpy as np

from .coco import CocoDataset

__all__ = ["LvisDataset", "COCO_URL_PREFIX"]

COCO_URL_PREFIX = "http://images.cocodataset.org/"


class LvisDataset(CocoDataset):
    """LVIS v0.5 / v1 (told apart by the image records)."""

    def __init__(self, ann_file: str, img_prefix: str = "", classes=None,
                 test_mode: bool = False, filter_empty_gt: bool = True, min_size: int = 32):
        super().__init__(ann_file=ann_file, img_prefix=img_prefix, classes=classes,
                         test_mode=test_mode, filter_empty_gt=filter_empty_gt,
                         min_size=min_size)

    def _read_annotations(self, ann_file: str) -> dict:
        with open(ann_file) as f:
            raw = json.load(f)
        for im in raw.get("images", []):
            if "file_name" not in im and "coco_url" in im:
                im["file_name"] = im["coco_url"].replace(COCO_URL_PREFIX, "")
        self._neg_ids = {im["id"]: set(im.get("neg_category_ids", []))
                         for im in raw.get("images", [])}
        return raw

    def evaluate(self, results, metric="bbox", classwise: bool = False,
                 max_dets: int = 300):
        """Federated bbox mAP: ``bbox_mAP`` and ``bbox_mAP_50`` over the
        categories with a verified gt."""
        from ..core.evaluation.coco_eval import CocoStyleEval

        per_class_ap: List[float] = []
        per_class_ap50: List[float] = []
        for c in range(len(self.CLASSES)):
            cat_id = self.cat_ids[c]
            gts_c, res_c = [], []
            for d, r in zip(self.data_infos, results):
                sel = d["labels"] == c
                if not (sel.any() or cat_id in self._neg_ids.get(d["id"], ())):
                    continue  # not verified for c
                gts_c.append(dict(bboxes=d["bboxes"][sel],
                                  labels=np.zeros(int(sel.sum()), np.int64),
                                  bboxes_ignore=d["bboxes_ignore"],
                                  width=d["width"], height=d["height"]))
                if isinstance(r, tuple) and len(r) >= 2:
                    dets, lbls = np.asarray(r[0]), np.asarray(r[1])
                    det_c = dets[lbls == c].reshape(-1, 5)
                else:  # a per-class list of (n, 5) arrays
                    det_c = np.asarray(r[c]).reshape(-1, 5)
                res_c.append((det_c, np.zeros(len(det_c), np.int64)))
            if not gts_c or not any(len(g["bboxes"]) for g in gts_c):
                continue
            stats = CocoStyleEval(gts_c, res_c, num_classes=1, max_dets=max_dets).summarize()
            per_class_ap.append(stats["AP"])
            per_class_ap50.append(stats["AP50"])
        out = {"bbox_mAP": float(np.mean(per_class_ap)) if per_class_ap else 0.0,
               "bbox_mAP_50": float(np.mean(per_class_ap50)) if per_class_ap50 else 0.0}
        if classwise:
            out["classwise"] = {self.CLASSES[i]: ap for i, ap in enumerate(per_class_ap)}
        return out
