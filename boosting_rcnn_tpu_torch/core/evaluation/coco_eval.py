"""COCO-style bbox and segm mAP in numpy (PyTorch port of
``boosting_rcnn_tpu/core/evaluation/coco_eval.py``).

The COCOeval protocol: IoU thresholds 0.50:0.05:0.95, 101-point
interpolated precision, area ranges all / small / medium / large,
``maxDets`` 100, crowd and ignore regions matched by IoF and not counted.
``CocoStyleEval`` scores boxes; ``SegmCocoStyleEval`` overrides its hooks
(``compute_iou``, ``gt_areas``, ``det_areas``, ``_det_scores``) to score
masks.  On the host, as in the reference.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ...data.mask_utils import crop_mask_iou, paste_mask, polygons_to_bitmap

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _iou(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU; for crowd gts the union is the det area (IoF)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    da = np.maximum(dets[:, 2] - dets[:, 0], 0) * np.maximum(dets[:, 3] - dets[:, 1], 0)
    ga = np.maximum(gts[:, 2] - gts[:, 0], 0) * np.maximum(gts[:, 3] - gts[:, 1], 0)
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = np.where(iscrowd[None, :], da[:, None], da[:, None] + ga[None, :] - inter)
    return inter / np.maximum(union, 1e-10)


class CocoStyleEval:
    """gts: per-image dicts with ``bboxes`` (N,4), ``labels`` (N,),
    ``bboxes_ignore`` (M,4).  results: per-image ``(dets (K,5), labels (K,))``
    in the same (original-image) coordinate frame."""

    def __init__(self, gts, results, num_classes: int, max_dets: int = 100):
        if len(gts) != len(results):
            raise ValueError(f"{len(results)} results for {len(gts)} images")
        self.gts = gts
        self.results = results
        self.num_classes = num_classes
        self.max_dets = max_dets

    def compute_iou(self, det_boxes, gt_boxes, gt_ig, img_idx, cls, det_sel):
        """``(D, G)`` IoU of one image's detections of class ``cls`` against
        its gts of that class and its ignore regions."""
        return _iou(det_boxes, gt_boxes, gt_ig)

    @staticmethod
    def _box_areas(boxes: np.ndarray) -> np.ndarray:
        if len(boxes) == 0:
            return np.zeros(0)
        return np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(
            boxes[:, 3] - boxes[:, 1], 0
        )

    def gt_areas(self, gt_boxes, gt_ig, img_idx, cls):
        """Each gt's area for the area-range test (box areas)."""
        return self._box_areas(gt_boxes)

    def det_areas(self, det_boxes, img_idx, cls, det_sel):
        """Each detection's area for the area-range test (box areas)."""
        return self._box_areas(det_boxes)

    def _det_scores(self, res):
        return res[0][:, 4]

    def _evaluate_img(
        self, det_scores, gt_ignore_mask, area_rng, ious, det_area, gt_area
    ):
        """Greedy matching for one (image, class, area-range).

        Returns (dt_matched (T, D), dt_ignore (T, D), num_valid_gt).
        """
        t = len(IOU_THRS)
        d = len(det_area)
        g = len(gt_area)
        gt_ig = gt_ignore_mask | (gt_area < area_rng[0]) | (gt_area > area_rng[1])
        # sort gts: unignored first (COCOeval matches real gts preferentially)
        gt_order = np.argsort(gt_ig, kind="stable")
        gt_ig = gt_ig[gt_order]
        ious = ious[:, gt_order]

        dt_m = np.zeros((t, d), dtype=np.int64) - 1
        gt_m = np.zeros((t, g), dtype=np.int64) - 1
        for ti, thr in enumerate(IOU_THRS):
            for di in range(d):
                best_iou = min(thr, 1 - 1e-10)
                best_g = -1
                for gi in range(g):
                    if gt_m[ti, gi] >= 0 and not gt_ig[gi]:
                        continue
                    # stop moving to ignored gts once a real match was found
                    if best_g >= 0 and not gt_ig[best_g] and gt_ig[gi]:
                        break
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best_g = gi
                if best_g >= 0:
                    dt_m[ti, di] = best_g
                    gt_m[ti, best_g] = di

        out_of_rng = (det_area < area_rng[0]) | (det_area > area_rng[1])
        dt_ig = np.zeros((t, d), dtype=bool)
        for ti in range(t):
            matched = dt_m[ti] >= 0
            matched_ig = np.zeros(d, dtype=bool)
            matched_ig[matched] = gt_ig[dt_m[ti][matched]]
            dt_ig[ti] = matched_ig | (~matched & out_of_rng)
        return (dt_m >= 0) & ~dt_ig, dt_ig, int((~gt_ig).sum())

    def accumulate(self) -> Dict[str, np.ndarray]:
        t = len(IOU_THRS)
        r = len(REC_THRS)
        k = self.num_classes
        a = len(AREA_RANGES)
        precision = -np.ones((t, r, k, a))
        recall = -np.ones((t, k, a))

        for ki in range(k):
            per_img = []
            for img_idx, (gt, res) in enumerate(zip(self.gts, self.results)):
                dets, labels = res[0], res[1]
                m = labels == ki
                db = dets[m, :4]
                ds = self._det_scores(res)[m]
                order = np.argsort(-ds, kind="stable")[: self.max_dets]
                gm = gt["labels"] == ki
                gb = gt["bboxes"][gm]
                gig = np.zeros(len(gb), dtype=bool)
                ig_boxes = gt.get("bboxes_ignore", np.zeros((0, 4)))
                gb_all = np.concatenate([gb, ig_boxes], axis=0)
                gig_all = np.concatenate([gig, np.ones(len(ig_boxes), dtype=bool)])
                det_sel = np.where(m)[0][order]
                ious = self.compute_iou(db[order], gb_all, gig_all, img_idx, ki, det_sel)
                d_area = self.det_areas(db[order], img_idx, ki, det_sel)
                g_area = self.gt_areas(gb_all, gig_all, img_idx, ki)
                per_img.append(
                    (ds[order], gig_all, ious, d_area, g_area)
                )

            for ai, arng in enumerate(AREA_RANGES.values()):
                tps, igs, scores = [], [], []
                npig = 0
                for ds, gig, ious, d_area, g_area in per_img:
                    tp, dig, nv = self._evaluate_img(
                        ds, gig, arng, ious, d_area, g_area
                    )
                    tps.append(tp)
                    igs.append(dig)
                    scores.append(ds)
                    npig += nv
                if npig == 0:
                    continue
                scores = np.concatenate(scores)
                order = np.argsort(-scores, kind="mergesort")
                tp = np.concatenate(tps, axis=1)[:, order]
                dig = np.concatenate(igs, axis=1)[:, order]
                keep = ~dig
                for ti in range(t):
                    tpk = tp[ti][keep[ti]]
                    fpk = (~tp[ti])[keep[ti]]
                    tp_cum = np.cumsum(tpk)
                    fp_cum = np.cumsum(fpk)
                    rc = tp_cum / npig
                    pr = tp_cum / np.maximum(tp_cum + fp_cum, 1e-10)
                    recall[ti, ki, ai] = rc[-1] if len(rc) else 0.0
                    # precision envelope (monotone non-increasing)
                    for i in range(len(pr) - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    inds = np.searchsorted(rc, REC_THRS, side="left")
                    q = np.zeros(r)
                    for ri, pi in enumerate(inds):
                        if pi < len(pr):
                            q[ri] = pr[pi]
                    precision[ti, :, ki, ai] = q
        self.precision = precision
        self.recall = recall
        return {"precision": precision, "recall": recall}

    def summarize(self) -> Dict[str, float]:
        if not hasattr(self, "precision"):
            self.accumulate()

        def ap(iou_thr=None, area="all"):
            ai = list(AREA_RANGES).index(area)
            p = self.precision[:, :, :, ai]
            if iou_thr is not None:
                ti = int(np.argmin(np.abs(IOU_THRS - iou_thr)))
                p = p[ti : ti + 1]
            valid = p > -1
            return float(p[valid].mean()) if valid.any() else float("nan")

        per_class = []
        ai = 0
        for ki in range(self.num_classes):
            p = self.precision[:, :, ki, ai]
            valid = p > -1
            per_class.append(float(p[valid].mean()) if valid.any() else float("nan"))
        return {
            "AP": ap(),
            "AP50": ap(0.5),
            "AP75": ap(0.75),
            "APs": ap(area="small"),
            "APm": ap(area="medium"),
            "APl": ap(area="large"),
            "per_class_AP": per_class,
        }


class SegmCocoStyleEval(CocoStyleEval):
    """Mask AP: ``results[i] = (dets, labels, mask_crops)``, each mask a
    box-relative probability crop (or a full-image mask, used as it is);
    gt masks rasterised from the COCO segmentations (``gts[i]`` also has
    ``width``, ``height``, ``segmentations`` and ``areas``).  Area ranges
    use mask areas, as COCOeval does: a gt's the annotation's ``area``, a
    detection's its pasted mask's pixel count.  Ignore regions are their
    boxes.  A fourth result entry, where present, holds the detections'
    mask scores."""

    def _det_scores(self, res):
        return res[3] if len(res) > 3 else res[0][:, 4]

    def gt_areas(self, gt_boxes, gt_ig, img_idx, cls):
        gt = self.gts[img_idx]
        areas = self._box_areas(gt_boxes)
        ann_areas = gt.get("areas")
        if ann_areas is not None and len(ann_areas) == len(gt["labels"]):
            seg_areas = np.asarray(ann_areas, np.float64)[gt["labels"] == cls]
            # the class's gts come first; the ignore regions after them are
            # boxes, whose box area is their mask area
            areas[:len(seg_areas)] = seg_areas
        return areas

    def det_areas(self, det_boxes, img_idx, cls, det_sel):
        gt, res = self.gts[img_idx], self.results[img_idx]
        h, w = int(gt["height"]), int(gt["width"])
        return np.asarray([float(res[2][j].sum()) if res[2][j].shape == (h, w)
                           else float(paste_mask(res[2][j], det_boxes[i], h, w).sum())
                           for i, j in enumerate(det_sel)], np.float64)

    def compute_iou(self, det_boxes, gt_boxes, gt_ig, img_idx, cls, det_sel):
        gt, res = self.gts[img_idx], self.results[img_idx]
        h, w = int(gt["height"]), int(gt["width"])
        crops = [res[2][j] for j in det_sel]
        keep = gt["labels"] == cls
        segs = [s for s, k in zip(gt.get("segmentations", []), keep) if k]
        gt_bitmaps = [polygons_to_bitmap(s, h, w) for s in segs]
        for bi in range(len(gt_bitmaps), len(gt_boxes)):  # the ignore regions' boxes
            bm = np.zeros((h, w), np.uint8)
            x1, y1, x2, y2 = [int(round(v)) for v in gt_boxes[bi]]
            bm[max(y1, 0):max(y2, 0), max(x1, 0):max(x2, 0)] = 1
            gt_bitmaps.append(bm)
        return crop_mask_iou(det_boxes, crops, gt_boxes, gt_bitmaps, gt_ig, h, w)
