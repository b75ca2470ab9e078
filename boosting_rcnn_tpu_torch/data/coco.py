"""COCO-format dataset (PyTorch port of ``boosting_rcnn_tpu/data/coco.py``;
numpy only, no pycocotools).

Annotation loading with the ``classes`` filter, category id -> contiguous
label, crowd and ``ignore`` boxes kept apart as ``bboxes_ignore``,
``filter_empty_gt`` / ``min_size`` for training, the aspect-ratio group
flags (1 where w / h > 1), results -> COCO json, and COCO-style bbox
evaluation.  ``"segm"`` and ``"proposal"`` evaluation are not ported yet
and raise.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["DATASET_CLASSES", "CocoDataset"]

COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)
UTDAC_CLASSES = ("echinus", "holothurian", "scallop", "starfish")
BRACKISH_CLASSES = ("crab", "fish", "jellyfish", "shrimp", "small_fish", "starfish")
TRASHCAN_INSTANCE_CLASSES = (
    "rov", "plant", "animal_fish", "animal_starfish", "animal_shells",
    "animal_crab", "animal_eel", "animal_etc", "trash_clothing", "trash_pipe",
    "trash_bottle", "trash_bag", "trash_snack_wrapper", "trash_can",
    "trash_cup", "trash_container", "trash_unknown_instance", "trash_branch",
    "trash_wreckage", "trash_tarp", "trash_rope", "trash_net",
)
TRASHCAN_MATERIAL_CLASSES = (
    "rov", "plant", "animal_fish", "animal_starfish", "animal_shells",
    "animal_crab", "animal_eel", "animal_etc", "trash_etc", "trash_fabric",
    "trash_fishing_gear", "trash_metal", "trash_paper", "trash_plastic",
    "trash_rubber", "trash_wood",
)
CITYSCAPES_CLASSES = ("person", "rider", "car", "truck", "bus", "train", "motorcycle",
                      "bicycle")
WIDERFACE_CLASSES = ("face",)
DEEPFASHION_CLASSES = (
    "top", "skirt", "leggings", "dress", "outer", "pants", "bag",
    "neckwear", "headwear", "eyeglass", "belt", "footwear", "hair",
    "skin", "face",
)

DATASET_CLASSES = {
    "CocoDataset": COCO_CLASSES,
    "UTDACDataset": UTDAC_CLASSES,
    "BrackishDataset": BRACKISH_CLASSES,
    "TrashCanInstanceDataset": TRASHCAN_INSTANCE_CLASSES,
    "TrashCanMaterialDataset": TRASHCAN_MATERIAL_CLASSES,
    "CityscapesDataset": CITYSCAPES_CLASSES,
    "WIDERFaceDataset": WIDERFACE_CLASSES,
    "DeepFashionDataset": DEEPFASHION_CLASSES,
}


class CocoDataset:
    """Detection dataset backed by a COCO-format json file."""

    def __init__(self, ann_file: str, img_prefix: str = "",
                 classes: Optional[Sequence[str]] = None, test_mode: bool = False,
                 filter_empty_gt: bool = True, min_size: int = 32):
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        with open(ann_file) as f:
            coco = json.load(f)

        cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
        if classes is not None:
            name2cat = {c["name"]: c for c in cats}
            cats = [name2cat[n] for n in classes if n in name2cat]
            self.CLASSES = tuple(classes)
        else:
            self.CLASSES = tuple(c["name"] for c in cats)
        self.cat_ids = [c["id"] for c in cats]
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}

        imgs = {im["id"]: im for im in coco.get("images", [])}
        anns_by_img = {i: [] for i in imgs}
        for a in coco.get("annotations", []):
            if a["image_id"] in anns_by_img and a["category_id"] in self.cat2label:
                anns_by_img[a["image_id"]].append(a)

        self.data_infos: List[dict] = []
        for img_id, im in imgs.items():
            boxes, labels, ignore, segs, areas = [], [], [], [], []
            for a in anns_by_img[img_id]:
                x, y, w, h = a["bbox"]
                if w < 1 or h < 1 or a.get("area", w * h) <= 0:
                    continue
                box = [x, y, x + w, y + h]
                if a.get("iscrowd", 0) or a.get("ignore", 0):
                    ignore.append(box)
                else:
                    boxes.append(box)
                    labels.append(self.cat2label[a["category_id"]])
                    segs.append(a.get("segmentation"))
                    areas.append(float(a.get("area", w * h)))
            if (not test_mode and filter_empty_gt
                    and (len(boxes) == 0 or min(im["width"], im["height"]) < min_size)):
                continue
            self.data_infos.append(dict(
                id=img_id, filename=im["file_name"], width=im["width"], height=im["height"],
                bboxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                labels=np.asarray(labels, np.int64),
                bboxes_ignore=np.asarray(ignore, np.float32).reshape(-1, 4),
                segmentations=segs, areas=np.asarray(areas, np.float64)))
        # aspect-ratio group flag: 1 where w / h > 1 (the landscape bucket)
        self.flags = np.array([1 if d["width"] / d["height"] > 1 else 0
                               for d in self.data_infos], np.uint8)

    def __len__(self):
        return len(self.data_infos)

    def img_path(self, idx: int) -> str:
        return os.path.join(self.img_prefix, self.data_infos[idx]["filename"])

    def results_to_coco_json(self, results: List[Tuple[np.ndarray, np.ndarray]]):
        """``results[i] = (dets (N, 5), labels (N,))`` in original image
        coordinates -> COCO detection dicts."""
        out = []
        for idx, (dets, labels) in enumerate(results):
            img_id = self.data_infos[idx]["id"]
            for det, lab in zip(dets, labels):
                x1, y1, x2, y2, score = det.tolist()
                out.append(dict(image_id=img_id, bbox=[x1, y1, x2 - x1, y2 - y1],
                                score=float(score), category_id=self.cat_ids[int(lab)]))
        return out

    def evaluate(self, results, metric="bbox", classwise: bool = False):
        """COCO-style bbox mAP with the numpy evaluator."""
        from ..core.evaluation.coco_eval import CocoStyleEval

        metrics = [metric] if isinstance(metric, str) else list(metric)
        for m in metrics:
            if m in ("segm", "proposal", "proposal_fast"):
                raise NotImplementedError(
                    f"metric {m!r} is not ported to PyTorch yet: it needs the mask data path "
                    f"and mask results (segm) or proposal recall (proposal)")
            if m != "bbox":
                raise KeyError(f"metric {m!r} is not supported")
        gts = [dict(bboxes=d["bboxes"], labels=d["labels"], bboxes_ignore=d["bboxes_ignore"])
               for d in self.data_infos]
        stats = CocoStyleEval(gts, results, num_classes=len(self.CLASSES)).summarize()
        out = dict(bbox_mAP=stats["AP"], bbox_mAP_50=stats["AP50"], bbox_mAP_75=stats["AP75"],
                   bbox_mAP_s=stats["APs"], bbox_mAP_m=stats["APm"], bbox_mAP_l=stats["APl"])
        if classwise:
            out["classwise"] = {self.CLASSES[i]: ap for i, ap in enumerate(stats["per_class_AP"])}
        return out
