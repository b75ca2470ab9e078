"""Pascal VOC dataset, XML annotations (PyTorch port of
``boosting_rcnn_tpu/data/voc.py``).  ``evaluate`` gives VOC ``mAP``
(``eval_map``) and COCO-style ``bbox`` mAP, as the flagship's VOC config
asks for both."""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["VOC_CLASSES", "VOCDataset", "WIDER_CLASSES", "WIDERFaceDataset"]

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class VOCDataset:
    def __init__(self, ann_file: str, img_prefix: str,
                 classes: Optional[Sequence[str]] = None, test_mode: bool = False):
        self.img_prefix = img_prefix
        self.CLASSES = tuple(classes) if classes else VOC_CLASSES
        self.cat2label = {c: i for i, c in enumerate(self.CLASSES)}
        with open(ann_file) as f:
            ids = [line.strip() for line in f if line.strip()]
        self.data_infos: List[dict] = []
        for img_id in ids:
            root = ET.parse(os.path.join(img_prefix, "Annotations", f"{img_id}.xml")).getroot()
            size = root.find("size")
            w = int(size.find("width").text)
            h = int(size.find("height").text)
            boxes, labels, ignore = [], [], []
            for obj in root.findall("object"):
                name = obj.find("name").text
                if name not in self.cat2label:
                    continue
                bnd = obj.find("bndbox")
                box = [float(bnd.find(k).text) for k in ("xmin", "ymin", "xmax", "ymax")]
                diff_el = obj.find("difficult")
                difficult = int(diff_el.text or 0) if diff_el is not None else 0
                if difficult:
                    ignore.append(box)
                else:
                    boxes.append(box)
                    labels.append(self.cat2label[name])
            if not test_mode and len(boxes) == 0:
                continue
            self.data_infos.append(dict(
                id=img_id, filename=os.path.join("JPEGImages", f"{img_id}.jpg"),
                width=w, height=h,
                bboxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                labels=np.asarray(labels, np.int64),
                bboxes_ignore=np.asarray(ignore, np.float32).reshape(-1, 4),
                segmentations=[]))
        self.flags = np.array([1 if d["width"] / d["height"] > 1 else 0
                               for d in self.data_infos], np.uint8)

    def __len__(self):
        return len(self.data_infos)

    def img_path(self, idx: int) -> str:
        return os.path.join(self.img_prefix, self.data_infos[idx]["filename"])

    def evaluate(self, results, metric="mAP", iou_thr: float = 0.5, classwise: bool = False):
        from ..core.evaluation.coco_eval import CocoStyleEval
        from ..core.evaluation.mean_ap import eval_map

        metrics = [metric] if isinstance(metric, str) else list(metric)
        for m in metrics:
            if m not in ("mAP", "bbox"):
                raise KeyError(f"metric {m!r} is not supported for VOC")
        anns = [dict(bboxes=d["bboxes"], labels=d["labels"], bboxes_ignore=d["bboxes_ignore"])
                for d in self.data_infos]
        out = {}
        if "mAP" in metrics:
            mean_ap, per_class = eval_map(results, anns, iou_thr=iou_thr,
                                          num_classes=len(self.CLASSES))
            out["mAP"] = mean_ap
            if classwise:
                out["classwise"] = {self.CLASSES[i]: p["ap"] for i, p in enumerate(per_class)}
        if "bbox" in metrics:
            stats = CocoStyleEval(anns, results, len(self.CLASSES)).summarize()
            out.update(bbox_mAP=stats["AP"], bbox_mAP_50=stats["AP50"])
        return out


WIDER_CLASSES = ("face",)


class WIDERFaceDataset(VOCDataset):
    """WIDER Face in the VOC layout (XML annotations, one ``face`` class),
    as the JAX package reads it: images at ``JPEGImages/<id>.jpg``."""

    def __init__(self, ann_file: str, img_prefix: str, **kwargs):
        kwargs.setdefault("classes", WIDER_CLASSES)
        super().__init__(ann_file=ann_file, img_prefix=img_prefix, **kwargs)
