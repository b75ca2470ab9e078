"""Cityscapes (PyTorch port of ``boosting_rcnn_tpu/data/cityscapes.py``).

COCO-format annotations of the 8 Cityscapes thing classes.  The
``cityscapes`` metric writes the official instance dump when given an
``outfile_prefix`` (``format_results``: an image's ``<stem>_pred.txt``
lists one line ``<mask png> <labelId> <score>`` an instance, and each
instance's full-frame binary mask is written as an 8-bit grayscale PNG,
0 or 255, by the port's own PNG writer) and reports mask AP / AP50 from
the COCO-style segm evaluation (``cityscapes_mAP``, ``cityscapes_AP50``).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from .coco import CITYSCAPES_CLASSES, CocoDataset
from .image_io import write_png_gray
from .mask_utils import paste_mask

__all__ = ["CityscapesDataset", "CLASS_TO_LABEL_ID"]

# the thing classes' official label ids
CLASS_TO_LABEL_ID = {
    "person": 24, "rider": 25, "car": 26, "truck": 27, "bus": 28,
    "train": 31, "motorcycle": 32, "bicycle": 33,
}


class CityscapesDataset(CocoDataset):
    def __init__(self, ann_file: str, img_prefix: str = "",
                 classes: Optional[Sequence[str]] = None, **kwargs):
        super().__init__(ann_file, img_prefix, classes=classes or CITYSCAPES_CLASSES, **kwargs)

    def format_results(self, results, outfile_prefix: str):
        """Write the instance dump of ``results[i] = (dets, labels, masks)``
        (box-relative mask crops) under ``outfile_prefix``; returns the
        ``*_pred.txt`` paths."""
        os.makedirs(outfile_prefix, exist_ok=True)
        files = []
        for idx, (dets, labels, masks) in enumerate(results):
            info = self.data_infos[idx]
            stem = os.path.splitext(os.path.basename(info["filename"]))[0]
            lines = []
            for j in range(len(dets)):
                label_id = CLASS_TO_LABEL_ID.get(self.CLASSES[int(labels[j])], 24)
                png = f"{stem}_{j}.png"
                full = paste_mask(np.asarray(masks[j], np.float32),
                                  np.asarray(dets[j][:4], np.float32),
                                  int(info["height"]), int(info["width"]))
                write_png_gray(os.path.join(outfile_prefix, png),
                               (full > 0.5).astype(np.uint8) * 255)
                lines.append(f"{png} {label_id} {float(dets[j][4]):.6f}")
            txt = os.path.join(outfile_prefix, f"{stem}_pred.txt")
            with open(txt, "w") as f:
                f.write("\n".join(lines) + ("\n" if lines else ""))
            files.append(txt)
        return files

    def evaluate(self, results, metric="bbox", classwise: bool = False,
                 outfile_prefix: Optional[str] = None):
        """``cityscapes`` (mask AP, and the dump with ``outfile_prefix``)
        beside the COCO metrics."""
        metrics = [metric] if isinstance(metric, str) else list(metric)
        out = {}
        if "cityscapes" in metrics:
            metrics.remove("cityscapes")
            if outfile_prefix and all(isinstance(r, tuple) and len(r) == 3 for r in results):
                self.format_results(results, outfile_prefix)
            segm = super().evaluate(results, metric="segm")
            out["cityscapes_mAP"] = segm["segm_mAP"]
            out["cityscapes_AP50"] = segm["segm_mAP_50"]
        if metrics:
            out.update(super().evaluate(results, metric=metrics, classwise=classwise))
        return out
