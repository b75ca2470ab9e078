"""Dataset builder (PyTorch port of ``boosting_rcnn_tpu/data/builder.py``):
``CocoDataset``, its class-list aliases (``UTDACDataset``, ...) and
``VOCDataset``.  Every other type, the dataset wrappers among them, raises
``NotImplementedError``."""
from __future__ import annotations

from typing import Any, Dict

from .coco import DATASET_CLASSES, CocoDataset
from .voc import VOCDataset

__all__ = ["build_dataset"]

# COCO-json types whose JAX datasets add more than the class list
_OTHER_COCO_TYPES = ("CityscapesDataset", "WIDERFaceDataset")


def build_dataset(cfg: Dict[str, Any], test_mode: bool = False):
    t = cfg.get("type", "CocoDataset")
    if t == "VOCDataset":
        return VOCDataset(ann_file=cfg["ann_file"], img_prefix=cfg.get("img_prefix", ""),
                          classes=cfg.get("classes"), test_mode=test_mode)
    if t not in DATASET_CLASSES or t in _OTHER_COCO_TYPES:
        raise NotImplementedError(f"dataset type {t!r} is not ported to PyTorch yet")
    classes = cfg.get("classes")
    if classes is None and t != "CocoDataset":
        classes = DATASET_CLASSES[t]
    return CocoDataset(ann_file=cfg["ann_file"], img_prefix=cfg.get("img_prefix", ""),
                       classes=classes, test_mode=test_mode, seg_prefix=cfg.get("seg_prefix"))
