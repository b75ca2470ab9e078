"""Dataset builder (PyTorch port of ``boosting_rcnn_tpu/data/builder.py``):
the wrappers ``ConcatDataset``, ``RepeatDataset`` and
``ClassBalancedDataset``, ``CityscapesDataset``, ``WIDERFaceDataset``,
``VOCDataset``, ``LVISDataset`` / ``LVISV05Dataset`` / ``LVISV1Dataset``,
and ``CocoDataset`` with its class-list aliases (``UTDACDataset``, ...).
``CocoPanopticDataset`` and unknown types raise ``NotImplementedError``."""
from __future__ import annotations

from typing import Any, Dict

from .cityscapes import CityscapesDataset
from .coco import DATASET_CLASSES, CocoDataset
from .dataset_wrappers import ClassBalancedDataset, ConcatDataset, RepeatDataset
from .lvis import LvisDataset
from .voc import VOCDataset, WIDERFaceDataset

__all__ = ["DATASET_TYPES", "build_dataset"]

LVIS_TYPES = ("LVISDataset", "LVISV05Dataset", "LVISV1Dataset")
WRAPPER_TYPES = ("ConcatDataset", "RepeatDataset", "ClassBalancedDataset")
# every type build_dataset takes
DATASET_TYPES = (WRAPPER_TYPES + LVIS_TYPES + ("VOCDataset",)
                 + tuple(t for t in DATASET_CLASSES))


def build_dataset(cfg: Dict[str, Any], test_mode: bool = False):
    t = cfg.get("type", "CocoDataset")
    if t == "ConcatDataset":
        return ConcatDataset([build_dataset(c, test_mode) for c in cfg["datasets"]])
    if t == "RepeatDataset":
        return RepeatDataset(build_dataset(cfg["dataset"], test_mode), cfg["times"])
    if t == "ClassBalancedDataset":
        return ClassBalancedDataset(build_dataset(cfg["dataset"], test_mode),
                                    cfg.get("oversample_thr", 1e-3))
    common = dict(ann_file=cfg["ann_file"], img_prefix=cfg.get("img_prefix", ""),
                  test_mode=test_mode)
    if t == "CityscapesDataset":
        return CityscapesDataset(classes=cfg.get("classes"), **common)
    if t == "WIDERFaceDataset":
        return WIDERFaceDataset(**common)
    if t == "VOCDataset":
        return VOCDataset(classes=cfg.get("classes"), **common)
    if t in LVIS_TYPES:
        return LvisDataset(classes=cfg.get("classes"), **common)
    if t not in DATASET_CLASSES:
        raise NotImplementedError(f"dataset type {t!r} is not ported to PyTorch yet")
    classes = cfg.get("classes")
    if classes is None and t != "CocoDataset":
        classes = DATASET_CLASSES[t]
    return CocoDataset(classes=classes, seg_prefix=cfg.get("seg_prefix"), **common)
