"""High-level API (PyTorch port of ``boosting_rcnn_tpu/apis.py``; the
reference's ``mmdet/apis``): ``init_detector``, ``inference_detector``,
``set_random_seed`` and ``train_detector``.

The device resolves as ``builder.resolve_device`` does: the one given,
else the GPU, and without a GPU the call raises instead of running on the
CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .builder import build_detector
from .config import Config, load_config
from .data.image_io import load_image
from .data.pipeline import collate, preprocess
from .engine import runner
from .engine.checkpoint import checkpoint_meta, load_params

__all__ = ["DetectorHandle", "init_detector", "inference_detector", "set_random_seed",
           "train_detector"]


class DetectorHandle:
    """A built detector with its canvas, resize scale, anchors, classes and
    config, ready for inference on images."""

    def __init__(self, detector, canvas: Tuple[int, int], classes=None,
                 cfg: Optional[Config] = None, tiny: bool = False,
                 scale: Tuple[int, int] = (1333, 800)):
        self.detector = detector
        self.canvas = tuple(canvas)
        self.scale = tuple(scale)
        self.classes = classes
        self.cfg = cfg
        self.tiny = tiny
        self.anchors, self.num_level_anchors = detector.anchors_for(self.canvas)


def set_random_seed(seed: int) -> torch.Generator:
    """Seed numpy and torch and return a CPU ``torch.Generator`` seeded
    with ``seed``.  (The train step pins cuDNN to deterministic algorithms
    itself.)"""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def init_detector(config: Union[str, Config], checkpoint: Optional[str] = None,
                  device=None, dtype: Optional[torch.dtype] = None, seed: int = 0,
                  tiny: bool = False) -> DetectorHandle:
    """Build the config's detector with seeded random weights, then load
    ``checkpoint`` (a directory of ``engine.checkpoint.save_checkpoint`` or
    an mmdet ``.pth``) when given.  ``dtype`` defaults to the config's
    ``compute_dtype``; the canvas and resize scale are the test pipeline's;
    ``tiny`` shrinks the flagship as ``--tiny`` does (on its 128 x 160
    canvas)."""
    cfg = load_config(config) if isinstance(config, str) else config
    det = build_detector(runner.model_config(cfg, tiny), device=device, seed=seed,
                         dtype=runner.compute_dtype(cfg, dtype))
    meta = {}
    if checkpoint:
        det.net.load_state_dict(load_params(checkpoint))
        meta = checkpoint_meta(checkpoint)
    data = cfg.get("data") or {}
    classes = (data.get("test") or {}).get("classes") or meta.get("classes") or None
    canvas, scale = runner.test_geometry(cfg, tiny)
    return DetectorHandle(det, canvas, classes, cfg, tiny, scale)


def inference_detector(handle: DetectorHandle,
                       imgs: Union[str, np.ndarray, Sequence], score_thr: float = 0.0):
    """Detections for image path(s) or BGR uint8 array(s): per image a list
    of per-class ``(n, 5)`` arrays ``(x1, y1, x2, y2, score)`` in the
    image's coordinates (the reference's ``bbox2result``)."""
    single = not isinstance(imgs, (list, tuple))
    if single:
        imgs = [imgs]
    det = handle.detector
    samples = [preprocess(load_image(img) if isinstance(img, str) else img,
                          np.zeros((0, 4), np.float32), np.zeros((0,), np.int64),
                          canvas=handle.canvas, scale=handle.scale, device=det.device)
               for img in imgs]
    batch = collate(samples)
    dets, labels, valid = (t.cpu().numpy() for t in det.predict(
        batch, handle.anchors, handle.num_level_anchors, rescale=True)[:3])
    num_classes = len(handle.classes) if handle.classes else int(labels.max(initial=0)) + 1
    outs = []
    for i in range(dets.shape[0]):
        m = valid[i] & (dets[i][:, 4] >= score_thr)
        outs.append([dets[i][m & (labels[i] == c)] for c in range(num_classes)])
    return outs[0] if single else outs


def train_detector(config: Union[str, Config, DetectorHandle], work_dir: Optional[str] = None,
                   **kwargs):
    """Train (``engine.runner.train_detector``): from a config, or from a
    ``DetectorHandle``, whose detector and weights are trained in place."""
    if isinstance(config, DetectorHandle):
        kwargs.setdefault("tiny", config.tiny)
        return runner.train_detector(config.cfg, work_dir, detector=config.detector, **kwargs)
    return runner.train_detector(config, work_dir, **kwargs)
