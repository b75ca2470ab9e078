"""Evaluation loop (PyTorch port of ``boosting_rcnn_tpu/engine/eval.py::
run_eval``): batched ``predict(..., rescale=True)`` over a test loader.

Each batch is predicted with the anchors of its own canvas (a portrait
batch's canvas is the transposed one), the results of the loader's
padding repeats (``pad``) are dropped, and each result goes to its
image's dataset index (``index``): the loader yields the landscape bucket
before the portrait one, and the dataset's ``evaluate`` pairs
``results[i]`` with image ``i``.  A mask model's results carry its
detections' box-relative mask crops too: ``(dets, labels, masks (N, 28,
28))``, and Mask Scoring R-CNN's their mask scores after them, ``(dets,
labels, masks, mask_scores (N,))``, as the JAX package's do (JAX
``engine/eval.py:50-55``); segm evaluation ranks by the mask scores.

``run_eval_tta`` is the flip and multi-scale test-time augmentation (JAX
``run_eval_tta``): one test loader a short side, each on its own canvas,
iterated in lockstep (every loader holds the same images in the same
order, a portrait bucket on the transposed canvas), each batch's views
through ``aug_predict_multi``; the results go back as ``run_eval``'s do.
Unlike the JAX function, its loaders take the pipeline's ``img_norm``
(a caffe-style config's BGR mean-only normalisation).
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.loader import DetDataLoader
from ..models.detectors.two_stage import aug_predict_multi, check_tta

__all__ = ["run_eval", "run_eval_tta", "tta_loaders"]


LOG_EVERY = 20  # batches between progress lines


def run_eval(detector, loader, logger=None,
             stats: dict | None = None) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-image ``(dets (N, 5), labels (N,))`` numpy results in
    original-image coordinates (``(dets, labels, masks (N, M, M))`` for a
    mask model, and ``mask_scores (N,)`` after them for Mask Scoring
    R-CNN), in the order of ``loader``'s dataset (a test-mode
    ``DetDataLoader``).  ``stats``, when given, receives
    ``images``, ``seconds`` and ``images_per_s``."""
    anchors = _anchors(detector)
    outs = ((b, detector.predict(b, *anchors(b), rescale=True)) for b in loader.epoch_iter(0))
    return _evaluate(outs, len(loader.ds), logger, stats, "eval")


def _anchors(detector):
    """``batch -> (anchors, num_level_anchors)`` of the batch's canvas,
    each canvas's made once."""
    cache = {}

    def get(batch):
        canvas = tuple(int(s) for s in batch["images"].shape[1:3])
        if canvas not in cache:
            cache[canvas] = detector.anchors_for(canvas)
        return cache[canvas]

    return get


def _evaluate(outs, n_images: int, logger, stats, what: str):
    """The results of each ``(batch, predict output)`` of ``outs`` at their
    images' dataset indices, the padding repeats dropped."""
    results: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [None] * n_images
    done = 0
    t0 = time.perf_counter()
    n_batches = 0
    for batch, out in outs:
        out = [t.cpu().numpy() for t in out]
        dets, labels, valid = out[:3]
        extra = out[3:]  # masks, and Mask Scoring R-CNN's mask scores
        for i, j in enumerate(batch["index"]):
            if batch["pad"][i]:
                continue
            if results[j] is not None:
                raise RuntimeError(f"image {j} came twice from the test loader")
            v = valid[i]
            results[j] = (dets[i][v], labels[i][v], *(x[i][v] for x in extra))
            done += 1
        n_batches += 1
        if logger and n_batches % LOG_EVERY == 0:
            logger.info(f"{what} batch {n_batches}, {done} imgs, "
                        f"{done / (time.perf_counter() - t0):.1f} img/s")
    if done != len(results):
        raise RuntimeError(f"the test loader gave {done} of {len(results)} images")
    seconds = time.perf_counter() - t0
    if logger:
        logger.info(f"{what}: {done} images in {seconds:.2f} s, "
                    f"{done / max(seconds, 1e-9):.2f} img/s")
    if stats is not None:
        stats.update(images=done, seconds=seconds, images_per_s=done / max(seconds, 1e-9))
    return results


def tta_loaders(dataset, batch_size: int, scales: Sequence[int], long_side: int = 1333,
                img_norm: Optional[Dict] = None, device="cpu") -> List[DetDataLoader]:
    """One test-mode loader a short side ``s`` of ``scales``: scale
    ``(long_side, s)`` on the canvas ``(ceil(s / 32) * 32, ceil(long_side /
    32) * 32)`` (JAX ``run_eval_tta``), normalised by ``img_norm``."""
    return [DetDataLoader(dataset, batch_size=batch_size,
                          canvas=(math.ceil(s / 32) * 32, math.ceil(long_side / 32) * 32),
                          scale=(long_side, s), train=False, img_norm=img_norm, device=device)
            for s in scales]


def run_eval_tta(detector, dataset, batch_size: int, scales: Sequence[int],
                 long_side: int = 1333, flip: bool = True, img_norm: Optional[Dict] = None,
                 logger=None, stats: dict | None = None) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-image ``(dets (N, 5), labels (N,))`` of test-time augmentation
    over the short sides ``scales`` (each view and, with ``flip``, its
    mirror; ``aug_predict_multi``), in dataset order, as ``run_eval``'s.
    A cascade or HTC raises before any image is read."""
    check_tta(detector)
    loaders = tta_loaders(dataset, batch_size, scales, long_side, img_norm, detector.device)
    anchors = _anchors(detector)
    flips = (False, True) if flip else (False,)

    def outs():
        for batches in zip(*(ld.epoch_iter(0) for ld in loaders)):
            first = batches[0]
            if not all(np.array_equal(b["index"], first["index"])
                       and np.array_equal(b["pad"], first["pad"]) for b in batches[1:]):
                raise RuntimeError("the test loaders of the scales hold different images")
            yield first, aug_predict_multi(detector, [(b, *anchors(b), f) for b in batches
                                                      for f in flips])

    return _evaluate(outs(), len(dataset), logger, stats, "tta eval")
