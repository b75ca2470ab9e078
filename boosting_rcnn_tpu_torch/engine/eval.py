"""Evaluation loop (PyTorch port of ``boosting_rcnn_tpu/engine/eval.py::
run_eval``): batched ``predict(..., rescale=True)`` over a test loader.

Each batch is predicted with the anchors of its own canvas (a portrait
batch's canvas is the transposed one), the results of the loader's
padding repeats (``pad``) are dropped, and each result goes to its
image's dataset index (``index``): the loader yields the landscape bucket
before the portrait one, and the dataset's ``evaluate`` pairs
``results[i]`` with image ``i``.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["run_eval"]


LOG_EVERY = 20  # batches between progress lines


def run_eval(detector, loader, logger=None,
             stats: dict | None = None) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-image ``(dets (N, 5), labels (N,))`` numpy results in
    original-image coordinates, in the order of ``loader``'s dataset (a
    test-mode ``DetDataLoader``).  ``stats``, when given, receives
    ``images``, ``seconds`` and ``images_per_s``."""
    anchors = {}
    results: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [None] * len(loader.ds)
    done = 0
    t0 = time.perf_counter()
    n_batches = 0
    for batch in loader.epoch_iter(0):
        canvas = tuple(int(s) for s in batch["images"].shape[1:3])
        if canvas not in anchors:
            anchors[canvas] = detector.anchors_for(canvas)
        dets, labels, valid = (t.cpu().numpy() for t in detector.predict(
            batch, *anchors[canvas], rescale=True)[:3])
        for i, j in enumerate(batch["index"]):
            if batch["pad"][i]:
                continue
            if results[j] is not None:
                raise RuntimeError(f"image {j} came twice from the test loader")
            results[j] = (dets[i][valid[i]], labels[i][valid[i]])
            done += 1
        n_batches += 1
        if logger and n_batches % LOG_EVERY == 0:
            logger.info(f"eval batch {n_batches}, {done} imgs, "
                        f"{done / (time.perf_counter() - t0):.1f} img/s")
    if done != len(results):
        raise RuntimeError(f"the test loader gave {done} of {len(results)} images")
    seconds = time.perf_counter() - t0
    if logger:
        logger.info(f"eval: {done} images in {seconds:.2f} s, "
                    f"{done / max(seconds, 1e-9):.2f} img/s")
    if stats is not None:
        stats.update(images=done, seconds=seconds, images_per_s=done / max(seconds, 1e-9))
    return results
