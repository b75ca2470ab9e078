"""Dataset wrappers (PyTorch port of ``boosting_rcnn_tpu/data/dataset_wrappers.py``):
``ConcatDataset``, ``RepeatDataset`` and ``ClassBalancedDataset``.

Each exposes what the loader reads: ``data_infos``, ``flags``,
``img_path(idx)``, ``CLASSES``, ``len()``, and ``semantic_map(idx)``
where the wrapped set has one.  ``ClassBalancedDataset`` repeats each
image ``ceil(max_c max(1, sqrt(t / f(c))))`` times over the classes ``c``
of its labels, ``f(c)`` the share of images holding ``c`` (the LVIS
paper's repeat-factor sampling).  ``evaluate`` is the first (or only)
wrapped set's, over the wrapper's images (the JAX wrappers have none; the
configs evaluate on a plain set, and this lets a ``ConcatDataset`` of VOC
sets give VOC mAP over all of its images).
"""
from __future__ import annotations

import copy
import math
from collections import defaultdict
from typing import Sequence

import numpy as np

__all__ = ["ConcatDataset", "RepeatDataset", "ClassBalancedDataset"]


class _Wrapper:
    def _inner(self):
        return self.datasets[0] if hasattr(self, "datasets") else self.dataset

    @property
    def CLASSES(self):
        return self._inner().CLASSES

    def __len__(self):
        return len(self.data_infos)

    def evaluate(self, results, *args, **kwargs):
        """The first wrapped set's ``evaluate`` with ``results[i]`` paired
        with this wrapper's image ``i``."""
        inner = copy.copy(self._inner())
        inner.data_infos = self.data_infos
        return inner.evaluate(results, *args, **kwargs)


class ConcatDataset(_Wrapper):
    """The images of ``datasets`` one set after another."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])
        self.data_infos = [d for ds in self.datasets for d in ds.data_infos]
        self.flags = np.concatenate([ds.flags for ds in self.datasets])

    def _locate(self, idx: int):
        di = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[di], idx - int(self._offsets[di])

    def img_path(self, idx: int) -> str:
        ds, i = self._locate(idx)
        return ds.img_path(i)

    def semantic_map(self, idx: int) -> np.ndarray:
        ds, i = self._locate(idx)
        return ds.semantic_map(i)


class RepeatDataset(_Wrapper):
    """``dataset``'s images ``times`` times over."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times
        self.data_infos = list(dataset.data_infos) * times
        self.flags = np.tile(dataset.flags, times)

    def img_path(self, idx: int) -> str:
        return self.dataset.img_path(idx % len(self.dataset))

    def semantic_map(self, idx: int) -> np.ndarray:
        return self.dataset.semantic_map(idx % len(self.dataset))


class ClassBalancedDataset(_Wrapper):
    """Repeat-factor sampling: image ``i`` repeated ``ceil(r(i))`` times,
    ``r(i) = max_{c in i} max(1, sqrt(oversample_thr / f(c)))``, in image
    order."""

    def __init__(self, dataset, oversample_thr: float = 1e-3):
        self.dataset = dataset
        counts = defaultdict(int)
        n = len(dataset)
        for d in dataset.data_infos:
            for c in set(d["labels"].tolist()):
                counts[c] += 1
        cat_repeat = {c: max(1.0, math.sqrt(oversample_thr / (cnt / n)))
                      for c, cnt in counts.items()}
        self.repeat_indices = []
        for i, d in enumerate(dataset.data_infos):
            r = max((cat_repeat.get(c, 1.0) for c in set(d["labels"].tolist())), default=1.0)
            self.repeat_indices.extend([i] * int(math.ceil(r)))
        self.data_infos = [dataset.data_infos[i] for i in self.repeat_indices]
        self.flags = dataset.flags[self.repeat_indices]

    def img_path(self, idx: int) -> str:
        return self.dataset.img_path(self.repeat_indices[idx])

    def semantic_map(self, idx: int) -> np.ndarray:
        return self.dataset.semantic_map(self.repeat_indices[idx])
