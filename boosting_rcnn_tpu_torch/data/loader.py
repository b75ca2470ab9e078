"""Aspect-ratio-bucketed batches with a prefetch thread (PyTorch port of
``boosting_rcnn_tpu/data/loader.py``'s ``DetDataLoader`` and
``FakeDetLoader``).

Batches never mix buckets: landscape images (flag 1) go on the canvas,
portrait ones on the transposed canvas.  In train mode the batches are the
JAX loader's for the same seed: the epoch's order from
``RandomState(seed + epoch)`` (landscape bucket first, each bucket shuffled
and padded to whole batches with its own first images), the flips drawn
per image, in that order, from one ``RandomState(seed * 1000 + epoch)``
(the JAX loader's stream of shard 0).  In test mode every image is
evaluated exactly once, in dataset order per bucket: the last batch of a
bucket is padded by repeating its last image, the batch's ``pad`` mask
``(B,)`` marks the repeats, whose results are dropped, and its ``index``
``(B,)`` holds each image's dataset index, since the buckets' order is not
the dataset's.  (The JAX test loader drops a bucket's partial last batch,
may mix buckets in a batch and yields its results in bucket order; the
port does none of these.)

The images are preprocessed on ``device`` (``data/pipeline.py``): a batch's
``images`` is a tensor there, its other fields numpy.  The JAX loader's
other augmentations are not ported (``engine/runner.py`` rejects a config
that asks for one).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .image_io import load_image
from .pipeline import DEFAULT_MEAN, DEFAULT_STD, collate, preprocess

__all__ = ["DetDataLoader", "FakeDetLoader"]

PREFETCH = 4  # batches made ahead by the worker thread


class DetDataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        canvas: Tuple[int, int] = (800, 1344),
        scale: Tuple[int, int] = (1333, 800),
        train: bool = True,
        flip_prob: float = 0.5,
        max_gt: int = 100,
        seed: int = 0,
        mstrain_range: Optional[Tuple[int, int]] = None,
        img_norm: Optional[Dict] = None,  # dict(mean=, std=, to_rgb=)
        device="cpu",
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.canvas = tuple(canvas)
        self.canvas_portrait = (canvas[1], canvas[0])
        self.scale = scale
        self.train = train
        self.flip_prob = flip_prob if train else 0.0
        self.max_gt = max_gt
        self.seed = seed
        self.mstrain_range = mstrain_range
        self.device = torch.device(device)
        img_norm = img_norm or {}
        self.norm_mean = np.asarray(img_norm.get("mean", DEFAULT_MEAN), np.float32)
        self.norm_std = np.asarray(img_norm.get("std", DEFAULT_STD), np.float32)
        self.norm_to_rgb = bool(img_norm.get("to_rgb", True))

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        """The train order of ``epoch``: each bucket (landscape first)
        shuffled and padded to whole batches with its first images."""
        rng = np.random.RandomState(self.seed + epoch)
        order = []
        bs = self.batch_size
        for flag in (1, 0):
            idx = np.where(self.ds.flags == flag)[0]
            rng.shuffle(idx)
            if len(idx) % bs:
                idx = np.concatenate([idx, idx[:bs - len(idx) % bs]])
            order.append(idx)
        return np.concatenate(order)

    def _test_batches(self):
        """``(indices, pad)`` of every test batch: dataset order per bucket
        (landscape first), a partial last batch filled with its last image."""
        bs = self.batch_size
        for flag in (1, 0):
            idx = np.where(self.ds.flags == flag)[0]
            for start in range(0, len(idx), bs):
                take = idx[start:start + bs]
                pad = np.arange(bs) >= len(take)
                yield np.concatenate([take, np.repeat(take[-1:], bs - len(take))]), pad

    def _batches(self, epoch: int):
        if not self.train:
            return list(self._test_batches())
        idx = self._epoch_indices(epoch)
        bs = self.batch_size
        return [(idx[b * bs:(b + 1) * bs], None) for b in range(len(idx) // bs)]

    def _draw(self, rng: np.random.RandomState):
        """One image's random draws, in the JAX loader's order: the flip,
        then the multi-scale short side (None without ``mstrain_range``)."""
        flip = rng.rand() < self.flip_prob
        short = None
        if self.mstrain_range is not None and self.train:
            short = int(rng.randint(self.mstrain_range[0], self.mstrain_range[1] + 1))
        return flip, short

    def _load(self, i: int, rng: np.random.RandomState) -> Dict[str, object]:
        info = self.ds.data_infos[i]
        img = load_image(self.ds.img_path(i))
        flip, short = self._draw(rng)
        canvas = self.canvas if self.ds.flags[i] == 1 else self.canvas_portrait
        return preprocess(img, info["bboxes"], info["labels"], canvas=canvas, scale=self.scale,
                          flip=flip, max_gt=self.max_gt, mean=self.norm_mean,
                          std=self.norm_std, to_rgb=self.norm_to_rgb,
                          short_side_override=short, device=self.device)

    def __len__(self):
        if not self.train:
            bs = self.batch_size
            return sum(-(-int((self.ds.flags == f).sum()) // bs) for f in (1, 0))
        return len(self._epoch_indices(0)) // self.batch_size

    def epoch_iter(self, epoch: int, start: int = 0) -> Iterator[Dict[str, object]]:
        """The batches of ``epoch`` from its batch ``start`` on (the skipped
        batches' random draws are made, not their images), made by a
        prefetch thread."""
        batches = self._batches(epoch)
        rng = np.random.RandomState(self.seed * 1000 + epoch)
        for take, _ in batches[:start]:
            for _ in take:
                self._draw(rng)
        batches = batches[start:]
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def worker():
            try:
                for take, pad in batches:
                    if stop.is_set():
                        return
                    batch = collate([self._load(int(i), rng) for i in take])
                    if pad is not None:
                        batch.update(pad=pad, index=take.astype(np.int64))
                    q.put(batch)
            except Exception as exc:  # raised in the consumer
                q.put(exc)
            finally:
                q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():  # unblock a worker waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.01)


class FakeDetLoader:
    """Seeded synthetic batches (the JAX package's ``FakeDetLoader``, boxes
    only): noise images on the canvas, 1 to ``max_gt`` boxes per image."""

    def __init__(self, batch_size: int, canvas: Tuple[int, int], num_classes: int,
                 max_gt: int = 20, seed: int = 0, num_batches: int = 10, device="cpu"):
        self.batch_size = batch_size
        self.canvas = tuple(canvas)
        self.num_classes = num_classes
        self.max_gt = max_gt
        self.seed = seed
        self.num_batches = num_batches
        self.device = torch.device(device)

    def __len__(self):
        return self.num_batches

    def epoch_iter(self, epoch: int, start: int = 0):
        rng = np.random.RandomState(self.seed + epoch)
        h, w = self.canvas
        for k in range(self.num_batches):
            b, g = self.batch_size, self.max_gt
            n = rng.randint(1, g + 1, size=b)
            cx = rng.uniform(50, w - 50, (b, g))
            cy = rng.uniform(50, h - 50, (b, g))
            bw = rng.uniform(20, 150, (b, g))
            bh = rng.uniform(20, 150, (b, g))
            boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                             axis=-1).astype(np.float32)
            boxes[..., [0, 2]] = boxes[..., [0, 2]].clip(0, w)
            boxes[..., [1, 3]] = boxes[..., [1, 3]].clip(0, h)
            mask = np.arange(g)[None, :] < n[:, None]
            images = rng.randn(b, h, w, 3).astype(np.float32)
            labels = rng.randint(0, self.num_classes, (b, g))
            if k < start:
                continue
            yield dict(
                images=torch.from_numpy(images).to(self.device),
                gt_bboxes=boxes * mask[..., None],
                gt_labels=(labels * mask).astype(np.int32),
                gt_mask=mask,
                img_shape=np.tile(np.array([h, w], np.float32), (b, 1)),
                scale_factor=np.ones((b, 4), np.float32),
                ori_shape=np.tile(np.array([h, w], np.int32), (b, 1)),
            )
