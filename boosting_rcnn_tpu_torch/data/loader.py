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
``images`` is a tensor there, its other fields numpy.  With ``with_masks``
a batch also carries the instances' box-relative ``gt_mask_crops`` ``(B,
max_gt, 112, 112)`` uint8, rasterised from their polygons or uncompressed
RLE; with ``with_semantic`` the stuff maps of the dataset's
``seg_prefix`` as ``gt_semantic_seg`` ``(B, ceil(H / stride), ceil(W /
stride))`` int32 (255 ignored).

Train-time augmentations, on the host before the fused resize, drawn from
the image's stream in the JAX loader's order: ``instaboost`` (with masks;
``data/instaboost.py``), then ``albu`` (``data/albu.py``), then the flip,
then either ``lsj_range`` (``data/transforms.py``; the fused resize then
keeps the jittered image's size) or the multi-scale short side.  Each
turns a stuff map into a full-ignore one.  ``aug_seconds`` sums each
augmentation's host time and ``aug_images`` counts the images through
them.  The JAX loader's mosaic, mixup, AutoAugment and SSD chain are not
ported (``engine/runner.py`` rejects a config that asks for one).

The domain-generalisation targets (JAX ``loader.py:76-99``, ``:256-306``):
``domain_file`` (``data/suodac.py``) gives every sample its one-hot
``domain_label``; in train mode ``dgaug`` stylises each image toward a
donor of its domain (the first image of each domain in dataset order,
downscaled ``[::4, ::4]``; without domains one of the first four images,
drawn) and preprocesses it again with the same geometry into ``img_aug``,
and ``jigsaw`` (the number of permutation classes) cuts the normalised
canvas into 3 x 3 tiles of its largest part that 3 divides and permutes
them by one of a fixed table (``RandomState(0)``'s permutations, id 0 the
identity), as ``img_puzzle`` with the one-hot ``jig_labels``.  The puzzle
is cut from the preprocessed tensor on ``device``, as the JAX loader cuts
it from its normalised canvas.  Their draws follow the image's flip and
multi-scale draw: the donor (without domains), the blend's Beta, the
permutation.

``num_shards`` / ``shard_id`` shard the train batches for data-parallel
training (JAX ``loader.py:340-355``): every shard orders the epoch alike
(each bucket padded to whole batches of ``batch_size * num_shards``),
shard ``k`` takes batch slot ``b * num_shards + k``, and its draws come
from ``RandomState(seed * 1000 + epoch + shard_id)``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .image_io import load_image
from .pipeline import DEFAULT_MEAN, DEFAULT_STD, collate, preprocess
from .suodac import DomainMap

__all__ = ["DetDataLoader", "FakeDetLoader", "jigsaw_permutations", "jigsaw_puzzle"]

PREFETCH = 4  # batches made ahead by the worker thread


def jigsaw_permutations(n: int) -> np.ndarray:
    """``(n, 9)``: the identity, then distinct permutations of the 3 x 3
    tiles drawn from ``RandomState(0)`` (the JAX loader's table)."""
    prng = np.random.RandomState(0)
    perms = [np.arange(9)]
    seen = {tuple(perms[0])}
    while len(perms) < n:
        p = prng.permutation(9)
        if tuple(p) not in seen:
            seen.add(tuple(p))
            perms.append(p)
    return np.stack(perms)


def jigsaw_puzzle(image: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    """``image`` ``(H, W, C)`` with the 3 x 3 tiles of its top-left ``(H //
    3 * 3, W // 3 * 3)`` part placed by ``perm`` (tile ``k`` of the puzzle
    is tile ``perm[k]`` of the image); the rest as it is."""
    h3, w3 = image.shape[0] // 3 * 3, image.shape[1] // 3 * 3
    th, tw, c = h3 // 3, w3 // 3, image.shape[2]
    tiles = image[:h3, :w3].reshape(3, th, 3, tw, c).permute(0, 2, 1, 3, 4).reshape(9, th, tw, c)
    idx = torch.as_tensor(np.asarray(perm), dtype=torch.int64, device=image.device)
    puzzle = image.clone()
    puzzle[:h3, :w3] = tiles[idx].reshape(3, 3, th, tw, c).permute(0, 2, 1, 3, 4).reshape(
        h3, w3, c)
    return puzzle


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
        with_masks: bool = False,
        with_semantic: bool = False,
        semantic_stride: int = 8,
        img_norm: Optional[Dict] = None,  # dict(mean=, std=, to_rgb=)
        lsj_range: Optional[Tuple[float, float]] = None,
        albu: Optional[Dict] = None,  # dict(transforms=[...], min_visibility=)
        instaboost: Optional[Dict] = None,  # InstaBoost's keyword arguments
        domain_file: Optional[str] = None,
        jigsaw: Optional[int] = None,  # JiGEN's permutation classes
        dgaug: bool = False,
        num_shards: int = 1,
        shard_id: int = 0,
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
        self.with_masks = with_masks
        self.with_semantic = with_semantic
        self.semantic_stride = semantic_stride
        self.lsj_range = tuple(lsj_range) if (lsj_range and train) else None
        self.albu = albu if train else None
        self.instaboost = instaboost if train else None
        self.aug_seconds = {"instaboost": 0.0, "albu": 0.0, "lsj": 0.0}
        self.aug_images = 0
        self.domain_map = DomainMap(domain_file) if domain_file else None
        self.jig_perms = jigsaw_permutations(jigsaw) if (jigsaw and train) else None
        self.dgaug = bool(dgaug and train)
        self._style_donors = None
        self.num_shards, self.shard_id = num_shards, shard_id
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} is not one of {num_shards} shards")
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
        bs = self.batch_size * self.num_shards
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
        bs, ns = self.batch_size, self.num_shards
        return [(idx[(b * ns + self.shard_id) * bs:][:bs], None)
                for b in range(len(idx) // (bs * ns))]

    @property
    def _augmenting(self) -> bool:
        return bool(self.instaboost or self.albu or self.lsj_range)

    def _draw(self, rng: np.random.RandomState):
        """One image's random draws without augmentations, in the JAX
        loader's order: the flip, then the multi-scale short side (None
        without ``mstrain_range``)."""
        flip = rng.rand() < self.flip_prob
        short = None
        if self.mstrain_range is not None and self.train:
            short = int(rng.randint(self.mstrain_range[0], self.mstrain_range[1] + 1))
        return flip, short

    def _augment(self, i: int, rng: np.random.RandomState) -> Dict[str, object]:
        """Image ``i`` loaded and augmented: the arguments of its
        ``preprocess`` but for the normalisation's."""
        info = self.ds.data_infos[i]
        segs = info.get("segmentations") if self.with_masks else None
        sem = self.ds.semantic_map(i) if self.with_semantic else None
        img = load_image(self.ds.img_path(i))
        bboxes, labels = info["bboxes"], info["labels"]
        if self.instaboost and segs is not None:
            from .instaboost import instaboost

            t0 = time.perf_counter()
            img, bboxes, segs = instaboost(img, bboxes, labels, segs, rng, **self.instaboost)
            self.aug_seconds["instaboost"] += time.perf_counter() - t0
            if sem is not None:  # pasted pixels: the raster no longer holds
                sem = np.full(img.shape[:2], 255, np.int32)
        if self.albu:
            from .albu import apply_albu

            t0 = time.perf_counter()
            img, bboxes, labels, segs = apply_albu(
                img, bboxes, labels, segs, self.albu.get("transforms", []), rng,
                min_visibility=self.albu.get("min_visibility", 0.0))
            self.aug_seconds["albu"] += time.perf_counter() - t0
            if sem is not None:
                sem = np.full(img.shape[:2], 255, np.int32)
        flip = rng.rand() < self.flip_prob
        canvas = self.canvas if self.ds.flags[i] == 1 else self.canvas_portrait
        scale, short = self.scale, None
        if self.lsj_range is not None:
            from .transforms import large_scale_jitter

            t0 = time.perf_counter()
            img, bboxes, labels, segs = large_scale_jitter(img, bboxes, labels, segs, rng,
                                                           canvas, self.lsj_range)
            self.aug_seconds["lsj"] += time.perf_counter() - t0
            scale = (max(img.shape[:2]), min(img.shape[:2]))  # the fused resize keeps it
            if sem is not None:
                sem = np.full(img.shape[:2], 255, np.int32)
        elif self.mstrain_range is not None and self.train:
            short = int(rng.randint(self.mstrain_range[0], self.mstrain_range[1] + 1))
        if self._augmenting:
            self.aug_images += 1
        return dict(img=img, bboxes=bboxes, labels=labels, segmentations=segs,
                    semantic_map=sem, flip=flip, canvas=canvas, scale=scale,
                    short_side_override=short)

    def _load(self, i: int, rng: np.random.RandomState) -> Dict[str, object]:
        a = self._augment(i, rng)
        geometry = dict(canvas=a["canvas"], scale=a["scale"], flip=a["flip"],
                        max_gt=self.max_gt, mean=self.norm_mean, std=self.norm_std,
                        to_rgb=self.norm_to_rgb, short_side_override=a["short_side_override"],
                        device=self.device)
        out = preprocess(a["img"], a["bboxes"], a["labels"], segmentations=a["segmentations"],
                         semantic_map=a["semantic_map"], semantic_stride=self.semantic_stride,
                         **geometry)
        domain = None
        if self.domain_map is not None:
            domain = self.domain_map.one_hot(self.ds.img_path(i))
            out["domain_label"] = domain
        if self.dgaug:
            from .style_transfer import stylize

            donors = self._style_donor_list()
            donor = int(np.argmax(domain)) if domain is not None else int(rng.randint(len(donors)))
            content = a["img"][..., ::-1].astype(np.float64) / 255.0
            aug = stylize(content, donors[donor % len(donors)], rng=rng)
            img_aug = (np.clip(aug, 0, 1) * 255.0 + 0.5).astype(np.uint8)[..., ::-1]
            out["img_aug"] = preprocess(img_aug, a["bboxes"], a["labels"], **geometry)["images"]
        if self.jig_perms is not None:
            jid = int(rng.randint(len(self.jig_perms)))
            out["img_puzzle"] = jigsaw_puzzle(out["images"], self.jig_perms[jid])
            out["jig_labels"] = np.eye(len(self.jig_perms), dtype=np.float32)[jid]
        return out

    def _replay_targets(self, rng: np.random.RandomState) -> None:
        """The draws of ``dgaug`` and ``jigsaw`` that ``_load`` makes after an
        image's flip and side, for a skipped image (none depends on it)."""
        if self.dgaug:
            if self.domain_map is None:
                rng.randint(min(4, len(self.ds.data_infos)))
            rng.beta(2.0, 2.0)
        if self.jig_perms is not None:
            rng.randint(len(self.jig_perms))

    def _style_donor_list(self):
        """The style donors, loaded once: each domain's first image in dataset
        order (image 0 for a domain without one), or without domains the
        first four images; each ``[::4, ::4]``, RGB float64 in [0, 1]."""
        if self._style_donors is None:
            if self.domain_map is not None:
                first = {}
                for i in range(len(self.ds.data_infos)):
                    p = self.ds.img_path(i)
                    first.setdefault(int(np.argmax(self.domain_map.one_hot(p))), p)
                paths = [first.get(d, self.ds.img_path(0))
                         for d in range(self.domain_map.num_domains)]
            else:
                paths = [self.ds.img_path(i) for i in range(min(4, len(self.ds.data_infos)))]
            self._style_donors = [load_image(p)[::4, ::4, ::-1].astype(np.float64) / 255.0
                                  for p in paths]
        return self._style_donors

    def __len__(self):
        if not self.train:
            bs = self.batch_size
            return sum(-(-int((self.ds.flags == f).sum()) // bs) for f in (1, 0))
        return len(self._epoch_indices(0)) // (self.batch_size * self.num_shards)

    def epoch_iter(self, epoch: int, start: int = 0) -> Iterator[Dict[str, object]]:
        """The batches of ``epoch`` from its batch ``start`` on (the skipped
        batches' random draws are made, and with augmentations, whose draws
        depend on the images, their images are loaded and augmented too),
        made by a prefetch thread."""
        batches = self._batches(epoch)
        rng = np.random.RandomState(self.seed * 1000 + epoch + self.shard_id)
        for take, _ in batches[:start]:
            for i in take:  # augmentations draw by the image's content: replay them
                self._augment(int(i), rng) if self._augmenting else self._draw(rng)
                self._replay_targets(rng)
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


FAKE_MASK_CROP_SIZE = 28  # the fake loader's circle crops (the JAX loader's default)
FAKE_STUFF_CLASSES = 8  # the fake loader's stuff classes after the thing classes


class FakeDetLoader:
    """Seeded synthetic batches (the JAX package's ``FakeDetLoader``): noise
    images on the canvas, 1 to ``max_gt`` boxes per image; with
    ``with_masks`` a 28 x 28 circle crop for every slot, with
    ``with_semantic`` a stuff map at ``1 / semantic_stride`` of the canvas
    (2-4 horizontal stripes of classes ``num_classes`` to ``num_classes +
    7``, each gt box painted with its label); with ``num_domains`` a
    drawn one-hot ``domain_label`` an image, with ``jigsaw`` the images
    upside down as ``img_puzzle`` and a drawn one-hot ``jig_labels``.  The
    draws are the JAX loader's, in its order, so the two give equal batches
    for a seed."""

    def __init__(self, batch_size: int, canvas: Tuple[int, int], num_classes: int,
                 max_gt: int = 20, seed: int = 0, num_batches: int = 10,
                 with_masks: bool = False, with_semantic: bool = False,
                 semantic_stride: int = 8, num_domains: int = 0, jigsaw: int = 0,
                 device="cpu"):
        self.batch_size = batch_size
        self.canvas = tuple(canvas)
        self.num_classes = num_classes
        self.max_gt = max_gt
        self.seed = seed
        self.num_batches = num_batches
        self.with_masks = with_masks
        self.with_semantic = with_semantic
        self.semantic_stride = semantic_stride
        self.num_domains, self.jigsaw = num_domains, jigsaw
        self.device = torch.device(device)

    def __len__(self):
        return self.num_batches

    def _semantic(self, rng, boxes, labels, n) -> np.ndarray:
        """The batch's stuff maps: stripes of stuff classes, then each gt box
        painted with its label (a learnable image -> class map)."""
        h, w = self.canvas
        st = self.semantic_stride
        b = boxes.shape[0]
        sh, sw = (h + st - 1) // st, (w + st - 1) // st
        sem = np.zeros((b, sh, sw), np.int32)
        for bi in range(b):
            nstripe = rng.randint(2, 5)
            edges = np.sort(rng.randint(0, sh, nstripe - 1))
            cls = rng.randint(self.num_classes, self.num_classes + FAKE_STUFF_CLASSES, nstripe)
            prev = 0
            for e, c in zip(list(edges) + [sh], cls):
                sem[bi, prev:e] = c
                prev = e
            for gi in range(int(n[bi])):
                x1, y1, x2, y2 = (boxes[bi, gi] / st).astype(int)
                sem[bi, y1:y2, x1:x2] = labels[bi, gi]
        return sem

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
            labels = (rng.randint(0, self.num_classes, (b, g)) * mask).astype(np.int32)
            boxes = boxes * mask[..., None]
            batch = dict(gt_bboxes=boxes, gt_labels=labels, gt_mask=mask,
                         img_shape=np.tile(np.array([h, w], np.float32), (b, 1)),
                         scale_factor=np.ones((b, 4), np.float32),
                         ori_shape=np.tile(np.array([h, w], np.int32), (b, 1)))
            if self.with_masks:
                s = FAKE_MASK_CROP_SIZE
                yy, xx = np.mgrid[0:s, 0:s]
                circle = (((yy - s / 2) ** 2 + (xx - s / 2) ** 2) < (s / 2.5) ** 2).astype(np.uint8)
                batch["gt_mask_crops"] = np.broadcast_to(circle, (b, g, s, s)).copy()
            if self.with_semantic:
                batch["gt_semantic_seg"] = self._semantic(rng, boxes, labels, n)
            if self.num_domains > 0:
                batch["domain_label"] = np.eye(self.num_domains, dtype=np.float32)[
                    rng.randint(0, self.num_domains, size=b)]
            if self.jigsaw > 0:
                batch["jig_labels"] = np.eye(self.jigsaw, dtype=np.float32)[
                    rng.randint(0, self.jigsaw, size=b)]
            if k < start:
                continue
            if self.jigsaw > 0:
                batch["img_puzzle"] = torch.from_numpy(images[:, ::-1].copy()).to(self.device)
            yield dict(images=torch.from_numpy(images).to(self.device), **batch)
