"""The port's datasets, wrappers and their evaluation against the JAX
package's, on the CPU, on sets from the port's generators
(``data/synthetic.py``): LVIS v1 and v0.5, Cityscapes, a VOC pair, shapes.

- wrappers: ``len``, ``flags``, ``data_infos`` and ``img_path`` equal to the
  JAX ``ConcatDataset`` / ``RepeatDataset`` / ``ClassBalancedDataset``'s;
- LVIS parsing equal in both versions; the federated bbox AP within 1e-12
  of JAX ``LvisDataset.evaluate`` on seeded results, classwise too;
- Cityscapes' ``format_results`` dump equal (the text lines, and the PNG
  masks through the port's decoder against ``cv2.imread`` of JAX's), and
  its ``cityscapes`` metric equal; WIDER Face parsing equal;
- the train loaders, the port's against JAX's ``DetDataLoader`` over two
  epochs with ``lsj_range``, ``albu`` and ``instaboost`` (with masks), each
  wrapper, and LVIS under ``ClassBalancedDataset``: batch order, boxes,
  labels and mask crops equal, images within 1e-4.
"""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

cv2 = pytest.importorskip("cv2")

from boosting_rcnn_tpu.data.builder import build_dataset as j_build  # noqa: E402
from boosting_rcnn_tpu.data.loader import DetDataLoader as JLoader  # noqa: E402
from boosting_rcnn_tpu_torch.data.builder import build_dataset as t_build  # noqa: E402
from boosting_rcnn_tpu_torch.data.image_io import load_png_gray  # noqa: E402
from boosting_rcnn_tpu_torch.data.loader import DetDataLoader as TLoader  # noqa: E402
from boosting_rcnn_tpu_torch.data.synthetic import (generate, generate_cityscapes,  # noqa: E402
                                                     generate_lvis, generate_voc)

CANVAS = (64, 80)
IMAGE_TOL = 1e-4
INFO_KEYS = ("id", "filename", "width", "height", "bboxes", "labels", "bboxes_ignore",
             "segmentations")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread: beside the suite's other pytest
    workers, torch's default of a thread a core oversubscribes the host
    (this file's cases ran several times slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sets"))
    out = {}
    for version in ("v1", "v0.5"):
        d = os.path.join(root, f"lvis_{version}")
        generate_lvis(d, n_train=24, n_val=6, seed=1, frame=(80, 64), version=version)
        out[version] = d
    generate_cityscapes(os.path.join(root, "cityscapes"), n_train=2, n_val=3, seed=2,
                        frame=(160, 80))
    generate_voc(os.path.join(root, "voc"), n_train=5, n_test=3, seed=3, frame=(80, 64))
    generate(os.path.join(root, "shapes"), n_train=6, n_val=0, seed=4,
             frame_sizes=[(80, 64)], n_portrait=1, object_scale=0.5)
    out["root"] = root
    return out


def _lvis_cfg(sets, version, split="train"):
    d = sets[version]
    return dict(type="LVISV1Dataset" if version == "v1" else "LVISV05Dataset",
                ann_file=os.path.join(d, "annotations", f"lvis_{version}_{split}.json"),
                img_prefix=d)


def _voc_cfg(sets, year, split="trainval"):
    d = os.path.join(sets["root"], "voc", f"VOC{year}")
    return dict(type="VOCDataset", ann_file=os.path.join(d, "ImageSets", "Main", f"{split}.txt"),
                img_prefix=d)


def _coco_cfg(sets):
    d = os.path.join(sets["root"], "shapes")
    return dict(type="CocoDataset", ann_file=os.path.join(d, "train.json"),
                img_prefix=os.path.join(d, "train"))


def _city_cfg(sets, split="val"):
    d = os.path.join(sets["root"], "cityscapes")
    return dict(type="CityscapesDataset",
                ann_file=os.path.join(d, "annotations",
                                      f"instancesonly_filtered_gtFine_{split}.json"),
                img_prefix=os.path.join(d, "leftImg8bit", split))


def _wrapper_cfgs(sets):
    return {
        "concat": dict(type="ConcatDataset", datasets=[_voc_cfg(sets, "2007"),
                                                       _voc_cfg(sets, "2012")]),
        "repeat": dict(type="RepeatDataset", times=3, dataset=_coco_cfg(sets)),
        "class_balanced": dict(type="ClassBalancedDataset", oversample_thr=0.1,
                               dataset=_lvis_cfg(sets, "v1")),
    }


def _same_infos(t, j):
    assert len(t) == len(j)
    np.testing.assert_array_equal(t.flags, j.flags)
    assert len(t.data_infos) == len(j.data_infos)
    for a, b in zip(t.data_infos, j.data_infos):
        for k in INFO_KEYS:
            if k in b:
                if isinstance(b[k], np.ndarray):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                else:
                    assert a[k] == b[k], k
    assert [t.img_path(i) for i in range(len(t))] == [j.img_path(i) for i in range(len(j))]
    assert tuple(t.CLASSES) == tuple(j.CLASSES)


@pytest.mark.parametrize("kind", ["concat", "repeat", "class_balanced"])
def test_wrappers_match_jax(sets, kind):
    cfg = _wrapper_cfgs(sets)[kind]
    t, j = t_build(cfg), j_build(cfg)
    _same_infos(t, j)
    if kind == "class_balanced":  # the long tail: some images repeated
        assert len(t) > len(t.dataset)


@pytest.mark.parametrize("version", ["v1", "v0.5"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_lvis_parsing_matches_jax(sets, version, split):
    cfg = _lvis_cfg(sets, version, split)
    t, j = t_build(cfg, test_mode=split == "val"), j_build(cfg, test_mode=split == "val")
    _same_infos(t, j)
    assert t.cat_ids == j.cat_ids and len(t.CLASSES) == (1203 if version == "v1" else 1230)
    assert t._neg_ids == j._neg_ids
    assert t.data_infos[0]["filename"].startswith(f"{split}2017/")


def _seeded_results(ds, seed, with_masks=False):
    """Per image: noisy copies of its gts at random scores, plus random
    boxes of classes it holds or not."""
    rs = np.random.RandomState(seed)
    out = []
    for d in ds.data_infos:
        boxes = d["bboxes"]
        n = len(boxes)
        jit = boxes + rs.uniform(-3, 3, boxes.shape).astype(np.float32)
        extra = np.sort(rs.uniform(0, 60, (4, 4)).astype(np.float32).reshape(4, 2, 2), 1)
        extra = extra.reshape(4, 4)[:, [0, 2, 1, 3]]
        dets = np.concatenate([jit, extra])
        labels = np.concatenate([d["labels"], rs.randint(0, len(ds.CLASSES), 2),
                                 d["labels"][:1].repeat(2) if n else rs.randint(0, 8, 2)])
        scores = rs.rand(len(dets)).astype(np.float32)
        r = (np.concatenate([dets, scores[:, None]], 1), labels.astype(np.int64))
        if with_masks:
            r = r + (rs.rand(len(dets), 28, 28).astype(np.float32),)
        out.append(r)
    return out


@pytest.mark.parametrize("version", ["v1", "v0.5"])
def test_lvis_federated_ap_matches_jax(sets, version):
    cfg = _lvis_cfg(sets, version, "train")
    t, j = t_build(cfg, test_mode=True), j_build(cfg, test_mode=True)
    results = _seeded_results(t, 7)
    got = t.evaluate(results, metric=["bbox", "segm"], classwise=True)
    ref = j.evaluate(results, metric=["bbox", "segm"], classwise=True)
    assert set(got) == set(ref) == {"bbox_mAP", "bbox_mAP_50", "classwise"}
    for k in ("bbox_mAP", "bbox_mAP_50"):
        assert abs(got[k] - ref[k]) <= 1e-12, k
    assert 0 < got["bbox_mAP"] < 1
    assert got["classwise"].keys() == ref["classwise"].keys()
    for k, v in ref["classwise"].items():
        assert abs(got["classwise"][k] - v) <= 1e-12


def test_cityscapes_dump_and_metric_match_jax(sets, tmp_path):
    cfg = _city_cfg(sets)
    t, j = t_build(cfg, test_mode=True), j_build(cfg, test_mode=True)
    _same_infos(t, j)
    results = _seeded_results(t, 8, with_masks=True)
    got = t.evaluate(results, metric=["cityscapes", "bbox"], outfile_prefix=str(tmp_path / "t"))
    ref = j.evaluate(results, metric=["cityscapes", "bbox"], outfile_prefix=str(tmp_path / "j"))
    assert set(got) == set(ref) and "cityscapes_mAP" in got
    for k in ref:  # nan where no gt falls in an area range
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-12, err_msg=k)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) > 3
    for name in names:
        if name.endswith(".txt"):
            assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
        else:
            np.testing.assert_array_equal(load_png_gray(str(tmp_path / "t" / name)),
                                          cv2.imread(str(tmp_path / "j" / name),
                                                     cv2.IMREAD_GRAYSCALE), err_msg=name)


def test_wider_face_parsing_matches_jax(sets, tmp_path):
    """A VOC-layout set with ``face`` objects."""
    root = tmp_path / "wider"
    generate_voc(str(root), n_train=3, n_test=0, seed=5, frame=(80, 64), years=("2007",))
    voc = root / "VOC2007"
    for xml in (voc / "Annotations").iterdir():
        text = xml.read_text()
        for name in ("bird", "boat", "car", "cat"):
            text = text.replace(f"<name>{name}</name>", "<name>face</name>")
        xml.write_text(text)
    cfg = dict(type="WIDERFaceDataset", ann_file=str(voc / "ImageSets" / "Main" / "trainval.txt"),
               img_prefix=str(voc))
    t, j = t_build(cfg), j_build(cfg)
    _same_infos(t, j)
    assert t.CLASSES == ("face",) and sum(len(d["bboxes"]) for d in t.data_infos) > 0


def _loader_pair(tds, jds, **kw):
    base = dict(batch_size=2, canvas=CANVAS, scale=(80, 64), train=True, seed=3)
    base.update(kw)
    jkw = {k: v for k, v in base.items() if k != "scale"}  # the JAX tool passes no scale
    return TLoader(tds, **base), JLoader(jds, **jkw)


def _same_batches(tl, jl, epochs=2):
    n = 0
    for epoch in range(epochs):
        tb, jb = list(tl.epoch_iter(epoch)), list(jl.epoch_iter(epoch))
        assert len(tb) == len(jb) == len(tl)
        for t, j in zip(tb, jb):
            assert set(t) == set(j)
            np.testing.assert_allclose(t["images"].numpy(), j["images"], rtol=0, atol=IMAGE_TOL)
            for key in set(j) - {"images"}:
                assert t[key].dtype == j[key].dtype, key
                np.testing.assert_array_equal(t[key], j[key], err_msg=key)
            n += 1
    return n


AUGMENTATIONS = {
    "lsj": dict(lsj_range=(0.3, 2.0)),
    "albu": dict(albu=dict(transforms=[
        dict(type="ShiftScaleRotate", shift_limit=0.0625, scale_limit=0.1, rotate_limit=10,
             p=0.7),
        dict(type="RandomBrightnessContrast", p=0.5), dict(type="ChannelShuffle", p=0.3),
        dict(type="OneOf", transforms=[dict(type="Blur", blur_limit=3, p=1.0),
                                       dict(type="MedianBlur", blur_limit=3, p=1.0)], p=0.5)],
        min_visibility=0.3)),
    "instaboost": dict(instaboost=dict(aug_ratio=0.7)),
}


@pytest.mark.parametrize("aug", sorted(AUGMENTATIONS))
def test_augmenting_loader_matches_jax(sets, aug):
    cfg = _coco_cfg(sets)
    tl, jl = _loader_pair(t_build(cfg), j_build(cfg), with_masks=True, **AUGMENTATIONS[aug])
    assert _same_batches(tl, jl) == 2 * len(tl)
    assert tl.aug_images > 0


@pytest.mark.parametrize("kind", ["concat", "repeat", "class_balanced"])
def test_wrapper_loader_matches_jax(sets, kind):
    cfg = _wrapper_cfgs(sets)[kind]
    masks = kind != "concat"
    kw = dict(with_masks=masks, mstrain_range=(48, 64)) if kind == "class_balanced" else \
        dict(with_masks=masks)
    tl, jl = _loader_pair(t_build(cfg), j_build(cfg), **kw)
    assert _same_batches(tl, jl, epochs=2 if kind != "class_balanced" else 1) > 0


def test_resumed_augmenting_loader_replays_the_draws(sets):
    """Starting an epoch at batch 2 gives the batches of the whole epoch's
    from there: the skipped images' augmentations are replayed."""
    cfg = _coco_cfg(sets)
    kw = dict(with_masks=True, **AUGMENTATIONS["instaboost"], **AUGMENTATIONS["lsj"])
    tl = _loader_pair(t_build(cfg), j_build(cfg), **kw)[0]
    full = list(tl.epoch_iter(1))
    tail = list(tl.epoch_iter(1, start=2))
    assert len(tail) == len(full) - 2
    for a, b in zip(tail, full[2:]):
        assert np.array_equal(a["images"].numpy(), b["images"].numpy())
        for key in ("gt_bboxes", "gt_mask_crops", "img_shape"):
            np.testing.assert_array_equal(a[key], b[key])


def test_concat_voc_map_over_both_years_matches_jax(sets):
    """A ``ConcatDataset`` of the two VOC years evaluates VOC mAP over all
    of its images: JAX ``eval_map`` on the years' annotations one after the
    other (the JAX wrapper has no ``evaluate``)."""
    from boosting_rcnn_tpu.core.evaluation.mean_ap import eval_map

    cfg = _wrapper_cfgs(sets)["concat"]
    t, j = t_build(cfg, test_mode=True), j_build(cfg, test_mode=True)
    results = _seeded_results(t, 9)
    anns = [dict(bboxes=d["bboxes"], labels=d["labels"], bboxes_ignore=d["bboxes_ignore"])
            for ds in j.datasets for d in ds.data_infos]
    ref, _ = eval_map(results, anns, iou_thr=0.5, num_classes=len(j.CLASSES))
    got = t.evaluate(results, metric="mAP")
    assert abs(got["mAP"] - ref) <= 1e-12 and 0 < got["mAP"] < 1
