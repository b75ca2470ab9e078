"""The 41 built configs that the runner refused before the port had their
datasets and augmentations (24 LVIS, 6 InstaBoost, 6 LSJ, 2 Cityscapes, 2
VOC0712, 1 Albu), and the 15 DetectoRS and Swin configs, on the CPU and
without JAX.

Each config, its ``data.*`` paths pointed at a set from the port's
generators, passes the runner's data, pipeline, optimizer and schedule
checks, and its train loader (``--tiny``'s canvas, no model built) gives a
first batch.  The SUODAC Faster R-CNN, once refused for its
``domain_file``, passes them and gives ``domain_label``.  Then one tiny
end-to-end run: a shrunk LVIS Mask R-CNN under ``ClassBalancedDataset``,
with InstaBoost and Albu on, takes 2 steps through ``train_detector``,
and the test CLI gives its federated AP.
"""
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.data.builder import build_dataset  # noqa: E402
from boosting_rcnn_tpu_torch.data.coco import (BRACKISH_CLASSES,  # noqa: E402
                                               TRASHCAN_INSTANCE_CLASSES)
from boosting_rcnn_tpu_torch.data.image_io import load_png_gray, write_png_gray  # noqa: E402
from boosting_rcnn_tpu_torch.data.synthetic import (generate, generate_cityscapes,  # noqa: E402
                                                     generate_lvis, generate_voc)
from boosting_rcnn_tpu_torch.engine import runner  # noqa: E402
from boosting_rcnn_tpu_torch.tools import test as test_cli  # noqa: E402

LVIS = (["lvis/mask_rcnn_{}_fpn_sample1e-3_mstrain_{}.py".format(b, s)
         for b in ("r50", "r101", "x101_32x4d", "x101_64x4d")
         for s in ("1x_lvis_v1", "2x_lvis_v0.5")]
        + ["seesaw_loss/{}_r{}_fpn_{}.py".format(d, b, v)
           for d, bs, vs in (
               ("mask_rcnn", ("50", "101"),
                ("random_seesaw_loss_mstrain_2x_lvis_v1",
                 "random_seesaw_loss_normed_mask_mstrain_2x_lvis_v1",
                 "sample1e-3_seesaw_loss_mstrain_2x_lvis_v1",
                 "sample1e-3_seesaw_loss_normed_mask_mstrain_2x_lvis_v1",
                 "seesaw_loss_random_2x_lvis_v1")),
               ("cascade_mask_rcnn", ("101",),
                ("random_seesaw_loss_mstrain_2x_lvis_v1",
                 "random_seesaw_loss_normed_mask_mstrain_2x_lvis_v1",
                 "sample1e-3_seesaw_loss_mstrain_2x_lvis_v1",
                 "sample1e-3_seesaw_loss_normed_mask_mstrain_2x_lvis_v1",
                 "seesaw_loss_random_2x_lvis_v1")))
           for b in bs for v in vs]
        + ["seesaw_loss/mask_rcnn_r50_fpn_seesaw_loss_sample1e-3_mstrain_2x_lvis_v1.py"])
INSTABOOST = [f"instaboost/{d}_{b}_fpn_instaboost_4x_coco.py"
              for d in ("mask_rcnn", "cascade_mask_rcnn") for b in ("r50", "r101", "x101_64x4d")]
LSJ = [f"strong_baselines/mask_rcnn_r50_{s}" for s in (
    "fpn_syncbn-all_rpn-2conv_lsj_50e_coco.py", "fpn_syncbn-all_rpn-2conv_lsj_100e_coco.py",
    "fpn_syncbn-all_rpn-2conv_lsj_100e_fp16_coco.py",
    "caffe_fpn_syncbn-all_rpn-2conv_lsj_100e_coco.py",
    "caffe_fpn_syncbn-all_rpn-2conv_lsj_100e_fp16_coco.py",
    "caffe_fpn_syncbn-all_rpn-2conv_lsj_400e_coco.py")]
OTHERS = ["cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py",
          "cityscapes/mask_rcnn_r50_fpn_1x_cityscapes.py",
          "pascal_voc/faster_rcnn_r50_fpn_1x_voc0712.py",
          "pascal_voc/cascade_rcnn_r50_fpn_1x_voc0712.py",
          "albu_example/mask_rcnn_r50_fpn_albu_1x_coco.py"]
CONFIGS = LVIS + INSTABOOST + LSJ + OTHERS
# DetectoRS and Swin, which the builder refused before the port had them
DETECTORS_SWIN = sorted(os.path.relpath(p, os.path.join(REPO, "configs")) for d in (
    "detectors", "swin") for p in glob.glob(os.path.join(REPO, "configs", d, "*.py")))
# the fork's underwater sets, generated with their class names
UNDERWATER = {"BrackishDataset": ("brackish", BRACKISH_CLASSES),
              "TrashCanInstanceDataset": ("trashcan", TRASHCAN_INSTANCE_CLASSES)}
LVIS_E2E = "lvis/mask_rcnn_r50_fpn_sample1e-3_mstrain_1x_lvis_v1.py"
SMALL_MASK_HEAD = {"model.roi_head.mask_head.conv_out_channels": "16",
                   "model.test_cfg.rcnn.max_per_img": "100", "model.backbone.init_cfg": "None",
                   "compute_dtype": "float32"}


def test_the_41_configs():
    assert (len(LVIS), len(INSTABOOST), len(LSJ), len(CONFIGS)) == (24, 6, 6, 41)
    assert len(set(CONFIGS)) == 41
    assert all(os.path.exists(os.path.join(REPO, "configs", c)) for c in CONFIGS)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data_sets"))
    generate_lvis(os.path.join(root, "lvis_v1"), n_train=12, n_val=2, seed=1, frame=(80, 64))
    generate_lvis(os.path.join(root, "lvis_v0.5"), n_train=6, n_val=2, seed=2, frame=(80, 64),
                  version="v0.5")
    generate_cityscapes(os.path.join(root, "cityscapes"), n_train=2, n_val=1, seed=3,
                        frame=(160, 80))
    generate_voc(os.path.join(root, "voc"), n_train=3, n_test=2, seed=4, frame=(80, 64))
    generate(os.path.join(root, "coco"), n_train=4, n_val=2, seed=5, frame_sizes=[(80, 64)],
             object_scale=0.5)
    for seed, (name, classes) in enumerate(UNDERWATER.values()):
        generate(os.path.join(root, name), n_train=2, n_val=1, seed=7 + seed,
                 frame_sizes=[(80, 64)], object_scale=0.5, classes=classes)
    return root


def _point(ds, root):
    """Point a leaf dataset config (or each wrapped one) at the generated sets."""
    for inner in ([ds["dataset"]] if ds.get("dataset") else []) + list(ds.get("datasets") or []):
        _point(inner, root)
    t = ds.get("type", "CocoDataset")
    train = "train" in str(ds.get("ann_file", "")) or "trainval" in str(ds.get("ann_file", ""))
    if t in ("LVISV1Dataset", "LVISV05Dataset", "LVISDataset"):
        v = "v1" if t == "LVISV1Dataset" else "v0.5"
        ds.update(ann_file=f"{root}/lvis_{v}/annotations/lvis_{v}_{'train' if train else 'val'}"
                           ".json", img_prefix=f"{root}/lvis_{v}")
    elif t == "CityscapesDataset":
        split = "train" if train else "val"
        ds.update(ann_file=f"{root}/cityscapes/annotations/instancesonly_filtered_gtFine_{split}"
                           ".json", img_prefix=f"{root}/cityscapes/leftImg8bit/{split}")
    elif t == "VOCDataset":
        year = "2012" if "2012" in ds["ann_file"] else "2007"
        split = "trainval" if train else "test"
        ds.update(ann_file=f"{root}/voc/VOC{year}/ImageSets/Main/{split}.txt",
                  img_prefix=f"{root}/voc/VOC{year}")
    elif "ann_file" in ds:
        split = "train" if train else "val"
        d = UNDERWATER.get(t, ("coco",))[0]
        ds.update(ann_file=f"{root}/{d}/{split}.json", img_prefix=f"{root}/{d}/{split}")


def _config(name, root):
    cfg = load_config(os.path.join(REPO, "configs", name))
    for split in ("train", "val", "test"):
        _point(cfg._data["data"][split], root)
    return cfg


@pytest.mark.parametrize("name", CONFIGS)
def test_config_passes_the_runner_checks(name, sets):
    cfg = _config(name, sets)
    runner.check_schedule(cfg)
    runner.check_data(cfg)
    mc = runner.model_config(cfg)
    loader = runner.train_loader(cfg, mc, "cpu", seed=0, tiny=True)
    batch = next(iter(loader.epoch_iter(0)))
    assert tuple(batch["images"].shape[1:3]) in (runner.TINY_CANVAS, runner.TINY_CANVAS[::-1])
    assert batch["gt_mask"].any()
    assert ("gt_mask_crops" in batch) == bool(mc["roi_head"].get("mask_head"))
    pipeline = runner._pipeline(cfg.data.to_dict(), "train", False)[0]
    assert loader.lsj_range == (tuple(pipeline["lsj_range"]) if "lsj_range" in pipeline
                                else None)
    assert loader.albu == pipeline.get("albu") and loader.instaboost == pipeline.get("instaboost")
    if name in LSJ:
        assert loader.lsj_range == (0.1, 2.0) and loader.batch_size == 8
        assert runner.compute_dtype(cfg) == torch.bfloat16


def test_the_15_detectors_and_swin_configs():
    assert len(DETECTORS_SWIN) == 15
    assert sum(n.startswith("swin/") for n in DETECTORS_SWIN) == 6


@pytest.mark.parametrize("name", DETECTORS_SWIN)
def test_detectors_and_swin_configs_pass_the_runner_checks(name, sets):
    """The DetectoRS and Swin configs pass the runner's data, optimizer and
    schedule checks (the Swin ones' ``adamw``) and give a first tiny batch:
    with masks for HTC and Mask R-CNN, with stuff maps for HTC; Brackish
    and TrashCan on sets of their class names."""
    cfg = _config(name, sets)
    train = cfg._data["data"]["train"]
    if cfg.model.roi_head.get("semantic_head"):  # HTC's stuff maps, one a train image
        stuff = os.path.join(sets, "stuff")
        os.makedirs(stuff, exist_ok=True)
        with open(train["ann_file"]) as f:
            for im in json.load(f)["images"]:
                write_png_gray(os.path.join(stuff, im["file_name"].rsplit(".", 1)[0] + ".png"),
                               np.full((im["height"], im["width"]), 7, np.uint8))
        train["seg_prefix"] = stuff
    runner.check_schedule(cfg)
    runner.check_data(cfg)
    assert (str(cfg.optimizer.type).lower() == "adamw") == name.startswith("swin/")
    mc = runner.model_config(cfg)
    loader = runner.train_loader(cfg, mc, "cpu", seed=0, tiny=True)
    batch = next(iter(loader.epoch_iter(0)))
    assert tuple(batch["images"].shape[1:3]) in (runner.TINY_CANVAS, runner.TINY_CANVAS[::-1])
    assert batch["gt_mask"].any()
    assert ("gt_mask_crops" in batch) == bool(mc["roi_head"].get("mask_head"))
    assert ("gt_semantic_seg" in batch) == bool(mc["roi_head"].get("semantic_head"))


def test_suodac_still_raises_naming_domain_file(sets, tmp_path):
    """Once the config the runner refused for its ``domain_file``: the
    SUODAC Faster R-CNN now passes the runner's checks, and its train loader
    reads ``data.train.domain_file`` and gives each image its one-hot
    ``domain_label``."""
    cfg = _config("suodac/faster_rcnn_r50_fpn_1x.py", sets)
    with open(os.path.join(sets, "coco", "train.json")) as f:
        stems = [im["file_name"].rsplit(".", 1)[0] for im in json.load(f)["images"]]
    domains = str(tmp_path / "domains.json")
    with open(domains, "w") as f:
        json.dump({"clear": stems[::2], "murky": stems[1::2]}, f)
    cfg._data["data"]["train"]["domain_file"] = domains
    runner.check_schedule(cfg)
    runner.check_data(cfg)
    mc = runner.model_config(cfg)
    loader = runner.train_loader(cfg, mc, "cpu", seed=0, tiny=True)
    batch = next(iter(loader.epoch_iter(0)))
    assert batch["domain_label"].shape == (loader.batch_size, 2)
    assert batch["domain_label"].dtype == np.float32
    np.testing.assert_array_equal(batch["domain_label"].sum(1), 1.0)


def test_unported_dataset_type_raises_naming_it():
    cfg = load_config(os.path.join(REPO, "configs", LVIS_E2E))
    cfg._data["data"]["test"]["type"] = "CocoPanopticDataset"
    with pytest.raises(NotImplementedError, match="CocoPanopticDataset"):
        runner.check_data(cfg)


def test_test_cli_writes_the_cityscapes_dump(sets, tmp_path, capsys):
    """The test CLI's ``--eval cityscapes --out x.json``: the metric and the
    official dump under ``x_cityscapes/`` (a ``*_pred.txt`` an image, one
    0/255 PNG a listed instance), with a tiny random Cityscapes Mask R-CNN."""
    name = "cityscapes/mask_rcnn_r50_fpn_1x_cityscapes.py"
    cfg = _config(name, sets)
    test = cfg._data["data"]["test"]
    out = str(tmp_path / "city.json")
    metrics = test_cli.main([os.path.join(REPO, "configs", name), "--device", "cpu", "--tiny",
                             "--eval", "cityscapes", "--out", out, "--cfg-options",
                             f"data.test.ann_file={test['ann_file']}",
                             f"data.test.img_prefix={test['img_prefix']}",
                             *[f"{k}={v}" for k, v in SMALL_MASK_HEAD.items()]])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == {"cityscapes_mAP", "cityscapes_AP50"} and metrics["num_results"] == 1
    dump = str(tmp_path / "city_cityscapes")
    txt = [f for f in os.listdir(dump) if f.endswith("_pred.txt")]
    assert len(txt) == 1 and txt[0].endswith("_leftImg8bit_pred.txt")
    lines = open(os.path.join(dump, txt[0])).read().splitlines()
    assert lines and len(lines) == len([f for f in os.listdir(dump) if f.endswith(".png")])
    png, label_id, score = lines[0].split()
    assert int(label_id) in (24, 25, 26, 27, 28, 31, 32, 33) and 0 <= float(score) <= 1
    mask = load_png_gray(os.path.join(dump, png))
    assert mask.shape == (80, 160) and set(np.unique(mask)) <= {0, 255}


def test_tiny_lvis_class_balanced_instaboost_albu_end_to_end(tmp_path, capsys):
    """2 steps of the shrunk LVIS Mask R-CNN (1203 classes) under
    ``ClassBalancedDataset`` with InstaBoost and Albu, then the test CLI's
    federated AP.  Its own 4-record set at ``oversample_thr`` 0.5 repeats
    the images of the categories in one of the 4, so that the epoch, and
    the loader's work ahead of the steps, stays a few batches; the test CLI
    keeps 100 detections an image, and the tiny model's mask convs are
    16 wide (``SMALL_MASK_HEAD``: ``--tiny`` keeps the mask head's 256, which
    over the sampled slots and 300 detections of 1203 classes are most of a
    CPU run)."""
    root = str(tmp_path / "lvis")
    generate_lvis(root, n_train=4, n_val=2, seed=6, frame=(80, 64))
    cfg = load_config(os.path.join(REPO, "configs", LVIS_E2E))
    cfg._data["data"]["train"]["dataset"].update(
        ann_file=f"{root}/annotations/lvis_v1_train.json", img_prefix=root)
    pipeline = cfg._data["data"]["train"]["dataset"]["pipeline"]
    pipeline.update(instaboost=dict(aug_ratio=1.0), albu=dict(transforms=[
        dict(type="ShiftScaleRotate", shift_limit=0.0625, scale_limit=0.0, rotate_limit=0, p=0.5),
        dict(type="RandomBrightnessContrast", p=0.5)]))
    cfg._data["data"]["train"]["oversample_thr"] = 0.5
    cfg.merge_from_options(SMALL_MASK_HEAD)
    ds = build_dataset(cfg.data.to_dict()["train"])
    assert len(ds.dataset) < len(ds) <= 8  # the long tail repeated
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU convolution backward is racy with several threads
    try:
        summary = runner.train_detector(cfg, str(tmp_path / "wd"), device="cpu", tiny=True,
                                        max_iters=2, validate=False)
    finally:
        torch.set_num_threads(threads)
    assert summary["steps"] == 2 and np.isfinite(summary["last_metrics"]["loss"])
    assert summary["aug_images"] >= 4 and summary["aug_seconds"]["instaboost"] > 0
    opts = [f"data.test.ann_file={root}/annotations/lvis_v1_val.json",
            f"data.test.img_prefix={root}", *[f"{k}={v}" for k, v in SMALL_MASK_HEAD.items()]]
    metrics = test_cli.main([os.path.join(REPO, "configs", LVIS_E2E),
                             summary["checkpoints"][-1], "--device", "cpu", "--tiny",
                             "--eval", "bbox", "--cfg-options", *opts])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == {"bbox_mAP", "bbox_mAP_50"}
    assert 0.0 <= metrics["bbox_mAP"] <= 1.0 and metrics["num_results"] == 2
