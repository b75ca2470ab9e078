"""The PyTorch port's test-time augmented evaluation, on the CPU:
``engine.eval.run_eval_tta`` and the test CLI's ``--tta``.

  * ``run_eval_tta`` against the JAX package's on the tiny flagship
    (``tests/test_torch_tta.py``'s weights) over a synthetic COCO set of
    four landscape images at batch 2, short sides 96 and 128, long side
    160, with flip: the JAX loader's defects (a dropped partial batch,
    mixed buckets, results in bucket order) cannot show there.  Each
    image's detections: the same count and labels, boxes and scores
    within 1e-3;
  * a set with a partial last batch and a portrait image between
    landscape ones: every image is evaluated once, in dataset order (each
    image's result equal to a batch-of-one run's), the portrait bucket on
    the transposed canvas at each scale;
  * the test CLI with ``--tta --tta-scales 96 128`` on ``--device cpu
    --tiny``, the long side set through ``--cfg-options`` on the test
    pipeline's ``scale``: its bbox mAP equals ``run_eval_tta``'s on the
    same seeded weights;
  * ``--tta`` with ``--eval segm``, with a cascade and with HTC raises
    before any image is read.
"""
import json
import os
import sys

os.environ["JAX_COMPILATION_CACHE_DIR"] = ""  # no compile-cache writes

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from boosting_rcnn_tpu.data.coco import CocoDataset as JCoco  # noqa: E402
from boosting_rcnn_tpu.engine.eval import run_eval_tta as j_run_eval_tta  # noqa: E402
from boosting_rcnn_tpu_torch import apis  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.data import loader as t_loader  # noqa: E402
from boosting_rcnn_tpu_torch.data.coco import CocoDataset as TCoco  # noqa: E402
from boosting_rcnn_tpu_torch.data.synthetic import generate  # noqa: E402
from boosting_rcnn_tpu_torch.engine.eval import run_eval_tta  # noqa: E402
from boosting_rcnn_tpu_torch.engine.runner import tta_options  # noqa: E402
from boosting_rcnn_tpu_torch.tools import test as test_cli  # noqa: E402
from test_torch_boosting_detectors import config_path  # noqa: E402
from test_torch_tta import FLAGSHIP, pair, tiny  # noqa: E402

SCALES = (96, 128)
LONG_SIDE = 160


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread: beside the suite's other pytest
    workers, torch's default of a thread a core oversubscribes the host
    (this file's cases ran several times slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def same_results(got, ref):
    assert len(got) == len(ref)
    for (gd, gl), (rd, rl) in zip(got, ref):
        assert gd.shape == rd.shape and gd.shape[0] > 0
        np.testing.assert_array_equal(gl, rl)
        np.testing.assert_allclose(gd, rd, rtol=0, atol=1e-3)


def test_run_eval_tta_matches_jax(tmp_path):
    p = pair(FLAGSHIP)
    generate(str(tmp_path), n_train=0, n_val=4, seed=4)
    ann, prefix = str(tmp_path / "val.json"), str(tmp_path / "val")
    tds, jds = TCoco(ann, prefix, test_mode=True), JCoco(ann, prefix, test_mode=True)
    assert tds.flags.tolist() == [1] * 4
    stats = {}
    got = run_eval_tta(p["tdet"], tds, 2, SCALES, long_side=LONG_SIDE, stats=stats)
    ref = j_run_eval_tta(p["jdet"], p["jv"], jds, 2, SCALES, long_side=LONG_SIDE)
    same_results(got, [(np.asarray(d), np.asarray(lb)) for d, lb in ref])
    assert stats["images"] == 4


def test_run_eval_tta_evaluates_every_image_in_dataset_order(tmp_path):
    """Five images, the portrait one second: batches [0, 2], [3, 4] (the
    landscape bucket), then [1] padded; each result is the image's own."""
    det = build_detector(tiny(FLAGSHIP, load_config), device="cpu")
    generate(str(tmp_path), n_train=0, n_val=5, seed=6, n_portrait=1)
    coco = json.load(open(tmp_path / "val.json"))
    coco["images"] = [coco["images"][i] for i in (0, 4, 1, 2, 3)]
    with open(tmp_path / "mixed.json", "w") as f:
        json.dump(coco, f)
    ds = TCoco(str(tmp_path / "mixed.json"), str(tmp_path / "val"), test_mode=True)
    assert ds.flags.tolist() == [1, 0, 1, 1, 1]
    canvases = []
    anchors_for = det.anchors_for
    det.anchors_for = lambda canvas: canvases.append(canvas) or anchors_for(canvas)
    got = run_eval_tta(det, ds, 2, SCALES, long_side=LONG_SIDE)
    assert canvases == [(96, 160), (128, 160), (160, 96), (160, 128)]
    alone = run_eval_tta(det, ds, 1, SCALES, long_side=LONG_SIDE)
    same_results(got, alone)
    # each result is its own image's: image 1 (portrait) has its boxes in a
    # portrait frame
    h, w = ds.data_infos[1]["height"], ds.data_infos[1]["width"]
    assert h > w and (got[1][0][:, 2] <= w + 1e-3).all()
    assert (got[1][0][:, 3] <= h + 1e-3).all() and (got[1][0][:, 3] > w).any()


def _overrides(root):
    return [f"data.test.ann_file={root}/val.json", f"data.test.img_prefix={root}/val",
            "data.samples_per_gpu=2", "model.backbone.init_cfg=None", "compute_dtype=float32",
            f"data.test.pipeline.scale=({LONG_SIDE},{SCALES[1]})"]


def test_test_cli_tta_equals_run_eval_tta(tmp_path):
    generate(str(tmp_path), n_train=0, n_val=4, seed=5)
    config = config_path(FLAGSHIP)
    args = [config, "--device", "cpu", "--tiny", "--tta", "--tta-scales", *map(str, SCALES),
            "--cfg-options", *_overrides(tmp_path)]
    metrics = test_cli.main(args)
    assert metrics["num_results"] == 4 and metrics["eval_stats"]["images"] == 4
    cfg = load_config(config)
    cfg.merge_from_options(dict(kv.split("=", 1) for kv in _overrides(tmp_path)))
    opts = tta_options(cfg, list(SCALES))
    assert (opts["scales"], opts["long_side"], opts["batch_size"]) == ([96, 128], 160, 2)
    assert tta_options(cfg)["scales"] == [SCALES[1]]  # flip only at the pipeline's side
    handle = apis.init_detector(cfg, device="cpu", tiny=True)
    ds = TCoco(str(tmp_path / "val.json"), str(tmp_path / "val"), test_mode=True)
    ref = ds.evaluate(run_eval_tta(handle.detector, ds, **opts))
    assert 0.0 <= metrics["bbox_mAP"] <= 1.0
    assert metrics["bbox_mAP"] == ref["bbox_mAP"]


@pytest.mark.parametrize("config, extra, match", [
    (FLAGSHIP, ["--eval", "segm"], "boxes only"),
    ("cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py", [], "roi_out takes a stage"),
    ("htc/htc_r50_fpn_1x_coco.py", [], "roi_out takes a stage"),
])
def test_test_cli_tta_raises_before_reading_images(config, extra, match, tmp_path,
                                                   monkeypatch):
    generate(str(tmp_path), n_train=0, n_val=2, seed=5)

    def no_read(path):
        raise AssertionError(f"an image was read: {path}")

    monkeypatch.setattr(t_loader, "load_image", no_read)
    with pytest.raises(NotImplementedError, match=match):
        test_cli.main([config_path(config), "--device", "cpu", "--tiny", "--tta", *extra,
                       "--cfg-options", *_overrides(tmp_path)])
