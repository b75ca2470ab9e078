"""The PyTorch port's entry points, on the CPU: evaluation and inference
against the JAX package's, the CLIs, checkpoints and a bitwise resume.

The tiny flagship (ResNet-18 at width 8, PAFPN 32, RPN 32 x 2, FC 64, in
float32 on the 128 x 160 canvas) gets random weights made with numpy from a
seed, which go to the JAX package as flax variables and to the port
through ``weights.from_jax_params``.  A synthetic shapes set
(``data/synthetic.py``, PPM images) is written to ``tmp_path``.  Checked:

  * ``engine.eval.run_eval`` against JAX ``run_eval`` over the same test
    loader's images (4 landscape images at batch 2, which the JAX loader
    covers whole): per image, labels equal, detection counts equal, boxes
    and scores within 1e-3 (the flagship's ``predict`` tolerance);
  * ``run_eval`` on a set with a portrait image between landscape ones,
    which the loader yields last: each result goes to its own image (a
    stand-in detector that returns the ground truth scores mAP 1), and the
    same set in another order gives the same results and mAP;
  * ``apis.inference_detector`` against JAX ``inference_detector`` on two
    arrays (one portrait) and a path: per class the same counts, within
    1e-3;
  * the CLIs' functions: ``tools.train --device cpu --tiny --iters 2`` on
    the set (and on ``--fake-data``) writes a checkpoint, ``tools.test`` on
    it evaluates every val image and returns a metrics dict and a COCO
    json, ``--resume-from`` it continues at its epoch, batch and step;
    without ``--device`` and without a GPU both raise;
  * ``train_detector`` stopped inside an epoch, its checkpoint restored
    into a fresh model, optimizer and generator (the model's and the
    optimizer's ``state_dict`` and the generator's state ``torch.equal`` to
    the saved ones), and the run resumed from it through ``resume_from``
    ends bitwise where an uninterrupted run does (one CPU thread, as the
    other train tests pin it).
"""
import copy
import json
import os
import sys

os.environ["JAX_COMPILATION_CACHE_DIR"] = ""  # no compile-cache writes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from boosting_rcnn_tpu import apis as j_apis  # noqa: E402
from boosting_rcnn_tpu.builder import build_detector as jax_build  # noqa: E402
from boosting_rcnn_tpu.config import load_config as jax_load_config  # noqa: E402
from boosting_rcnn_tpu.data.coco import CocoDataset as JCoco  # noqa: E402
from boosting_rcnn_tpu.data.loader import DetDataLoader as JLoader  # noqa: E402
from boosting_rcnn_tpu.engine.eval import run_eval as j_run_eval  # noqa: E402
from boosting_rcnn_tpu_torch import apis  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.data.coco import CocoDataset as TCoco  # noqa: E402
from boosting_rcnn_tpu_torch.data.image_io import load_image  # noqa: E402
from boosting_rcnn_tpu_torch.data.loader import DetDataLoader as TLoader  # noqa: E402
from boosting_rcnn_tpu_torch.data.synthetic import generate  # noqa: E402
from boosting_rcnn_tpu_torch.engine import runner  # noqa: E402
from boosting_rcnn_tpu_torch.engine.checkpoint import restore_checkpoint  # noqa: E402
from boosting_rcnn_tpu_torch.engine.eval import run_eval  # noqa: E402
from boosting_rcnn_tpu_torch.tools import test as test_cli  # noqa: E402
from boosting_rcnn_tpu_torch.tools import train as train_cli  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402

CONFIG = os.path.join(REPO, "configs/boosting_rcnn/boosting_rcnn_r50_pafpn_1x_utdac.py")
CANVAS = runner.TINY_CANVAS
TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """CPU convolution backward is racy with several threads in some
    PyTorch CPU builds; the train tests run on one."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    generate(root, n_train=6, n_val=5, seed=3)
    return root


def _overrides(root):
    return [f"data.{s}.ann_file={root}/{f}.json" for s, f in
            (("train", "train"), ("val", "val"), ("test", "val"))] + [
        f"data.{s}.img_prefix={root}/{f}" for s, f in
        (("train", "train"), ("val", "val"), ("test", "val"))] + [
        "data.samples_per_gpu=2", "model.backbone.init_cfg=None", "compute_dtype=float32"]


def _random_variables(shapes, rs):
    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        shape = s.shape
        if name.endswith("['kernel']"):
            return rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        if name.endswith("['var']"):
            return rs.uniform(0.5, 1.5, shape)
        if name.endswith("['scale']"):
            return 1.0 + 0.1 * rs.randn(*shape)
        if "rpn_cls" in name:
            return -2.0 + 0.1 * rs.randn(*shape)
        return 0.1 * rs.randn(*shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


@pytest.fixture(scope="module")
def pair():
    mc = runner.shrink_model(jax_load_config(CONFIG).model.to_dict())
    jdet = jax_build(mc, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), CANVAS))
    variables = _random_variables(shapes, np.random.RandomState(0))
    handle = apis.init_detector(CONFIG, device="cpu", dtype=torch.float32, tiny=True)
    handle.detector.net.load_state_dict(from_jax_params(variables), strict=True)
    return jdet, jax.tree.map(jnp.asarray, variables), handle


def _same_results(got, ref):
    assert len(got) == len(ref)
    for (gd, gl), (rd, rl) in zip(got, ref):
        rd, rl = np.asarray(rd), np.asarray(rl)
        np.testing.assert_array_equal(gl, rl)
        assert gd.shape == rd.shape
        np.testing.assert_allclose(gd, rd, rtol=0, atol=TOL)


def test_run_eval_matches_jax(pair, tmp_path):
    jdet, jv, handle = pair
    generate(str(tmp_path), n_train=0, n_val=4, seed=5)
    ann, prefix = str(tmp_path / "val.json"), str(tmp_path / "val")
    jl = JLoader(JCoco(ann, prefix, test_mode=True), batch_size=2, canvas=CANVAS, train=False)
    anchors, nla = jdet.anchors_for(CANVAS)
    ref = j_run_eval(jdet, jv, jl, anchors, nla)
    tl = TLoader(TCoco(ann, prefix, test_mode=True), batch_size=2, canvas=CANVAS, train=False)
    stats = {}
    got = run_eval(handle.detector, tl, stats=stats)
    _same_results(got, ref)
    assert sum(len(d) for d, _ in got) > 0 and stats["images"] == 4


class _GroundTruthDetector:
    """Stands in for the detector in ``run_eval``: ``predict`` returns each
    image's own ground truth at score 1, so a result paired with another
    image costs AP."""

    def anchors_for(self, canvas):
        return None, None

    def predict(self, batch, anchors, num_level_anchors, rescale=True):
        boxes = batch["gt_bboxes"] / batch["scale_factor"][:, None, :]
        dets = np.concatenate([boxes, np.ones_like(boxes[..., :1])], -1)
        return (torch.from_numpy(dets), torch.from_numpy(batch["gt_labels"]),
                torch.from_numpy(batch["gt_mask"]))


def test_run_eval_keeps_dataset_order(pair, tmp_path):
    """A portrait image between landscape ones: the test loader yields it
    after them, and its result still goes to it."""
    _, _, handle = pair
    generate(str(tmp_path), n_train=0, n_val=5, seed=6, n_portrait=1)
    coco = json.load(open(tmp_path / "val.json"))
    coco["images"] = [coco["images"][i] for i in (0, 4, 1, 2, 3)]
    with open(tmp_path / "mixed.json", "w") as f:
        json.dump(coco, f)
    sets = [TCoco(str(tmp_path / name), str(tmp_path / "val"), test_mode=True)
            for name in ("val.json", "mixed.json")]
    assert sets[1].flags.tolist() == [1, 0, 1, 1, 1]
    maps, by_name = [], []
    for ds in sets:
        loader = TLoader(ds, batch_size=2, canvas=CANVAS, train=False)
        assert ds.evaluate(run_eval(_GroundTruthDetector(), loader))["bbox_mAP"] == 1.0
        results = run_eval(handle.detector, loader)
        maps.append(ds.evaluate(results)["bbox_mAP"])
        by_name.append({info["filename"]: r for info, r in zip(ds.data_infos, results)})
    assert maps[0] == maps[1]
    names = sorted(by_name[0])
    _same_results([by_name[1][n] for n in names], [by_name[0][n] for n in names])


def test_inference_detector_matches_jax(pair, synth):
    jdet, jv, handle = pair
    jhandle = j_apis.DetectorHandle(jdet, jv, CANVAS, None)
    rs = np.random.RandomState(9)
    imgs = [rs.randint(0, 256, (150, 200, 3)).astype(np.uint8),
            rs.randint(0, 256, (200, 120, 3)).astype(np.uint8),
            os.path.join(synth, "val", "val_0000.ppm")]
    ref = j_apis.inference_detector(jhandle, imgs)
    got = apis.inference_detector(handle, imgs)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        _same_results([(gc, np.zeros(len(gc))) for gc in g],
                      [(rc, np.zeros(len(rc))) for rc in r])
    single = apis.inference_detector(handle, load_image(imgs[2]))  # a batch of one
    for g, r in zip(single, got[2]):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=TOL)


def test_train_and_test_clis(synth, tmp_path):
    cfg = [CONFIG, "--device", "cpu", "--tiny", "--cfg-options", *_overrides(synth)]
    wd = str(tmp_path / "wd")
    summary = train_cli.main(cfg[:1] + ["--work-dir", wd, "--iters", "2"] + cfg[1:])
    # 3 batches an epoch: stopped inside epoch 0
    assert summary["steps"] == 2 and summary["checkpoints"] == [os.path.join(wd, "iter_2")]
    assert np.isfinite(summary["last_metrics"]["loss"]) and summary["images_per_s"] > 0
    assert 0 <= summary["loader_wait_share"] < 1
    out = str(tmp_path / "res.json")
    metrics = test_cli.main(cfg[:1] + [os.path.join(wd, "iter_2"), "--out", out] + cfg[1:])
    assert metrics["num_results"] == 5 and "bbox_mAP" in metrics
    assert metrics["eval_stats"]["images"] == 5
    assert isinstance(json.load(open(out)), list)
    resumed = train_cli.main(cfg[:1] + ["--work-dir", wd, "--iters", "4", "--resume-from",
                                        os.path.join(wd, "iter_2")] + cfg[1:])
    assert resumed["steps"] == 2 and resumed["checkpoints"] == [
        os.path.join(wd, "epoch_1"), os.path.join(wd, "iter_4")]
    fake = train_cli.main(cfg[:1] + ["--work-dir", str(tmp_path / "fake"), "--iters", "2",
                                     "--fake-data"] + cfg[1:])
    assert fake["steps"] == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main([CONFIG, "--tiny", "--fake-data", "--iters", "1", "--work-dir",
                            str(tmp_path / "nodev")])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            test_cli.main([CONFIG, "--tiny", "--cfg-options", *_overrides(synth)])


def _trainer_state(trainer):
    """A copy of what a checkpoint holds: the model's and the optimizer's
    ``state_dict`` (momentum buffers, step count) and the sampler
    generator's state."""
    return copy.deepcopy({"model": trainer.detector.net.state_dict(),
                          "optimizer": trainer.optimizer.state_dict(),
                          "generator": trainer.generator.get_state()})


def _differing(a, b, path=""):
    """Where two nested states differ (tensors by ``torch.equal``)."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [f"{path} keys"]
        return [d for k in a for d in _differing(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} length"]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in _differing(x, y, f"{path}/{i}")]
    if torch.is_tensor(a):
        return [] if torch.equal(a, b) else [path]
    return [] if a == b else [path]


def test_resume_is_bitwise(synth, tmp_path):
    """``train_detector`` stopped inside an epoch and resumed from its
    checkpoint (into a model of other weights) ends bit for bit where an
    uninterrupted run does, through the rest of that epoch and into the
    next."""
    cfg = load_config(CONFIG)
    cfg.merge_from_options(dict(kv.split("=", 1) for kv in _overrides(synth)))

    def run(name, seed=0, **kw):
        handle = apis.init_detector(cfg, device="cpu", tiny=True, seed=seed)
        return apis.train_detector(handle, str(tmp_path / name), validate=False, **kw)

    whole = run("whole", max_iters=5)  # 3 batches an epoch: ends inside epoch 1
    first = run("first", max_iters=2)
    ckpt = first["checkpoints"][-1]
    assert ckpt == str(tmp_path / "first" / "iter_2")
    saved = _trainer_state(first["trainer"])
    fresh = runner.build_trainer(cfg, apis.init_detector(cfg, device="cpu", tiny=True,
                                                         seed=1).detector, 3)
    meta = restore_checkpoint(ckpt, fresh.detector.net, fresh.optimizer, fresh.generator)
    assert meta["step"] == 2 and (meta["epoch"], meta["iter"]) == (0, 2)
    assert not _differing(_trainer_state(fresh), saved)
    rest = run("rest", seed=1, max_iters=5, resume_from=ckpt)
    assert rest["steps"] == 3 and rest["checkpoints"] == [
        str(tmp_path / "rest" / name) for name in ("epoch_1", "iter_5")]
    end = _trainer_state(whole["trainer"])
    differ = _differing(_trainer_state(rest["trainer"]), end)
    assert not differ, differ[:5]
    # epoch 1's first step, logged by both runs
    losses = [{k: v for k, v in m.items() if not k.endswith("time")}
              for m in (rest["last_metrics"], whole["last_metrics"])]
    assert losses[0] == losses[1] and losses[0]["epoch"] == 1
    assert _differing(saved["optimizer"], end["optimizer"])
