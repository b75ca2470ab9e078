"""The PyTorch port's data layer against the JAX package's, on the CPU.

A COCO json and PPM images written to ``tmp_path`` (a crowd box, an
``ignore`` box, a box under 1 px, an empty image, a portrait image and a
small one) go through both packages.  Checked:

  * ``CocoDataset``: ``data_infos`` and ``flags`` equal, in train mode
    (empty and small images filtered) and test mode; the classes filter;
  * ``load_image``: the port's numpy PPM/PGM decoder gives cv2's bytes;
  * ``preprocess``: images within 1e-4 of the JAX package's native branch
    (asserted to be the branch it took), boxes, labels, ``gt_mask``,
    ``img_shape``, ``scale_factor`` and ``ori_shape`` equal; with and
    without flip, up- and downscaled, a portrait image on the landscape
    canvas (the cap on the factor), ``max_gt`` truncation;
  * the train loader: two epochs at seed 0, batch 2, batch for batch equal
    to ``DetDataLoader`` (images within 1e-4, the rest equal), a portrait
    bucket among them;
  * the test loader: every image once, no batch mixing buckets, the
    repeats marked by ``pad``, on 5 images (one portrait) at batch 2,
    where the JAX loader yields 4.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

cv2 = pytest.importorskip("cv2")

from boosting_rcnn_tpu.data import pipeline as j_pipeline  # noqa: E402
from boosting_rcnn_tpu.data.coco import CocoDataset as JCoco  # noqa: E402
from boosting_rcnn_tpu.data.loader import DetDataLoader as JLoader  # noqa: E402
from boosting_rcnn_tpu_torch.data import pipeline as t_pipeline  # noqa: E402
from boosting_rcnn_tpu_torch.data.builder import build_dataset  # noqa: E402
from boosting_rcnn_tpu_torch.data.coco import CocoDataset as TCoco  # noqa: E402
from boosting_rcnn_tpu_torch.data.image_io import load_image, write_ppm  # noqa: E402
from boosting_rcnn_tpu_torch.data.loader import DetDataLoader as TLoader  # noqa: E402
from native import get_lib, native_preprocess  # noqa: E402

CANVAS = (128, 160)
TOL = 1e-4
CLASSES = ("echinus", "holothurian", "scallop", "starfish")


def _write_set(root, sizes, seed=0, extra_anns=()):
    """A COCO json over PPM images of ``sizes`` ((W, H) each), 1-3 boxes an
    image of the 4 classes (none for an image of size with a 0 count)."""
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    images, anns = [], []
    for i, (w, h) in enumerate(sizes):
        fn = f"im_{i}.ppm"
        write_ppm(os.path.join(root, "img", fn), rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
        images.append(dict(id=i + 1, file_name=fn, width=w, height=h))
        for _ in range(rs.randint(1, 4) if i != 2 else 0):  # image 3 has no box
            bw, bh = rs.uniform(4, w / 2), rs.uniform(4, h / 2)
            x, y = rs.uniform(0, w - bw), rs.uniform(0, h - bh)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1, category_id=int(rs.randint(1, 5)),
                             bbox=[x, y, bw, bh], area=bw * bh, iscrowd=0))
    for a in extra_anns:
        anns.append(dict(a, id=len(anns) + 1))
    cats = [dict(id=c + 1, name=n) for c, n in enumerate(CLASSES)] + [dict(id=9, name="other")]
    path = os.path.join(root, "ann.json")
    with open(path, "w") as f:
        json.dump(dict(images=images, annotations=anns, categories=cats), f)
    return path, os.path.join(root, "img")


SIZES = [(200, 150), (90, 70), (64, 60), (120, 200), (20, 40), (333, 250), (180, 120),
         (100, 160)]
EXTRA = [
    dict(image_id=1, category_id=2, bbox=[10, 10, 30, 20], area=600, iscrowd=1),
    dict(image_id=2, category_id=1, bbox=[5, 5, 20, 20], area=400, ignore=1),
    dict(image_id=1, category_id=3, bbox=[50, 50, 0.5, 9], area=4.5),
    dict(image_id=6, category_id=9, bbox=[3, 3, 30, 30], area=900),  # class filtered out
]


@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    return _write_set(str(tmp_path_factory.mktemp("coco")), SIZES, extra_anns=EXTRA)


def _same_infos(jds, tds):
    assert len(jds.data_infos) == len(tds.data_infos)
    for j, t in zip(jds.data_infos, tds.data_infos):
        for key in ("id", "filename", "width", "height"):
            assert j[key] == t[key]
        for key in ("bboxes", "labels", "bboxes_ignore", "areas"):
            assert j[key].dtype == t[key].dtype
            np.testing.assert_array_equal(j[key], t[key])
    np.testing.assert_array_equal(jds.flags, tds.flags)
    assert jds.CLASSES == tds.CLASSES and jds.cat_ids == tds.cat_ids


@pytest.mark.parametrize("test_mode", [False, True])
@pytest.mark.parametrize("classes", [None, CLASSES])
def test_dataset_infos_and_flags(coco_set, test_mode, classes):
    ann, prefix = coco_set
    jds = JCoco(ann, prefix, classes=classes, test_mode=test_mode)
    tds = TCoco(ann, prefix, classes=classes, test_mode=test_mode)
    _same_infos(jds, tds)
    assert len(tds) == (len(SIZES) if test_mode else len(SIZES) - 2)  # empty and small out
    assert any(len(d["bboxes_ignore"]) for d in tds.data_infos)  # crowd and ignore kept apart
    assert (tds.flags == 0).any() and (tds.flags == 1).any()  # a portrait image
    built = build_dataset(dict(type="UTDACDataset", ann_file=ann, img_prefix=prefix),
                          test_mode=test_mode)
    assert built.CLASSES == CLASSES


def test_load_image_matches_cv2(tmp_path):
    rs = np.random.RandomState(1)
    img = rs.randint(0, 256, (13, 17, 3)).astype(np.uint8)
    write_ppm(str(tmp_path / "a.ppm"), img)
    gray = rs.randint(0, 256, (9, 11)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "g.pgm"), gray)
    cv2.imwrite(str(tmp_path / "c.png"), img)
    for name in ("a.ppm", "g.pgm", "c.png"):
        got, ref = load_image(str(tmp_path / name)), cv2.imread(str(tmp_path / name))
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(load_image(str(tmp_path / "a.ppm")), img)
    with pytest.raises(FileNotFoundError):
        load_image(str(tmp_path / "missing.ppm"))


def test_load_image_without_cv2(tmp_path, monkeypatch):
    """PPM, and the PNGs numpy decodes, by numpy alone; another PNG (a
    palette one) through PIL where cv2 does not import; with neither
    library a JPEG raises naming its format."""
    pil = pytest.importorskip("PIL.Image")
    img = np.random.RandomState(2).randint(0, 256, (7, 5, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "c.png"), img)
    cv2.imwrite(str(tmp_path / "c.jpg"), img)
    write_ppm(str(tmp_path / "a.ppm"), img)
    pil.fromarray(img[..., ::-1]).convert("P").save(str(tmp_path / "p.png"))
    with pil.open(str(tmp_path / "p.png")) as im:
        palette_ref = np.asarray(im.convert("RGB"))[..., ::-1]
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(load_image(str(tmp_path / "c.png")), img)
    np.testing.assert_array_equal(load_image(str(tmp_path / "p.png")), palette_ref)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(load_image(str(tmp_path / "a.ppm")), img)
    np.testing.assert_array_equal(load_image(str(tmp_path / "c.png")), img)
    with pytest.raises(RuntimeError, match=r"\.jpg images needs cv2 or PIL"):
        load_image(str(tmp_path / "c.jpg"))


def _same_sample(got, ref, with_images=True):
    if with_images:
        g = got["images"]
        g = g.cpu().numpy() if torch.is_tensor(g) else g
        assert g.shape == ref["images"].shape and g.dtype == np.float32
        np.testing.assert_allclose(g, ref["images"], rtol=0, atol=TOL)
    for key in ("gt_bboxes", "gt_labels", "gt_mask", "img_shape", "scale_factor", "ori_shape"):
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


# (image (H, W), canvas, scale, max_gt): down- and upscaled, a portrait image
# on the landscape canvas (its factor capped), max_gt cutting the boxes, a
# full-size UTDAC frame on the flagship's canvas
CASES = [((150, 200), CANVAS, (1333, 800), 100), ((37, 45), (96, 160), (1333, 800), 100),
         ((200, 120), CANVAS, (1333, 800), 100), ((123, 217), (608, 1024), (1000, 600), 3),
         ((480, 586), CANVAS, (1333, 800), 2), ((1080, 1920), (800, 1344), (1333, 800), 100)]


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_preprocess_matches_native_branch(case, flip):
    assert get_lib() is not None, "the JAX package's native preprocess did not load"
    (h, w), canvas, scale, max_gt = CASES[case]
    rs = np.random.RandomState(case)
    img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    xy = rs.uniform(0, 1, (5, 2)) * [w, h]
    boxes = np.concatenate([xy, xy + rs.uniform(2, 40, (5, 2))], 1).astype(np.float32)
    labels = rs.randint(0, 4, 5)
    ref = j_pipeline.preprocess(img, boxes, labels, canvas=canvas, scale=scale, flip=flip,
                                max_gt=max_gt)
    # the JAX side took its native branch: the same bytes as the native pass
    nh, nw = (int(v) for v in ref["img_shape"])
    native = native_preprocess(img, canvas, nh, nw, j_pipeline.DEFAULT_MEAN,
                               j_pipeline.DEFAULT_STD, flip=flip)
    np.testing.assert_array_equal(ref["images"], native)
    got = t_pipeline.preprocess(img, boxes, labels, canvas=canvas, scale=scale, flip=flip,
                                max_gt=max_gt)
    _same_sample(got, ref)
    assert int(got["gt_mask"].sum()) == min(5, max_gt)


def test_train_loader_matches_jax(coco_set):
    ann, prefix = coco_set
    jds, tds = JCoco(ann, prefix), TCoco(ann, prefix)
    kw = dict(batch_size=2, canvas=CANVAS, train=True, seed=0)
    jl, tl = JLoader(jds, **kw), TLoader(tds, **kw)
    assert len(jl) == len(tl)
    shapes = set()
    for epoch in range(2):
        jb, tb = list(jl.epoch_iter(epoch)), list(tl.epoch_iter(epoch))
        assert len(jb) == len(tb) == len(tl)
        for j, t in zip(jb, tb):
            assert set(t) == set(j)
            _same_sample(t, j)
            shapes.add(tuple(t["images"].shape[1:3]))
    assert shapes == {CANVAS, CANVAS[::-1]}


def test_test_loader_evaluates_every_image(tmp_path):
    sizes = [(200, 150), (90, 70), (120, 200), (180, 120), (150, 100)]
    ann, prefix = _write_set(str(tmp_path), sizes)
    jds, tds = JCoco(ann, prefix, test_mode=True), TCoco(ann, prefix, test_mode=True)
    kw = dict(batch_size=2, canvas=CANVAS, train=False)
    jbatches = list(JLoader(jds, **kw).epoch_iter(0))
    # the reference loader drops the tail: 4 of 5 images
    assert sum(len(b["images"]) for b in jbatches) == 4
    loader = TLoader(tds, **kw)
    batches = list(loader.epoch_iter(0))
    assert len(batches) == len(loader) == 3  # 4 landscape in 2 batches, 1 portrait padded
    seen = []
    order = [i for f in (1, 0) for i in np.where(tds.flags == f)[0]]
    for b in batches:
        canvases = {tuple(b["images"].shape[1:3])}
        assert len(canvases) == 1
        for i in range(len(b["pad"])):
            if not b["pad"][i]:
                seen.append(int(b["ori_shape"][i][0] * 10000 + b["ori_shape"][i][1]))
    assert len(seen) == len(tds)
    assert seen == [tds.data_infos[i]["height"] * 10000 + tds.data_infos[i]["width"]
                    for i in order]
    # each image's dataset index comes with it (the buckets' order is not the dataset's)
    assert [int(j) for b in batches for i, j in enumerate(b["index"]) if not b["pad"][i]] == order
    assert order != sorted(order)
    last = batches[-1]
    assert last["pad"].tolist() == [False, True]
    assert tuple(last["images"].shape[1:3]) == CANVAS[::-1]
    torch.testing.assert_close(last["images"][0], last["images"][1], rtol=0, atol=0)
