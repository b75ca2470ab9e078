"""The PyTorch port's flip and multi-scale test-time augmentation against
the JAX package's, on the CPU.

Tiny detectors, each a config as ``--tiny`` shrinks it (ResNet-18 at
width 8, neck and RPN 32, FC 64, 32 test proposals an image): here the
flagship (prior fusion) and Faster R-CNN R50-FPN (the softmax,
class-specific boxes, 80 classes); ``tests/test_torch_tta_soft_nms.py``
runs the same checks on the COCO ResNeXt family config with soft-NMS.
Random weights made with numpy from a seed go to the JAX
package as flax variables (shapes by ``jax.eval_shape``) and to the port
through ``weights.from_jax_params``.  Checked, at the tolerances of
``predict`` (labels and valid equal, detections within 1e-3):

  * ``aug_predict`` (the batch and its mirror) and ``aug_predict_multi``
    over two short sides with flip (four views on the canvases 128 x 160
    and 96 x 128);
  * ``hflip_boxes`` against the JAX ``_hflip_boxes``;
  * a cascade and HTC raise ``NotImplementedError`` naming why.

``tests/test_torch_tta_eval.py`` holds ``run_eval_tta`` and the CLI.  Each
file stays near a minute on the CPU: each JAX function is jitted per
model.
"""
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from boosting_rcnn_tpu.builder import build_detector as jax_build  # noqa: E402
from boosting_rcnn_tpu.config import load_config as jax_load_config  # noqa: E402
from boosting_rcnn_tpu.models.detectors import two_stage as j_two_stage  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.engine.runner import shrink_model  # noqa: E402
from boosting_rcnn_tpu_torch.models.detectors import two_stage as t_two_stage  # noqa: E402
from boosting_rcnn_tpu_torch.ops.box_ops import hflip_boxes  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402
from test_torch_boosting_detectors import _random_variables, config_path  # noqa: E402

FLAGSHIP = "boosting_rcnn/boosting_rcnn_r50_pafpn_1x_utdac.py"
FASTER = "faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py"
# the two views' canvases, valid shapes and scale factors: the same two
# images at short sides 128 and 96
VIEWS = (((128, 160), [[128.0, 150.0], [116.0, 160.0]], [1.0, 1.25]),
         ((96, 128), [[96.0, 112.0], [87.0, 120.0]], [0.75, 0.9375]))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread: beside the suite's other pytest
    workers, torch's default of a thread a core oversubscribes the host
    (this file's cases ran several times slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny(name: str, load):
    mc = shrink_model(load(config_path(name)).model.to_dict())
    nms = mc["test_cfg"]["rcnn"]["nms"]
    if nms.get("type") == "soft_nms":
        nms["min_score"] = 1e-3  # the JAX package's, whatever the config says
    return mc


def view_batches(rs):
    return [{"images": (rs.rand(2, *canvas, 3) * 2.0 - 1.0).astype(np.float32),
             "img_shape": np.array(shape, np.float32),
             "scale_factor": np.repeat(np.array(sf, np.float32)[:, None], 4, 1)}
            for canvas, shape, sf in VIEWS]


def pair(name: str, seed: int = 0):
    """The JAX and the port's detectors of ``name`` on the same weights,
    with each view's anchors and batch, made from ``seed``."""
    mc = tiny(name, jax_load_config)
    jdet = jax_build(mc, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), VIEWS[0][0]))
    rs = np.random.RandomState(seed)
    variables = _random_variables(shapes, rs)
    tdet = build_detector(tiny(name, load_config), device="cpu")
    tdet.net.load_state_dict(from_jax_params(variables), strict=True)
    anchors = []
    for canvas, _, _ in VIEWS:
        ja, jn = jdet.anchors_for(canvas)
        ta, tn = tdet.anchors_for(canvas)
        assert tn == jn
        anchors.append(((ja, jn), (ta, tn)))
    return dict(jdet=jdet, tdet=tdet, jv=jax.tree.map(jnp.asarray, variables),
                anchors=anchors, batches=view_batches(rs))


def torch_views(p, flips, n_scales):
    return [(p["batches"][s], *p["anchors"][s][1], f) for s in range(n_scales) for f in flips]


def run_jax(p, flips, n_scales):
    anchors = [p["anchors"][s][0] for s in range(n_scales)]

    def fn(v, batches):
        views = [(batches[s], *anchors[s], f) for s in range(n_scales) for f in flips]
        return j_two_stage.aug_predict_multi(p["jdet"], v, views)

    batches = [jax.tree.map(jnp.asarray, p["batches"][s]) for s in range(n_scales)]
    return [np.asarray(x) for x in jax.jit(fn)(p["jv"], batches)]


def check_same(got, ref, min_dets: int = 10):
    dets, labels, valid = (x.numpy() for x in got)
    assert int(valid.sum()) >= min_dets
    np.testing.assert_array_equal(valid, ref[2])
    np.testing.assert_array_equal(labels, ref[1])
    np.testing.assert_allclose(dets, ref[0], rtol=0, atol=1e-3)
    assert np.isfinite(dets).all()


def check_flip(p):
    """``aug_predict`` against JAX's on the first view's batch."""
    ta, tn = p["anchors"][0][1]
    check_same(t_two_stage.aug_predict(p["tdet"], p["batches"][0], ta, tn),
               run_jax(p, (False, True), 1))


def check_multi(p):
    """``aug_predict_multi`` over both short sides with flip against JAX's."""
    check_same(t_two_stage.aug_predict_multi(p["tdet"], torch_views(p, (False, True), 2)),
               run_jax(p, (False, True), 2))


@pytest.fixture(scope="module", params=[FLAGSHIP, FASTER], ids=["flagship", "faster_rcnn"])
def det_pair(request):
    return pair(request.param)


def test_tiny_models_reach_their_branches(det_pair):
    det = det_pair["tdet"]
    assert det.roi_cfg.prob == (det.rpn_type == "atss_rpn")  # the flagship fuses its prior
    assert det.bbox_cfg.reg_class_agnostic is False
    assert det.rcnn_test_cfg.nms_type == "nms"


def test_aug_predict_flip_matches_jax(det_pair):
    check_flip(det_pair)


def test_aug_predict_multi_two_scales_flip_matches_jax(det_pair):
    check_multi(det_pair)


def test_hflip_boxes_mirrors_inside_the_width():
    boxes = torch.tensor([[[1.0, 2.0, 5.0, 9.0], [0.0, 0.0, 160.0, 3.0]]])
    got = hflip_boxes(boxes, 160.0)
    np.testing.assert_array_equal(got.numpy(), [[[155.0, 2.0, 159.0, 9.0],
                                                 [0.0, 0.0, 160.0, 3.0]]])
    torch.testing.assert_close(hflip_boxes(got, 160.0), boxes, rtol=0, atol=0)
    ref = np.asarray(j_two_stage._hflip_boxes(jnp.asarray(boxes.numpy()), 160.0))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", ["cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py",
                                  "htc/htc_r50_fpn_1x_coco.py"])
def test_cascades_raise_named(name):
    det = build_detector(shrink_model(load_config(config_path(name)).model.to_dict()),
                         device="cpu")
    batch = view_batches(np.random.RandomState(0))[0]
    a, n = det.anchors_for(VIEWS[0][0])
    with pytest.raises(NotImplementedError, match="roi_out takes a stage"):
        t_two_stage.aug_predict(det, batch, a, n)
