"""The caffe-style ResNet family in the PyTorch port against the JAX
package, on the CPU.

  * a tiny caffe ResNet-50 and ResNeXt-50 (``base_channels=8``, Bottleneck
    blocks, so that the stride's place matters) against JAX
    ``build_resnet`` / ``build_resnext`` with ``style='caffe'``: C2-C5
    within 1e-5 of each level's largest value; the stride sits on each
    stage's first 1x1 and the shortcut, the same weights in the pytorch
    style give other outputs;
  * the parameter names and shapes are the pytorch style's, so
    ``from_jax_params``, ``from_torchvision_resnet`` and
    ``load_pretrained`` carry a caffe backbone unchanged;
  * ``faster_rcnn_r50_caffe_fpn_1x_coco.py`` at a tiny size (caffe
    ResNet-50 at width 8, FPN 32, RPN 32, FC 64, 4 classes) through
    ``tests/test_torch_boosting_detectors.py``'s harness: ``predict``
    (labels and valid equal, detections within 1e-3), the four losses (rtol
    1e-4), every parameter gradient and the parameters after two SGD steps,
    on weights and a batch drawn from seed 1 (at seed 0 two of image 0's
    kept detections are 1.5e-7 apart in score, 2e-7 from JAX's, and the
    packages keep them in opposite orders);
  * both loaders' batches with the caffe configs' ``img_norm`` (BGR, mean
    only, ``to_rgb=False``) equal, in train and test mode.
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

from boosting_rcnn_tpu.builder import build_resnet, build_resnext  # noqa: E402
from boosting_rcnn_tpu.data.coco import CocoDataset as JCoco  # noqa: E402
from boosting_rcnn_tpu.data.loader import DetDataLoader as JLoader  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.data.coco import CocoDataset as TCoco  # noqa: E402
from boosting_rcnn_tpu_torch.data.loader import DetDataLoader as TLoader  # noqa: E402
from boosting_rcnn_tpu_torch.data.synthetic import generate  # noqa: E402
from boosting_rcnn_tpu_torch.models.backbones.resnet import ResNet  # noqa: E402
from boosting_rcnn_tpu_torch.weights import (  # noqa: E402
    from_jax_params,
    from_torchvision_resnet,
    load_pretrained,
)
from test_torch_mmdet_weights import _torchvision_names  # noqa: E402
from test_torch_boosting_detectors import (  # noqa: E402
    _random_variables,
    check_gradients,
    check_losses,
    check_predict,
    check_step,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
    run_pair,
    shrink_heads,
)

CAFFE = "faster_rcnn/faster_rcnn_r50_caffe_fpn_1x_coco.py"
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox")
CAFFE_NORM = dict(mean=[103.530, 116.280, 123.675], std=[1.0, 1.0, 1.0], to_rgb=False)
BACKBONES = {
    "resnet50": (build_resnet, {}),
    "resnext50_2x4d": (build_resnext, dict(groups=2, base_width=4)),
}


def _backbone_cfg(name, style="caffe"):
    return dict(type="ResNet" if name == "resnet50" else "ResNeXt", depth=50, base_channels=8,
                frozen_stages=1, style=style, **BACKBONES[name][1])


def _port_backbone(name, style="caffe"):
    cfg = _backbone_cfg(name, style)
    return ResNet(torch.Generator().manual_seed(0), depth=50, base_channels=8, frozen_stages=1,
                  style=style, **{k: cfg[k] for k in ("groups", "base_width") if k in cfg})


def _levels(net, images):
    with torch.inference_mode():
        return [c.permute(0, 2, 3, 1) for c in net(torch.from_numpy(images).permute(0, 3, 1, 2))]


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_caffe_backbone_matches_jax(name):
    rs = np.random.RandomState(0)
    images = (rs.rand(2, 64, 96, 3) * 2.0 - 1.0).astype(np.float32)
    jmod = BACKBONES[name][0](_backbone_cfg(name))
    assert jmod.style == "caffe"
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros(images.shape)))
    variables = _random_variables(shapes, rs)
    ref = jax.jit(jmod.apply)(jax.tree.map(jnp.asarray, variables), jnp.asarray(images))
    net = _port_backbone(name)
    net.load_state_dict(from_jax_params(variables), strict=True)
    got = _levels(net, images)
    assert len(got) == len(ref) == 4
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max(),
                                   err_msg=f"{name} C{i + 2}")
    for stage in (2, 3, 4):
        block = getattr(net, f"layer{stage}_0")
        assert (block.conv1.stride, block.conv2.stride) == ((2, 2), (1, 1))
        assert block.downsample_conv.stride == (2, 2)
    pytorch_style = _port_backbone(name, "pytorch")
    pytorch_style.load_state_dict(from_jax_params(variables), strict=True)
    assert pytorch_style.layer2_0.conv2.stride == (2, 2)
    other = _levels(pytorch_style, images)
    assert other[1].shape == got[1].shape and not torch.allclose(other[1], got[1], atol=1e-3)


def test_caffe_backbone_weights_are_the_pytorch_style_ones(tmp_path):
    caffe, pytorch = _port_backbone("resnet50"), _port_backbone("resnet50", "pytorch")
    assert {k: v.shape for k, v in caffe.state_dict().items()} == {
        k: v.shape for k, v in pytorch.state_dict().items()}
    # a torchvision-named file (what load_pretrained reads) into a caffe config's net
    mc = load_config(config_path(CAFFE)).model.to_dict()
    mc["backbone"].update(base_channels=8)
    mc["neck"]["in_channels"] = [32, 64, 128, 256]
    det = build_detector(shrink_heads(mc, num_classes=4), device="cpu")
    assert det.net.backbone.layer3_0.conv1.stride == (2, 2)
    sd = _torchvision_names({k: v for k, v in det.net.state_dict().items()
                             if k.startswith("backbone.")})
    path = str(tmp_path / "caffe_r50.pth")
    torch.save(sd, path)
    assert load_pretrained(det.net, dict(type="Pretrained", checkpoint=path)) == path
    mapped = from_torchvision_resnet(sd)
    for k, v in det.net.backbone.state_dict().items():
        assert torch.equal(v, mapped["backbone." + k]), k
    with pytest.raises(ValueError, match="fetches nothing"):
        load_pretrained(det.net, mc["backbone"]["init_cfg"])


def _faster_caffe(load):
    mc = load(config_path(CAFFE)).model.to_dict()
    assert mc["backbone"]["style"] == "caffe"
    mc["backbone"].update(base_channels=8)
    mc["neck"]["in_channels"] = [32, 64, 128, 256]
    mc["roi_head"]["bbox_roi_extractor"]["out_channels"] = 32
    return shrink_heads(mc, num_classes=4)


@pytest.fixture(scope="module")
def run():
    return run_pair(_faster_caffe, seed=1)


def test_faster_caffe_is_caffe_style(run):
    net = run["tdet"].net.backbone
    assert net.layer2_0.conv1.stride == (2, 2) and net.layer2_0.conv2.stride == (1, 1)
    assert run["jdet"].net.backbone.style == "caffe"


def test_faster_caffe_predict_matches_jax(run):
    check_predict(run)


def test_faster_caffe_losses_match_jax(run):
    check_losses(run, LOSSES)


def test_faster_caffe_gradients_match_jax(run):
    check_gradients(run)


@pytest.mark.parametrize("step", [0, 1])
def test_faster_caffe_sgd_steps_match_jax(run, step):
    check_step(run, step, LOSSES)


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_loaders_match_with_the_caffe_norm(train, tmp_path):
    generate(str(tmp_path), n_train=0, n_val=5, seed=2, n_portrait=1)
    ann, prefix = str(tmp_path / "val.json"), str(tmp_path / "val")
    kw = dict(batch_size=2, canvas=(128, 160), train=train, seed=3, img_norm=CAFFE_NORM)
    jl = JLoader(JCoco(ann, prefix, test_mode=not train), **kw)
    tl = TLoader(TCoco(ann, prefix, test_mode=not train), **kw)
    assert tl.norm_to_rgb is jl.norm_to_rgb is False
    jb, tb = list(jl.epoch_iter(0)), list(tl.epoch_iter(0))
    if not train:  # the JAX test loader drops the portrait bucket's partial batch
        tb = [b for b in tb if not b["pad"].any()]
    assert len(jb) == len(tb) > 0
    for j, t in zip(jb, tb):
        images = t["images"].numpy()
        np.testing.assert_allclose(images, j["images"], rtol=0, atol=1e-4)
        for key in ("gt_bboxes", "gt_labels", "gt_mask", "img_shape", "scale_factor"):
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    # BGR kept and only the mean taken off: the first channel is blue
    img = tb[0]["images"][0].numpy()
    h, w = (int(v) for v in tb[0]["img_shape"][0])
    assert img[:h, :w].min() >= -123.675 - 1e-3 and img[:h, :w].max() <= 255 - 103.53 + 1e-3
