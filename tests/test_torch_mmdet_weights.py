"""The PyTorch port's mmdet and torchvision weight loading against the JAX
package's converter, on the CPU.

State dicts in mmdet's naming come from ``tests/test_full_model_parity.py``'s
torch modules (the tiny flagship: ResNet-18 at width 8, PAFPN 32, ATSS RPN
32 x 2 with GroupNorm and per-level scales, Shared2FC 48) and, for the tiny
Mask R-CNN, from plain ``torch.nn`` layers named as mmdet names them (FPN,
the one-conv RPN, Shared2FC, the FCN mask head with its transposed conv),
each with seeded random values and written with ``torch.save``.  Checked:

  * ``weights.from_mmdet_state_dict`` equals ``weights.from_jax_params`` of
    the JAX ``convert_mmdet_checkpoint`` of the same file, tensor for
    tensor, and loads strictly into the port's model; the one tensor the
    JAX converter drops (the plain RPN's ``rpn_head.rpn_conv``) is the
    source tensor;
  * the first FC after the RoI pool: the port's head on NHWC-pooled
    features equals the torch module's on the same features flattened
    ``(C, 7, 7)`` (within 1e-5), and the mask head's transposed conv equals
    ``nn.ConvTranspose2d``;
  * ``from_torchvision_resnet`` equals ``from_jax_params`` of the JAX
    ``convert_torchvision_resnet`` at depths 18 and 50 (classifier and BN
    counters skipped); ``load_pretrained`` loads a local file and refuses
    an address; ``engine.checkpoint.load_params`` reads an mmdet file;
  * Cascade Mask R-CNN's and HTC's (with and without the semantic head)
    per-stage mask heads and semantic head: the port's seeded weights,
    renamed to mmdet's names in the test, load back into a fresh model
    through ``from_mmdet_state_dict`` and ``load_params``, every tensor
    equal (the JAX converter drops these keys, so the port is held to its
    own module names); keys of modules the port lacks raise, named.
"""
import os
import re
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_full_model_parity import FC, FEAT, STACKED, TorchBoosting  # noqa: E402
from tools.convert_torch_weights import (  # noqa: E402
    convert_mmdet_checkpoint,
    convert_torchvision_resnet,
)
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.engine.checkpoint import load_params  # noqa: E402
from boosting_rcnn_tpu_torch.engine.runner import shrink_model  # noqa: E402
from boosting_rcnn_tpu_torch.weights import (  # noqa: E402
    from_jax_params,
    from_mmdet_state_dict,
    from_torchvision_resnet,
    load_pretrained,
)

FLAGSHIP = os.path.join(REPO, "configs/boosting_rcnn/boosting_rcnn_r50_pafpn_1x_utdac.py")
MASK = os.path.join(REPO, "configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread: beside the suite's other pytest
    workers, torch's default of a thread a core oversubscribes the host
    (this file's cases ran several times slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if t.is_floating_point():
                t.copy_(torch.rand(t.shape, generator=g) + 0.5 if "running_var" in name
                        else 0.2 * torch.randn(t.shape, generator=g))
    return module


def _flagship_port():
    """The port's flagship at the torch modules' sizes (as
    ``test_full_model_parity._build_jax_detector``)."""
    mc = load_config(FLAGSHIP).model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"].update(in_channels=[8, 16, 32, 64], out_channels=FEAT, start_level=1)
    mc["rpn_head"].update(feat_channels=FEAT, stacked_convs=STACKED, anchor_generator=dict(
        octave_base_scale=8, scales_per_octave=1, ratios=[1.0], strides=[8, 16, 32, 64, 128]))
    mc["roi_head"]["bbox_head"].update(fc_out_channels=FC, num_classes=4)
    return build_detector(mc, device="cpu")


def _mask_port():
    mc = load_config(MASK).model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"].update(in_channels=[8, 16, 32, 64], out_channels=32)
    mc["rpn_head"].update(in_channels=32, feat_channels=32)
    roi = mc["roi_head"]
    roi["bbox_head"].update(in_channels=32, fc_out_channels=16, num_classes=4)
    roi["mask_head"].update(in_channels=32, conv_out_channels=16, num_classes=4)
    return build_detector(mc, device="cpu")


class TorchMaskRCNN(torch.nn.Module):
    """The tiny Mask R-CNN's layers past the backbone, named as mmdet's."""

    def __init__(self):
        super().__init__()
        self.lateral = torch.nn.ModuleList([torch.nn.Conv2d(c, 32, 1) for c in (8, 16, 32, 64)])
        self.fpn = torch.nn.ModuleList([torch.nn.Conv2d(32, 32, 3, 1, 1) for _ in range(4)])
        self.rpn_conv = torch.nn.Conv2d(32, 32, 3, 1, 1)
        self.rpn_cls = torch.nn.Conv2d(32, 3, 1)
        self.rpn_reg = torch.nn.Conv2d(32, 12, 1)
        self.shared_fcs = torch.nn.ModuleList([torch.nn.Linear(32 * 49, 16),
                                               torch.nn.Linear(16, 16)])
        self.fc_cls = torch.nn.Linear(16, 5)
        self.fc_reg = torch.nn.Linear(16, 16)
        self.mask_convs = torch.nn.ModuleList(
            [torch.nn.Conv2d(32 if i == 0 else 16, 16, 3, 1, 1) for i in range(4)])
        self.upsample = torch.nn.ConvTranspose2d(16, 16, 2, 2)
        self.conv_logits = torch.nn.Conv2d(16, 4, 1)

    def mmdet_state_dict(self, backbone):
        sd = {k: v for k, v in backbone.items() if k.startswith("backbone.")}
        for i in range(4):
            for leaf in ("weight", "bias"):
                sd[f"neck.lateral_convs.{i}.conv.{leaf}"] = getattr(self.lateral[i], leaf)
                sd[f"neck.fpn_convs.{i}.conv.{leaf}"] = getattr(self.fpn[i], leaf)
                sd[f"roi_head.mask_head.convs.{i}.conv.{leaf}"] = getattr(self.mask_convs[i],
                                                                          leaf)
        for leaf in ("weight", "bias"):
            for name in ("rpn_conv", "rpn_cls", "rpn_reg"):
                sd[f"rpn_head.{name}.{leaf}"] = getattr(getattr(self, name), leaf)
            for i, fc in enumerate(self.shared_fcs):
                sd[f"roi_head.bbox_head.shared_fcs.{i}.{leaf}"] = getattr(fc, leaf)
            for name in ("fc_cls", "fc_reg"):
                sd[f"roi_head.bbox_head.{name}.{leaf}"] = getattr(getattr(self, name), leaf)
            for name in ("upsample", "conv_logits"):
                sd[f"roi_head.mask_head.{name}.{leaf}"] = getattr(getattr(self, name), leaf)
        sd["backbone.bn1.num_batches_tracked"] = torch.tensor(7)
        return {k: v.detach().clone() for k, v in sd.items()}


def _flagship_sd():
    tm = _randomize(TorchBoosting(), 0).eval()
    return tm, tm.mmdet_state_dict()


def _via_jax(sd, path):
    torch.save({"state_dict": sd}, path)
    params, stats = convert_mmdet_checkpoint(path)
    return from_jax_params({"params": params, "batch_stats": stats})


def _same(got, ref):
    for k in ref:
        g, r = got[k], ref[k]
        if g.dim() == 0 and r.shape == (1,):  # a scalar Scale: numpy hands JAX's on as (1,)
            g = g.reshape(1)
        assert g.dtype == r.dtype == torch.float32, k
        assert g.shape == r.shape, k
        assert torch.equal(g, r), k


def test_flagship_mmdet_state_dict(tmp_path):
    tm, sd = _flagship_sd()
    got = from_mmdet_state_dict(sd)
    ref = _via_jax(sd, str(tmp_path / "flagship.pth"))
    assert set(got) == set(ref)
    _same(got, ref)
    det = _flagship_port()
    det.net.load_state_dict(got, strict=True)
    # the first FC on the same pooled features, NHWC in the port, (C, 7, 7) in mmdet
    pooled = torch.randn(6, 7, 7, FEAT, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        cls, reg = det.net.bbox_head(pooled)
        t_cls, t_reg = tm.head_fwd(pooled.permute(0, 3, 1, 2).reshape(6, -1))
    torch.testing.assert_close(cls, t_cls, rtol=0, atol=1e-5)
    torch.testing.assert_close(reg, t_reg, rtol=0, atol=1e-5)
    assert torch.equal(load_params(str(tmp_path / "flagship.pth"))["bbox_head.fc_cls.weight"],
                       got["bbox_head.fc_cls.weight"])


def test_mask_rcnn_mmdet_state_dict(tmp_path):
    _, flagship = _flagship_sd()
    tm = _randomize(TorchMaskRCNN(), 2)
    sd = tm.mmdet_state_dict(flagship)
    got = from_mmdet_state_dict(sd)
    ref = _via_jax(sd, str(tmp_path / "mask.pth"))
    # the JAX converter reads the ATSS RPN's rpn_convs.N only: the plain RPN's
    # one conv is the single tensor it drops
    assert set(got) - set(ref) == {"rpn.rpn_conv.weight", "rpn.rpn_conv.bias"}
    assert set(ref) <= set(got)
    _same(got, ref)
    assert torch.equal(got["rpn.rpn_conv.weight"], sd["rpn_head.rpn_conv.weight"])
    det = _mask_port()
    det.net.load_state_dict(got, strict=True)
    x = torch.randn(3, 16, 14, 14, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        torch.testing.assert_close(det.net.mask_head.upsample(x), tm.upsample(x), rtol=0,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="cascade"):
        from_mmdet_state_dict({**sd, "roi_head.bbox_head.1.cascade.weight": torch.zeros(1)})


def _torchvision_names(port_backbone):
    """A torchvision ResNet state dict with the port backbone's shapes."""
    sd = {}
    g = torch.Generator().manual_seed(4)
    for key, t in port_backbone.items():
        name = key[len("backbone."):]
        m = re.fullmatch(r"layer(\d+)_(\d+)\.(.+)", name)
        if m:
            rest = m[3].replace("downsample_conv.", "downsample.0.").replace(
                "downsample_bn.", "downsample.1.")
            name = f"layer{m[1]}.{m[2]}.{rest}"
        sd[name] = (torch.rand(t.shape, generator=g) + 0.5 if "running_var" in name
                    else torch.randn(t.shape, generator=g))
        if name.endswith("running_var"):
            sd[name.replace("running_var", "num_batches_tracked")] = torch.tensor(3)
    sd["fc.weight"], sd["fc.bias"] = torch.randn(10, 4), torch.randn(10)
    return sd


@pytest.mark.parametrize("depth", [18, 50])
def test_torchvision_resnet(depth, tmp_path):
    mc = load_config(FLAGSHIP).model.to_dict()
    mc["backbone"].update(depth=depth, base_channels=8)
    mc["neck"].update(in_channels=[8, 16, 32, 64] if depth == 18 else [32, 64, 128, 256],
                      out_channels=32)
    mc["rpn_head"].update(feat_channels=32, stacked_convs=1)
    mc["roi_head"]["bbox_head"]["fc_out_channels"] = 16
    det = build_detector(mc, device="cpu")
    own = {k: v for k, v in det.net.state_dict().items() if k.startswith("backbone.")}
    sd = _torchvision_names(own)
    got = from_torchvision_resnet(sd)
    params, stats = convert_torchvision_resnet(sd)
    ref = from_jax_params({"params": {"backbone": params}, "batch_stats": {"backbone": stats}})
    assert set(got) == set(ref) == set(own)
    _same(got, ref)
    path = str(tmp_path / "resnet.pth")
    torch.save(sd, path)
    assert load_pretrained(det.net, dict(type="Pretrained", checkpoint=path)) == path
    _same(det.net.state_dict(), got)
    with pytest.raises(ValueError, match="fetches nothing"):
        load_pretrained(det.net, dict(type="Pretrained", checkpoint="torchvision://resnet50"))


# the port's module names -> mmdet's, for the cascade models' round trips
_TO_MMDET = (
    (r"backbone\.layer(\d+)_(\d+)\.downsample_conv\.(.+)", r"backbone.layer\1.\2.downsample.0.\3"),
    (r"backbone\.layer(\d+)_(\d+)\.downsample_bn\.(.+)", r"backbone.layer\1.\2.downsample.1.\3"),
    (r"backbone\.layer(\d+)_(\d+)\.(.+)", r"backbone.layer\1.\2.\3"),
    (r"backbone\.(.+)", r"backbone.\1"),
    (r"neck\.lateral_(\d+)\.conv\.(.+)", r"neck.lateral_convs.\1.conv.\2"),
    (r"neck\.fpn_conv_(\d+)\.conv\.(.+)", r"neck.fpn_convs.\1.conv.\2"),
    (r"rpn\.(rpn_conv|rpn_cls|rpn_reg)\.(.+)", r"rpn_head.\1.\2"),
    (r"bbox_heads\.(\d+)\.shared_fc_(\d+)\.(.+)", r"roi_head.bbox_head.\1.shared_fcs.\2.\3"),
    (r"bbox_heads\.(\d+)\.(fc_cls|fc_reg)\.(.+)", r"roi_head.bbox_head.\1.\2.\3"),
    (r"mask_heads\.(\d+)\.conv_(\d+)\.(.+)", r"roi_head.mask_head.\1.convs.\2.conv.\3"),
    (r"mask_heads\.(\d+)\.conv_res\.(.+)", r"roi_head.mask_head.\1.conv_res.conv.\2"),
    (r"mask_heads\.(\d+)\.(upsample|conv_logits)\.(.+)", r"roi_head.mask_head.\1.\2.\3"),
    (r"semantic_head\.lateral_(\d+)\.(.+)", r"roi_head.semantic_head.lateral_convs.\1.conv.\2"),
    (r"semantic_head\.conv_(\d+)\.(.+)", r"roi_head.semantic_head.convs.\1.conv.\2"),
    (r"semantic_head\.conv_embedding\.(.+)", r"roi_head.semantic_head.conv_embedding.conv.\1"),
    (r"semantic_head\.conv_seg\.(.+)", r"roi_head.semantic_head.conv_logits.\1"),
)


def _mmdet_names(state, roi_feat_size=7):
    """An mmdet state dict of the port's ``state``: mmdet's names, the first
    FC after the pool taking its input flattened ``(C, S, S)``."""
    out = {}
    for key, value in state.items():
        name = next(re.sub(p, r, key) for p, r in _TO_MMDET if re.fullmatch(p, key))
        if re.fullmatch(r"bbox_heads\.\d+\.shared_fc_0\.weight", key):
            s = roi_feat_size
            o, i = value.shape
            value = value.reshape(o, s, s, i // (s * s)).permute(0, 3, 1, 2).reshape(o, i)
        out[name] = value.clone()
    return out


CASCADE_MASK_MODELS = {
    "htc": os.path.join(REPO, "configs/htc/htc_r50_fpn_1x_coco.py"),
    "htc_without_semantic": os.path.join(
        REPO, "configs/htc/htc_without_semantic_r50_fpn_1x_coco.py"),
    "cascade_mask_rcnn": os.path.join(
        REPO, "configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py"),
}


@pytest.mark.parametrize("name", sorted(CASCADE_MASK_MODELS))
def test_cascade_mask_mmdet_round_trip(name, tmp_path):
    """The port's seeded weights in mmdet's names, through
    ``from_mmdet_state_dict`` and an mmdet ``.pth`` file into a model of
    another seed: every tensor back, equal; the per-stage mask heads'
    ``convs``, ``conv_res``, ``upsample`` and ``conv_logits`` and the
    semantic head's laterals, convs, embedding and logits each placed."""
    mc = shrink_model(load_config(CASCADE_MASK_MODELS[name]).model.to_dict())
    src = build_detector(mc, device="cpu", seed=1).net.state_dict()
    sd = _mmdet_names(src)
    assert any(".mask_head.1.convs.0.conv." in k for k in sd)
    assert any(".mask_head.2.conv_res.conv." in k for k in sd) == name.startswith("htc")
    assert any(".semantic_head.conv_logits." in k for k in sd) == (name == "htc")
    path = str(tmp_path / f"{name}.pth")
    torch.save({"state_dict": {**sd, "backbone.bn1.num_batches_tracked": torch.tensor(7)}},
               path)
    det = build_detector(mc, device="cpu", seed=2)
    assert any(not torch.equal(v, src[k]) for k, v in det.net.state_dict().items())
    got = from_mmdet_state_dict(sd)
    assert set(got) == set(src)
    det.net.load_state_dict(load_params(path), strict=True)
    for k, v in det.net.state_dict().items():
        assert torch.equal(v, src[k]), k
        assert torch.equal(got[k], src[k]), k


@pytest.mark.parametrize("key", [
    "roi_head.mask_head.1.conv_res.norm.weight",
    "roi_head.semantic_head.fcs.0.weight",
    "roi_head.mask_head.0.convs.0.bn.weight",
    "roi_head.mask_iou_head.conv_logits.weight",
])
def test_unknown_mmdet_keys_raise_named(key):
    with pytest.raises(ValueError, match=re.escape(repr(key))):
        from_mmdet_state_dict({key: torch.zeros(2)})
