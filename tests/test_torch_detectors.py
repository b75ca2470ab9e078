"""DetectoRS in the PyTorch port against the JAX package, on the CPU:
``DetectoRS_ResNet`` with Switchable Atrous Convolution and the ``RFP``
neck (JAX ``models/backbones/detectors_resnet.py``, ``necks/fpn.py:565``).

Modules, the same seeded numpy parameters (through
``weights.from_jax_params``) on the same seeded inputs
(``tests/test_torch_necks_fpt.py::run_module``), values and gradients
within 1e-5 of the largest: ``SAConv`` at stride 1 and 2 on odd maps,
``DetBottleneck`` with SAC with and without a feedback map, the tiny
``DetectoRSResNet`` (ResNet-50 at width 8, every stage trainable so that
every gradient is seen), and ``RFP`` with its own feedback backbone (one
FPN called on both passes, the shared ASPP, the sigmoid gate).  In
bfloat16 the tiny backbone and the RFP within 1.5% of the JAX bfloat16
build's largest value and closer than the port's float32 build.

The tiny DetectoRS Cascade R-CNN
(``configs/detectors/detectors_cascade_rcnn_r50_1x_coco.py``: SAC in
stages 2-4, RFP with 2 steps; both backbones ResNet-50 at width 8, as the
JAX package's own tests shrink them, neck and RPN 32, 4 classes) through
``tests/test_torch_cascade.py``'s harness at its tolerances: ``predict``,
every stage's samples, the losses, every gradient (the frozen stem and
stage 1 of both backbones get none in the port and zeros in the JAX
package) and two SGD steps from JAX's state.  The feedback backbone's
frozen stages are under ``neck/rfp_backbone``, where the JAX optimizer's
frozen mask does not reach: weight decay and momentum move them in both
packages alike, by ``lr * wd * p`` at the first step.

The 9 DetectoRS configs build at full width and pass the runner's
checks; ``use_deform`` is read as the JAX package reads it (not at all);
a key the JAX builder does not read raises; an mmdet DetectoRS state
dict raises, naming its SAC and RFP keys.
"""
import glob
import os
import sys

os.environ["JAX_COMPILATION_CACHE_DIR"] = ""  # no compile-cache writes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_boosting_detectors import (  # noqa: E402
    FROZEN,
    _random_variables,
    check_gradients,
    check_predict,
    check_step,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
)
from test_torch_cascade import (  # noqa: E402
    check_cascade_losses,
    check_samples,
    run_cascade_pair,
    tiny_cascade,
)
from test_torch_necks_fpt import _nchw, _nhwc, _Tupled, check_module, run_module  # noqa: E402
from test_torch_zoo_backbones import damp_residuals  # noqa: E402

from boosting_rcnn_tpu.models.backbones import detectors_resnet as j_det  # noqa: E402
from boosting_rcnn_tpu.models.necks import fpn as j_fpn  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.engine.runner import check_data, check_schedule  # noqa: E402
from boosting_rcnn_tpu_torch.models import layers as t_layers  # noqa: E402
from boosting_rcnn_tpu_torch.models.backbones import detectors_resnet as t_det  # noqa: E402
from boosting_rcnn_tpu_torch.models.necks import fpn as t_fpn  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params, from_mmdet_state_dict  # noqa: E402

DETECTORS = "detectors/detectors_cascade_rcnn_r50_1x_coco.py"
CONFIGS = sorted(glob.glob(config_path("detectors/*.py")))
BF16_TOL = 0.015
RFP_FROZEN = ("neck.rfp_backbone.conv1.", "neck.rfp_backbone.bn1.",
              "neck.rfp_backbone.layer1_")
# the tiny backbone's input and its stage outputs at width 8
IMG = (2, 48, 64, 3)
STAGES = ((12, 16, 32), (6, 8, 64), (3, 4, 128), (2, 2, 256))


def _gen():
    return torch.Generator().manual_seed(0)


def condition_sac(variables, seed: int = 11):
    """Random SAC variables at a trained model's scale: each ``SAConv``'s
    ``aws_gamma`` around ``1 / sqrt(fan_in)`` (10% spread), its
    ``aws_beta`` and ``weight_diff`` small beside that, so that the
    standardised weight is LeCun-sized (the harness's draws, 0.1 around 0,
    put a constant of 0.1 into every tap, and through the feedback
    backbone's 13 SAC blocks the pyramid reaches 4e5 and the RFP's gate
    saturates to a gradient of exactly 0)."""
    rs = np.random.RandomState(seed)

    def walk(tree):
        for value in tree.values():
            if not isinstance(value, dict):
                continue
            if "aws_gamma" in value:
                kh, kw, cin, c = value["kernel"].shape
                scale = 1.0 / np.sqrt(kh * kw * cin)
                value["aws_gamma"][...] = scale * (1.0 + 0.1 * rs.randn(1, 1, 1, c))
                value["aws_beta"][...] = 0.05 * scale * rs.randn(1, 1, 1, c)
                value["weight_diff"][...] = 0.3 * scale * rs.randn(kh, kw, cin, c)
            walk(value)

    walk(variables["params"])
    return variables


def _maps(rs, shapes, c, scale=0.5):
    return [(rs.randn(2, h, w, c) * scale).astype(np.float32) for h, w in shapes]


# ---------------------------------------------------------------- modules
@pytest.mark.parametrize("stride", [1, 2])
def test_saconv_matches_jax(stride):
    x = _maps(np.random.RandomState(1), [(9, 11)], 12)
    r = run_module(j_det.SAConv(16, stride=stride), t_det.SAConv(12, 16, stride, _gen()), x)
    assert r["t_out"][0].shape == ((2, 9, 11, 16) if stride == 1 else (2, 5, 6, 16))
    check_module(r)


@pytest.mark.parametrize("feedback", [False, True], ids=["plain", "feedback"])
def test_det_bottleneck_matches_jax(feedback):
    rs = np.random.RandomState(2)
    x = _maps(rs, [(10, 12)], 16)
    if feedback:
        x += _maps(rs, [(5, 6)], 24)
    r = run_module(j_det.DetBottleneck(8, stride=2, sac=True, rfp=True),
                   t_det.DetBottleneck(16, 8, 2, _gen(), sac=True,
                                       rfp_inplanes=24 if feedback else None), x)
    assert ("rfp_conv.weight" in r["t_gp"]) == feedback
    check_module(r)


def _image(seed=7):
    return [np.random.RandomState(seed).uniform(-1, 1, IMG).astype(np.float32)]


def test_detectors_resnet_matches_jax():
    r = run_module(j_det.DetectoRSResNet(depth=50, base_channels=8, frozen_stages=-1),
                   t_det.DetectoRSResNet(_gen(), depth=50, base_channels=8, frozen_stages=-1),
                   _image(), prepare=condition_sac)
    assert [o.shape[1:] for o in r["t_out"]] == list(STAGES)
    assert any(k.endswith("conv2.weight_diff") for k in r["t_gp"])
    check_module(r)


def _on_tuple(m, xs):
    return m(tuple(xs))


def _rfp_pair(dtype=jnp.float32):
    """The RFP on ``(img, C2..C5)`` of the tiny backbone's sizes, its
    feedback backbone with every stage trainable (the image's gradient
    flows), FPN 16, ASPP 8 a branch."""
    jm = j_fpn.RFP(in_channels=(32, 64, 128, 256), out_channels=16, aspp_out_channels=8,
                   rfp_backbone=j_det.DetectoRSResNet(depth=50, base_channels=8,
                                                      frozen_stages=-1, dtype=dtype),
                   dtype=dtype)
    tm = t_fpn.RFP(_gen(), (32, 64, 128, 256), t_det.DetectoRSResNet(
        _gen(), depth=50, base_channels=8, frozen_stages=-1, rfp_inplanes=32),
        out_channels=16, aspp_out_channels=8)
    rs = np.random.RandomState(3)
    inputs = _image() + [_maps(rs, [hw[:2]], hw[2])[0] for hw in STAGES]
    return _Tupled(jm), tm, inputs


def test_rfp_matches_jax():
    jm, tm, inputs = _rfp_pair()
    r = run_module(jm, tm, inputs, call=_on_tuple, prepare=condition_sac)
    assert len(r["t_out"]) == 5 and r["t_gp"]["rfp_weight.weight"].abs().max() > 0
    assert r["t_gp"]["rfp_backbone.layer2_0.rfp_conv.weight"].abs().max() > 0
    check_module(r)


def _bf16(jm, tm, inputs, call=lambda m, xs: m(*xs)):
    """``jm`` in bfloat16 (jitted without excess precision) and ``tm`` in
    float32 and bfloat16 on the same seeded variables: the port's bfloat16
    outputs within ``BF16_TOL`` of the largest JAX output, and closer to
    JAX's than the port's float32 outputs."""
    xs = [jnp.asarray(x) for x in inputs]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *xs))
    variables = condition_sac(_random_variables(shapes, np.random.RandomState(8)))
    ref = jax.jit(jm.apply, compiler_options={"xla_allow_excess_precision": False})(
        variables, *xs)
    ref = [np.asarray(r, np.float32) for r in ref]
    tm.load_state_dict(from_jax_params(variables), strict=True)
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        t_layers.set_compute_dtype(tm, dt)
        with torch.no_grad():
            outs[dt] = [_nhwc(o.float()) for o in call(tm, [_nchw(x).detach() for x in inputs])]
    scale = max(np.abs(r).max() for r in ref)
    err = {dt: max(np.abs(o - r).max() for o, r in zip(out, ref)) / scale
           for dt, out in outs.items()}
    for i, r in enumerate(ref):
        np.testing.assert_allclose(outs[torch.bfloat16][i], r, rtol=0, atol=BF16_TOL * scale,
                                   err_msg=f"output {i}")
    assert err[torch.bfloat16] < err[torch.float32], err
    return err


def test_detectors_resnet_bf16_matches_jax_bf16():
    # on this CPU the port's bfloat16 backbone gives the JAX build's bits
    # (the switch's pool and sigmoid rounded as JAX rounds them)
    _bf16(j_det.DetectoRSResNet(depth=50, base_channels=8, dtype=jnp.bfloat16),
          t_det.DetectoRSResNet(_gen(), depth=50, base_channels=8), _image())


def test_rfp_bf16_matches_jax_bf16():
    jm, tm, inputs = _rfp_pair(jnp.bfloat16)
    _bf16(jm, tm, inputs, call=_on_tuple)


# ------------------------------------------- the tiny DetectoRS Cascade R-CNN
def _tiny_detectors(load):
    mc = load(config_path(DETECTORS)).model.to_dict()
    for head in mc["roi_head"]["bbox_head"]:
        head["num_classes"] = 4
    mc = tiny_cascade(mc)
    mc["backbone"].update(depth=50, base_channels=8)
    mc["neck"]["in_channels"] = [32, 64, 128, 256]
    mc["neck"]["rfp_backbone"].update(base_channels=8)
    return mc


def condition_detectors(variables):
    """``condition_sac``, and each bottleneck's last norm damped in both
    backbones (``damp_residuals``): random blocks that add as much as their
    shortcut grow the two ResNet-50s' activations (the pyramid to 200), and
    the packages' float32 rounding with them, to proposals 0.03 px apart."""
    damp_residuals(condition_sac(variables)["params"])
    return variables


@pytest.fixture(scope="module")
def run():
    return run_cascade_pair(_tiny_detectors, edit_variables=condition_detectors)


def test_detectors_cascade_config(run):
    net = run["tdet"].net
    assert isinstance(net.backbone, t_det.DetectoRSResNet) and net.backbone.output_img
    assert isinstance(net.neck, t_fpn.RFP) and net.neck.rfp_steps == 2
    assert isinstance(net.backbone.layer2_0.conv2, t_det.SAConv)
    assert not isinstance(net.backbone.layer1_0.conv2, t_det.SAConv)
    assert net.backbone.layer2_0.rfp_conv is None
    assert tuple(net.neck.rfp_backbone.layer2_0.rfp_conv.weight.shape) == (64, 256, 1, 1)
    frozen = {k for k, p in net.named_parameters() if not p.requires_grad}
    assert frozen and all(k.startswith(FROZEN) for k in frozen)


def test_detectors_cascade_predict_matches_jax(run):
    check_predict(run)


def test_detectors_cascade_samples_match_jax(run):
    check_samples(run)


def test_detectors_cascade_losses_match_jax(run):
    check_cascade_losses(run)


def test_detectors_cascade_gradients_match_jax(run):
    check_gradients(run, frozen_names=FROZEN + RFP_FROZEN)
    assert run["t_grads"]["neck.rfp_weight.weight"].abs().max() > 0
    assert run["t_grads"]["backbone.layer3_0.conv2.weight_diff"].abs().max() > 0


@pytest.mark.parametrize("step", [0, 1])
def test_detectors_cascade_sgd_steps_match_jax(run, step):
    check_step(run, step, check_cascade_losses(run))


def test_feedback_backbone_frozen_stages_decay_as_jax(run):
    """The feedback backbone's frozen stem and stage 1 get no gradient, but
    the JAX step's weight decay moves them (its mask reads ``backbone``
    only): after the first step each is ``p0 - lr * wd * p0`` in both
    packages (lr 0.01, wd 1e-4), after the second momentum moves them on."""
    j_params, t_params = run["steps"][0][:2]
    names = [k for k in t_params if k.startswith(RFP_FROZEN)]
    assert names
    for name in names:
        p0 = run["p0"][name]
        ref = j_params[name].reshape(p0.shape)
        np.testing.assert_allclose(ref.numpy(), (p0 - 0.01 * 1e-4 * p0).numpy(), rtol=1e-6,
                                   atol=1e-12, err_msg=name)
        assert torch.equal(t_params[name], ref) or np.allclose(
            t_params[name].numpy(), ref.numpy(), rtol=1e-7, atol=0), name
    moved = [k for k in names if not torch.equal(run["steps"][1][1][k], run["p0"][k])]
    assert len(moved) == len([k for k in names if run["p0"][k].any()])


# -------------------------------------------------------------- configs
@pytest.fixture
def seeded_init_skipped():
    """Full-width builds without the seeded draws: the checks read the
    built detectors' structure, never their weights."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (t_layers, t_det):
            mp.setattr(module, "lecun_normal_", lambda weight, fan_in, gen: None)
        for name in ("kaiming_uniform_", "uniform_"):
            mp.setattr(torch.nn.init, name, lambda tensor, *a, **k: tensor)
        yield


@pytest.mark.usefixtures("seeded_init_skipped")
@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p)[:-3] for p in CONFIGS])
def test_detectors_configs_build_at_full_width(path):
    cfg = load_config(path)
    det = build_detector(cfg.model.to_dict(), device="cpu")
    check_schedule(cfg)
    check_data(cfg)
    mc = cfg.model.to_dict()
    sac = mc["backbone"].get("sac") is not None
    assert isinstance(det.net.backbone, t_det.DetectoRSResNet)
    assert isinstance(det.net.backbone.layer3_0.conv2, t_det.SAConv) == sac
    assert isinstance(det.net.neck, t_fpn.RFP) == (mc["neck"]["type"] == "RFP")


@pytest.mark.usefixtures("seeded_init_skipped")
def test_unread_keys_raise_and_use_deform_is_not_read():
    mc = load_config(config_path(DETECTORS)).model.to_dict()
    mc["backbone"]["sac"]["use_deform"] = False  # the JAX builder reads neither value
    build_detector(mc, device="cpu")
    for part, key, value in (("backbone", "dcn", dict(type="DCN")),
                             ("backbone", "style", "caffe"),
                             ("neck", "aspp_dilations", (1, 2, 4, 1)),
                             ("neck", "rfp_backbone", dict(type="ResNet"))):
        bad = load_config(config_path(DETECTORS)).model.to_dict()
        bad[part][key] = value
        with pytest.raises(NotImplementedError, match=key if key != "rfp_backbone" else "type"):
            build_detector(bad, device="cpu")


def test_mmdet_detectors_keys_raise_named():
    sd = {"backbone.conv1.weight": torch.zeros(64, 3, 7, 7),
          "backbone.layer2.0.conv2.weight": torch.zeros(128, 128, 3, 3),
          "backbone.layer2.0.conv2.weight_diff": torch.zeros(128, 128, 3, 3),
          "backbone.layer2.0.conv2.switch.weight": torch.zeros(1, 128, 1, 1),
          "backbone.layer2.0.conv2.offset_s.weight": torch.zeros(18, 128, 3, 3),
          "backbone.layer2.0.rfp_conv.weight": torch.zeros(512, 256, 1, 1),
          "neck.rfp_aspp.aspp.0.weight": torch.zeros(64, 256, 1, 1),
          "neck.rfp_weight.weight": torch.zeros(1, 256, 1, 1)}
    with pytest.raises(NotImplementedError, match="weight_diff.*DetectoRS"):
        from_mmdet_state_dict(sd)
    with pytest.raises(NotImplementedError, match="neck.rfp_weight"):
        from_mmdet_state_dict({k: v for k, v in sd.items() if k.startswith("neck.")})
