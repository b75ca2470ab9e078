"""The zoo's necks in the PyTorch port against the JAX package's, on the CPU.

Each module with the same seeded numpy parameters (flax variables through
``weights.from_jax_params``) on the same seeded inputs, values and
gradients (of a seeded cotangent, with respect to the parameters and the
inputs) within 1e-5 of the largest: SPPFPN's lateral of each ``SPP_type``
(``ASPP``, ``ASPP_share``, ``SPP``, ``RFB``) and the SPPFPN, the PAFPN
with its extra levels by max pool; FPT's ``SelfTrans``, ``GroundTrans``
with a non-zero ``gate``, the FPT with its rendering pass (on levels whose
sizes make it resize) and without, FPT_lite's ``_GroundTransLite`` and
the FPT_lite, with their live BNs in train mode (batch statistics, and the
running averages they move) and in eval mode.  The attention in query
chunks (``necks/fpt.py::chunked``, each chunk checkpointed) equals the
unchunked form within 1e-6, gradients too.  Then the tiny FPT Faster
R-CNN (``configs/fpt/faster_rcnn_r50_fpt_1x_coco.py`` at ResNet-18 width
8, FPN 32: FPT width 4) through ``tests/test_torch_norm_configs.py``'s
live-norm harness and at its tolerances, its variables conditioned as the
modules' (``condition_fpt``), and the necks' configs at full width.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_boosting_detectors import (  # noqa: E402
    _random_variables,
    check_gradients,
    check_losses,
    check_predict,
    check_step,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
)
from test_torch_norm_configs import (  # noqa: E402
    FASTER_LOSSES,
    _check_stats,
    _damped,
    run_live,
)

from boosting_rcnn_tpu.models.necks import fpn as j_fpn  # noqa: E402
from boosting_rcnn_tpu.models.necks import fpt as j_fpt  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.models import layers as t_layers  # noqa: E402
from boosting_rcnn_tpu_torch.models.necks import fpn as t_fpn  # noqa: E402
from boosting_rcnn_tpu_torch.models.necks import fpt as t_fpt  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402

FPT_CONFIG = "fpt/faster_rcnn_r50_fpt_1x_coco.py"
NECK_CONFIGS = (FPT_CONFIG, "fpt/faster_rcnn_r50_fptlite_1x_coco.py",
                "faster_rcnn/faster_rcnn_r50_sppfpn_1x_coco.py",
                "pafpn/faster_rcnn_r50_pafpn_1x_coco.py")


def _nchw(x):
    return torch.tensor(np.ascontiguousarray(np.moveaxis(x, -1, 1)), requires_grad=True)


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def run_module(jmod, tmod, inputs, seed: int = 0, train: bool = False, call=None,
               prepare=None):
    """``jmod`` (flax) and ``tmod`` (the port) on the same seeded variables
    and NHWC ``inputs`` (a list of maps): outputs, the gradients of a seeded
    cotangent's product with them (parameters and inputs) and, in
    ``train``, the moved running statistics; ``call`` (default: the module
    on the inputs as its positional arguments) adapts the call, ``prepare``
    the variables."""
    call = call or (lambda m, xs: m(*xs))
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              *[jnp.asarray(x) for x in inputs]))
    variables = _random_variables(shapes, rs)
    stats = variables.get("batch_stats", {})
    for leaf in jax.tree_util.tree_leaves(stats):  # running averages away from 0 and 1
        leaf += rs.uniform(0.1, 0.3, leaf.shape).astype(np.float32)
    if prepare is not None:
        prepare(variables)
    tmod.load_state_dict(from_jax_params(variables), strict=True)
    tmod.train(train)

    def j_fn(params, xs):
        v = {"params": params, **({"batch_stats": stats} if stats else {})}
        if train and stats:
            out, new = jmod.apply(v, *xs, mutable=["batch_stats"])
            return _as_tuple(out), new["batch_stats"]
        return _as_tuple(jmod.apply(v, *xs)), stats

    j_xs = [jnp.asarray(x) for x in inputs]
    j_out, j_stats = jax.jit(j_fn)(variables["params"], j_xs)
    cots = [rs.randn(*o.shape).astype(np.float32) for o in j_out]

    def j_obj(params, xs):
        outs, _ = j_fn(params, xs)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    j_gp, j_gx = jax.jit(jax.grad(j_obj, argnums=(0, 1)))(variables["params"], j_xs)
    t_xs = [_nchw(x) for x in inputs]
    t_out = _as_tuple(call(tmod, t_xs))
    sum((o * _nchw(c).detach()).sum() for o, c in zip(t_out, cots)).backward()
    return dict(j_out=[np.asarray(o) for o in j_out], t_out=[_nhwc(o) for o in t_out],
                j_gp=from_jax_params(jax.tree.map(np.asarray, j_gp)),
                t_gp={k: p.grad for k, p in tmod.named_parameters()},
                j_gx=[np.asarray(g) for g in j_gx], t_gx=[_nhwc(x.grad) for x in t_xs],
                j_stats=from_jax_params({"params": {}, "batch_stats": jax.tree.map(
                    np.asarray, j_stats)}) if stats else {},
                t_state=tmod.state_dict())


def _close(got, ref, rel=1e-5, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-12),
                               err_msg=what)


def check_module(r, rel=1e-5):
    """Outputs within ``rel`` of the largest output value (of all a neck's
    levels), every gradient within ``rel`` of the largest parameter gradient
    or of the largest input gradient, the running statistics within 1e-6 +
    rtol 1e-5."""
    o_max = max(np.abs(o).max() for o in r["j_out"])
    for i, (got, ref) in enumerate(zip(r["t_out"], r["j_out"])):
        assert got.shape == ref.shape, i
        np.testing.assert_allclose(got, ref, rtol=0, atol=rel * o_max, err_msg=f"output {i}")
    assert set(r["t_gp"]) == set(r["j_gp"])
    g_max = max(np.abs(g.numpy()).max() for g in r["j_gp"].values())
    for name, ref in r["j_gp"].items():
        got = r["t_gp"][name]
        assert got is not None, name
        np.testing.assert_allclose(got.numpy(), ref.reshape(got.shape).numpy(), rtol=0,
                                   atol=rel * g_max, err_msg=name)
    x_max = max(np.abs(g).max() for g in r["j_gx"])
    for i, (got, ref) in enumerate(zip(r["t_gx"], r["j_gx"])):
        assert got.shape == ref.shape, i
        np.testing.assert_allclose(got, ref, rtol=0, atol=rel * x_max,
                                   err_msg=f"input gradient {i}")
    for name, ref in r["j_stats"].items():
        np.testing.assert_allclose(r["t_state"][name].numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def _maps(rs, shapes, c):
    return [(rs.randn(2, h, w, c) * 0.5).astype(np.float32) for h, w in shapes]


# -------------------------------------------------------------- SPP, PAFPN
@pytest.mark.parametrize("spp_type", t_fpn.SPP_TYPES)
def test_spp_lateral_matches_jax(spp_type):
    x = _maps(np.random.RandomState(1), [(9, 11)], 12)
    gen = torch.Generator().manual_seed(0)
    r = run_module(j_fpn._SPPLateral(16, spp_type=spp_type),
                   t_fpn.SPPLateral(12, 16, gen, spp_type), x)
    check_module(r)


@pytest.mark.parametrize("spp_type", ["ASPP_share", "RFB"])
def test_sppfpn_matches_jax(spp_type):
    chans = (8, 16, 24, 32)
    rs = np.random.RandomState(2)
    xs = [(rs.randn(2, h, w, c) * 0.5).astype(np.float32)
          for (h, w), c in zip(((32, 40), (16, 20), (8, 10), (4, 5)), chans)]
    jmod = j_fpn.SPPFPN(in_channels=chans, out_channels=16, num_outs=5, spp_type=spp_type)
    tmod = t_fpn.FPN(torch.Generator().manual_seed(0), chans, 16, 5, spp_type=spp_type)
    r = run_module(_Tupled(jmod), tmod, xs, call=lambda m, t: m(tuple(t)))
    assert len(r["t_out"]) == 5 and r["t_out"][4].shape[1:3] == (2, 3)
    check_module(r)


def test_pafpn_without_extra_convs_matches_jax():
    chans = (8, 16, 24, 32)
    rs = np.random.RandomState(3)
    xs = [(rs.randn(2, h, w, c) * 0.5).astype(np.float32)
          for (h, w), c in zip(((32, 40), (16, 20), (8, 10), (4, 5)), chans)]
    jmod = j_fpn.PAFPN(in_channels=chans, out_channels=16, num_outs=5, add_extra_convs=False)
    tmod = t_fpn.PAFPN(torch.Generator().manual_seed(0), chans, 16, 5, add_extra_convs=False)
    r = run_module(_Tupled(jmod), tmod, xs, call=lambda m, t: m(tuple(t)))
    assert not hasattr(tmod, "fpn_conv_4")
    check_module(r)


class _Tupled:
    """A flax neck called on its levels as positional arguments (the
    harness's calling form): ``init`` / ``apply`` pass them as one tuple."""

    def __init__(self, module):
        self.module = module

    def init(self, rng, *xs):
        return self.module.init(rng, tuple(xs))

    def apply(self, variables, *xs, **kw):
        return self.module.apply(variables, tuple(xs), **kw)


# -------------------------------------------------------------------- FPT
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_self_trans_matches_jax(train):
    # inputs of std 2: a sharp attention, whose output varies over the map as
    # much as the live BN (train) needs to normalise it to float32 rounding
    x = [m * 4 for m in _maps(np.random.RandomState(4), [(9, 13)], 8)]
    r = run_module(j_fpt.SelfTrans(8), t_fpt.SelfTrans(8, torch.Generator().manual_seed(0)),
                   x, train=train)
    check_module(r)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_ground_trans_matches_jax(train):
    rs = np.random.RandomState(5)
    xs = _maps(rs, [(10, 12)], 8) + _maps(rs, [(5, 6)], 8)
    r = run_module(j_fpt.GroundTrans(8), t_fpt.GroundTrans(8, torch.Generator().manual_seed(0)),
                   xs, train=train)
    assert r["t_state"]["gate"].abs().item() > 0.01  # the attention counts
    check_module(r)


def condition_fpt(variables):
    """Random FPT variables conditioned for float32 comparisons: each
    ``SelfTrans``'s shared q/k projection 10 times sharper (a near-uniform
    attention gives a near-constant map, which ``bn_out``'s batch
    statistics normalise to its rounding) and each ``GroundTrans``'s output
    without its constant (``theta``, ``wz_conv`` and ``wz_bn`` biases and
    ``wz_bn``'s running mean zero: the 'dot' attention's output is
    otherwise a small variation on a constant, which the posthoc GroupNorm
    normalises to its rounding)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    for name, block in params.items():
        if "conv_qk" in block:
            block["conv_qk"]["kernel"] *= 10
        if name.startswith("gt_"):
            block["theta"]["bias"][:] = 0
            block["wz_conv"]["bias"][:] = 0
            block["wz_bn"].get("BatchNorm_0", block["wz_bn"])["bias"][:] = 0
            bn = stats[name]["wz_bn"]
            bn.get("BatchNorm_0", bn)["mean"][:] = 0


LEVELS = ((16, 16), (7, 7), (4, 4), (2, 2))  # 16 -> 8 by the stride-2 conv: resized to 7


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("rendering", [True, False])
def test_fpt_matches_jax(rendering, train):
    chans = (8, 16, 24, 32)
    rs = np.random.RandomState(6)
    xs = [(rs.randn(2, h, w, c) * 2).astype(np.float32) for (h, w), c in zip(LEVELS, chans)]
    jmod = j_fpt.FPT(out_channels=32, num_outs=5, fpt_rendering=rendering)
    tmod = t_fpt.FPT(torch.Generator().manual_seed(0), chans, 32, 5, rendering)
    r = run_module(_Tupled(jmod), tmod, xs, call=lambda m, t: m(tuple(t)), train=train,
                   prepare=condition_fpt)
    assert [o.shape[1:3] for o in r["t_out"]] == [*LEVELS, (1, 1)]
    # in train mode the neck's seven live BNs each normalise an attention
    # output by its batch statistics, and the packages' float32 roundings
    # meet 2-5e-5 of the largest value (the modules alone hold 1e-5 in train
    # mode, the neck 1e-5 in eval mode)
    check_module(r, 1e-4 if train else 1e-5)


def test_ground_trans_lite_matches_jax():
    rs = np.random.RandomState(7)
    xs = _maps(rs, [(8, 10)], 16) + _maps(rs, [(4, 5)], 16)
    r = run_module(j_fpt._GroundTransLite(16),
                   t_fpt.GroundTransLite(16, 16, torch.Generator().manual_seed(0)), xs)
    check_module(r)


def test_fpt_lite_matches_jax():
    chans = (8, 16, 24, 32)
    rs = np.random.RandomState(8)
    xs = [(rs.randn(2, h, w, c) * 0.5).astype(np.float32)
          for (h, w), c in zip(((16, 20), (8, 10), (4, 5), (2, 3)), chans)]
    jmod = j_fpt.FPTLite(out_channels=16, num_outs=5)
    tmod = t_fpt.FPTLite(torch.Generator().manual_seed(0), chans, 16, 5)
    r = run_module(_Tupled(jmod), tmod, xs, call=lambda m, t: m(tuple(t)))
    check_module(r)


@pytest.mark.parametrize("which", ["self_trans", "ground_trans", "lite"])
def test_chunked_attention_equals_the_unchunked_form(which, monkeypatch):
    """Each module with its attention in chunks of a few queries (a chunk
    limit of 3 keys' or key rows' worth of scores) against the same module
    unchunked: outputs and gradients within 1e-6 of the largest."""
    rs = np.random.RandomState(9)
    gen = torch.Generator().manual_seed(0)
    if which == "self_trans":
        mod, xs = t_fpt.SelfTrans(8, gen), [torch.randn(2, 8, 9, 13, generator=gen)]
    elif which == "ground_trans":
        mod = t_fpt.GroundTrans(8, gen)
        xs = [torch.randn(2, 8, 10, 12, generator=gen), torch.randn(2, 8, 5, 6, generator=gen)]
        with torch.no_grad():
            mod.gate.fill_(0.5)
    else:
        mod = t_fpt.GroundTransLite(16, 16, gen)
        xs = [torch.randn(2, 16, 8, 10, generator=gen), torch.randn(2, 16, 4, 5, generator=gen)]
    mod.eval()  # the attention alone: no batch statistics around it
    cot = None
    results = []
    for limit in (None, 2 * 4 * 30 * 3):
        if limit:
            monkeypatch.setattr(t_fpt, "ATTN_CHUNK_ELEMS", limit)
        mod.zero_grad()
        inputs = [x.clone().requires_grad_(True) for x in xs]
        out = mod(*inputs)
        if cot is None:
            cot = torch.as_tensor(rs.randn(*out.shape).astype(np.float32))
        (out * cot).sum().backward()
        results.append((out.detach(), [x.grad for x in inputs],
                        {k: p.grad.clone() for k, p in mod.named_parameters()}))
    (o0, gx0, gp0), (o1, gx1, gp1) = results
    _close(o1, o0.numpy(), 1e-6, "output")
    for a, b in zip(gx1, gx0):
        _close(a, b.numpy(), 1e-6, "input gradient")
    # of the largest parameter gradient: the key bias's is zero but rounding
    # (a softmax is shift-invariant)
    g_max = max(g.abs().max().item() for g in gp0.values())
    for k in gp0:
        np.testing.assert_allclose(gp1[k].numpy(), gp0[k].numpy(), rtol=0, atol=1e-6 * g_max,
                                   err_msg=k)


def test_chunked_splits_and_checkpoints(monkeypatch):
    """``chunked`` at a limit of 10 scores a query of 4 keys: chunks of 2
    queries; it recomputes each chunk in the backward."""
    monkeypatch.setattr(t_fpt, "ATTN_CHUNK_ELEMS", 10)
    calls = []

    def fn(q, k):
        calls.append(q.shape[1])
        return q @ k.transpose(-1, -2)

    q = torch.randn(1, 5, 3, requires_grad=True)
    k = torch.randn(1, 4, 3, requires_grad=True)
    out = t_fpt.chunked(fn, q, k, per_query=4)
    assert calls == [2, 2, 1]
    out.sum().backward()
    assert sorted(calls[3:]) == [1, 2, 2]  # each chunk again, in the backward's order
    ref = q @ k.transpose(-1, -2)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


# --------------------------------------------------------- the FPT detector
def _tiny_fpt(load):
    mc = load(config_path(FPT_CONFIG)).model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"].update(in_channels=[8, 16, 32, 64], out_channels=32)
    mc["rpn_head"].update(in_channels=32, feat_channels=32)
    roi = mc["roi_head"]
    roi["bbox_roi_extractor"]["out_channels"] = 32
    roi["bbox_head"].update(in_channels=32, fc_out_channels=16, num_classes=4)
    mc["train_cfg"]["rpn_proposal"].update(nms_pre=200, max_per_img=64)
    mc["train_cfg"]["rcnn"]["sampler"]["num"] = 32
    mc["test_cfg"]["rpn"].update(nms_pre=100, max_per_img=32)
    return mc


@pytest.fixture(scope="module")
def fpt_run():
    """The live-norm harness's run, its variables also conditioned by
    ``condition_fpt`` (the neck's variables are ``params["neck"]``)."""

    def conditioned(variables):
        variables = _damped(variables)
        condition_fpt({"params": variables["params"]["neck"],
                       "batch_stats": variables["batch_stats"]["neck"]})
        return variables

    # seeds 0 and 3 put an activation of the backbone's stage 2 or of the
    # neck at a float32 edge (gradients 15-36 times the harness's
    # tolerance), seed 4 the second step's gradient norm (1.6e-4 apart),
    # seeds 5 and 6 a detection (1.1e-3 px and more); at seed 1 none
    return run_live(_tiny_fpt, seed=1, damped=conditioned)


# A GroundTrans's ``wz_conv`` bias is followed by a live BN, which subtracts
# the batch mean: its gradient is 0 but for rounding, and its steps are
# weight decay on both sides
SHIFT_INVARIANT = ("wz_conv.bias",)


def without_shift_invariant(run, suffixes=SHIFT_INVARIANT):
    """The run's gradients and steps without the biases that a live BN
    follows (names ending with ``suffixes``): their gradients are held to
    be rounding of 0 (a sum over the batch of terms that cancel; within
    1e-4 of the largest gradient) and their steps to be that rounding times
    the learning rate on weight decay (within 1e-4 of the step's largest
    update)."""
    g_max = max(g.abs().max().item() for g in run["j_grads"].values())
    j_grads, t_grads = dict(run["j_grads"]), dict(run["t_grads"])
    for name in [k for k in j_grads if k.endswith(suffixes)]:
        for g in (j_grads.pop(name), t_grads.pop(name)):
            assert g is None or g.abs().max().item() <= 1e-4 * g_max, name  # None: frozen
    steps = []
    for j_params, t_params, *rest in run["steps"]:
        j_params = dict(j_params)
        largest = max((r.reshape(run["p0"][k].shape) - run["p0"][k]).abs().max().item()
                      for k, r in j_params.items())
        for name in [k for k in j_params if k.endswith(suffixes)]:
            np.testing.assert_allclose(t_params[name].numpy(), j_params.pop(name).numpy(),
                                       rtol=0, atol=1e-4 * largest, err_msg=name)
        steps.append((j_params, t_params, *rest[:2]))
    return dict(run, j_grads=j_grads, t_grads=t_grads, steps=steps)


def test_tiny_fpt_has_live_norms_and_gates(fpt_run):
    neck = fpt_run["tdet"].net.neck
    assert isinstance(neck, t_fpt.FPT) and isinstance(neck.gt_0.wz_bn, t_layers.LiveBatchNorm)
    assert all(getattr(neck, f"gt_{i}").gate.abs().item() > 0 for i in range(3))


def test_tiny_fpt_predict_matches_jax(fpt_run):
    check_predict(fpt_run)


def test_tiny_fpt_live_losses_match_jax(fpt_run):
    check_losses(fpt_run, FASTER_LOSSES)


def test_tiny_fpt_live_gradients_match_jax(fpt_run):
    check_gradients(without_shift_invariant(fpt_run))


def test_tiny_fpt_statistics_after_the_loss_match_jax(fpt_run):
    _check_stats(fpt_run["tdet"].net.state_dict(), fpt_run["j_stats"], min_moved=4,
                 before=fpt_run["s0"])


@pytest.mark.parametrize("step", [0, 1])
def test_tiny_fpt_sgd_steps_match_jax(fpt_run, step):
    check_step(without_shift_invariant(fpt_run), step, FASTER_LOSSES)
    _check_stats(fpt_run["steps"][step][5], fpt_run["steps"][step][4])


@pytest.mark.parametrize("name", NECK_CONFIGS)
def test_neck_configs_build(name, monkeypatch):
    """Each neck config builds at full width (the seeded initialisation
    skipped), its neck of its kind."""
    monkeypatch.setattr(t_layers, "lecun_normal_", lambda weight, fan_in, gen: None)
    for init in ("kaiming_uniform_", "uniform_"):  # torch's own inits, overwritten
        monkeypatch.setattr(torch.nn.init, init, lambda tensor, *a, **k: tensor)
    det = build_detector(load_config(config_path(name)).model.to_dict(), device="cpu")
    neck = det.net.neck
    want = {FPT_CONFIG: t_fpt.FPT, NECK_CONFIGS[1]: t_fpt.FPTLite, NECK_CONFIGS[2]: t_fpn.FPN,
            NECK_CONFIGS[3]: t_fpn.PAFPN}[name]
    assert type(neck) is want
    if name == NECK_CONFIGS[2]:
        assert neck.lateral_0.spp_type == "ASPP_share"
        assert tuple(neck.lateral_0.shared.weight.shape) == (256, 256, 3, 3)
    if name == NECK_CONFIGS[3]:
        assert neck.add_extra_convs is False
