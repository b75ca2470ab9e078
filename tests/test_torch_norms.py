"""The PyTorch port's trainable norms and normed layers against the JAX
package's, on the CPU: ``LiveBatchNorm`` (flax ``nn.BatchNorm``) in train
and eval mode, GroupNorm, LayerNorm, ``ConvModule`` with each
``norm_cfg`` / ``conv_cfg``, the FPN with GN and ConvWS, the
Shared4Conv1FC box head and the GN FCN mask head, and the backbone with
live BN.

The same inputs, made with numpy from a seed, go through both; the flax
variables go to the port through ``weights.from_jax_params``.  Float32:
outputs, the updated ``mean`` / ``var`` and gradients within 1e-5 of the
largest value; bfloat16 (the JAX side jitted with XLA's excess precision
off, as ``tests/test_torch_bf16.py`` runs it): ``LiveBatchNorm``'s and
GroupNorm's outputs within 1 ulp of flax's.
"""
import functools
import os
import sys

os.environ["JAX_COMPILATION_CACHE_DIR"] = ""  # no compile-cache writes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from boosting_rcnn_tpu.models import layers as j_layers  # noqa: E402
from boosting_rcnn_tpu.models.backbones import resnet as j_resnet  # noqa: E402
from boosting_rcnn_tpu.models.necks.fpn import FPN as JFPN  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads.bbox_head import ConvFCBBoxHead as JBBoxHead  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads.mask_head import FCNMaskHead as JMaskHead  # noqa: E402
from boosting_rcnn_tpu_torch.models import layers as t_layers  # noqa: E402
from boosting_rcnn_tpu_torch.models.backbones.resnet import ResNet  # noqa: E402
from boosting_rcnn_tpu_torch.models.necks.fpn import FPN  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads.bbox_head import ConvFCBBoxHead  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads.mask_head import FCNMaskHead  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402

BF16 = torch.bfloat16
# the JAX reference rounds at every bfloat16 op, as on the TPU
_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})
GN = {"type": "GN", "num_groups": 4}
WS = {"type": "ConvWS"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread: beside the suite's other pytest
    workers, torch's default of a thread a core oversubscribes the host
    (this file's cases ran several times slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _close(got, ref, rel=1e-5, what=""):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30), err_msg=what)


def _variables(module, x, rs, **kw):
    """flax variables of ``module`` on ``x``, drawn around their init:
    kernels LeCun-scaled, norm scales near 1, biases and means near 0,
    variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x, **kw))

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        if name.endswith("['var']"):
            return rs.uniform(0.5, 1.5, s.shape)
        if name.endswith("['scale']"):
            return 1.0 + 0.2 * rs.randn(*s.shape)
        return 0.2 * rs.randn(*s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


def _load(module, variables, strict=True):
    module.load_state_dict(from_jax_params(variables), strict=strict)
    return module


def _bn_input(rs, shape=(2, 6, 7, 16)):
    """NHWC activations with per-channel offsets and scales, as a conv's
    output has."""
    c = shape[-1]
    return (rs.randn(*shape) * rs.uniform(0.5, 2.0, c) + rs.uniform(-1.0, 1.0, c)).astype(
        np.float32)


# ------------------------------------------------------------- LiveBatchNorm
@pytest.mark.parametrize("train", [True, False])
def test_live_batch_norm_matches_flax_f32(train):
    """Output, the moved statistics (train) and the gradients of the input,
    scale and bias under a random cotangent, within 1e-5."""
    rs = np.random.RandomState(0)
    x = _bn_input(rs)
    jm = j_layers.LiveBatchNorm()
    variables = _variables(jm, x, rs)
    ct = rs.randn(*x.shape).astype(np.float32)

    def f(params, xx):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        if train:
            y, upd = jm.apply(v, xx, mutable=["batch_stats"])
        else:
            y, upd = jm.apply(v, xx), {"batch_stats": variables["batch_stats"]}
        return jnp.sum(y * ct), (y, upd)

    (_, (jy, upd)), (jgp, jgx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        variables["params"], x)
    tm = _load(t_layers.LiveBatchNorm(16), variables).train(train)
    xt = _nchw(x).requires_grad_(True)
    ty = tm(xt)
    (ty * _nchw(ct)).sum().backward()
    _close(_nhwc(ty), jy, what="output")
    _close(_nhwc(xt.grad), jgx, what="input gradient")
    want = from_jax_params({"params": jax.tree.map(np.asarray, jgp)})
    _close(tm.weight.grad.numpy(), want["weight"], what="scale gradient")
    _close(tm.bias.grad.numpy(), want["bias"], what="bias gradient")
    stats = from_jax_params({"params": {}, "batch_stats": jax.tree.map(np.asarray,
                                                                      upd["batch_stats"])})
    for key in ("running_mean", "running_var"):
        _close(getattr(tm, key).numpy(), stats[key], what=key)
        moved = not np.array_equal(stats[key], from_jax_params(variables)[key])
        assert moved == train, key


def test_live_batch_norm_running_var_is_biased():
    """The running variance moves towards the biased batch variance (flax),
    not the unbiased one that ``torch.nn.BatchNorm2d`` keeps."""
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(0))
    bn = t_layers.LiveBatchNorm(3).train()
    bn(x)
    biased = x.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * biased, rtol=0, atol=1e-6)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean((0, 2, 3)), rtol=0, atol=1e-7)


@pytest.mark.parametrize("train", [True, False])
def test_live_batch_norm_bf16_within_one_ulp(train):
    rs = np.random.RandomState(1)
    x = _bn_input(rs, (2, 9, 11, 32))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jm = j_layers.LiveBatchNorm(dtype=jnp.bfloat16)
    variables = _variables(jm, xb, rs)
    if train:
        jy, _ = _jit(lambda v, xx: jm.apply(v, xx, mutable=["batch_stats"]))(variables, xb)
    else:
        jy = _jit(lambda v, xx: jm.apply(v, xx))(variables, xb)
    assert jy.dtype == jnp.bfloat16
    tm = _load(t_layers.LiveBatchNorm(32), variables).train(train)
    ty = tm(_nchw(np.asarray(xb.astype(jnp.float32))).to(BF16))
    assert ty.dtype == BF16
    _within_one_ulp(_nhwc(ty), np.asarray(jy.astype(jnp.float32)))


def _within_one_ulp(got, ref):
    """Each bfloat16 value within one unit in the last place of flax's."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), np.finfo(np.float32).tiny))) - 7)
    diff = np.abs(got - ref)
    assert (diff <= ulp).all(), float((diff / ulp).max())
    assert (diff == 0).mean() > 0.9


# ------------------------------------------------------ GroupNorm, LayerNorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_flax(dtype):
    rs = np.random.RandomState(2)
    x = _bn_input(rs, (2, 9, 11, 32))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x).astype(jdt)
    jm = fnn.GroupNorm(num_groups=4, epsilon=1e-5, dtype=jdt)
    variables = _variables(jm, xj, rs)
    jy = _jit(jm.apply)(variables, xj)
    tm = _load(t_layers.GroupNorm(4, 32, eps=1e-5), variables)
    ty = tm(_nchw(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype)))
    if dtype == "float32":
        _close(_nhwc(ty), jy)
    else:
        _within_one_ulp(_nhwc(ty), np.asarray(jy.astype(jnp.float32)))


def test_layer_norm_matches_flax():
    rs = np.random.RandomState(3)
    x = _bn_input(rs, (3, 1, 1, 24))
    jm = fnn.LayerNorm()
    variables = _variables(jm, x, rs)
    ct = rs.randn(*x.shape).astype(np.float32)
    (jy, jgx) = jax.jit(lambda v, xx: (jm.apply(v, xx), jax.grad(
        lambda z: jnp.sum(jm.apply(v, z) * ct))(xx)))(variables, x)
    tm = _load(t_layers.LayerNorm(24), variables)
    xt = _nchw(x).requires_grad_(True)
    ty = tm(xt)
    (ty * _nchw(ct)).sum().backward()
    _close(_nhwc(ty), jy)
    _close(_nhwc(xt.grad), jgx)


# ---------------------------------------------------------------- ConvModule
@pytest.mark.parametrize("norm_cfg, conv_cfg", [
    (GN, None), (GN, WS), ({"type": "SyncBN"}, None), (None, WS), ({"type": "LN"}, None)])
def test_conv_module_matches_jax(norm_cfg, conv_cfg):
    """conv (plain or ConvWS) + norm (GN, LN, or BN frozen) + ReLU, and the
    input gradient."""
    rs = np.random.RandomState(4)
    x = rs.randn(2, 10, 12, 8).astype(np.float32)
    jm = j_layers.ConvModule(16, 3, norm_cfg=norm_cfg, conv_cfg=conv_cfg)
    variables = _variables(jm, x, rs)
    ct = rs.randn(2, 10, 12, 16).astype(np.float32)
    jy, jgx = jax.jit(lambda v, xx: (jm.apply(v, xx), jax.grad(
        lambda z: jnp.sum(jm.apply(v, z) * ct))(xx)))(variables, x)
    tm = _load(t_layers.ConvModule(8, 16, 3, torch.Generator(), norm_cfg=norm_cfg,
                                   conv_cfg=conv_cfg, act="relu"), variables)
    kinds = {type(m).__name__ for m in tm.modules()}
    assert ("WSConv" in kinds) == (conv_cfg is not None)
    assert (tm.conv.bias is None) == (norm_cfg is not None)
    xt = _nchw(x).requires_grad_(True)
    ty = tm(xt)
    (ty * _nchw(ct)).sum().backward()
    _close(_nhwc(ty), jy)
    _close(_nhwc(xt.grad), jgx)


# -------------------------------------------------------- neck and RoI heads
@pytest.mark.parametrize("norm_cfg, conv_cfg, no_norm_on_lateral", [
    (GN, WS, False), (GN, None, True), ({"type": "BN"}, None, False)])
def test_fpn_with_norms_matches_jax(norm_cfg, conv_cfg, no_norm_on_lateral):
    rs = np.random.RandomState(5)
    chans = (8, 16, 32, 64)
    xs = [rs.randn(2, 32 // 2 ** i, 40 // 2 ** i, c).astype(np.float32)
          for i, c in enumerate(chans)]
    jm = JFPN(in_channels=chans, out_channels=16, num_outs=5, norm_cfg=norm_cfg,
              conv_cfg=conv_cfg, no_norm_on_lateral=no_norm_on_lateral)
    variables = _variables(jm, tuple(xs), rs)
    jys = jax.jit(jm.apply)(variables, tuple(xs))
    tm = _load(FPN(torch.Generator(), chans, 16, 5, norm_cfg=norm_cfg, conv_cfg=conv_cfg,
                   no_norm_on_lateral=no_norm_on_lateral), variables)
    tys = tm([_nchw(x) for x in xs])
    assert (tm.lateral_0.norm is None) == no_norm_on_lateral
    for got, ref in zip(tys, jys):
        _close(_nhwc(got), ref)


@pytest.mark.parametrize("conv_cfg", [None, WS])
def test_shared4conv1fc_head_matches_jax(conv_cfg):
    """Four 3x3 ConvModules with GN and ReLU, then one FC over the map
    flattened in (H, W, C) order, then cls and reg."""
    rs = np.random.RandomState(6)
    x = rs.randn(5, 7, 7, 16).astype(np.float32)
    jm = JBBoxHead(num_classes=3, num_shared_convs=4, num_shared_fcs=1, conv_out_channels=8,
                   fc_out_channels=12, conv_cfg=conv_cfg, norm_cfg=GN)
    variables = _variables(jm, x, rs)
    jcls, jreg = jax.jit(jm.apply)(variables, x)
    tm = _load(ConvFCBBoxHead(torch.Generator(), 3, in_channels=16, num_shared_fcs=1,
                              fc_out_channels=12, num_shared_convs=4, conv_out_channels=8,
                              conv_cfg=conv_cfg, norm_cfg=GN), variables)
    tcls, treg = tm(torch.from_numpy(x))
    _close(tcls.detach().numpy(), jcls)
    _close(treg.detach().numpy(), jreg)


def test_gn_fcn_mask_head_matches_jax():
    rs = np.random.RandomState(7)
    x = rs.randn(3, 14, 14, 16).astype(np.float32)
    jm = JMaskHead(num_classes=3, num_convs=2, conv_channels=8, norm_cfg=GN)
    variables = _variables(jm, x, rs)
    jy = jax.jit(jm.apply)(variables, x)
    tm = _load(FCNMaskHead(torch.Generator(), 3, in_channels=16, num_convs=2, conv_channels=8,
                           norm_cfg=GN), variables)
    assert isinstance(tm.conv_0, t_layers.ConvModule) and tm.conv_0.conv.bias is None
    _close(tm(torch.from_numpy(x)).detach().numpy(), jy)


# ------------------------------------------------------------------ backbone
def test_live_bn_backbone_matches_jax():
    """ResNet-50 at base width 4 with live BN in train mode (the GN and
    ConvWS backbones run through ``tests/test_torch_norm_configs.py``'s
    detectors): the stage outputs, every moved statistic and the gradients
    of the unfrozen stages.  Each bottleneck's last norm is scaled by 0.1
    (``tests/test_torch_norm_configs.py::_damped``: a norm on the data's
    statistics divides the float32 rounding of its input by that input's
    spread, and where every residual branch adds as much as the shortcut
    this compounds over the 16 blocks past 1e-5 between the packages)."""
    rs = np.random.RandomState(8)
    x = rs.randn(2, 64, 48, 3).astype(np.float32)
    jm = j_resnet.ResNet(depth=50, base_channels=4, frozen_stages=1, norm_eval=False)
    variables = _variables(jm, x, rs)
    for name, block in variables["params"].items():
        if name.startswith("layer"):
            bn3 = block["bn3"]["BatchNorm_0"]
            bn3["scale"] = bn3["scale"] * np.float32(0.1)

    def f(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        outs, upd = jm.apply(v, x, mutable=["batch_stats"])
        return sum(jnp.sum(o * o) for o in outs) * 1e-3, (outs, upd)

    (_, (jouts, upd)), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(variables["params"])
    tm = _load(ResNet(torch.Generator(), depth=50, base_channels=4, frozen_stages=1,
                      norm_eval=False), variables).train()
    touts = tm(_nchw(x))
    (sum((o * o).sum() for o in touts) * 1e-3).backward()
    for got, ref in zip(touts, jouts):
        _close(_nhwc(got), ref)
    want = from_jax_params({"params": jax.tree.map(np.asarray, jg)})
    g_max = max(np.abs(g.numpy()).max() for g in want.values())
    for name, p in tm.named_parameters():
        if p.grad is None:
            assert not want[name].any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-3 * np.abs(want[name].numpy()).max() + 1e-6 * g_max,
                                   err_msg=name)
    stats = from_jax_params({"params": {}, "batch_stats": jax.tree.map(
        np.asarray, upd["batch_stats"])})
    state = tm.state_dict()
    assert len(stats) == 2 * 53 and sum(type(m).__name__ == "LiveBatchNorm"
                                         for m in tm.modules()) == 53
    for k, v in stats.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
