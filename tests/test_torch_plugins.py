"""The PyTorch port's backbone plugins and weight-standardised conv against
the JAX package's (``boosting_rcnn_tpu/models/plugins.py``), on the CPU:
``standardize_weight`` / ``WSConv``, GCNet's ``ContextBlock`` (attention
and average pooling; add, mul and both fusions),
``GeneralizedAttention`` at ``attention_type`` ``'0010'`` and ``'1111'``
with kv stride 2 on a non-square map (and a query stride of 2), and a
bottleneck with plugins at each position.  The same numpy inputs and flax
variables (through ``weights.from_jax_params``) go to both; outputs and
the input gradient under a random cotangent within 1e-5 of the largest
value, float32.
"""
import os
import sys

os.environ["JAX_COMPILATION_CACHE_DIR"] = ""  # no compile-cache writes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_norms import _close, _load, _nchw, _nhwc, _variables  # noqa: E402

from boosting_rcnn_tpu.models import plugins as j_plugins  # noqa: E402
from boosting_rcnn_tpu.models.backbones import resnet as j_resnet  # noqa: E402
from boosting_rcnn_tpu_torch.models import plugins as t_plugins  # noqa: E402
from boosting_rcnn_tpu_torch.models.backbones.resnet import Bottleneck  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread: beside the suite's other pytest
    workers, torch's default of a thread a core oversubscribes the host
    (this file's cases ran several times slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(jm, tm, x, rs, grad=True):
    """``jm`` and ``tm`` (loaded from ``jm``'s random variables) on ``x``:
    outputs and, under a random cotangent, the input gradients."""
    variables = _variables(jm, x, rs)
    _load(tm, variables)
    y_shape = jax.eval_shape(lambda: jm.apply(variables, x)).shape
    ct = rs.randn(*y_shape).astype(np.float32)
    jy, jgx = jax.jit(lambda v, xx: (jm.apply(v, xx), jax.grad(
        lambda z: jnp.sum(jm.apply(v, z) * ct))(xx)))(variables, x)
    xt = _nchw(x).requires_grad_(True)
    ty = tm(xt)
    (ty * _nchw(ct)).sum().backward()
    _close(_nhwc(ty), jy, what="output")
    if grad:
        _close(_nhwc(xt.grad), jgx, what="input gradient")
    return variables


def test_standardize_weight_matches_jax():
    rs = np.random.RandomState(0)
    w = (rs.randn(3, 3, 8, 16) * 0.3 + 0.05).astype(np.float32)  # HWIO
    ref = np.asarray(j_plugins.standardize_weight(jnp.asarray(w)))
    got = t_plugins.standardize_weight(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    _close(got.numpy().transpose(2, 3, 1, 0), ref)
    # the biased std (jnp.std), each output filter over its fan-in
    flat = got.reshape(16, -1).double()
    np.testing.assert_allclose(flat.mean(1).numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(flat.std(1, unbiased=False).numpy(), 1.0, atol=1e-4)


@pytest.mark.parametrize("stride, groups", [(1, 1), (2, 2)])
def test_ws_conv_matches_jax(stride, groups):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 11, 13, 8).astype(np.float32)
    jm = j_plugins.WSConv(16, (3, 3), strides=(stride, stride), padding=[(1, 1), (1, 1)],
                          feature_group_count=groups, use_bias=True)
    tm = t_plugins.make_ws_conv(8, 16, 3, stride, 1, True, torch.Generator(), groups=groups)
    _pair(jm, tm, x, rs)


@pytest.mark.parametrize("pooling, fusions", [
    ("att", ("channel_add",)), ("avg", ("channel_mul",)),
    ("att", ("channel_add", "channel_mul"))])
def test_context_block_matches_jax(pooling, fusions):
    rs = np.random.RandomState(2)
    x = rs.randn(2, 7, 9, 32).astype(np.float32)
    jm = j_plugins.ContextBlock(ratio=1.0 / 4, pooling_type=pooling, fusion_types=fusions)
    tm = t_plugins.ContextBlock(32, torch.Generator(), ratio=1.0 / 4, pooling_type=pooling,
                                fusion_types=fusions)
    _pair(jm, tm, x, rs)


@pytest.mark.parametrize("attention_type, q_stride", [("0010", 1), ("1111", 1), ("1111", 2)])
def test_generalized_attention_matches_jax(attention_type, q_stride):
    """Eight heads of 4 dims on a 10 x 13 map, kv stride 2; ``gamma`` drawn
    non-zero (it starts at 0)."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 10, 13, 32).astype(np.float32)
    jm = j_plugins.GeneralizedAttention(num_heads=8, kv_stride=2, q_stride=q_stride,
                                        attention_type=attention_type)
    tm = t_plugins.GeneralizedAttention(32, torch.Generator(), num_heads=8, kv_stride=2,
                                        q_stride=q_stride, attention_type=attention_type)
    variables = _pair(jm, tm, x, rs)
    assert float(np.abs(variables["params"]["gamma"]).max()) > 0
    names = set(dict(tm.named_parameters()))
    assert ("appr_bias" in names) == (attention_type[2] == "1")
    assert ("appr_geom_fc_x.weight" in names) == (attention_type in ("1111",))


def test_position_embedding_matches_jax():
    ref = np.asarray(j_plugins._position_embedding(5, 3, 1, 2, 16, 8.0))
    _close(t_plugins.position_embedding(5, 3, 1, 2, 16, 8.0).numpy(), ref)


@pytest.mark.parametrize("position", ["after_conv1", "after_conv2", "after_conv3"])
def test_bottleneck_with_plugins_matches_jax(position):
    """A stride-2 bottleneck with a ContextBlock and a GeneralizedAttention
    at ``position`` (in that order, as a stage's plugin list runs them)."""
    rs = np.random.RandomState(4)
    x = rs.randn(2, 12, 10, 16).astype(np.float32)
    plugins = ((dict(type="ContextBlock", ratio=1.0 / 4), position),
               (dict(type="GeneralizedAttention", num_heads=2, attention_type="1111"),
                position))
    jm = j_resnet.Bottleneck(planes=8, stride=2, downsample=True, plugins=plugins)
    tm = Bottleneck(16, 8, 2, True, torch.Generator(), plugins=plugins)
    assert sorted(n for n, _ in tm.named_children() if "plugin" in n) == [
        f"{position}_plugin0", f"{position}_plugin1"]
    _pair(jm, tm, x, rs)


def test_build_plugin_names_what_it_does_not_take():
    gen = torch.Generator()
    assert isinstance(t_plugins.build_plugin(dict(type="ContextBlock", ratio=1 / 16,
                                                  in_channels=999), 64, gen),
                      t_plugins.ContextBlock)
    for cfg, message in ((dict(type="NonLocal2d"), "type='NonLocal2d'"),
                         (dict(type="ContextBlock", ratio=0.25, norm="LN"), r"\['norm'\]"),
                         (dict(type="GeneralizedAttention", spatial_range=5), "spatial_range"),
                         (dict(type="ContextBlock", fusion_types=("channel_cat",)),
                          "fusion_types")):
        with pytest.raises(NotImplementedError, match=message):
            t_plugins.build_plugin(cfg, 64, gen)
    with pytest.raises(NotImplementedError, match="position='after_conv4'"):
        t_plugins.stage_plugins([dict(cfg=dict(type="ContextBlock"), position="after_conv4")], 0)
    assert t_plugins.stage_plugins([dict(cfg=dict(type="ContextBlock"),
                                         stages=(False, True, True, True))], 0) == ()
