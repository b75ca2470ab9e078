"""Backbone block plugins and the weight-standardised conv (PyTorch port of
``boosting_rcnn_tpu/models/plugins.py``), on NCHW maps.

- ``standardize_weight`` / ``WSConv``: ConvWS (``conv_cfg=dict(type='ConvWS')``,
  the gn+ws configs): each output filter's weights standardised over its
  fan-in in float32, ``(w - mean) / (std + 1e-5)`` with the biased std
  (``jnp.std``; mmcv's ``conv_ws_2d`` divides by ``torch.std``'s unbiased
  one), then cast to the compute dtype.
- ``ContextBlock``: GCNet's global-context block (``configs/gcnet``):
  attention pooling (a 1x1 conv scores each pixel, a float32 softmax over
  the pixels) or the mean, then per fusion ``conv -> LayerNorm over the
  channels -> ReLU -> conv`` on the context vector, multiplied in through a
  sigmoid (``channel_mul``, first) and added (``channel_add``).
- ``GeneralizedAttention``: the empirical-attention block
  (``configs/empirical_attention``): queries on the (``q_stride``-strided)
  map, keys and values on the ``kv_stride``-strided one, the energy
  ``[0] q.k + [1] q.r + [2] u.k + [3] v.r`` of the ``attention_type`` bits
  in float32 (``r`` the separable x / y projections of sinusoidal relative
  positions), a softmax over the keys, the values summed, a 1x1
  projection and the residual ``x + gamma * out``.  The energy and the
  value sum are einsums, as in the JAX package (no Pallas kernel there).

``build_plugin`` makes one from a backbone ``plugins=`` entry's ``cfg``.
Parameter names follow the JAX modules' (``conv_mask``,
``channel_add_conv1``, ``channel_add_ln``, ``query_conv``,
``appr_geom_fc_x``, ``appr_bias``, ``gamma``, ...), so
``weights.from_jax_params`` maps them by its rules.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, LayerNorm, lecun_normal_, make_conv, make_linear

__all__ = ["standardize_weight", "WSConv", "make_ws_conv", "ContextBlock",
           "position_embedding", "GeneralizedAttention", "build_plugin"]


def standardize_weight(w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``(O, I, kh, kw)`` weights, each output filter to zero mean and unit
    (biased) std over its fan-in, in float32 (JAX ``plugins.py:207-215``)."""
    w = w.float()
    mean = w.mean((1, 2, 3), keepdim=True)
    std = w.std((1, 2, 3), keepdim=True, unbiased=False)
    return (w - mean) / (std + eps)


class WSConv(Conv2d):
    """A ``Conv2d`` whose float32 weight is standardised at each call
    (``standardize_weight``) before the cast to ``compute_dtype`` (JAX
    ``WSConv``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cast_conv(x, standardize_weight(self.weight))


def make_ws_conv(cin: int, cout: int, k: int, stride: int, pad: int, bias: bool,
                 gen: torch.Generator, groups: int = 1) -> WSConv:
    """``layers.make_conv``'s initialisation for a ``WSConv``."""
    conv = WSConv(cin, cout, k, stride, pad, bias=bias, groups=groups)
    lecun_normal_(conv.weight, cin // groups * k * k, gen)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


class ContextBlock(nn.Module):
    """GCNet's ContextBlock on ``channels`` (JAX ``plugins.py:32-77``):
    ``planes = max(int(channels * ratio), 1)``; ``pooling_type`` ``'att'``
    or ``'avg'``; ``fusion_types`` of ``'channel_add'`` and
    ``'channel_mul'``.  The context is pooled in float32; the transforms run
    in the compute dtype of their convs; the fusion in the input's dtype."""

    def __init__(self, channels: int, gen: torch.Generator, ratio: float = 1.0 / 4,
                 pooling_type: str = "att", fusion_types: Sequence[str] = ("channel_add",)):
        super().__init__()
        if pooling_type not in ("att", "avg"):
            raise NotImplementedError(f"ContextBlock pooling_type={pooling_type!r} is not ported")
        unknown = set(fusion_types) - {"channel_add", "channel_mul"}
        if unknown or not fusion_types:
            raise NotImplementedError(f"ContextBlock fusion_types={fusion_types!r} is not ported")
        planes = max(int(channels * ratio), 1)
        self.pooling_type = pooling_type
        self.fusions = [f for f in ("channel_mul", "channel_add") if f in fusion_types]
        if pooling_type == "att":
            self.conv_mask = make_conv(channels, 1, 1, 1, 0, True, gen)
        for f in self.fusions:
            self.add_module(f"{f}_conv1", make_conv(channels, planes, 1, 1, 0, True, gen))
            self.add_module(f"{f}_ln", LayerNorm(planes))
            self.add_module(f"{f}_conv2", make_conv(planes, channels, 1, 1, 0, True, gen))

    def _transform(self, fusion: str, context: torch.Tensor) -> torch.Tensor:
        y = getattr(self, f"{fusion}_conv1")(context)
        y = F.relu(getattr(self, f"{fusion}_ln")(y))
        return getattr(self, f"{fusion}_conv2")(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        if self.pooling_type == "att":
            mask = self.conv_mask(x).reshape(n, h * w).float().softmax(-1)
            context = torch.einsum("ncs,ns->nc", x.reshape(n, c, h * w).float(), mask)
        else:
            context = x.float().mean((2, 3))
        context = context[:, :, None, None]  # the transforms' convs cast it
        out = x
        if "channel_mul" in self.fusions:
            out = out * torch.sigmoid(self._transform("channel_mul", context))
        if "channel_add" in self.fusions:
            out = out + self._transform("channel_add", context)
        return out


def position_embedding(q_len: int, kv_len: int, q_stride: int, kv_stride: int, feat_dim: int,
                       position_magnitude: float, device=None,
                       wave_length: float = 1000.0) -> torch.Tensor:
    """``(q_len, kv_len, feat_dim)`` sinusoidal embedding of the scaled 1-D
    relative positions, sin then cos halves (JAX ``_position_embedding``),
    float32."""
    q_idx = torch.arange(q_len, dtype=torch.float32, device=device) * q_stride
    kv_idx = torch.arange(kv_len, dtype=torch.float32, device=device) * kv_stride
    diff = (q_idx[:, None] - kv_idx[None, :]) * position_magnitude
    half = feat_dim // 2
    exps = (2.0 / feat_dim) * torch.arange(half, dtype=torch.float32, device=device)
    angle = diff[..., None] / torch.pow(torch.tensor(wave_length, device=device), exps)
    return torch.cat([torch.sin(angle), torch.cos(angle)], -1)


class GeneralizedAttention(nn.Module):
    """The empirical-attention block on ``channels`` (JAX
    ``plugins.py:80-204``): ``num_heads`` heads of ``channels //
    num_heads`` dims; ``attention_type`` the four bits of (query-key,
    query-position, bias-key, bias-position); the position embedding
    ``position_embedding_dim`` wide (``channels`` when not positive);
    ``spatial_range`` >= 0 (a masking window) raises, as in the JAX
    package.  ``gamma`` starts at 0, so the block starts as the identity.
    The energy is float32 of shape ``(N, heads, hq, wq, hk * wk)``; with
    ``q_stride`` > 1 the output is resized bilinearly to the input's size.
    The residual ``x + gamma * out`` is float32 (``gamma`` is a float32
    tensor), as flax promotes it; the next conv casts it."""

    def __init__(self, channels: int, gen: torch.Generator, num_heads: int = 9,
                 spatial_range: int = -1, kv_stride: int = 2, q_stride: int = 1,
                 attention_type: str = "1111", position_embedding_dim: int = -1,
                 position_magnitude: float = 8.0):
        super().__init__()
        if spatial_range >= 0:
            raise NotImplementedError(
                "GeneralizedAttention spatial_range masking is not implemented (the JAX "
                "package raises too; the empirical_attention configs use spatial_range=-1)")
        if len(attention_type) != 4 or set(attention_type) - {"0", "1"}:
            raise ValueError(f"attention_type={attention_type!r} is not four bits")
        self.at = at = [ch == "1" for ch in attention_type]
        self.heads, self.qk_dim = num_heads, channels // num_heads
        self.kv_stride, self.q_stride = kv_stride, q_stride
        self.position_magnitude = position_magnitude
        self.pos_dim = position_embedding_dim if position_embedding_dim > 0 else channels
        inner = self.qk_dim * num_heads
        if at[0] or at[1]:
            self.query_conv = make_conv(channels, inner, 1, 1, 0, False, gen)
        if at[0] or at[2]:
            self.key_conv = make_conv(channels, inner, 1, 1, 0, False, gen)
        self.value_conv = make_conv(channels, inner, 1, 1, 0, False, gen)
        stdv = 1.0 / math.sqrt(self.qk_dim * 2)
        for bit, name in ((2, "appr_bias"), (3, "geom_bias")):
            if at[bit]:
                p = torch.empty(num_heads, self.qk_dim)
                with torch.no_grad():
                    p.uniform_(-stdv, stdv, generator=gen)
                setattr(self, name, nn.Parameter(p))
        if at[1] or at[3]:
            for axis in ("x", "y"):
                setattr(self, f"appr_geom_fc_{axis}",
                        make_linear(self.pos_dim // 2, inner, gen, bias=False))
        self.proj_conv = make_conv(inner, channels, 1, 1, 0, True, gen)
        self.gamma = nn.Parameter(torch.zeros(1))

    def _heads(self, y: torch.Tensor) -> torch.Tensor:
        """``(N, heads * d, h, w)`` -> float32 ``(N, h, w, heads, d)``."""
        n, _, h, w = y.shape
        return y.reshape(n, self.heads, self.qk_dim, h, w).permute(0, 3, 4, 1, 2).float()

    def _geometry(self, axis: str, q_len: int, kv_len: int, device) -> torch.Tensor:
        """The projected ``(q_len, kv_len, heads, d)`` position term of one
        axis, float32, divided by sqrt(2)."""
        emb = position_embedding(q_len, kv_len, self.q_stride, self.kv_stride,
                                 self.pos_dim // 2, self.position_magnitude, device)
        fc = getattr(self, f"appr_geom_fc_{axis}")
        r = fc(emb.to(fc.compute_dtype)).reshape(q_len, kv_len, self.heads, self.qk_dim)
        return r.float() / math.sqrt(2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        at = self.at
        n, c, h, w = x.shape
        x_q = x[:, :, ::self.q_stride, ::self.q_stride] if self.q_stride > 1 else x
        x_kv = x[:, :, ::self.kv_stride, ::self.kv_stride] if self.kv_stride > 1 else x
        hq, wq = x_q.shape[-2:]
        hk, wk = x_kv.shape[-2:]
        if at[0] or at[1]:
            q = self._heads(self.query_conv(x_q))
        if at[0] or at[2]:
            k = self._heads(self.key_conv(x_kv))
        v = self._heads(self.value_conv(x_kv))
        if at[1] or at[3]:
            rx = self._geometry("x", wq, wk, x.device)
            ry = self._geometry("y", hq, hk, x.device)
        energy = torch.zeros((n, self.heads, 1, 1, 1, 1), dtype=torch.float32, device=x.device)
        if at[0]:
            energy = energy + torch.einsum("nywhd,nYWhd->nhywYW", q, k)
        if at[2]:
            energy = energy + torch.einsum("hd,nYWhd->nhYW", self.appr_bias, k)[:, :, None, None]
        if at[1]:
            ex = torch.einsum("nywhd,wWhd->nhywW", q, rx)[..., None, :]
            ey = torch.einsum("nywhd,yYhd->nhywY", q, ry)[..., :, None]
            energy = energy + ex + ey
        if at[3]:
            ex = torch.einsum("hd,wWhd->hwW", self.geom_bias, rx)
            ey = torch.einsum("hd,yYhd->hyY", self.geom_bias, ry)
            energy = energy + (ex[None, :, None, :, None, :] + ey[None, :, :, None, :, None])
        energy = energy.expand(n, self.heads, hq, wq, hk, wk).reshape(
            n, self.heads, hq, wq, hk * wk)
        attn = energy.softmax(-1)
        out = torch.einsum("nhywS,nShd->nhdyw", attn,
                           v.reshape(n, hk * wk, self.heads, self.qk_dim))
        out = self.proj_conv(out.reshape(n, self.heads * self.qk_dim, hq, wq)
                             .to(self.proj_conv.compute_dtype))
        if self.q_stride > 1:
            out = F.interpolate(out, size=(h, w), mode="bilinear", align_corners=False)
        return x + self.gamma * out


def build_plugin(cfg: dict, channels: int, gen: torch.Generator) -> nn.Module:
    """A backbone plugin from its ``cfg`` (JAX ``build_plugin``):
    ``ContextBlock`` or ``GeneralizedAttention`` on ``channels``; their
    ``in_channels`` is not read (the block's width is); other types and
    keys raise."""
    kind = cfg.get("type")
    kw = {k: v for k, v in cfg.items() if k not in ("type", "in_channels")}
    allowed = {"ContextBlock": ("ratio", "pooling_type", "fusion_types"),
               "GeneralizedAttention": ("num_heads", "spatial_range", "kv_stride", "q_stride",
                                        "attention_type", "position_embedding_dim",
                                        "position_magnitude")}
    if kind not in allowed:
        raise NotImplementedError(f"plugin type={kind!r} is not ported to PyTorch yet")
    extra = sorted(set(kw) - set(allowed[kind]))
    if extra:
        raise NotImplementedError(f"plugin {kind}: {extra} not ported to PyTorch yet")
    if kind == "ContextBlock":
        if "fusion_types" in kw:
            kw["fusion_types"] = tuple(kw["fusion_types"])
        return ContextBlock(channels, gen, **kw)
    return GeneralizedAttention(channels, gen, **kw)


def stage_plugins(plugins: Optional[Sequence[dict]], stage: int):
    """The ``(cfg, position)`` pairs active in ``stage`` (0-based) of a
    backbone's ``plugins=`` list (JAX ``ResNet._stage_plugins``): an entry
    with ``stages`` None is in every stage; ``position`` defaults to
    ``after_conv3``."""
    out = []
    for p in plugins or ():
        extra = sorted(set(p) - {"cfg", "stages", "position"})
        if extra:
            raise NotImplementedError(f"backbone plugins entry: {extra} not ported to PyTorch yet")
        position = p.get("position", "after_conv3")
        if position not in ("after_conv1", "after_conv2", "after_conv3"):
            raise NotImplementedError(f"plugin position={position!r} is not ported")
        stages = p.get("stages")
        if stages is None or stages[stage]:
            out.append((p["cfg"], position))
    return tuple(out)
