"""Feature Pyramid Transformer necks (PyTorch port of
``boosting_rcnn_tpu/models/necks/fpt.py``, the fork's ``FPT`` and
``FPT_lite``), with the JAX package's repairs of the fork's code (a 1x1
adapter where the rendering add mixes widths, fine-to-coarse outputs) and
its copies of the fork's quirks (``GroundTrans`` replaces the lateral, no
residual; ``_GroundTransLite`` doubles its residuals).

``FPT``, at ``fpt_dim = out_channels // 8``: C5 through a 1x1 conv, GN and
``SelfTrans``; each lower level through a 3x3 conv, GN and ReLU, its
``SelfTrans``, then ``GroundTrans`` from the level above into it; a 3x3
conv, GN and ReLU to ``out_channels`` a level, then the rendering pass
(coarse to fine: a stride-2 conv of the finer output, resized by nearest
neighbour with half-pixel centres where the sizes differ, plus a 1x1
adapter of the target, then a 3x3 conv), extra levels by ``max_pool(1,
2)``.  ``SelfTrans`` is a mixture of 4 softmaxes over keys and values from
a stride-2 average pool: ``sum_m pi_m softmax(q_m k_m^T / sqrt(d)) v``,
``q`` and ``k`` one shared 1x1 projection split into the 4 components,
``v`` shared by them, ``d`` the full width; ``GroundTrans`` is a non-local
'dot' attention ``(theta phi^T / K) g`` whose output passes a 1x1 conv, a
``LiveBatchNorm`` and a zero-initialised scalar ``gate``.  Both compute
their products and softmax in float32 in either dtype.

``FPTLite``: 1x1 laterals, then top-down each lateral replaced by
``GroundTransLite`` of it and the one above (a pre-norm 4-head cross
attention, flax ``MultiHeadDotProductAttention``, and a two-layer MLP,
each output doubled), 3x3 output convs, extra levels by ``max_pool(1,
2)``.  Its attention computes in the compute dtype, as flax's.

The attention is the JAX package's arithmetic in chunks of queries
(``chunked``): at 800 x 1344, C2's 67,200 queries into 16,800 keys would
be a 36 GB float32 score tensor at batch 2 (``SelfTrans``, ``FPT_lite``)
or 9 GB (``GroundTrans``).  Each chunk's scores live only inside it; the
backward recomputes them a chunk at a time (``torch.utils.checkpoint``).
A chunk holds at most ``ATTN_CHUNK_ELEMS`` scores, so at the CPU tests'
sizes one chunk is the whole, unchunked form.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..layers import GroupNorm, LiveBatchNorm, _fast_stats, avg_pool, make_conv, \
    make_linear, max_pool, nearest_resize

__all__ = ["ATTN_CHUNK_ELEMS", "chunked", "SelfTrans", "GroundTrans", "FPT", "TokenLayerNorm",
           "MultiHeadAttention", "GroundTransLite", "FPTLite"]

# the float32 scores one chunk of queries may hold (1 GiB)
ATTN_CHUNK_ELEMS = 2 ** 28


def chunked(fn, q: torch.Tensor, *rest, per_query: int):
    """``fn(q_chunk, *rest)`` over chunks of ``q``'s token axis 1,
    concatenated; ``per_query`` is the number of scores a query makes, and
    a chunk holds at most ``ATTN_CHUNK_ELEMS``.  Where autograd records,
    each chunk is checkpointed: its scores are recomputed in the backward
    instead of kept."""
    n = q.shape[1]
    size = max(1, min(n, ATTN_CHUNK_ELEMS // max(per_query, 1)))
    if size >= n:
        return fn(q, *rest)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, *rest) if torch.is_tensor(t))
    outs = []
    for i in range(0, n, size):
        part = q[:, i:i + size]
        outs.append(checkpoint(fn, part, *rest, use_reentrant=False) if grad
                    else fn(part, *rest))
    return torch.cat(outs, 1)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """``(B, C, H, W)`` -> ``(B, H*W, C)``, row-major tokens as NHWC flattens."""
    return x.flatten(2).transpose(1, 2)


def _map(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``(B, H*W, C)`` -> ``(B, C, H, W)``."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


def _mixture(q, k, v, pi, d: int):
    """``sum_m pi_m softmax(q_m k_m^T / sqrt(d)) v`` in float32: ``q`` ``(B,
    n, d)``, ``k`` ``(B, K, d)``, ``v`` ``(B, K, d)``, ``pi`` ``(B, m)``."""
    b, n, _ = q.shape
    m = pi.shape[1]
    qm = q.reshape(b, n, m, d // m).transpose(1, 2)
    km = k.reshape(b, k.shape[1], m, d // m).transpose(1, 2)
    attn = torch.softmax(qm @ km.transpose(-1, -2) / d ** 0.5, dim=-1)
    attn = (attn * pi[:, :, None, None]).sum(1)
    return attn @ v


def _dot(theta, phi, g):
    """``(theta phi^T / K) g`` in float32 (the 'dot' non-local)."""
    f = theta @ phi.transpose(-1, -2)
    return (f / f.shape[-1]) @ g


class SelfTrans(nn.Module):
    """JAX ``SelfTrans``: ``conv_qk`` and ``conv_v`` (1x1 with biases) over
    the map and its 3x3 / stride-2 average pool (padding counted), the
    mixture weights ``pi`` from ``mix_weight`` ``(m, d)`` and the mean
    query, the mixture attention, ``conv_out`` (1x1, no bias), ``bn_out``,
    plus the input."""

    def __init__(self, dim: int, gen: torch.Generator, n_mix: int = 4):
        super().__init__()
        self.dim, self.n_mix = dim, n_mix
        self.conv_qk = make_conv(dim, dim, 1, 1, 0, True, gen)
        self.conv_v = make_conv(dim, dim, 1, 1, 0, True, gen)
        # flax's uniform(scale=m ** -0.5): [0, scale)
        self.mix_weight = nn.Parameter(
            torch.rand((n_mix, dim), generator=gen) * n_mix ** -0.5)
        self.conv_out = make_conv(dim, dim, 1, 1, 0, False, gen)
        self.bn_out = LiveBatchNorm(dim)

    def forward(self, x):
        b, _, h, w = x.shape
        d = self.dim
        pooled = avg_pool(x, 3, 2, 1)
        qt = _tokens(self.conv_qk(x))
        kt = _tokens(self.conv_qk(pooled)).float()
        vt = _tokens(self.conv_v(pooled)).float()
        bar_q = qt.float().mean(1).to(qt.dtype).float()
        pi = torch.softmax(bar_q @ self.mix_weight.t(), dim=1)
        out = chunked(lambda q, k, v, p: _mixture(q.float(), k, v, p, d), qt, kt, vt, pi,
                      per_query=b * self.n_mix * kt.shape[1])
        out = _map(out.to(x.dtype), h, w)
        return self.bn_out(self.conv_out(out)) + x


class GroundTrans(nn.Module):
    """JAX ``GroundTrans``: queries ``theta`` from the low (finer) map, keys
    ``phi`` and values ``g`` from the high one (1x1 convs with biases to
    half the width), the 'dot' attention, ``wz_conv`` (1x1, bias),
    ``wz_bn`` and the scalar ``gate`` (zero at initialisation)."""

    def __init__(self, channels: int, gen: torch.Generator):
        super().__init__()
        inter = max(channels // 2, 1)
        self.g = make_conv(channels, inter, 1, 1, 0, True, gen)
        self.theta = make_conv(channels, inter, 1, 1, 0, True, gen)
        self.phi = make_conv(channels, inter, 1, 1, 0, True, gen)
        self.wz_conv = make_conv(inter, channels, 1, 1, 0, True, gen)
        self.wz_bn = LiveBatchNorm(channels)
        self.gate = nn.Parameter(torch.zeros(1))

    def forward(self, x_low, x_high):
        b, _, h, w = x_low.shape
        g = _tokens(self.g(x_high)).float()
        theta = _tokens(self.theta(x_low))
        phi = _tokens(self.phi(x_high)).float()
        y = chunked(lambda t, p, v: _dot(t.float(), p, v), theta, phi, g,
                    per_query=b * phi.shape[1])
        z = self.wz_bn(self.wz_conv(_map(y.to(x_low.dtype), h, w)))
        return z * self.gate.to(z.dtype)


class _GNConv(nn.Module):
    """The JAX FPT's ``gn_conv``: a conv without bias (``{name}_conv``),
    GroupNorm of ``min(32, cout)`` groups (``{name}_gn``), ReLU."""

    def __init__(self, cin: int, cout: int, k: int, gen: torch.Generator, stride: int = 1):
        super().__init__()
        self.conv = make_conv(cin, cout, k, stride, (k - 1) // 2, False, gen)
        self.gn = GroupNorm(min(32, cout), cout, eps=1e-5)

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))


class FPT(nn.Module):
    """JAX ``FPT`` over the backbone's levels (all of them, C2-C5), fine to
    coarse out, ``num_outs`` levels.  Its ``gn_conv`` blocks are named as
    the JAX package's parameters: ``lateral_{i}``, ``posthoc_{i}``,
    ``rend1_{i}``, ``rend_adapt_{i}`` and ``rend2_{i}`` each hold ``_conv``
    and ``_gn`` (``weights.py`` maps ``lateral_0_conv`` to
    ``lateral_0.conv``)."""

    def __init__(self, gen: torch.Generator, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, fpt_rendering: bool = True):
        super().__init__()
        fpt_dim = out_channels // 8
        n = self.n = len(in_channels)
        self.num_outs, self.fpt_rendering = num_outs, fpt_rendering
        self.conv_top = make_conv(in_channels[-1], fpt_dim, 1, 1, 0, False, gen)
        self.conv_top_gn = GroupNorm(min(32, fpt_dim), fpt_dim, eps=1e-5)
        self.st_top = SelfTrans(fpt_dim, gen)
        for i in range(n - 1):
            self.add_module(f"lateral_{i}", _GNConv(in_channels[-(i + 2)], fpt_dim, 3, gen))
            self.add_module(f"st_{i}", SelfTrans(fpt_dim, gen))
            self.add_module(f"gt_{i}", GroundTrans(fpt_dim, gen))
        for i in range(n):
            self.add_module(f"posthoc_{i}", _GNConv(fpt_dim, out_channels, 3, gen))
        if fpt_rendering:
            for i in range(n - 1):
                self.add_module(f"rend1_{i}", _GNConv(out_channels, fpt_dim, 3, gen, stride=2))
                self.add_module(f"rend_adapt_{i}", _GNConv(out_channels, fpt_dim, 1, gen))
                self.add_module(f"rend2_{i}", _GNConv(fpt_dim, out_channels, 3, gen))

    def forward(self, inputs):
        n = self.n
        inner = [self.st_top(self.conv_top_gn(self.conv_top(inputs[-1])))]
        for i in range(n - 1):
            lat = getattr(self, f"st_{i}")(getattr(self, f"lateral_{i}")(inputs[-(i + 2)]))
            inner.append(getattr(self, f"gt_{i}")(lat, inner[-1]))
        middle = [getattr(self, f"posthoc_{i}")(t) for i, t in enumerate(inner)]
        if self.fpt_rendering:
            outs = [middle[-1]]
            for i in range(2, n + 1):
                rend = getattr(self, f"rend1_{i - 2}")(outs[0])
                tgt = middle[n - i]
                if rend.shape[-2:] != tgt.shape[-2:]:
                    rend = nearest_resize(rend, tgt.shape[-2:])
                rend = rend + getattr(self, f"rend_adapt_{i - 2}")(tgt)
                outs.insert(0, getattr(self, f"rend2_{i - 2}")(rend))
        else:
            outs = middle[::-1]
        if outs[0].shape[-2] < outs[-1].shape[-2]:
            outs = outs[::-1]
        while len(outs) < self.num_outs:
            outs.append(max_pool(outs[-1], 1, 2, 0))
        return tuple(outs)


class TokenLayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis of ``(..., C)`` tokens, eps
    1e-6: float32 statistics as ``E[x^2] - E[x]^2`` and affine map, cast
    once to the input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean, var = _fast_stats(x, -1)
        return ((x.float() - mean) * (torch.rsqrt(var + self.eps) * self.weight)
                + self.bias).to(x.dtype)


def _heads_attention(q, k, v, heads: int):
    """flax ``dot_product_attention`` in the inputs' dtype: ``(B, n, H*D)``
    queries (already scaled), keys and values -> ``(B, n, H*D)``."""
    b, n, hd = q.shape
    dh = hd // heads
    qh = q.reshape(b, n, heads, dh).transpose(1, 2)
    kh = k.reshape(b, k.shape[1], heads, dh).transpose(1, 2)
    vh = v.reshape(b, v.shape[1], heads, dh).transpose(1, 2)
    attn = torch.softmax(qh @ kh.transpose(-1, -2), dim=-1).to(q.dtype)
    return (attn @ vh).transpose(1, 2).reshape(b, n, hd)


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` without dropout or mask:
    ``query``, ``key``, ``value`` (``Linear`` to ``heads * head_dim`` with
    biases; flax's ``(in, heads, head_dim)`` kernels flattened), the query
    divided by ``sqrt(head_dim)``, the softmax over the keys, ``out``
    (``Linear`` from ``heads * head_dim``)."""

    def __init__(self, channels: int, gen: torch.Generator, heads: int = 4):
        super().__init__()
        self.heads = heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, make_linear(channels, channels, gen))

    def forward(self, q_in, kv_in):
        q = self.query(q_in)
        q = q / torch.tensor(math.sqrt(q.shape[-1] // self.heads), dtype=q.dtype)
        k, v = self.key(kv_in), self.value(kv_in)
        y = chunked(lambda a, b_, c: _heads_attention(a, b_, c, self.heads), q, k, v,
                    per_query=q.shape[0] * self.heads * k.shape[1])
        return self.out(y)


class GroundTransLite(nn.Module):
    """JAX ``_GroundTransLite``: the lateral's and the top's tokens through
    one LayerNorm (``norm1``), the 4-head attention of the lateral into the
    top (``attn``), doubled, ``norm2``, ``linear1`` (to ``dim``), ReLU,
    ``linear2``, doubled: the fork's residual adds reuse the block's
    output."""

    def __init__(self, channels: int, dim: int, gen: torch.Generator, heads: int = 4):
        super().__init__()
        self.norm1 = TokenLayerNorm(channels)
        self.attn = MultiHeadAttention(channels, gen, heads)
        self.norm2 = TokenLayerNorm(channels)
        self.linear1 = make_linear(channels, dim, gen)
        self.linear2 = make_linear(dim, channels, gen)

    def forward(self, x_lat, x_top):
        _, _, h, w = x_lat.shape
        a = self.attn(self.norm1(_tokens(x_lat)), self.norm1(_tokens(x_top)))
        x = a + a
        y = self.linear2(F.relu(self.linear1(self.norm2(x))))
        return _map(y + y, h, w)


class FPTLite(nn.Module):
    """JAX ``FPTLite`` over the backbone's levels from ``start_level``:
    ``lateral_{i}`` (1x1, bias), top-down ``gt_{i}`` (``GroundTransLite``
    at ``out_channels``), ``fpn_conv_{i}`` (3x3, bias), extra levels by
    ``max_pool(1, 2)``."""

    def __init__(self, gen: torch.Generator, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, start_level: int = 0):
        super().__init__()
        used = list(in_channels[start_level:])
        self.start_level, self.n, self.num_outs = start_level, len(used), num_outs
        for i, c in enumerate(used):
            self.add_module(f"lateral_{i}", make_conv(c, out_channels, 1, 1, 0, True, gen))
        for i in range(len(used) - 1):
            self.add_module(f"gt_{i}", GroundTransLite(out_channels, out_channels, gen))
        for i in range(len(used)):
            self.add_module(f"fpn_conv_{i}", make_conv(out_channels, out_channels, 3, 1, 1, True,
                                                       gen))

    def forward(self, inputs):
        lats = [getattr(self, f"lateral_{i}")(x)
                for i, x in enumerate(inputs[self.start_level:])]
        for i in range(self.n - 1, 0, -1):
            lats[i - 1] = getattr(self, f"gt_{i - 1}")(lats[i - 1], lats[i])
        outs = [getattr(self, f"fpn_conv_{i}")(t) for i, t in enumerate(lats)]
        while len(outs) < self.num_outs:
            outs.append(max_pool(outs[-1], 1, 2, 0))
        return tuple(outs)
