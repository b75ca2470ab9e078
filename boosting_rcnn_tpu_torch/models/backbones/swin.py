"""Swin Transformer backbone (PyTorch port of
``boosting_rcnn_tpu/models/backbones/swin.py``; reference mmdet
``backbones/swin.py``): a 4x4 patch embedding (a stride-4 conv, then a
LayerNorm), four stages of window-attention blocks (every second one on
windows shifted by half a window) with a patch merging between stages,
and a LayerNorm on each output.  The tokens run channels-last, ``(B, H, W,
C)``; the images come and the outputs go NCHW.

Window attention batches every window of the batch: ``qkv`` and ``proj``
are ``Linear`` layers, the scores get the relative-position bias (a
float32 table, its rows picked by a one-hot product, cast to the scores'
dtype) and, in a shifted block, -100
between tokens of different regions; the softmax is float32, cast back.
A block pads its normed tokens to whole windows, shifts, attends, shifts
back and crops (the JAX block's order, ``swin.py:94-138``); its MLP's GELU
is the exact one, written as JAX writes it, ``0.5 * x * erfc(-x *
sqrt(1/2))``, op by op in the tokens' dtype.  ``PatchMerging`` pads odd
sizes and concatenates the 2x2 neighbours as ``[x00, x10, x01, x11]``
(row offset first); mmdet's ``nn.Unfold`` order is another, which
``weights.from_mmdet_state_dict`` permutes.  The LayerNorms are
``layers.LayerNorm`` at eps 1e-5 (flax's float32 statistics).  The JAX
builder reads ``frozen_stages`` and the JAX module ignores it; so does the
port.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..layers import LayerNorm, make_conv, make_linear

__all__ = ["window_partition", "window_reverse", "relative_position_index",
           "shifted_window_mask", "WindowAttention", "SwinBlock", "PatchMerging",
           "SwinTransformer"]

SWIN_EPS = 1e-5


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """``(B, H, W, C)`` -> ``(B * nH * nW, ws * ws, C)``; H and W divisible by ``ws``."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(win: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """``window_partition``'s inverse: windows -> ``(B, h, w, C)``."""
    b = win.shape[0] // ((h // ws) * (w // ws))
    x = win.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """``(ws*ws, ws*ws)`` int32: each token pair's row in the bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def shifted_window_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """The shifted blocks' mask on an ``(h, w)`` padded map: ``(windows,
    ws*ws, ws*ws)`` float32, -100 between tokens of different regions."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _mask_on(h: int, w: int, ws: int, shift: int, device: str) -> torch.Tensor:
    """``shifted_window_mask`` on ``device``, made once for every shifted
    block of a map's size (read only)."""
    return torch.as_tensor(shifted_window_mask(h, w, ws, shift), device=device)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU as ``jax.nn.gelu(approximate=False)`` writes it."""
    sqrt_half = torch.tensor(np.sqrt(0.5), dtype=x.dtype, device=x.device)
    return 0.5 * x * torch.erfc(-x * sqrt_half)


class WindowAttention(nn.Module):
    """Multi-head self-attention within windows (JAX ``WindowAttention``):
    ``(nW, N, C)`` tokens and an optional ``(windows per image, N, N)``
    mask -> ``(nW, N, C)``."""

    def __init__(self, dim: int, num_heads: int, window_size: int, gen: torch.Generator):
        super().__init__()
        self.dim, self.num_heads, self.window_size = dim, num_heads, window_size
        self.qkv = make_linear(dim, 3 * dim, gen)
        self.proj = make_linear(dim, dim, gen)
        table = torch.empty((2 * window_size - 1) ** 2, num_heads)
        nn.init.trunc_normal_(table, 0.0, 0.02, -0.04, 0.04, generator=gen)
        self.relative_position_bias_table = nn.Parameter(table)
        # the table's rows by a one-hot product: its gradient is a matmul,
        # which repeats bit for bit on the card (an index's backward adds
        # with atomics there)
        index = relative_position_index(window_size).reshape(-1)
        onehot = np.zeros((index.size, table.shape[0]), np.float32)
        onehot[np.arange(index.size), index] = 1.0
        self.register_buffer("rp_onehot", torch.from_numpy(onehot), persistent=False)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        nw, n, c = x.shape
        heads = self.num_heads
        hd = self.dim // heads
        qkv = self.qkv(x).reshape(nw, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul(q * hd ** -0.5, k.transpose(-2, -1))
        table = self.relative_position_bias_table
        bias = torch.matmul(self.rp_onehot, table).reshape(n, n, heads)
        attn = attn + bias.permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nwi = mask.shape[0]
            attn = (attn.reshape(nw // nwi, nwi, heads, n, n)
                    + mask[None, :, None].to(attn.dtype)).reshape(nw, heads, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(nw, n, self.dim)
        return self.proj(out)


class SwinBlock(nn.Module):
    """``norm1``, pad to whole windows, shift by ``-shift``, windowed
    ``attn``, shift back, crop, the residual; ``norm2``, ``mlp_fc1``, GELU,
    ``mlp_fc2``, the residual (JAX ``SwinBlock``), on ``(B, H, W, C)``."""

    def __init__(self, dim: int, num_heads: int, gen: torch.Generator, window_size: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = LayerNorm(dim, SWIN_EPS, channels_last=True)
        self.attn = WindowAttention(dim, num_heads, window_size, gen)
        self.norm2 = LayerNorm(dim, SWIN_EPS, channels_last=True)
        hidden = int(dim * mlp_ratio)
        self.mlp_fc1 = make_linear(dim, hidden, gen)
        self.mlp_fc2 = make_linear(hidden, dim, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        ws, shift = self.window_size, self.shift
        y = self.norm1(x)
        pad_h, pad_w = (-h) % ws, (-w) % ws
        if pad_h or pad_w:
            y = F.pad(y, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, w + pad_w
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), (1, 2))
            mask = _mask_on(hp, wp, ws, shift, str(y.device))
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, hp, wp)
        if shift > 0:
            y = torch.roll(y, (shift, shift), (1, 2))
        if pad_h or pad_w:
            y = y[:, :h, :w]
        x = x + y
        return x + self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(x))))


class PatchMerging(nn.Module):
    """2x2 neighbours to channels (odd sizes padded), ``norm`` over the 4C
    channels, ``reduction`` to ``out_dim`` without a bias."""

    def __init__(self, dim: int, out_dim: int, gen: torch.Generator):
        super().__init__()
        self.norm = LayerNorm(4 * dim, SWIN_EPS, channels_last=True)
        self.reduction = make_linear(4 * dim, out_dim, gen, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """NCHW images -> the LayerNormed outputs (NCHW) of the stages in
    ``out_indices``; defaults are Swin-T's."""

    def __init__(self, gen: torch.Generator, embed_dims: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, patch_size: int = 4, mlp_ratio: float = 4.0,
                 out_indices: Sequence[int] = (0, 1, 2, 3)):
        super().__init__()
        if len(num_heads) < len(depths):
            raise ValueError(f"{len(depths)} stages and num_heads {tuple(num_heads)}")
        self.patch_size, self.depths = patch_size, tuple(depths)
        self.out_indices = tuple(out_indices)
        self.patch_embed = make_conv(3, embed_dims, patch_size, patch_size, 0, True, gen)
        self.patch_norm = LayerNorm(embed_dims, SWIN_EPS, channels_last=True)
        dim, channels = embed_dims, []
        for stage, depth in enumerate(self.depths):
            for blk in range(depth):
                self.add_module(f"stage{stage}_block{blk}", SwinBlock(
                    dim, num_heads[stage], gen, window_size,
                    shift=0 if blk % 2 == 0 else window_size // 2, mlp_ratio=mlp_ratio))
            channels.append(dim)
            if stage in self.out_indices:
                self.add_module(f"out_norm{stage}", LayerNorm(dim, SWIN_EPS, channels_last=True))
            if stage < len(self.depths) - 1:
                self.add_module(f"merge{stage}", PatchMerging(dim, 2 * dim, gen))
                dim *= 2
        self.out_channels = tuple(channels[i] for i in self.out_indices)

    def forward(self, x: torch.Tensor):
        ps = self.patch_size
        h, w = x.shape[-2:]
        if h % ps or w % ps:
            x = F.pad(x, (0, (-w) % ps, 0, (-h) % ps))
        x = self.patch_norm(self.patch_embed(x).permute(0, 2, 3, 1))
        outs = []
        for stage, depth in enumerate(self.depths):
            for blk in range(depth):
                x = getattr(self, f"stage{stage}_block{blk}")(x)
            if stage in self.out_indices:
                outs.append(getattr(self, f"out_norm{stage}")(x).permute(0, 3, 1, 2))
            if stage < len(self.depths) - 1:
                x = getattr(self, f"merge{stage}")(x)
        return tuple(outs)
