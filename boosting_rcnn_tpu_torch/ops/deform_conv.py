"""Deformable convolution v1 / v2 (PyTorch port of
``boosting_rcnn_tpu/ops/deform_conv.py``).

The JAX package computes it in XLA, not in a Pallas kernel, and so does
the port, in plain PyTorch: each tap's sample is a bilinear gather of the
four neighbouring pixels (zero outside the map), then one matrix product
contracts the taps and channels, ``(B*Ho*Wo, KK*Cin) x (KK*Cin, Cout)``,
tap-major and channel-minor, as the JAX package's ``(kh, kw, Cin, Cout)``
kernel is laid out.

The offsets have ``dg*KK*2`` channels, interleaved ``(dy, dx)`` per tap in
row-major tap order (mmcv's layout); v2's mask has ``dg*KK`` channels,
already through the sigmoid.  NCHW in and out.

Dtypes follow the JAX function: the sampling grid, the positions, the
bilinear weights and the four-corner sums are computed in the input's
dtype, op by op (in bfloat16 the grid itself rounds past 256, as
``jnp.arange(n, dtype=bfloat16)`` does); the contraction sums in float32
and rounds once to the input's dtype (``preferred_element_type=float32``,
then ``.astype``).

The gathers are advanced indexing, whose gradient is ``index_put_`` with
``accumulate=True``: on the GPU a sort-based sum in a fixed order, so the
backward is bitwise repeatable, also under
``torch.use_deterministic_algorithms(True)``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .losses import sigmoid

__all__ = ["deform_conv2d", "split_modulated_offset"]


def _bilinear_gather(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``img`` ``(N, H, W, C)`` sampled at fractional rows ``y`` and columns
    ``x`` ``(N, P)`` -> ``(N, P, C)``; corners outside the map add 0 (JAX
    ``_bilinear_gather``, one image and group per row of ``N``)."""
    n, h, w, c = img.shape
    flat = img.reshape(n, h * w, c)
    rows = torch.arange(n, device=img.device)[:, None]
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1

    def corner(yy, xx, wgt):
        inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        yi = torch.clamp(yy.to(torch.int64), 0, h - 1)
        xi = torch.clamp(xx.to(torch.int64), 0, w - 1)
        vals = flat[rows, yi * w + xi]
        return vals * (wgt * inside.to(img.dtype))[..., None]

    return (corner(y0, x0, wy0 * wx0) + corner(y0, x0 + 1, wy0 * wx1)
            + corner(y0 + 1, x0, wy1 * wx0) + corner(y0 + 1, x0 + 1, wy1 * wx1))


def deform_conv2d(
    x: torch.Tensor,
    offset: torch.Tensor,
    weight: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 1,
    dilation: int = 1,
    deform_groups: int = 1,
) -> torch.Tensor:
    """Deformable convolution (no bias, as every ported DCN) of ``x``
    ``(B, Cin, H, W)`` by ``weight`` ``(Cout, Cin, kh, kw)`` at ``offset``
    ``(B, dg*KK*2, Ho, Wo)``; with
    ``mask`` ``(B, dg*KK, Ho, Wo)`` it is DCNv2 (modulated).  Returns
    ``(B, Cout, Ho, Wo)`` in ``x``'s dtype."""
    b, cin, h, w = x.shape
    cout, wcin, kh, kw = weight.shape
    if wcin != cin or cin % deform_groups:
        raise ValueError(f"weight {tuple(weight.shape)} for {cin} channels in "
                         f"{deform_groups} deform groups")
    kk, dg, cg = kh * kw, deform_groups, cin // deform_groups
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    if tuple(offset.shape) != (b, dg * kk * 2, ho, wo):
        raise ValueError(f"offset {tuple(offset.shape)} for {dg} groups of {kk} taps "
                         f"at {ho} x {wo}")
    dt, dev = x.dtype, x.device

    # the base grid, row-major taps, in x's dtype (JAX: jnp.arange(n, dtype=x.dtype))
    oy = torch.arange(ho, dtype=dt, device=dev) * stride - padding
    ox = torch.arange(wo, dtype=dt, device=dev) * stride - padding
    ky = torch.arange(kh, dtype=dt, device=dev) * dilation
    kx = torch.arange(kw, dtype=dt, device=dev) * dilation
    base_y = oy[:, None] + ky.repeat_interleave(kw)[None, :]  # (Ho, KK)
    base_x = ox[:, None] + kx.repeat(kh)[None, :]  # (Wo, KK)
    off = offset.reshape(b, dg, kk, 2, ho, wo).permute(0, 1, 4, 5, 2, 3)  # (B, dg, Ho, Wo, KK, 2)
    sy = base_y[None, None, :, None, :] + off[..., 0]
    sx = base_x[None, None, None, :, :] + off[..., 1]

    img = x.reshape(b, dg, cg, h, w).permute(0, 1, 3, 4, 2).reshape(b * dg, h, w, cg)
    samples = _bilinear_gather(img, sy.reshape(b * dg, -1), sx.reshape(b * dg, -1))
    samples = samples.reshape(b, dg, ho, wo, kk, cg)
    if mask is not None:
        samples = samples * mask.reshape(b, dg, kk, ho, wo).permute(0, 1, 3, 4, 2)[..., None]
    # tap-major, channel-minor: (B, Ho, Wo, KK, dg, C/dg) -> (B*Ho*Wo, KK*Cin)
    samples = samples.permute(0, 2, 3, 4, 1, 5).reshape(b * ho * wo, kk * cin)
    wmat = weight.permute(2, 3, 1, 0).reshape(kk * cin, cout)
    out = (samples.float() @ wmat.to(dt).float()).to(dt)
    return out.reshape(b, ho, wo, cout).permute(0, 3, 1, 2)


def split_modulated_offset(raw: torch.Tensor, deform_groups: int,
                           kk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The v2 offset conv's ``dg*3*KK`` channels -> (the offsets, the first
    ``dg*2*KK``; the mask, the sigmoid of the rest), along dim 1."""
    if raw.shape[1] != deform_groups * 3 * kk:
        raise ValueError(f"{raw.shape[1]} offset channels for {deform_groups} groups of {kk} "
                         "taps")
    two = deform_groups * 2 * kk
    return raw[:, :two], sigmoid(raw[:, two:])
