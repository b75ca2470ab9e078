"""PointRend's heads and point selection (PyTorch port of
``boosting_rcnn_tpu/models/roi_heads/point_rend.py``; reference
``coarse_mask_head.py``, ``mask_point_head.py`` and
``point_rend_roi_head.py``).

``CoarseMaskHead``: the pooled RoI features ``(R, 14, 14, C)`` through a
2 x 2 stride-2 ``downsample_conv`` of 256 channels with ReLU, flattened in
NHWC order, ``num_fcs`` FCs with ReLU and ``fc_logits``: a ``(R, 7, 7, K)``
float32 coarse logit map.  ``MaskPointHead``: an MLP over each point's
fine feature concatenated with its coarse logits, the coarse logits
appended again after each FC (``coarse_pred_each_layer``), and a float32
``fc_logits``.

``get_train_points`` samples each RoI's training points: ``3 P`` uniform
candidates, the ``0.75 P`` most uncertain of them by the coarse logit of
the RoI's label (``-|logit|``), then ``P - 0.75 P`` fresh uniform points.
``subdivision_refine`` is the inference refinement: ``steps`` times a 2x
bilinear upsample of the label's logit map, then the ``num_points`` most
uncertain cells re-predicted by the point head.  ``jax.lax.top_k`` puts
the lower index first among equal values, and ``torch.topk`` promises no
order (the CPU and the GPU differ), so both take a stable descending sort
and its first ``k``.

``upsample2x`` is ``jax.image.resize(..., "bilinear")`` at scale 2:
half-pixel centres, weights 0.75 and 0.25, and at the borders the one
sample inside with weight 1 (the JAX weights renormalised); it contracts
the columns, then the rows, as the JAX function's two matrix products do,
and agrees with it within 1e-6 of the largest value (XLA's products sum
in another order: values 2 ulps apart).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.point_sample import point_sample
from ..layers import make_conv, make_linear

__all__ = ["CoarseMaskHead", "MaskPointHead", "PointRendCfg", "label_column", "point_uncertainty",
           "top_k_indices", "get_train_points", "upsample2x", "subdivision_refine",
           "sample_gt_mask_at_points"]


class CoarseMaskHead(nn.Module):
    """``(R, S, S, C)`` pooled features -> ``(R, S/d, S/d, num_classes)``
    float32 coarse logits (JAX ``CoarseMaskHead``: ``num_convs`` 3x3 convs
    of ``conv_channels`` with ReLU, the ``d x d`` stride-``d``
    ``downsample_conv`` with ReLU, ``num_fcs`` FCs of ``fc_channels`` with
    ReLU, ``fc_logits``)."""

    def __init__(self, gen: torch.Generator, num_classes: int = 80, in_channels: int = 256,
                 conv_channels: int = 256, num_convs: int = 0, num_fcs: int = 2,
                 fc_channels: int = 1024, roi_feat_size: int = 14, downsample_factor: int = 2):
        super().__init__()
        self.num_classes, self.num_convs, self.num_fcs = num_classes, num_convs, num_fcs
        self.downsample_factor = downsample_factor
        self.side = roi_feat_size // downsample_factor
        cin = in_channels
        for i in range(num_convs):
            self.add_module(f"conv_{i}", make_conv(cin, conv_channels, 3, 1, 1, True, gen))
            cin = conv_channels
        if downsample_factor > 1:
            d = downsample_factor
            self.downsample_conv = make_conv(cin, conv_channels, d, d, 0, True, gen)
            cin = conv_channels
        cin *= self.side * self.side
        for i in range(num_fcs):
            self.add_module(f"fc_{i}", make_linear(cin, fc_channels, gen))
            cin = fc_channels
        self.fc_logits = make_linear(cin, self.side * self.side * num_classes, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = x.shape[0]
        x = x.permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv_{i}")(x))
        if self.downsample_factor > 1:
            x = F.relu(self.downsample_conv(x))
        x = x.permute(0, 2, 3, 1).reshape(r, -1)
        for i in range(self.num_fcs):
            x = F.relu(getattr(self, f"fc_{i}")(x))
        x = self.fc_logits(x)
        return x.reshape(r, self.side, self.side, self.num_classes).float()


class MaskPointHead(nn.Module):
    """``(P, Cf)`` fine features and ``(P, K)`` coarse logits -> ``(P, K)``
    float32 point logits (JAX ``MaskPointHead``)."""

    def __init__(self, gen: torch.Generator, in_channels: int, num_classes: int = 80,
                 num_fcs: int = 3, fc_channels: int = 256, coarse_pred_each_layer: bool = True):
        super().__init__()
        self.num_fcs, self.coarse_pred_each_layer = num_fcs, coarse_pred_each_layer
        cin = in_channels + num_classes
        for i in range(num_fcs):
            self.add_module(f"fc_{i}", make_linear(cin, fc_channels, gen))
            cin = fc_channels + (num_classes if coarse_pred_each_layer else 0)
        self.fc_logits = make_linear(cin, num_classes, gen)

    def forward(self, fine: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
        x = torch.cat([fine, coarse.to(fine.dtype)], dim=-1)
        for i in range(self.num_fcs):
            x = F.relu(getattr(self, f"fc_{i}")(x))
            if self.coarse_pred_each_layer:
                x = torch.cat([x, coarse.to(x.dtype)], dim=-1)
        return self.fc_logits(x).float()


@dataclasses.dataclass(frozen=True)
class PointRendCfg:
    num_points: int = 196
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    subdivision_steps: int = 5
    subdivision_num_points: int = 784
    scale_factor: int = 2

    @property
    def train_draws(self):
        """The numbers of uniform candidates and of fresh points
        ``get_train_points`` draws for each RoI."""
        n_unc = int(self.importance_sample_ratio * self.num_points)
        return int(self.num_points * self.oversample_ratio), self.num_points - n_unc


def label_column(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits`` ``(R, P, K)`` at each RoI's label ``(R,)`` (clamped to the
    classes) -> ``(R, P)``, by a one-hot product (an elementwise gradient;
    the JAX package's ``take_along_axis``)."""
    c = logits.shape[-1]
    onehot = F.one_hot(torch.clamp(labels.long(), 0, c - 1), c).to(logits.dtype)
    return (logits * onehot[:, None, :]).sum(-1)


def point_uncertainty(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``-|logit at the label|``: logits ``(R, P, K)``, labels ``(R,)`` ->
    ``(R, P)``."""
    return -torch.abs(label_column(logits, labels))


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest values of each row of ``x``, the
    lower index first among equal values (``jax.lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


@torch.no_grad()
def get_train_points(cfg: PointRendCfg, coarse_logits: torch.Tensor, labels: torch.Tensor,
                     uniforms=None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Each RoI's ``(R, num_points, 2)`` RoI-relative ``(x, y)`` training
    points from its coarse logits ``(R, S, S, K)`` and label ``(R,)``.
    ``uniforms``, when given, are the two draws ``((R, 3 P, 2), (R, P - 0.75
    P, 2))`` (the JAX function's ``k1`` and ``k2`` uniforms), else they are
    drawn from ``generator``."""
    r, dev = coarse_logits.shape[0], coarse_logits.device
    n_sampled, n_rand = cfg.train_draws
    n_unc = cfg.num_points - n_rand
    if uniforms is None:
        uniforms = tuple(torch.rand((r, n, 2), generator=generator, device=dev)
                         for n in (n_sampled, n_rand))
    cand, rnd = (torch.as_tensor(u, dtype=torch.float32, device=dev) for u in uniforms)
    unc = point_uncertainty(point_sample(coarse_logits, cand), labels)
    idx = top_k_indices(unc, n_unc)
    top = torch.gather(cand, 1, idx[..., None].expand(-1, -1, 2))
    return torch.cat([top, rnd], dim=1) if n_rand > 0 else top


def _lerp2x(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` upsampled 2x along ``dim`` with half-pixel centres: output
    ``2j`` is ``0.25 x[j-1] + 0.75 x[j]``, ``2j+1`` is ``0.75 x[j] + 0.25
    x[j+1]``, and the first and last ``x[0]`` and ``x[n-1]``."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = 2 * n
    dev = x.device
    j = torch.arange(n, device=dev)
    lo = torch.stack([j - 1, j], dim=1).reshape(-1)
    w_lo = torch.tensor([0.25, 0.75], dtype=x.dtype, device=dev).repeat(n)
    w_hi = 1.0 - w_lo
    w_lo = torch.where(lo < 0, torch.zeros_like(w_lo), w_lo)
    w_hi = torch.where(lo < 0, torch.ones_like(w_hi), w_hi)
    w_lo = torch.where(lo + 1 > n - 1, torch.ones_like(w_lo), w_lo)
    w_hi = torch.where(lo + 1 > n - 1, torch.zeros_like(w_hi), w_hi)
    a = x.index_select(dim, torch.clamp(lo, 0, n - 1))
    b = x.index_select(dim, torch.clamp(lo + 1, 0, n - 1))
    return a * w_lo.view(shape) + b * w_hi.view(shape)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """``(R, H, W)`` -> ``(R, 2H, 2W)``: ``jax.image.resize(x, (R, 2H,
    2W), "bilinear")``."""
    return _lerp2x(_lerp2x(x, 2), 1)


def subdivision_refine(cfg: PointRendCfg, label_logits: torch.Tensor,
                       point_fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Inference subdivision (JAX ``subdivision_refine``, reference
    ``_mask_point_forward_test``) of the label's logit maps ``(R, S, S)``:
    ``cfg.subdivision_steps`` times, ``upsample2x`` (the scale factor 2),
    then the ``cfg.subdivision_num_points`` most uncertain cells (``-|logit|``,
    ties to the lower index) re-predicted by ``point_fn`` (cell-centre
    points ``(R, k, 2)`` RoI-relative -> ``(R, k)`` logits) and scattered
    back.  Returns ``(R, S 2^steps, S 2^steps)``."""
    if cfg.scale_factor != 2:
        raise NotImplementedError(f"subdivision scale_factor={cfg.scale_factor} is not ported")
    logits = label_logits
    dev = logits.device
    for _ in range(cfg.subdivision_steps):
        logits = upsample2x(logits)
        r, h, w = logits.shape
        k = min(cfg.subdivision_num_points, h * w)
        flat = logits.reshape(r, h * w)
        idx = top_k_indices(-torch.abs(flat), k)
        hh = torch.full((), float(h), dtype=torch.float32, device=dev)
        ww = torch.full((), float(w), dtype=torch.float32, device=dev)
        gy = torch.div(idx, w, rounding_mode="floor").float()
        gx = (idx % w).float()
        pts = torch.stack([(gx + 0.5) / ww, (gy + 0.5) / hh], dim=-1)
        flat = flat.scatter(1, idx, point_fn(pts).to(flat.dtype))
        logits = flat.reshape(r, h, w)
    return logits


@torch.no_grad()
def sample_gt_mask_at_points(crops: torch.Tensor, gt_boxes: torch.Tensor, rois: torch.Tensor,
                             rel_pts: torch.Tensor) -> torch.Tensor:
    """Point targets ``(R, P)`` float32: each RoI's points ``(R, P, 2)``
    (RoI-relative) in the image, then relative to its gt box ``(R, 4)``,
    sampled bilinearly from its gt's box-relative crop ``(R, S, S)`` and
    binarised at 0.5."""
    ix = rois[:, None, 0] + rel_pts[..., 0] * (rois[:, None, 2] - rois[:, None, 0])
    iy = rois[:, None, 1] + rel_pts[..., 1] * (rois[:, None, 3] - rois[:, None, 1])
    gw = torch.clamp(gt_boxes[:, 2] - gt_boxes[:, 0], min=1e-3)[:, None]
    gh = torch.clamp(gt_boxes[:, 3] - gt_boxes[:, 1], min=1e-3)[:, None]
    nx = (ix - gt_boxes[:, None, 0]) / gw
    ny = (iy - gt_boxes[:, None, 1]) / gh
    vals = point_sample(crops.float()[..., None], torch.stack([nx, ny], dim=-1))[..., 0]
    return (vals >= 0.5).float()
