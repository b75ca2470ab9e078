"""The fork's domain-generalisation model parts (PyTorch port of
``boosting_rcnn_tpu/models/thesis_extras.py``).

``EMAU`` / ``FPEMAU``: Expectation-Maximisation Attention Units (the
reference's ``faster_rcnn.py:849`` / ``:924``).  A basis ``mu`` ``(C,
K)`` is refined by three E/M steps in float32 without gradient (the
reference wraps them in ``torch.no_grad()``): responsibilities ``z =
softmax(x mu)`` over the K bases, normalised over the pixels, and the new
bases ``l2norm(x^T z)`` over C.  The input is rebuilt from the refined
bases (``mu z^T``; the gradient reaches the input through ``z``), passed
through ReLU, a bias-free 1 x 1 conv and BN on its running statistics
(frozen, as the JAX ``nn.BatchNorm(use_running_average=True)``), added to
the input and passed through ReLU.  ``FPEMAU`` runs one basis and one set
of convs over every level of a pyramid, its E/M steps over the levels'
pixels together; ``EMAFasterRCNN`` applies it to the neck's outputs.

``mu`` is a buffer (the JAX ``batch_stats`` entry), drawn at build as the
JAX ``_mu_buffer`` draws it (``l2norm(normal(C, K) * sqrt(2 / K))`` over
C; here from ``build_detector``'s generator, so a model that must equal a JAX
one takes its ``mu`` through ``weights.from_jax_params``).  In a
``train()``-mode forward it moves to ``0.9 * mu + 0.1 * mean_b(mu_b)``,
the batch mean taken over the global batch across data-parallel ranks;
in ``eval()`` mode it stays.

``HiddenMixupResNet``: the two-view backbone of the fork
(``hiddenMixupResnet.py:670``) around a ResNet.  Its one-view call is the
ResNet's; with a second view both run the shared stages, the spatial
contrastive loss over the first level is returned beside the outputs
(``train=True``), and with ``mix_lams`` (one blend factor a level, the
first unused) every later level is the ``mixup_data`` blend of the two
views.  The JAX function draws each level's ``Beta(alpha, alpha)`` from a
key; the port takes the draws.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_reduce_mean
from .layers import LiveBatchNorm, _normalize, make_conv

__all__ = ["EMAU", "FPEMAU", "HiddenMixupResNet", "mixup_data", "global_k_max_pool_loss",
           "spatial_contrastive_loss", "channel_contrastive_loss"]

EM_STAGES = 3
EM_MOMENTUM = 0.9


def _l2norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / (1e-6 + torch.linalg.vector_norm(x, dim=dim, keepdim=True))


def _mu_init(c: int, k: int, gen: torch.Generator) -> torch.Tensor:
    return _l2norm(torch.randn((c, k), generator=gen) * math.sqrt(2.0 / k), 0)


class RunningBatchNorm(LiveBatchNorm):
    """BN on its running statistics in every mode (flax ``nn.BatchNorm(
    use_running_average=True)``): float32 arithmetic cast once to the
    input's dtype; its scale and bias train."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _normalize(x, self.running_mean[:, None, None], self.running_var[:, None, None],
                          self.weight, self.bias, self.eps)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> ``(B, H*W, C)`` float32, pixels in row-major order."""
    b, c = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(b, -1, c).float()


@torch.no_grad()
def _em(flat: torch.Tensor, mu0: torch.Tensor, stages: int = EM_STAGES) -> torch.Tensor:
    """``stages`` E/M steps from the basis ``mu0`` ``(C, K)`` over ``flat``
    ``(B, N, C)`` -> the batch's bases ``(B, C, K)``."""
    mu = mu0[None].expand(flat.shape[0], *mu0.shape)
    for _ in range(stages):
        z = torch.softmax(torch.einsum("bnc,bck->bnk", flat, mu), dim=2)
        z_ = z / (1e-6 + z.sum(dim=1, keepdim=True))
        mu = _l2norm(torch.einsum("bnc,bnk->bck", flat, z_), 1)
    return mu


def _rebuild(flat: torch.Tensor, mu: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``mu softmax(x mu)^T`` as an NCHW map shaped and typed as ``like``."""
    b, c, h, w = like.shape
    z = torch.softmax(torch.einsum("bnc,bck->bnk", flat, mu), dim=2)
    rec = torch.einsum("bck,bnk->bnc", mu, z).reshape(b, h, w, c).permute(0, 3, 1, 2)
    return rec.to(like.dtype)


class _EMBase(nn.Module):
    def __init__(self, channels: int, k: int, gen: torch.Generator):
        super().__init__()
        self.k = k
        self.conv1 = make_conv(channels, channels, 1, 1, 0, True, gen)
        self.conv2 = make_conv(channels, channels, 1, 1, 0, False, gen)
        self.bn2 = RunningBatchNorm(channels)
        self.register_buffer("mu", _mu_init(channels, k, gen))

    def _moved(self, mu: torch.Tensor) -> None:
        """In train mode, move ``mu`` by the global batch's mean basis."""
        if self.training:
            mean = all_reduce_mean(mu.mean(0))
            self.mu.copy_(EM_MOMENTUM * self.mu + (1.0 - EM_MOMENTUM) * mean)

    def _out(self, x, flat, mu, identity):
        rec = self.bn2(self.conv2(F.relu(_rebuild(flat, mu, x))))
        return F.relu(rec + identity)


class EMAU(_EMBase):
    """The EM attention unit on one NCHW map -> ``(out, the batch's bases
    (B, C, K))``."""

    def forward(self, x: torch.Tensor):
        y = self.conv1(x)
        flat = _flat(y)
        mu = _em(flat, self.mu)
        with torch.no_grad():
            self._moved(mu)
        return self._out(y, flat, mu, x), mu


class FPEMAU(_EMBase):
    """One EM attention unit over a pyramid of NCHW maps (one basis, shared
    convs; the E/M steps over all levels' pixels) -> ``(outs, the batch's
    bases)``."""

    def forward(self, feats: Sequence[torch.Tensor]):
        xs = [self.conv1(f) for f in feats]
        flats = [_flat(x) for x in xs]
        mu = _em(torch.cat(flats, 1), self.mu)
        with torch.no_grad():
            self._moved(mu)
        return tuple(self._out(x, fl, mu, f) for x, fl, f in zip(xs, flats, feats)), mu


def mixup_data(x1: torch.Tensor, x2: torch.Tensor, lam) -> torch.Tensor:
    """``lam * x1 + (1 - lam) * x2`` (``hiddenMixupResnet.py:739``; ``lam``
    a ``Beta(alpha, alpha)`` draw)."""
    return lam * x1 + (1.0 - lam) * x2


def global_k_max_pool_loss(var: torch.Tensor, k: int) -> torch.Tensor:
    """The mean of each row's ``k`` largest values (``GlobalkMaxPooling``)."""
    return torch.topk(var.reshape(var.shape[0], -1), k, dim=1).values.mean()


def spatial_contrastive_loss(x1: torch.Tensor, x2: torch.Tensor,
                             margin: float = 0.01) -> torch.Tensor:
    """``hiddenMixupResnet.py:720`` on NHWC maps: the per-pixel channel mean
    of the squared difference, hinged at ``margin``, top ``(H/4)(W/4)``
    pooled."""
    var = F.relu(((x1 - x2) ** 2).mean(-1) - margin)
    h, w = var.shape[1:3]
    return global_k_max_pool_loss(var, max((h // 4) * (w // 4), 1))


def channel_contrastive_loss(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``hiddenMixupResnet.py:731`` on NHWC maps: each channel's spatial mean
    of the squared difference, top ``C/8`` pooled."""
    var = ((x1 - x2) ** 2).mean((1, 2))
    return global_k_max_pool_loss(var, max(var.shape[-1] // 8, 1))


class HiddenMixupResNet(nn.Module):
    """The two-view backbone around ``resnet`` (its parameters under
    ``backbone.resnet.*``); a one-view call is the ResNet's."""

    def __init__(self, resnet: nn.Module):
        super().__init__()
        self.resnet = resnet
        self.out_channels = resnet.out_channels
        self.frozen_stages = resnet.frozen_stages

    def forward(self, x1: torch.Tensor, x2: Optional[torch.Tensor] = None,
                mix_lams: Optional[Sequence[float]] = None,
                train: bool = False) -> Tuple:
        """NCHW views -> the levels (NCHW), with ``train`` also the spatial
        contrastive loss of the first level (0 for one view)."""
        outs1 = self.resnet(x1)
        if x2 is None:
            return (outs1, torch.zeros((), device=x1.device)) if train else outs1
        outs2 = self.resnet(x2)
        contrastive = spatial_contrastive_loss(outs1[0].float().permute(0, 2, 3, 1),
                                               outs2[0].float().permute(0, 2, 3, 1))
        if mix_lams is not None:
            outs1 = tuple(a if i == 0 else mixup_data(a, b, lam)
                          for i, (a, b, lam) in enumerate(zip(outs1, outs2, mix_lams)))
        return (outs1, contrastive) if train else outs1
