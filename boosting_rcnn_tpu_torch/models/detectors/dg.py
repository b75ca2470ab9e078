"""The fork's domain-generalisation detectors (PyTorch port of
``boosting_rcnn_tpu/models/detectors/dg.py``; the reference's
``mmdet/models/detectors/faster_rcnn.py:47-668``).

- ``DGFasterRCNNDetector`` (DANN): a ``DomainClassifier`` on the
  backbone's stage-2 output behind a gradient-reversal layer whose
  strength ``alpha = 2 / (1 + exp(-10 p)) - 1`` ramps with the share ``p``
  of images seen; ``0.1 *`` the cross entropy of the domain prediction
  joins the losses as ``loss_domain``.  As in the reference and the JAX
  package, the classifier ends in a softmax and the cross entropy takes a
  log-softmax of that softmax.
- ``JiGENFasterRCNNDetector``: a ``JigsawClassifier`` on the global
  average of the backbone's last output for the tile-permuted view
  (``img_puzzle``); ``0.1 *`` the binary cross entropy of its softmax
  against the one-hot ``jig_labels`` (clipped to ``[1e-7, 1 - 1e-7]``,
  averaged over every element) joins the losses as ``loss_jig``.
- ``DGaugFasterRCNNDetector``: trains on the style-transferred view
  (``img_aug``, made by the loader's ``dgaug``); the reference's two-view
  mixup branch reduces to the augmented view's features
  (``thesis_extras.HiddenMixupResNet``), as in the JAX package.

The classifiers' parameters train in their own optimizer group, Adam(1e-3)
with a global-norm clip of 0.1 (``engine/train.py``): the JAX package's
one clean update in place of the reference's lagged Adam step beside the
main SGD (ARCHITECTURE.md deviation 23).  ``MMDAAEFasterRCNN`` is not
rebuilt in the JAX package (deviation 16), nor here.

The images-seen ``count`` is a float32 buffer of the domain classifier
(the JAX ``batch_stats`` entry): a ``train()``-mode forward advances it by
the global batch (every rank's images), and ``alpha`` is computed from the
advanced count in both modes, as the JAX module computes it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import world_size
from ..layers import make_conv, make_linear
from .two_stage import TwoStageDetector

__all__ = ["grad_reverse", "DomainClassifier", "JigsawClassifier", "DGFasterRCNNDetector",
           "JiGENFasterRCNNDetector", "DGaugFasterRCNNDetector", "DG_LOSS_WEIGHT"]

DG_LOSS_WEIGHT = 0.1  # the reference's weight of loss_domain and loss_jig
JIG_CLIP = 1e-7


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.save_for_backward(alpha)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (alpha,) = ctx.saved_tensors
        return -alpha.to(g.dtype) * g, None


def grad_reverse(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Identity forward, ``-alpha * g`` backward (the reference's
    ``ReverseLayerF``); no gradient reaches ``alpha``."""
    return _GradReverse.apply(x, alpha.detach())


class DomainClassifier(nn.Module):
    """The reference's ``domain_cls``: gradient reversal, two VALID 3 x 3
    stride-2 convs with ReLU (128 and 64 channels), the global average in
    float32, a linear layer to ``num_domains`` and a softmax.  Takes an
    NCHW map, returns ``(B, num_domains)`` float32 probabilities."""

    def __init__(self, in_channels: int, gen: torch.Generator, num_domains: int = 2,
                 total_img: float = 56064.0):
        super().__init__()
        self.total_img = float(total_img)
        self.conv1 = make_conv(in_channels, 128, 3, 2, 0, True, gen)
        self.conv2 = make_conv(128, 64, 3, 2, 0, True, gen)
        self.fc = make_linear(64, num_domains, gen)
        self.register_buffer("count", torch.zeros((), dtype=torch.float32))

    def alpha(self, batch: int) -> torch.Tensor:
        """The reversal strength after ``batch`` more images (every rank's)."""
        p = (self.count + float(batch)) / self.total_img
        return 2.0 / (1.0 + torch.exp(-10.0 * p)) - 1.0

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        seen = feat.shape[0] * world_size()
        alpha = self.alpha(seen)
        if self.training:
            with torch.no_grad():
                self.count.add_(float(seen))
        dt = self.conv1.compute_dtype
        x = grad_reverse(feat.to(dt), alpha.to(dt))
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        # the JAX Dense has no dtype: float32 whatever the compute dtype
        logits = F.linear(x.mean((2, 3)).float(), self.fc.weight, self.fc.bias)
        return torch.softmax(logits, dim=-1)


class JigsawClassifier(nn.Module):
    """The reference's ``jig_cls``: the global average in float32, a linear
    layer to ``jig_classes`` and a softmax.  NCHW in, ``(B, jig_classes)``
    float32 out."""

    def __init__(self, in_channels: int, gen: torch.Generator, jig_classes: int = 31):
        super().__init__()
        self.fc = make_linear(in_channels, jig_classes, gen)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        logits = F.linear(feat.float().mean((2, 3)), self.fc.weight, self.fc.bias)  # float32
        return torch.softmax(logits, dim=-1)


class DGFasterRCNNDetector(TwoStageDetector):
    """DANN domain-adversarial Faster R-CNN (reference ``faster_rcnn.py:47``)."""

    def _extract_for_loss(self, batch) -> Tuple[tuple, Dict[str, torch.Tensor]]:
        feats, d_pred = self.net.features_dg(self._tensor(batch["images"]))
        style = torch.argmax(self._tensor(batch["domain_label"]), dim=-1)
        logp = torch.log_softmax(d_pred, dim=-1)  # over the softmaxed prediction
        dl = -logp.gather(1, style[:, None])[:, 0].mean()
        return feats, {"loss_domain": DG_LOSS_WEIGHT * dl}


class JiGENFasterRCNNDetector(TwoStageDetector):
    """Jigsaw-auxiliary Faster R-CNN (reference ``faster_rcnn.py:382``)."""

    def _extract_for_loss(self, batch) -> Tuple[tuple, Dict[str, torch.Tensor]]:
        feats = self.net.features(self._tensor(batch["images"]))
        jig_pred = self.net.jig_out(self._tensor(batch["img_puzzle"]))
        y = self._tensor(batch["jig_labels"])
        p = torch.clamp(jig_pred, JIG_CLIP, 1.0 - JIG_CLIP)
        bce = -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p)).mean()
        return feats, {"loss_jig": DG_LOSS_WEIGHT * bce}


class DGaugFasterRCNNDetector(TwoStageDetector):
    """Style-augmented Faster R-CNN (reference ``faster_rcnn.py:544``):
    trains on ``img_aug`` where the batch has it."""

    def _extract_for_loss(self, batch) -> Tuple[tuple, Dict[str, torch.Tensor]]:
        images = batch["img_aug"] if "img_aug" in batch else batch["images"]
        return self.net.features(self._tensor(images)), {}
