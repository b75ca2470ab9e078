"""ProbRoIHead, inference (PyTorch port of
``boosting_rcnn_tpu/models/roi_heads/prob_roi_head.py``).

At test time the R-CNN class probabilities are fused with the RPN prior:
``sqrt(softmax(cls) * prior)``.  Sampling and the boosting loss are not
ported yet.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ProbRoICfg:
    """The inference part of the JAX ``ProbRoICfg``."""

    prob: bool = True


def prob_fuse_scores(cls_score: torch.Tensor, prior: torch.Tensor) -> torch.Tensor:
    """``sqrt(softmax(cls) * prior)`` over ``(..., R, K+1)`` logits and
    ``(..., R)`` priors."""
    p = torch.softmax(cls_score.float(), dim=-1)
    return torch.sqrt(torch.clamp(p * prior[..., None], min=0.0))
