"""Exact top-k with the JAX package's tie order (PyTorch port).

Counterpart of ``boosting_rcnn_tpu/ops/topk.py::select_topk``, exact path
only (the approximate path is a TPU PartialReduce option, off on the
flagship).  ``lax.top_k`` breaks ties toward the lower index; a stable
descending sort does the same, where ``torch.topk`` promises no order.
"""
from __future__ import annotations

import torch


def select_topk(scores: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest scores along the last axis,
    in descending order, equal scores in index order.  ``k`` is clamped to
    the axis length."""
    k = min(k, scores.shape[-1])
    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
