"""PISA, prime sample attention (PyTorch port of
``boosting_rcnn_tpu/ops/pisa.py``; reference
``mmdet/models/losses/pisa_loss.py``: ``isr_p`` and ``carl_loss``).

Fixed-shape forms, as in the JAX package: the reference's sorts per
(label, gt) group become masked O(N^2) rank comparisons over the N
sampled slots (1024 at batch 2: a million comparisons), ties broken by
the slot index as a stable sort breaks them; invalid and padded slots
carry no weight.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["group_rank", "isr_p_weights", "carl_loss"]


def group_rank(values: torch.Tensor, same_group: torch.Tensor) -> torch.Tensor:
    """Descending rank of each of the ``(N,)`` ``values`` within its group
    (0: the largest), ``same_group[i, j]`` True where i and j share one;
    equal values rank by index (JAX ``_group_rank``)."""
    n = values.shape[0]
    vi, vj = values[:, None], values[None, :]
    idx = torch.arange(n, device=values.device)
    earlier = (vj > vi) | ((vj == vi) & (idx[None, :] < idx[:, None]))
    return (earlier & same_group).sum(1)


def isr_p_weights(labels: torch.Tensor, gt_ids: torch.Tensor, ious: torch.Tensor,
                  label_weights: torch.Tensor, pos_mask: torch.Tensor,
                  pos_loss_cls: torch.Tensor, k: float = 2.0,
                  bias: float = 0.0) -> torch.Tensor:
    """ISR-P, importance-based sample reweighting of the positives (the
    reference ``isr_p``, JAX ``isr_p_weights``): each positive's IoU rank
    within its (label, gt) group shifts its IoU to a hierarchical local
    rank, whose rank within its label gives the importance ``((max_l -
    rank) / max_l)``, raised to ``k`` after the ``bias``; the positives'
    new weights are rescaled so that their cross-entropy sum
    (``pos_loss_cls``, detached by the caller) is unchanged.  ``(N,)``
    each; the negatives keep ``label_weights``.  Two slots share a gt where
    their ``gt_ids`` are equal, whatever image they come from, as the
    caller gives them."""
    posf = pos_mask.float()
    same_label = (labels[:, None] == labels[None, :]) & pos_mask[None, :] & pos_mask[:, None]
    max_l_num = torch.clamp(same_label.sum(1).max(), min=1)
    same_gt = same_label & (gt_ids[:, None] == gt_ids[None, :])
    max_l = max_l_num.to(ious.dtype)
    t_rank = group_rank(ious, same_gt)
    ious_hlr = ious + (max_l - t_rank)
    l_rank = group_rank(ious_hlr, same_label)
    imp = (max_l - l_rank) / max_l_num
    pos_imp = label_weights * imp
    pos_imp = (bias + pos_imp * (1 - bias)) ** k
    ori = (pos_loss_cls * label_weights * posf).sum()
    new = torch.clamp((pos_loss_cls * pos_imp * posf).sum(), min=1e-12)
    pos_imp = pos_imp * ori / new
    return torch.where(pos_mask, pos_imp, label_weights)


def carl_loss(cls_score: torch.Tensor, labels: torch.Tensor, pos_mask: torch.Tensor,
              loss_reg_elem: torch.Tensor, k: float = 1.0, bias: float = 0.2,
              avg_factor: Optional[torch.Tensor] = None, sigmoid: bool = False) -> torch.Tensor:
    """CARL, the classification-aware regression loss (the reference
    ``carl_loss``, JAX ``carl_loss``): each positive's elementwise box loss
    ``(N, 4)`` weighted by ``(bias + (1 - bias) * p)**k``, ``p`` the
    float32 softmax (or sigmoid) probability of its label from the ``(N,
    C)`` logits, the weights renormalised to sum to the positives' count;
    the gradient reaches ``cls_score`` through the weights and through that
    normaliser.  Summed and divided by ``avg_factor`` (default N)."""
    c = cls_score.shape[-1]
    safe = torch.clamp(labels, 0, c - 1).long()
    x = cls_score.float()
    p = torch.sigmoid(x) if sigmoid else torch.softmax(x, dim=-1)
    pos_p = torch.gather(p, 1, safe[:, None])[:, 0]
    w = (bias + (1 - bias) * pos_p) ** k
    posf = pos_mask.float()
    n_pos = torch.clamp(posf.sum(), min=1.0)
    w = w * n_pos / torch.clamp((w * posf).sum(), min=1e-12)
    if avg_factor is None:
        avg_factor = loss_reg_elem.shape[0]
    return (loss_reg_elem * (w * posf)[:, None]).sum() / avg_factor
