"""Fixed-size random RoI sampling (PyTorch port).

Counterpart of ``SampleResult``, ``_rank_within`` and ``random_sample`` in
``boosting_rcnn_tpu/ops/samplers.py``: ``num`` slots per image, sampled
positives first (in random order), then sampled negatives, then invalid
padding.  The randomness is two uniform vectors, one ranking the
positives and one the negatives.  ``random_sample`` draws them from a
``torch.Generator``; ``random_sample_from_uniforms`` takes them as
arguments, so that a caller holding the JAX package's own draws gets the
identical sample.  ``score_hlr_sample`` is the JAX package's
ScoreHLRSampler rule (hard negatives by score), the same way.  Every sort
is stable, as ``jnp.argsort`` is.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .assigners import AssignResult

__all__ = ["SampleResult", "random_sample", "random_sample_from_uniforms", "score_hlr_sample"]

BIG = 2 ** 30


class SampleResult(NamedTuple):
    """Fixed ``(num,)``-slot sampling output of one image."""

    inds: torch.Tensor  # (num,) int64 index into the candidates
    is_pos: torch.Tensor  # (num,) bool
    valid: torch.Tensor  # (num,) bool: the slot holds a real sample
    gt_inds: torch.Tensor  # (num,) int64 0-based assigned gt (positive slots)
    num_pos: torch.Tensor  # () int64
    num_neg: torch.Tensor  # () int64


def _rank_within(mask: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """0-based rank of each ``mask`` row by ``key`` (others get ``BIG``)."""
    k = torch.where(mask, key, torch.full_like(key, float("inf")))
    order = torch.argsort(k, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(order.shape[0], device=order.device)
    return torch.where(mask, ranks, torch.full_like(ranks, BIG))


def random_sample(
    assign: AssignResult,
    cand_valid: torch.Tensor,
    num: int = 512,
    pos_fraction: float = 0.25,
    neg_pos_ub: int = -1,
    generator: Optional[torch.Generator] = None,
) -> SampleResult:
    """Sample ``num`` slots with uniforms drawn from ``generator`` (the
    default generator of the candidates' device when None)."""
    n = assign.gt_inds.shape[0]
    dev = generator.device if generator is not None else cand_valid.device
    u = torch.rand((2, n), generator=generator, device=dev).to(cand_valid.device)
    return random_sample_from_uniforms(assign, cand_valid, u[0], u[1], num,
                                       pos_fraction, neg_pos_ub)


def random_sample_from_uniforms(
    assign: AssignResult,
    cand_valid: torch.Tensor,
    u_pos: torch.Tensor,
    u_neg: torch.Tensor,
    num: int = 512,
    pos_fraction: float = 0.25,
    neg_pos_ub: int = -1,
) -> SampleResult:
    """Up to ``int(num * pos_fraction)`` positives (truncated, as the
    reference's ``BaseSampler``), then negatives up to ``num``, ranked by
    the ``(N,)`` uniforms ``u_pos`` and ``u_neg``.  ``assign.gt_inds`` uses
    the -1/0/i+1 code; candidates with ``cand_valid`` False are never
    sampled."""
    num_expected_pos = int(num * pos_fraction)
    pos_mask = (assign.gt_inds > 0) & cand_valid
    neg_mask = (assign.gt_inds == 0) & cand_valid
    pos_rank = _rank_within(pos_mask, u_pos)
    neg_rank = _rank_within(neg_mask, u_neg)

    num_pos = torch.clamp(pos_mask.sum(), max=num_expected_pos)
    num_neg_expected = num - num_pos
    if neg_pos_ub >= 0:
        num_neg_expected = torch.minimum(
            num_neg_expected, torch.clamp(neg_pos_ub * num_pos, min=1))
    return _assemble(assign, pos_mask & (pos_rank < num_expected_pos), pos_rank,
                     neg_mask & (neg_rank < num_neg_expected), neg_rank, num)


def _assemble(assign: AssignResult, sel_pos, pos_rank, sel_neg, neg_rank, num: int):
    """The slots of the selected positives in the order of ``pos_rank``, then
    of the selected negatives in the order of ``neg_rank``, then invalid
    padding (JAX ``_assemble``).  Each rank counts from 0 over its selected
    rows: a rank over a larger set does, where those rows come first."""
    num_pos, num_neg = sel_pos.sum(), sel_neg.sum()
    big = torch.full_like(pos_rank, BIG)
    key = torch.where(sel_pos, pos_rank, torch.where(sel_neg, num_pos + neg_rank, big))
    order = torch.argsort(key, stable=True)[:num]
    slot_key = key[order]
    valid = slot_key < BIG
    inds = torch.where(valid, order, torch.zeros_like(order))
    is_pos = valid & (slot_key < num_pos)
    gt_inds = torch.where(is_pos, assign.gt_inds[inds] - 1, torch.zeros_like(inds))
    return SampleResult(inds, is_pos, valid, gt_inds, num_pos, num_neg)


def score_hlr_sample(assign: AssignResult, cand_valid: torch.Tensor, neg_scores: torch.Tensor,
                     u_pos: torch.Tensor, u_neg: torch.Tensor, num: int = 512,
                     pos_fraction: float = 0.25, score_fraction: float = 0.5) -> SampleResult:
    """The ScoreHLRSampler's sampling rule as the JAX package has it (JAX
    ``score_hlr_sample``; on no detector path there, nor here: the PISA
    configs' ``ScoreHLRSampler`` is read as the random sampler): up to
    ``int(num * pos_fraction)`` positives ranked by ``u_pos``; of the
    negatives expected, a ``score_fraction`` share the highest
    ``neg_scores`` (``(N,)``, each candidate's largest foreground
    probability), the rest ranked by ``u_neg`` (the JAX function's two
    draws, ``(N,)`` uniforms)."""
    num_expected_pos = int(num * pos_fraction)
    pos_mask = (assign.gt_inds > 0) & cand_valid
    neg_mask = (assign.gt_inds == 0) & cand_valid
    pos_rank = _rank_within(pos_mask, u_pos)
    sel_pos = pos_mask & (pos_rank < num_expected_pos)
    num_neg_expected = num - sel_pos.sum()
    n_hard = (num_neg_expected.float() * score_fraction).long()
    hard_rank = _rank_within(neg_mask, -neg_scores)
    sel_hard = neg_mask & (hard_rank < n_hard)
    rand_rank = _rank_within(neg_mask & ~sel_hard, u_neg)
    sel_rand = neg_mask & ~sel_hard & (rand_rank < num_neg_expected - n_hard)
    sel_neg = sel_hard | sel_rand
    neg_key = torch.where(sel_hard, hard_rank.float(), 1e6 + rand_rank.float())
    return _assemble(assign, sel_pos, pos_rank, sel_neg, _rank_within(sel_neg, neg_key), num)
