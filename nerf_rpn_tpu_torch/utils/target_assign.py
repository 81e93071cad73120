"""Anchor <-> gt matching and balanced fg / bg sampling (port of
``nerf_rpn_tpu/utils/target_assign.py``).

``match_anchors`` is exact against the JAX package: the first gt index on
argmax ties, the low-quality force-match by exact IoU equality, and padded
gt rows (``gt_valid`` False) that never win and never force-match.

``sample_balanced_indices`` keeps the JAX budgets (``num_pos = min(#pos,
int(batch * fraction))``, ``num_neg = min(#neg, batch - num_pos)``, K =
min(batch, N) slots, ``take`` ANDed with eligibility) and picks the
eligible anchors with the lowest random priorities, ties to the lowest
index.  The priorities come from an explicit ``torch.Generator``; they
cannot equal ``jax.random``'s bits, so a caller may pass them instead.
"""

from __future__ import annotations

import torch

from nerf_rpn_tpu_torch.ops.topk import safe_top_k

BELOW_LOW_THRESHOLD = -1
BETWEEN_THRESHOLDS = -2


def match_anchors(iou: torch.Tensor, gt_valid: torch.Tensor, high_threshold: float,
                  low_threshold: float, allow_low_quality: bool = True) -> torch.Tensor:
    """(G, N) IoU, (G,) bool -> (N,) int64: gt index, -1 background or
    -2 ignore."""
    masked = torch.where(gt_valid[:, None], iou, -1.0)
    matched_vals = masked.amax(dim=0)
    matches = masked.argmax(dim=0)  # first maximal index on ties
    labels = torch.where(matched_vals < low_threshold, BELOW_LOW_THRESHOLD, matches)
    labels = torch.where((matched_vals >= low_threshold) & (matched_vals < high_threshold),
                         BETWEEN_THRESHOLDS, labels)
    if allow_low_quality:
        # each valid gt: every anchor tied at that gt's best IoU gets its
        # own pre-threshold argmax match back
        best_per_gt = torch.where(gt_valid[:, None], iou, -torch.inf).amax(dim=1)
        is_best = (iou == best_per_gt[:, None]) & gt_valid[:, None]
        labels = torch.where(is_best.any(dim=0), matches, labels)
    return labels


def sample_balanced_indices(matches: torch.Tensor, batch_size: int, positive_fraction: float,
                            generator: torch.Generator | None = None,
                            priorities: tuple[torch.Tensor, torch.Tensor] | None = None):
    """(B, N) matches -> ``(pos_idx, pos_take, neg_idx, neg_take)``, each
    (B, K) with K = min(batch_size, N): anchor indices and whether each
    slot counts (untaken slots point at arbitrary anchors).

    ``priorities``: (pos, neg) uniform [0, 1) tensors of shape (B, N); when
    absent they are drawn from ``generator`` on the matches' device.
    """
    b, n = matches.shape
    is_pos = matches >= 0
    is_neg = matches == BELOW_LOW_THRESHOLD
    num_pos = is_pos.sum(-1).clamp_max(int(batch_size * positive_fraction))
    num_neg = torch.minimum(is_neg.sum(-1), batch_size - num_pos)
    k_sel = min(batch_size, n)
    if priorities is None:
        if generator is None:
            raise ValueError("sample_balanced_indices needs a generator or priorities")
        priorities = tuple(torch.rand((b, n), generator=generator, device=matches.device)
                           for _ in range(2))

    def pick(prio, mask, budget):
        # uniforms are < 1, so the sentinel 2 sorts every ineligible
        # anchor after the eligible ones
        _, idx = safe_top_k(-torch.where(mask, prio, 2.0), k_sel)
        take = torch.arange(k_sel, device=matches.device)[None, :] < budget[:, None]
        return idx, take & torch.gather(mask, 1, idx)

    pos_idx, pos_take = pick(priorities[0], is_pos, num_pos)
    neg_idx, neg_take = pick(priorities[1], is_neg, num_neg)
    return pos_idx, pos_take, neg_idx, neg_take
