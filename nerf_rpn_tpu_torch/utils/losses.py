"""Loss primitives of the anchor RPN (port of ``nerf_rpn_tpu/utils/losses.py``).

Elementwise smooth L1 (the beta form of ``F.smooth_l1_loss``) and binary
cross-entropy on logits, written as the JAX package writes them so that the
values agree to rounding.  The focal and IoU losses belong to FCOS and are
not ported yet.
"""

from __future__ import annotations

import torch


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth L1 (Huber / beta form); beta <= 0 is plain L1."""
    diff = (pred - target).abs()
    if beta <= 0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits (the stable form)."""
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
