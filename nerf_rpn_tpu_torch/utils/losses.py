"""Loss primitives of the RPN and FCOS heads (port of ``nerf_rpn_tpu/utils/losses.py``).

Elementwise smooth L1 (the beta form of ``F.smooth_l1_loss``), binary
cross-entropy on logits and the sigmoid focal loss of FCOS's
classification (torchvision's RetinaNet form), written as the JAX package
writes them so that the values agree to rounding.  FCOS's IoU losses on
distance-encoded boxes live in ``models/fcos.py``, as in the JAX package;
its ``iou_loss_aabb`` here is on no path of the port and is not copied.
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


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Elementwise sigmoid focal loss (RetinaNet form); ``alpha < 0`` drops
    the class weighting."""
    p = torch.sigmoid(logits)
    ce = bce_with_logits(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss
