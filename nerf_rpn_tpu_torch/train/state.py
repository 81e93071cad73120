"""Optimizer, schedule and gradient clipping (port of ``nerf_rpn_tpu/train/state.py``).

The JAX package trains with ``optax.chain(clip_by_global_norm_recorded,
adamw(cosine_onecycle_schedule))``.  The port keeps optax's arithmetic
where torch's stock pieces differ from it:

- the schedule is optax's piecewise cosine one-cycle (``onecycle_factor``,
  run as a ``LambdaLR``), not ``torch.optim.lr_scheduler.OneCycleLR``,
  which ends its phases one step earlier (at ``pct * T - 1`` and ``T - 1``);
- the clip is ``where(norm < max, g, g / norm * max)`` over the global norm
  (``clip_by_global_norm_``), not ``clip_grad_norm_``'s
  ``max / (norm + 1e-6)``; the pre-clip norm is the ``grad_norm`` metric;
- AdamW (b1 0.9, b2 0.999, eps 1e-8) decays every trained parameter, as
  optax's ``adamw`` does without a mask.

Under a process group the gradients are summed over the ranks before the
clip (``parallel.ddp.all_reduce_grads_``): each rank's loss is divided by
the global normalisers, so the sum is the gradient of the global batch,
and ``grad_norm`` is the global batch's.

With ``freeze_backbone`` the backbone's parameters are left out of the
optimizer (no update, no decay) and of the clip norm, as
``optax.multi_transform(..., set_to_zero)`` leaves them in the JAX CLI.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from nerf_rpn_tpu_torch.parallel import ddp


def onecycle_factor(step: int, total_steps: int, pct_start: float = 0.3,
                    div_factor: float = 25.0, final_div_factor: float = 1e4) -> float:
    """``optax.cosine_onecycle_schedule`` with peak 1 at ``step``, for
    ``transition_steps = max(total_steps, 4)`` (below 4 the warm-up phase
    rounds to no steps and optax divides 0 by 0)."""
    total = max(total_steps, 4)
    bounds = [0, int(pct_start * total), int(total)]
    values = [1.0 / div_factor, 1.0, 1.0 / (div_factor * final_div_factor)]
    if step >= bounds[-1]:
        return values[-1]
    for i in range(2):
        if bounds[i] <= step < bounds[i + 1]:
            pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
            start, end = values[i], values[i + 1]
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)
    raise ValueError(f"negative step {step}")


@torch.no_grad()
def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element, as a 0-dim tensor of
    f32 (f64 for f64 tensors) on the tensors' device (per-tensor norms in
    one ``foreach`` launch, then their norm).  On the CPU the norm kernels accumulate a
    million-entry tensor to only ~1e-4 relative, so there each tensor's sum
    of squares is a (cascaded) ``sum`` instead."""
    wide = [t.to(torch.promote_types(t.dtype, torch.float32)) for t in tensors]
    if tensors[0].device.type == "cpu":
        return torch.sqrt(torch.stack([torch.sum(t * t) for t in wide]).sum())
    norms = torch._foreach_norm(wide)
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's clip in place: ``g / norm * max`` where ``norm >= max``,
    ``g`` untouched (divided and multiplied by exactly 1) otherwise.

    Returns the pre-clip global norm.  No host sync: the branch is a
    ``where`` on the device, as it is under ``jit``.
    """
    norm = global_norm(grads)
    trigger = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(trigger, one, norm))
    torch._foreach_mul_(grads, torch.where(trigger, one, torch.full_like(norm, max_norm)))
    return norm


class TrainState:
    """The model, its optimizer and schedule, and the step count.

    ``params`` are the trained parameters: all of them, or only those
    outside the backbone with ``freeze_backbone``.
    """

    def __init__(self, model: torch.nn.Module, lr: float, total_steps: int,
                 weight_decay: float = 0.01, clip_grad_norm: float = 0.1,
                 pct_start: float = 0.3, freeze_backbone: bool = False):
        self.model = model
        self.clip_grad_norm = clip_grad_norm
        self.step = 0
        if freeze_backbone:
            for p in model.backbone.parameters():
                p.requires_grad_(False)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = torch.optim.AdamW(
            self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer,
            lambda s: onecycle_factor(s, total_steps, pct_start))

    def apply_gradients(self) -> torch.Tensor:
        """Sum the gradients over the ranks, clip, update, advance the
        schedule; returns the pre-clip norm."""
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise RuntimeError("a trained parameter received no gradient")
        ddp.all_reduce_grads_(grads)
        norm = clip_by_global_norm_(grads, self.clip_grad_norm)
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return norm
