"""The ``optax`` pieces the trainers use, over lists of f32 tensors.

Counterparts of ``optax.warmup_cosine_decay_schedule``,
``clip_by_global_norm``, ``adamw``, ``adam`` and
``softmax_cross_entropy_with_integer_labels`` with optax's arithmetic, not
``torch.optim``'s:

- a schedule is read at the update count *before* the update, so a warmup
  from 0 makes the first update's learning rate 0;
- ``clip_by_global_norm`` leaves the gradients alone while their norm is
  below ``max_norm`` and otherwise computes ``g / norm * max_norm``
  (``clip_grad_norm_`` adds 1e-6 to the norm and scales always);
- weight decay applies to every tensor, LayerNorms and biases included,
  inside the update before the learning rate scales it:
  ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.

The learning rate is a host number (the step count is the host's), and the
clip's trigger stays on the device: an update makes no host read.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

__all__ = [
    "Adam", "adam", "adamw", "clip_by_global_norm", "softmax_cross_entropy_with_integer_labels",
    "warmup_cosine_decay_schedule",
]

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int, end_value: float = 0.0,
) -> Schedule:
    """Linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at ``decay_steps``
    (which counts the warmup).  ``warmup_steps <= 0`` starts at the peak."""
    if not decay_steps - warmup_steps > 0:
        msg = f"the cosine decay needs positive decay_steps, got {decay_steps - warmup_steps}"
        raise ValueError(msg)
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    f32 = np.float32

    def schedule(count: int) -> float:
        # In f32 and in optax's order of operations.
        if count < warmup_steps:
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        t = f32(min(count - warmup_steps, cosine_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / f32(cosine_steps)))
        decayed = f32(1 - alpha) * cosine + f32(alpha)
        return float(f32(peak_value) * decayed)

    return schedule


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Clip ``grads`` in place to ``max_norm`` of their global norm, as
    optax does; returns the norm before clipping (a device scalar)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    below = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    torch._foreach_div_(grads, torch.where(below, one, norm))
    torch._foreach_mul_(grads, torch.where(below, one, one * max_norm))
    return norm


@dataclass
class Adam:
    """Adam with optax's arithmetic over a list of f32 tensors, updated in
    place: ``scale_by_adam``, then (``weight_decay``) ``+ wd * p``, then
    ``* -lr(count)``.  ``clip`` (optax's ``chain(clip_by_global_norm,
    ...)``) clips the gradients first."""

    params: list[torch.Tensor]
    lr: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip: float | None = None
    count: int = 0
    mu: list[torch.Tensor] = field(init=False)
    nu: list[torch.Tensor] = field(init=False)

    def __post_init__(self) -> None:
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        """One update from ``grads`` (consumed: clipped and scaled in place)."""
        if self.clip is not None:
            clip_by_global_norm(grads, self.clip)
        lr = self.lr(self.count)
        self.count += 1
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - self.b1))
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - self.b2))
        # The bias corrections in f32, as optax computes 1 - b**count.
        c1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(self.count))
        updates = torch._foreach_div(self.mu, c1)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, c2))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(updates, denom)
        if self.weight_decay:
            torch._foreach_add_(updates, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(self.params, updates)


def adamw(
    params: list[torch.Tensor], lr: Schedule, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
    weight_decay: float = 1e-4, clip: float | None = None,
) -> Adam:
    """``optax.adamw`` (optionally chained after ``clip_by_global_norm``)."""
    return Adam(params, lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, clip=clip)


def adam(params: list[torch.Tensor], lr: float) -> Adam:
    """``optax.adam`` at a constant learning rate and optax's defaults."""
    return Adam(params, lambda count: lr)


def softmax_cross_entropy_with_integer_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logsumexp(logits) - logits[label]`` over the last axis."""
    label_logits = logits.gather(-1, labels[..., None].to(torch.int64))[..., 0]
    return torch.logsumexp(logits, dim=-1) - label_logits
