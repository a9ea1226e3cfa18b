"""Optimiser and learning-rate schedule (port of
``fourierdiffusion_tpu/training/optim.py``).

The update is optax's ``chain(clip_by_global_norm(c), adamw(schedule, b1=0.9,
b2=0.999, eps=1e-8, weight_decay=0.01))`` written out in plain tensor code:

* clip: ``g * c / norm`` where the global norm is at least ``c``, ``g``
  otherwise (not ``torch.nn.utils.clip_grad_norm_``, which divides by
  ``norm + 1e-6``);
* Adam moments with bias correction, ``eps`` outside the square root;
* decoupled weight decay on every parameter, scaled by the learning rate;
* the learning rate of update ``k`` (counted from 0) is ``schedule(k)``,
  so the first update has rate 0, as optax evaluates its schedule at count 0.

``MultiSteps(inner, every_k)`` is optax's ``MultiSteps`` (gradient
accumulation): the gradients of ``every_k`` micro-steps are averaged, as a
running mean ``acc + (g - acc) / (mini_step + 1)``, and the inner clip and
AdamW run once, on the ``every_k``-th micro-step, so the inner count (and
with it the schedule) advances once per application.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

Schedule = Callable[[int], float]


def cosine_warmup_schedule(lr_max: float, num_training_steps: int) -> Schedule:
    """Linear warmup from 0 over ``max(1, N // 10)`` steps, then cosine decay
    to 0 reached at step ``max(2, N)`` (optax ``warmup_cosine_decay_schedule``)."""
    warmup = max(1, num_training_steps // 10)
    decay_steps = max(2, num_training_steps) - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return lr_max * count / warmup
        done = min(count - warmup, decay_steps)
        return lr_max * 0.5 * (1.0 + math.cos(math.pi * done / decay_steps))

    return schedule


class AdamW:
    """Global-norm clipping followed by AdamW, over a fixed list of tensors.

    ``step(grads)`` updates the parameters in place (under ``no_grad``) and
    returns the learning rate it used. ``state_dict``/``load_state_dict``
    copy the moments and the count, for the trainer's rollback snapshots.
    """

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        schedule: Schedule,
        *,
        gradient_clip_val: float = 1.0,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.01,
    ) -> None:
        self.params = list(params)
        self.schedule = schedule
        self.gradient_clip_val = gradient_clip_val
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> float:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        grads = clip_by_global_norm(grads, self.gradient_clip_val)
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - self.b1**self.count
        bc2 = 1.0 - self.b2**self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            update = update + self.weight_decay * p
            p.sub_(lr * update)
        return lr

    def state_dict(self) -> dict:
        return {
            "count": self.count,
            "mu": [m.clone() for m in self.mu],
            "nu": [v.clone() for v in self.nu],
        }

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)


class MultiSteps:
    """Gradient accumulation over ``every_k`` micro-steps (optax
    ``MultiSteps`` with a constant ``every_k_schedule``). ``step(grads)``
    returns whether the inner optimiser was applied. The accumulator and the
    mini-step are part of ``state_dict``, so they persist across epochs, the
    trainer's rollback snapshots and the ``last`` checkpoint."""

    def __init__(self, inner: AdamW, every_k: int) -> None:
        if every_k < 1:
            raise ValueError(f"every_k must be at least 1, got {every_k}")
        self.inner = inner
        self.every_k = int(every_k)
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = [torch.zeros_like(p) for p in inner.params]

    @property
    def count(self) -> int:
        return self.inner.count

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> bool:
        if len(grads) != len(self.acc):
            raise ValueError(f"{len(grads)} gradients for {len(self.acc)} parameters")
        for a, g in zip(self.acc, grads):
            a.add_((g - a) / (self.mini_step + 1))
        if self.mini_step < self.every_k - 1:
            self.mini_step += 1
            return False
        self.inner.step(self.acc)
        for a in self.acc:
            a.zero_()
        self.mini_step = 0
        self.gradient_step += 1
        return True

    def state_dict(self) -> dict:
        return {
            "mini_step": self.mini_step,
            "gradient_step": self.gradient_step,
            "acc": [a.clone() for a in self.acc],
            "inner": self.inner.state_dict(),
        }

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])
        for dst, src in zip(self.acc, state["acc"]):
            dst.copy_(src)
        self.inner.load_state_dict(state["inner"])


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """optax's rule: scale by ``max_norm / norm`` only where ``norm >= max_norm``."""
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    keep = norm < max_norm  # a tensor: no host synchronisation
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


def make_optimizer(
    params: Iterable[torch.Tensor],
    lr_max: float,
    num_training_steps: int,
    *,
    gradient_clip_val: float = 1.0,
    weight_decay: float = 0.01,
    accumulate_grad_batches: int = 1,
) -> AdamW | MultiSteps:
    """Clip + AdamW on the warmup-cosine schedule; with
    ``accumulate_grad_batches`` above 1, wrapped in ``MultiSteps``."""
    optimizer = AdamW(
        params,
        cosine_warmup_schedule(lr_max, num_training_steps),
        gradient_clip_val=gradient_clip_val,
        weight_decay=weight_decay,
    )
    if accumulate_grad_batches > 1:
        return MultiSteps(optimizer, accumulate_grad_batches)
    return optimizer


__all__ = ["AdamW", "MultiSteps", "clip_by_global_norm", "cosine_warmup_schedule",
           "make_optimizer"]
