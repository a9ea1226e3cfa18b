"""Denoising score-matching loss (port of ``fourierdiffusion_tpu/losses.py``).

Sample ``t ~ U[eps, T]`` and ``z ~ N(0, I)``, perturb ``x`` with the
per-frequency std, and regress the score against ``-z / std`` under one of
two weightings:

* default: ``lambda(t) = 1 / tr(Sigma^{-1})`` (one scalar per sample);
* likelihood weighting: ``|| Sigma^{1/2} (s - grad log p) ||^2``.

The draws are arguments: ``t`` comes from ``batch.timesteps`` and ``z`` is
passed in, or both are drawn from ``generator``, so a test can hand in the
draws that JAX made.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from fourierdiffusion_tpu_torch.data.batch import DiffusableBatch
from fourierdiffusion_tpu_torch.schedulers.sde import SDE

ScoreFn = Callable[[DiffusableBatch], torch.Tensor]


def draw_loss_noise(
    scheduler: SDE, x: torch.Tensor, generator: Optional[torch.Generator] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """``t`` ``(B,)`` uniform on ``[eps, T)`` and ``z`` standard normal like ``x``."""
    t = torch.rand(x.shape[0], generator=generator, device=x.device, dtype=x.dtype)
    t = t * (scheduler.T - scheduler.eps) + scheduler.eps
    z = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return t, z


def sde_loss(
    score_fn: ScoreFn,
    scheduler: SDE,
    batch: DiffusableBatch,
    *,
    z: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    reduce_mean: bool = True,
    likelihood_weighting: bool = False,
) -> torch.Tensor:
    """Scalar DSM loss of one mini-batch (batch mean).

    ``batch.timesteps`` and ``z`` are used when given; whichever is missing
    is drawn from ``generator``.
    """
    x = batch.X
    timesteps = batch.timesteps
    if timesteps is None or z is None:
        t_draw, z_draw = draw_loss_noise(scheduler, x, generator)
        timesteps = t_draw if timesteps is None else timesteps
        z = z_draw if z is None else z

    mean, std = scheduler.marginal_prob(x, timesteps)  # (B, L, C), (B, L)
    noise = std[..., None] * z
    target_noise = z / std[..., None]
    x_noisy = mean + noise
    score = score_fn(DiffusableBatch(X=x_noisy, y=batch.y, timesteps=timesteps))

    if not likelihood_weighting:
        weighting = 1.0 / torch.sum(1.0 / std**2, dim=1)  # (B,)
        losses = weighting[:, None, None] * torch.square(score + target_noise)
    else:
        losses = torch.square(std[..., None] * (score + target_noise))

    losses = losses.reshape(losses.shape[0], -1)
    if reduce_mean:
        losses = torch.mean(losses, dim=-1)
    else:
        losses = 0.5 * torch.sum(losses, dim=-1)
    return torch.mean(losses)


__all__ = ["draw_loss_noise", "sde_loss"]
