"""Reverse-diffusion sampler (port of the ``em``/``ode`` part of
``fourierdiffusion_tpu/sampling/sampler.py``).

``reverse_diffusion`` is the low-level loop: it takes the prior ``x_T``
and, for ``em``, the per-step standard-normal draws ``z`` (or a
``torch.Generator`` to draw them from), so a test can replay the noise JAX
drew. ``make_sample_fn`` and ``DiffusionSampler`` draw both from a
generator. For a ``ScoreTransformer`` on CUDA the fused forward (one
kernel launch per encoder layer and step) is selected automatically, as
the JAX sampler selects its Pallas path on the TPU. The K steps run as a
Python loop. The predictor-corrector method, the divergence guard and
CUDA-graph capture of the loop are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from fourierdiffusion_tpu_torch import resolve_device
from fourierdiffusion_tpu_torch.models.fused import (
    fused_score_forward,
    pack_score_transformer,
)
from fourierdiffusion_tpu_torch.models.score_models import ScoreTransformer
from fourierdiffusion_tpu_torch.schedulers.sde import SDE

METHODS = ("em", "ode")
ScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _clip_score(
    scheduler: SDE, score: torch.Tensor, t: torch.Tensor, score_clip: Optional[float]
) -> torch.Tensor:
    """Clamp the score to ``+-score_clip / std(t)`` per frequency."""
    if score_clip is None:
        return score
    _, std = scheduler.marginal_prob(score[:1] * 0, t.reshape(1).to(score.dtype))
    bound = score_clip / torch.clamp(std[0], min=1e-6)  # (L,)
    return torch.clamp(score, -bound[:, None], bound[:, None])


@torch.no_grad()
def reverse_diffusion(
    score_fn: ScoreFn,
    scheduler: SDE,
    x_T: torch.Tensor,
    *,
    num_diffusion_steps: int,
    method: str = "em",
    score_clip: Optional[float] = None,
    z: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Run the K reverse steps from ``x_T`` ``(B, L, C)``.

    ``z`` ``(K, B, L, C)`` holds the ``em`` noise of every step; without it
    each step draws from ``generator``. ``ode`` draws nothing.
    """
    if method not in METHODS:
        raise ValueError(f"Unknown sampling method: {method!r}")
    if z is not None and tuple(z.shape) != (num_diffusion_steps, *x_T.shape):
        raise ValueError(f"z must be (K, *x_T.shape), got {tuple(z.shape)}")
    timesteps = scheduler.timesteps(num_diffusion_steps, device=x_T.device)
    step_size = scheduler.step_size(num_diffusion_steps)
    x = x_T
    for i in range(num_diffusion_steps):
        t = timesteps[i]
        t_vec = t.expand(x.shape[0]).to(x.dtype)
        score = _clip_score(scheduler, score_fn(x, t_vec), t, score_clip)
        if method == "ode":
            x = scheduler.ode_step(score, t, x, step_size).prev_sample
        else:
            zi = None if z is None else z[i]
            x = scheduler.step(score, t, x, step_size, z=zi, generator=generator).prev_sample
    return x


def _score_fn(model: ScoreTransformer, fused: bool) -> ScoreFn:
    if not fused:
        return model
    packed = pack_score_transformer(model)
    return lambda x, t: fused_score_forward(model, packed, x, t)


def make_sample_fn(
    model: ScoreTransformer,
    scheduler: SDE,
    *,
    num_diffusion_steps: int,
    batch_size: int,
    max_len: int,
    n_channels: int,
    fused: Optional[bool] = None,
    method: str = "em",
    score_clip: Optional[float] = None,
    device: str | torch.device = "cuda",
) -> Callable[[torch.Generator], torch.Tensor]:
    """Return ``sample(generator) -> (batch_size, max_len, n_channels)``.

    The model must already live on ``device``. ``fused=None`` takes the
    fused forward for a ``ScoreTransformer`` on CUDA and the module's own
    forward elsewhere. The weights are packed at each call, so a changed
    model is picked up.
    """
    dev = resolve_device(device)
    if method not in METHODS:
        raise ValueError(f"Unknown sampling method: {method!r}")
    if fused is None:
        fused = isinstance(model, ScoreTransformer) and dev.type == "cuda"
    if fused and not isinstance(model, ScoreTransformer):
        raise ValueError(f"fused sampling unsupported for {type(model).__name__}")
    shape = (batch_size, max_len, n_channels)

    def sample(generator: torch.Generator) -> torch.Tensor:
        with torch.no_grad():
            x_T = scheduler.prior_sampling(shape, generator=generator, device=dev)
            return reverse_diffusion(
                _score_fn(model, fused), scheduler, x_T,
                num_diffusion_steps=num_diffusion_steps, method=method,
                score_clip=score_clip, generator=generator,
            )

    return sample


class DiffusionSampler:
    """Batched sampling; the number of batches rounds up and the output is
    trimmed to exactly ``num_samples``.

    Moves ``model`` to ``device`` and puts it in eval mode.
    """

    def __init__(
        self,
        model: ScoreTransformer,
        scheduler: SDE,
        *,
        max_len: int,
        n_channels: int,
        sample_batch_size: int = 200,
        method: str = "em",
        score_clip: Optional[float] = None,
        fused: Optional[bool] = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.scheduler = scheduler
        self.max_len = max_len
        self.n_channels = n_channels
        self.sample_batch_size = sample_batch_size
        self.method = method
        self.score_clip = score_clip
        self.fused = fused

    def sample(
        self,
        num_samples: int,
        num_diffusion_steps: int = 1000,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``num_samples`` series ``(num_samples, max_len, n_channels)``."""
        if generator is None:
            generator = torch.Generator(device=self.device)
        batch = min(self.sample_batch_size, num_samples)
        fn = make_sample_fn(
            self.model, self.scheduler,
            num_diffusion_steps=num_diffusion_steps, batch_size=batch,
            max_len=self.max_len, n_channels=self.n_channels, fused=self.fused,
            method=self.method, score_clip=self.score_clip, device=self.device,
        )
        outs = [fn(generator) for _ in range(-(-num_samples // batch))]
        return torch.cat(outs, dim=0)[:num_samples]


__all__ = ["DiffusionSampler", "make_sample_fn", "reverse_diffusion"]
