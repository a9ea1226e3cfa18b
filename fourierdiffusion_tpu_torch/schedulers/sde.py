"""Continuous SDE noise schedulers, VP and VE (port of
``fourierdiffusion_tpu/schedulers/sde.py``).

Schedulers are frozen dataclasses of Python scalars; every method is plain
tensor code. The diagonal noise-scaling matrix ``G`` stays the length-L
vector ``g_vector``. The random draws are arguments: ``prior_sampling`` and
``step`` take the standard-normal ``z`` (or a ``torch.Generator`` to draw
it from), so a test can hand in the noise that JAX drew.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch


class SamplingOutput(NamedTuple):
    prev_sample: torch.Tensor


def g_vector(
    max_len: int,
    fourier_noise_scaling: bool,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Diagonal of G: all ones, or with Fourier noise scaling ``1/sqrt(2)``
    with DC (and Nyquist for even ``max_len``) kept at 1."""
    if not fourier_noise_scaling:
        return torch.ones(max_len, dtype=dtype, device=device)
    g = torch.full((max_len,), 1.0 / math.sqrt(2.0), dtype=dtype, device=device)
    g[0] = 1.0
    if max_len % 2 == 0:
        g[max_len // 2] = 1.0
    return g


def _as_tensor(t, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class SDE:
    """Base continuous SDE over ``t in [eps, T=1]``."""

    fourier_noise_scaling: bool = False
    eps: float = 1e-5

    @property
    def T(self) -> float:
        return 1.0

    def timesteps(
        self, num_diffusion_steps: int, dtype: torch.dtype = torch.float32,
        device: torch.device | str | None = None,
    ) -> torch.Tensor:
        """Descending time grid ``linspace(T, eps, K)``."""
        return torch.linspace(
            self.T, self.eps, num_diffusion_steps, dtype=dtype, device=device
        )

    def step_size(self, num_diffusion_steps: int) -> float:
        return (self.T - self.eps) / (num_diffusion_steps - 1)

    def g(self, max_len: int, like: torch.Tensor) -> torch.Tensor:
        return g_vector(max_len, self.fourier_noise_scaling, like.dtype, like.device)

    def marginal_prob(
        self, x: torch.Tensor, t: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Mean ``(B, L, C)`` and per-frequency std ``(B, L)`` of
        ``p(x(t) | x(0))`` for times ``t`` of shape ``(B,)``."""
        raise NotImplementedError

    def prior_sampling(
        self,
        shape: tuple[int, ...],
        *,
        z: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.float32,
        device: torch.device | str | None = None,
    ) -> torch.Tensor:
        """``G z`` with ``z ~ N(0, I)``; ``z`` is drawn from ``generator``
        unless given."""
        if z is None:
            z = torch.randn(shape, generator=generator, dtype=dtype, device=device)
        return self.g(shape[-2], z)[:, None] * z

    def _diffusion_vec(self, timestep, like: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def reverse_drift_sde(self, model_output, timestep, sample) -> torch.Tensor:
        """Reverse-SDE drift ``f(x,t) - G G^T score``."""
        raise NotImplementedError

    def reverse_drift_ode(self, model_output, timestep, sample) -> torch.Tensor:
        """Probability-flow ODE drift ``f(x,t) - 1/2 G G^T score``."""
        raise NotImplementedError

    def step(
        self,
        model_output: torch.Tensor,
        timestep,
        sample: torch.Tensor,
        step_size: float,
        *,
        z: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> SamplingOutput:
        """One reverse Euler–Maruyama step; ``z`` is the standard-normal
        draw (from ``generator`` unless given)."""
        if z is None:
            z = torch.randn(
                sample.shape, generator=generator, dtype=sample.dtype,
                device=sample.device,
            )
        diffusion = self._diffusion_vec(timestep, sample)
        drift = self.reverse_drift_sde(model_output, timestep, sample)
        x = sample - drift * step_size + math.sqrt(step_size) * diffusion[:, None] * z
        return SamplingOutput(prev_sample=x)

    def ode_step(
        self, model_output, timestep, sample, step_size: float
    ) -> SamplingOutput:
        drift = self.reverse_drift_ode(model_output, timestep, sample)
        return SamplingOutput(prev_sample=sample - drift * step_size)


@dataclasses.dataclass(frozen=True)
class VEScheduler(SDE):
    """Variance-exploding SDE."""

    sigma_min: float = 0.01
    sigma_max: float = 50.0

    def marginal_prob(self, x, t):
        sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
        return x, sigma[:, None] * self.g(x.shape[-2], x)[None, :]

    def prior_sampling(self, shape, **kwargs) -> torch.Tensor:
        return self.sigma_max * super().prior_sampling(shape, **kwargs)

    def _diffusion_vec(self, timestep, like):
        t = _as_tensor(timestep, like)
        sqrt_derivative = (
            self.sigma_min
            * math.sqrt(2.0 * math.log(self.sigma_max / self.sigma_min))
            * (self.sigma_max / self.sigma_min) ** t
        )
        return sqrt_derivative * self.g(like.shape[-2], like)

    def reverse_drift_sde(self, model_output, timestep, sample):
        diffusion = self._diffusion_vec(timestep, sample)
        return -(diffusion**2)[:, None] * model_output

    def reverse_drift_ode(self, model_output, timestep, sample):
        diffusion = self._diffusion_vec(timestep, sample)
        return -0.5 * (diffusion**2)[:, None] * model_output


@dataclasses.dataclass(frozen=True)
class VPScheduler(SDE):
    """Variance-preserving SDE (the default)."""

    beta_min: float = 0.1
    beta_max: float = 20.0

    def _log_mean_coeff(self, t):
        return -0.25 * t**2 * (self.beta_max - self.beta_min) - 0.5 * t * self.beta_min

    def marginal_prob(self, x, t):
        lmc = self._log_mean_coeff(t)
        mean = torch.exp(lmc)[:, None, None] * x
        std = torch.sqrt(1.0 - torch.exp(2.0 * lmc))[:, None] * self.g(
            x.shape[-2], x
        )[None, :]
        return mean, std

    def beta(self, timestep):
        return self.beta_min + timestep * (self.beta_max - self.beta_min)

    def _diffusion_vec(self, timestep, like):
        beta = self.beta(_as_tensor(timestep, like))
        return torch.sqrt(beta) * self.g(like.shape[-2], like)

    def reverse_drift_sde(self, model_output, timestep, sample):
        beta = self.beta(_as_tensor(timestep, sample))
        diffusion = self._diffusion_vec(timestep, sample)
        return -0.5 * beta * sample - (diffusion**2)[:, None] * model_output

    def reverse_drift_ode(self, model_output, timestep, sample):
        beta = self.beta(_as_tensor(timestep, sample))
        diffusion = self._diffusion_vec(timestep, sample)
        return -0.5 * beta * sample - 0.5 * (diffusion**2)[:, None] * model_output


__all__ = ["SDE", "SamplingOutput", "VEScheduler", "VPScheduler", "g_vector"]
