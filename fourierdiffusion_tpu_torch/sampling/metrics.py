"""Sample-quality metrics: sliced and marginal Wasserstein collections
(port of ``fourierdiffusion_tpu/sampling/metrics.py``).

``MetricCollection`` duplicates each metric for the time and frequency
domains (keys prefixed ``time_`` / ``freq_``), optionally adds baselines
(half of the originals against the other half, ``_self``, and the mean
sample, ``_dummy``) and a spectral-density ``MarginalWasserstein``
(``spectral_`` prefix), and returns the result sorted by key, so its
results carry the JAX package's ``results.yaml`` keys. The samples are
held as numpy arrays, as in the JAX package; the transforms and distances
run in torch on ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Optional

import numpy as np
import torch

from fourierdiffusion_tpu_torch.ops.fourier import dft, spectral_density
from fourierdiffusion_tpu_torch.ops.wasserstein import (
    _f32,
    check_flat_array,
    marginal_w2,
    sliced_w2,
)


class Metric(ABC):
    def __init__(self, original_samples) -> None:
        self.original_samples = check_flat_array(original_samples)

    @abstractmethod
    def __call__(self, other_samples) -> dict[str, Any]: ...

    @property
    @abstractmethod
    def name(self) -> str: ...

    @property
    def baseline_metrics(self) -> dict[str, float]:
        return {}


class _DistanceMetric(Metric):
    """The mean and max of a vector of W2 distances (``<name>_mean``,
    ``<name>_max``, with ``save_all_distances`` also ``<name>_all``), and
    the baselines: half of the originals against the other half
    (``_self``) and the originals against their mean (``_dummy``)."""

    save_all_distances: bool

    @abstractmethod
    def _distances(self, a: np.ndarray, b: np.ndarray) -> np.ndarray: ...

    def __call__(self, other_samples) -> dict[str, Any]:
        d = self._distances(self.original_samples, check_flat_array(other_samples))
        out: dict[str, Any] = {f"{self.name}_mean": float(np.mean(d)),
                               f"{self.name}_max": float(np.max(d))}
        if self.save_all_distances:
            out[f"{self.name}_all"] = d.tolist()
        return out

    @property
    def baseline_metrics(self) -> dict[str, float]:
        n = self.original_samples.shape[0]
        avg = np.mean(self.original_samples, axis=0, keepdims=True)
        out = {}
        for tag, (a, b) in (("self", (self.original_samples[: n // 2],
                                      self.original_samples[n // 2:])),
                            ("dummy", (self.original_samples, avg))):
            d = self._distances(a, b)
            out[f"{self.name}_mean_{tag}"] = float(np.mean(d))
            out[f"{self.name}_max_{tag}"] = float(np.max(d))
        return out


class SlicedWasserstein(_DistanceMetric):
    """W2 over random unit projections."""

    def __init__(
        self,
        original_samples,
        random_seed: int,
        num_directions: int,
        save_all_distances: bool = False,
        normalisation: str = "none",
        device: torch.device | str = "cuda",
    ) -> None:
        super().__init__(original_samples)
        self.random_seed = random_seed
        self.num_directions = num_directions
        self.save_all_distances = save_all_distances
        self.normalisation = normalisation
        self.device = device

    def _distances(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return sliced_w2(a, b, num_directions=self.num_directions, seed=self.random_seed,
                         normalisation=self.normalisation, device=self.device)

    @property
    def name(self) -> str:
        return "sliced_wasserstein"


class MarginalWasserstein(_DistanceMetric):
    """W2 per flattened feature (``random_seed`` is kept for the JAX
    package's signature; nothing is drawn)."""

    def __init__(
        self,
        original_samples,
        random_seed: int,
        save_all_distances: bool = False,
        normalisation: str = "none",
        device: torch.device | str = "cuda",
    ) -> None:
        super().__init__(original_samples)
        self.random_seed = random_seed
        self.save_all_distances = save_all_distances
        self.normalisation = normalisation
        self.device = device

    def _distances(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return marginal_w2(a, b, normalisation=self.normalisation, device=self.device)

    @property
    def name(self) -> str:
        return "marginal_wasserstein"


class MetricCollection:
    """The time, frequency and spectral composition of the metrics.

    ``metric_factories`` are callables ``(original_samples) -> Metric``;
    ``original_samples`` and the samples scored are time-domain series
    ``(n, L, C)``, numpy arrays or tensors on any device.
    """

    def __init__(
        self,
        metric_factories: list[Callable[[np.ndarray], Metric]],
        original_samples,
        include_baselines: bool = True,
        include_spectral_density: bool = False,
        device: torch.device | str = "cuda",
    ) -> None:
        self.device = device
        original_samples = _f32(original_samples, device)
        self.metrics_time = [f(original_samples.cpu().numpy()) for f in metric_factories]
        self.metrics_freq = [f(dft(original_samples).cpu().numpy()) for f in metric_factories]
        self.include_baselines = include_baselines
        self.metric_spectral: Optional[MarginalWasserstein] = (
            MarginalWasserstein(
                original_samples=spectral_density(original_samples),
                random_seed=42, save_all_distances=True, device=device,
            )
            if include_spectral_density
            else None
        )

    def __call__(self, other_samples) -> dict[str, Any]:
        other_samples = _f32(other_samples, self.device)
        other_time = other_samples.cpu().numpy()
        other_freq = dft(other_samples).cpu().numpy()
        out: dict[str, Any] = {}
        for mt, mf in zip(self.metrics_time, self.metrics_freq):
            out.update({f"time_{k}": v for k, v in mt(other_time).items()})
            out.update({f"freq_{k}": v for k, v in mf(other_freq).items()})
        if self.include_baselines:
            out.update(self.baseline_metrics)
        if self.metric_spectral is not None:
            spec = self.metric_spectral(spectral_density(other_samples))
            out.update({f"spectral_{k}": v for k, v in spec.items()})
        return dict(sorted(out.items(), key=lambda kv: kv[0]))

    @property
    def baseline_metrics(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for mt, mf in zip(self.metrics_time, self.metrics_freq):
            out.update({f"time_{k}": v for k, v in mt.baseline_metrics.items()})
            out.update({f"freq_{k}": v for k, v in mf.baseline_metrics.items()})
        return out


__all__ = [
    "MarginalWasserstein",
    "Metric",
    "MetricCollection",
    "SlicedWasserstein",
]
