"""Datamodules and the DFT/standardise-on-load contract (port of the
``DiffusionArrays``, ``Datamodule``, ``SyntheticDatamodule`` and
``DummyDatamodule`` parts of ``fourierdiffusion_tpu/data/datamodules.py``).

A split is one CPU tensor; the trainer moves it to its device once and
draws batches by index. With ``fourier_transform`` the split goes through
``dft`` first, and the mean and std (ddof 1) are taken in the diffusion
domain from a reference split: the validation split uses the training
statistics, and ``samples_to_data`` turns samples back into the data's
scale (``feature_mean_and_std``, the training split's) and domain. ``SyntheticDatamodule``
generates its series with numpy from the seed and caches them as CSV, as
the JAX package does, so both packages read the same numbers. The ECG, MIMIC-III, NASDAQ, NASA and US-droughts
datamodules are not ported yet.
"""

from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from fourierdiffusion_tpu_torch.ops.fourier import dft, idft


@dataclasses.dataclass
class DiffusionArrays:
    """A split in the diffusion domain; ``standardized()`` is model-ready."""

    X: torch.Tensor
    y: Optional[torch.Tensor]
    feature_mean: torch.Tensor
    feature_std: torch.Tensor
    standardize: bool

    def standardized(self) -> torch.Tensor:
        if not self.standardize:
            return self.X
        return (self.X - self.feature_mean) / self.feature_std

    def __len__(self) -> int:
        return self.X.shape[0]


def make_diffusion_arrays(
    X: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    *,
    fourier_transform: bool = False,
    standardize: bool = False,
    X_ref: Optional[torch.Tensor] = None,
) -> DiffusionArrays:
    """Build a split with statistics from ``X_ref`` (default: ``X``)."""
    if fourier_transform:
        X = dft(X)
        if X_ref is not None:
            X_ref = dft(X_ref)
    if X_ref is None:
        X_ref = X
    mean = torch.mean(X_ref, dim=0)
    std = torch.std(X_ref, dim=0, correction=1)
    return DiffusionArrays(
        X=X, y=y, feature_mean=mean, feature_std=std, standardize=standardize
    )


class Datamodule(ABC):
    """Dataset loading and split construction."""

    def __init__(
        self,
        data_dir: Path | str = Path.cwd() / "data",
        random_seed: int = 42,
        batch_size: int = 32,
        fourier_transform: bool = False,
        standardize: bool = False,
    ) -> None:
        self.data_dir = Path(data_dir) / self.dataset_name
        self.random_seed = random_seed
        self.batch_size = batch_size
        self.fourier_transform = fourier_transform
        self.standardize = standardize
        self.X_train: Optional[torch.Tensor] = None
        self.y_train: Optional[torch.Tensor] = None
        self.X_test: Optional[torch.Tensor] = None
        self.y_test: Optional[torch.Tensor] = None

    def prepare_data(self) -> None:
        if not self.data_dir.exists():
            self.data_dir.mkdir(parents=True, exist_ok=True)
            self.download_data()

    @abstractmethod
    def download_data(self) -> None: ...

    @abstractmethod
    def setup(self, stage: str = "fit") -> None: ...

    @property
    @abstractmethod
    def dataset_name(self) -> str: ...

    def train_arrays(self) -> DiffusionArrays:
        if self.X_train is None:
            raise RuntimeError("call setup() first")
        return make_diffusion_arrays(
            self.X_train, self.y_train,
            fourier_transform=self.fourier_transform, standardize=self.standardize,
        )

    def val_arrays(self) -> DiffusionArrays:
        """Validation split, standardised with the training statistics."""
        if self.X_test is None or self.X_train is None:
            raise RuntimeError("call setup() first")
        return make_diffusion_arrays(
            self.X_test, self.y_test,
            fourier_transform=self.fourier_transform, standardize=self.standardize,
            X_ref=self.X_train,
        )

    def test_arrays(self) -> DiffusionArrays:
        """Test split in the diffusion domain, not standardised."""
        if self.X_test is None:
            raise RuntimeError("call setup() first")
        return make_diffusion_arrays(
            self.X_test, self.y_test, fourier_transform=self.fourier_transform,
            standardize=False,
        )

    @property
    def steps_per_epoch(self) -> int:
        if self.X_train is None:
            raise RuntimeError("call setup() first")
        return -(-self.X_train.shape[0] // self.batch_size)

    @property
    def dataset_parameters(self) -> dict:
        if self.X_train is None:
            raise RuntimeError("call setup() first")
        return {
            "n_channels": int(self.X_train.shape[2]),
            "max_len": int(self.X_train.shape[1]),
            "steps_per_epoch": self.steps_per_epoch,
        }

    @property
    def feature_mean_and_std(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The training split's mean and std (ddof 1) per (position,
        channel) in the diffusion domain."""
        split = self.train_arrays()
        return split.feature_mean, split.feature_std

    def samples_to_data(self, x: torch.Tensor) -> torch.Tensor:
        """Samples drawn in the diffusion domain, back in the data's scale
        and domain: un-standardised with the training statistics where the
        splits are standardised, then ``idft`` where they are in frequency."""
        if self.standardize:
            mean, std = self.feature_mean_and_std
            x = x * std.to(x.device) + mean.to(x.device)
        if self.fourier_transform:
            x = idft(x)
        return x


class SyntheticDatamodule(Datamodule):
    """Synthetic series generated with numpy from the seed and cached as
    CSV: ``sine`` (sin(t f + phi), f ~ Beta(2, 2), phi ~ N(0, 1)),
    ``multisine`` (three random sines) or ``ar2`` (a stationary AR(2)
    process with a random resonance per series)."""

    FAMILIES = ("sine", "multisine", "ar2")

    def __init__(
        self,
        data_dir: Path | str = Path.cwd() / "data",
        random_seed: int = 42,
        batch_size: int = 32,
        fourier_transform: bool = False,
        standardize: bool = False,
        max_len: int = 100,
        num_samples: int = 1000,
        family: str = "sine",
    ) -> None:
        if family not in self.FAMILIES:
            raise ValueError(f"Unknown synthetic family: {family!r}")
        self.family = family  # before super().__init__: it names the directory
        super().__init__(data_dir, random_seed, batch_size, fourier_transform, standardize)
        self.max_len = max_len
        self.num_samples = num_samples

    def setup(self, stage: str = "fit") -> None:
        X_train = np.loadtxt(self.data_dir / "train.csv", delimiter=",", dtype=np.float32)
        X_test = np.loadtxt(self.data_dir / "test.csv", delimiter=",", dtype=np.float32)
        self.X_train = torch.from_numpy(X_train)[:, :, None]
        self.X_test = torch.from_numpy(X_test)[:, :, None]

    def _generate(self, rng: np.random.Generator, n: int) -> np.ndarray:
        t = np.arange(self.max_len)
        if self.family == "sine":
            phase = rng.normal(size=(n, 1))
            frequency = rng.beta(a=2, b=2, size=(n, 1))
            return np.sin(t * frequency + phase)
        if self.family == "multisine":
            x = np.zeros((n, self.max_len))
            for _ in range(3):
                amp = rng.uniform(0.2, 1.0, size=(n, 1))
                phase = rng.normal(size=(n, 1))
                frequency = rng.beta(a=2, b=2, size=(n, 1))
                x += amp * np.sin(t * frequency + phase)
            return x / np.sqrt(3.0)
        r = rng.uniform(0.7, 0.95, size=n)
        theta = rng.uniform(0.1, np.pi / 2, size=n)
        a1, a2 = 2 * r * np.cos(theta), -(r**2)
        burn = 100
        x = np.zeros((n, self.max_len + burn))
        eps = rng.normal(size=(n, self.max_len + burn)) * 0.3
        for k in range(2, self.max_len + burn):
            x[:, k] = a1 * x[:, k - 1] + a2 * x[:, k - 2] + eps[:, k]
        return x[:, burn:]

    def download_data(self) -> None:
        rng = np.random.default_rng(self.random_seed)
        X = self._generate(rng, 2 * self.num_samples).astype(np.float32)
        np.savetxt(self.data_dir / "train.csv", X[: self.num_samples], delimiter=",")
        np.savetxt(self.data_dir / "test.csv", X[self.num_samples :], delimiter=",")

    @property
    def dataset_name(self) -> str:
        return "synthetic" if self.family == "sine" else f"synthetic_{self.family}"


class DummyDatamodule(Datamodule):
    """Seeded Gaussian data for tests: ``10 * batch_size`` series per split.

    The draws come from ``torch.Generator`` and so differ from the JAX
    package's ``jax.random`` draws of the same seed.
    """

    def __init__(
        self,
        data_dir: Path | str = Path.cwd() / "data",
        random_seed: int = 42,
        batch_size: int = 32,
        fourier_transform: bool = False,
        standardize: bool = False,
        n_channels: int = 3,
        max_len: int = 20,
    ) -> None:
        super().__init__(data_dir, random_seed, batch_size, fourier_transform, standardize)
        self.n_channels = n_channels
        self.max_len = max_len

    def prepare_data(self) -> None:
        pass

    def download_data(self) -> None:
        pass

    def setup(self, stage: str = "fit") -> None:
        g = torch.Generator().manual_seed(self.random_seed)
        shape = (10 * self.batch_size, self.max_len, self.n_channels)
        self.X_train = torch.randn(shape, generator=g)
        self.X_test = torch.randn(shape, generator=g)

    @property
    def dataset_name(self) -> str:
        return "dummy"


__all__ = [
    "Datamodule",
    "DiffusionArrays",
    "DummyDatamodule",
    "SyntheticDatamodule",
    "make_diffusion_arrays",
]
