"""Datamodules and the DFT/standardise-on-load contract (port of
``fourierdiffusion_tpu/data/datamodules.py``).

A split is one CPU tensor; the trainer moves it to its device once and
draws batches by index. With ``fourier_transform`` the split goes through
``dft`` first, and the mean and std (ddof 1) are taken in the diffusion
domain from a reference split: the validation split uses the training
statistics, and ``samples_to_data`` turns samples back into the data's
scale (``feature_mean_and_std``, the training split's) and domain.

``SyntheticDatamodule`` generates its series with numpy from the seed and
caches them as CSV, as the JAX package does, so both packages read the
same numbers. The dataset-backed datamodules read the raw files where the
JAX package does, without pandas (``data/csvio.py``,
``data/preprocessing.py``): ECG (MIT-BIH, L=187), NASDAQ (252 trading
days, 5 features), NASA batteries (charge: 251 steps, 4 features;
discharge: 134, 5), US droughts (365 days, 13 features) and MIMIC-III (24
hours, the ``n_feats`` of highest variance; its HDF5 file needs pandas,
its cached arrays do not). ``download_data`` fetches nothing: where the
raw files are absent it names the dataset and the directory to put them in.
"""

from __future__ import annotations

import dataclasses
import logging
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from fourierdiffusion_tpu_torch.data import preprocessing
from fourierdiffusion_tpu_torch.data.csvio import read_csv
from fourierdiffusion_tpu_torch.ops.fourier import (
    dft,
    idft,
    localization_metrics,
    smooth_frequency,
)

logger = logging.getLogger(__name__)


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


def _kaggle_download(dataset: str, path: Path) -> None:
    """The port downloads nothing: the raw files go in ``path``."""
    raise RuntimeError(
        f"Dataset requires the kaggle API to download {dataset!r}. "
        f"Install/authenticate kaggle, or place the raw files in {path} manually."
    )


class ECGDatamodule(Datamodule):
    """MIT-BIH heartbeats (kaggle ``shayanfazeli/heartbeat``): 187-step
    univariate series and a label column.

    The CSV's first line is read as a header, as ``pd.read_csv`` reads it:
    the real files have none, so each split loses its first beat, as in the
    JAX package. ``subsample_localization`` keeps the 1000 series of lowest
    ``x_loc / x_spec_loc`` (a stable sort); ``smooth_frequency`` smooths
    both splits' spectra with a Gaussian of ``smoother_width``.
    """

    def __init__(
        self,
        data_dir: Path | str = Path.cwd() / "data",
        random_seed: int = 42,
        batch_size: int = 32,
        fourier_transform: bool = False,
        standardize: bool = False,
        subsample_localization: bool = False,
        smooth_frequency: bool = False,
        smoother_width: float = 0.0,
    ) -> None:
        super().__init__(data_dir, random_seed, batch_size, fourier_transform, standardize)
        self.subsample_localization = subsample_localization
        self.smooth_frequency = smooth_frequency
        self.smoother_width = smoother_width

    @staticmethod
    def _read(path: Path) -> tuple[torch.Tensor, torch.Tensor]:
        table = read_csv(path)
        X = np.stack(table.columns[:187], axis=1).astype(np.float32)
        y = table.columns[187].astype(np.int64)
        return torch.from_numpy(X)[:, :, None], torch.from_numpy(y)

    def setup(self, stage: str = "fit") -> None:
        self.X_train, self.y_train = self._read(self.data_dir / "mitbih_train.csv")
        self.X_test, self.y_test = self._read(self.data_dir / "mitbih_test.csv")

        if self.subsample_localization:
            x_loc, x_spec_loc = localization_metrics(self.X_train)
            idx = torch.argsort(x_loc / x_spec_loc, stable=True)[:1000]
            self.X_train = self.X_train[idx]
            self.y_train = self.y_train[idx]
            x_loc, x_spec_loc = localization_metrics(self.X_train)
            logger.info("Subsampled by localization: time deloc %.3g, freq deloc %.3g",
                        float(x_loc.mean()), float(x_spec_loc.mean()))

        if self.smooth_frequency and self.smoother_width > 0.0:
            self.X_train = smooth_frequency(self.X_train, sigma=self.smoother_width)
            self.X_test = smooth_frequency(self.X_test, sigma=self.smoother_width)
            logger.info("Smoothed the frequency domain (sigma=%s)", self.smoother_width)

    def download_data(self) -> None:
        _kaggle_download("shayanfazeli/heartbeat", self.data_dir)

    @property
    def dataset_name(self) -> str:
        return "ecg"


class _CachedPreprocessDatamodule(Datamodule):
    """Runs a one-shot preprocessing pipeline where the cached
    ``X_train.npy``/``X_test.npy`` are missing, then loads them."""

    cache_subdir: str = ""

    def _cache_dir(self) -> Path:
        return self.data_dir / self.cache_subdir if self.cache_subdir else self.data_dir

    @abstractmethod
    def _preprocess(self) -> None: ...

    def setup(self, stage: str = "fit") -> None:
        cache = self._cache_dir()
        if not (cache / "X_train.npy").exists() or not (cache / "X_test.npy").exists():
            logger.info("Cache missing for %s; running preprocessing.", self.dataset_name)
            self._preprocess()
        self.X_train = torch.from_numpy(np.load(cache / "X_train.npy"))
        self.X_test = torch.from_numpy(np.load(cache / "X_test.npy"))
        self._postprocess()

    def _postprocess(self) -> None:
        pass


class MIMICIIIDatamodule(_CachedPreprocessDatamodule):
    """MIMIC-III hourly vitals and labs (restricted: the user places
    MIMIC-Extract's ``all_hourly_data.h5``). Keeps the ``n_feats`` features
    of highest variance (averaged over time; ties in feature order)."""

    def __init__(
        self,
        data_dir: Path | str = Path.cwd() / "data",
        random_seed: int = 42,
        batch_size: int = 32,
        fourier_transform: bool = False,
        standardize: bool = False,
        n_feats: int = 40,
    ) -> None:
        super().__init__(data_dir, random_seed, batch_size, fourier_transform, standardize)
        self.n_feats = n_feats

    def _preprocess(self) -> None:
        preprocessing.mimic_preprocess(data_dir=self.data_dir, random_seed=self.random_seed)

    def _postprocess(self) -> None:
        std = torch.std(self.X_train, dim=0, correction=1).mean(dim=0)
        top = torch.argsort(-std, stable=True)[: self.n_feats]
        self.X_train = self.X_train[:, :, top]
        self.X_test = self.X_test[:, :, top]

    def download_data(self) -> None:
        path = self.data_dir / "all_hourly_data.h5"
        if not path.exists():
            raise RuntimeError(
                f"MIMIC-III is restricted; place the MIMIC-Extract "
                f"'all_hourly_data.h5' at {path} (see "
                f"https://github.com/MLforHealth/MIMIC_Extract)."
            )

    @property
    def dataset_name(self) -> str:
        return "mimiciii"


class NASDAQDatamodule(_CachedPreprocessDatamodule):
    """2019 daily prices of the NASDAQ stocks that traded every day of it;
    Volume, the last feature, is dropped (5 features at L=252)."""

    def _preprocess(self) -> None:
        preprocessing.nasdaq_preprocess(data_dir=self.data_dir, random_seed=self.random_seed)

    def _postprocess(self) -> None:
        if not tuple(self.X_train.shape[1:]) == tuple(self.X_test.shape[1:]) == (252, 6):
            raise ValueError(f"NASDAQ splits of shapes {tuple(self.X_train.shape)}, "
                             f"{tuple(self.X_test.shape)}; expected (*, 252, 6)")
        self.X_train = self.X_train[:, :, :-1]
        self.X_test = self.X_test[:, :, :-1]

    def download_data(self) -> None:
        _kaggle_download("jacksoncrow/stock-market-dataset", self.data_dir)

    @property
    def dataset_name(self) -> str:
        return "nasdaq"


class NASADatamodule(_CachedPreprocessDatamodule):
    """NASA battery cycles, ``subdataset`` charge or discharge. Charge with
    ``remove_outlier_feature``: every second step (251) and features
    [0, 1, 3, 4]."""

    def __init__(
        self,
        data_dir: Path | str = Path.cwd() / "data",
        random_seed: int = 42,
        batch_size: int = 32,
        fourier_transform: bool = False,
        standardize: bool = False,
        subdataset: str = "charge",
        remove_outlier_feature: bool = True,
    ) -> None:
        super().__init__(data_dir, random_seed, batch_size, fourier_transform, standardize)
        if subdataset not in ("charge", "discharge"):
            raise ValueError(f"subdataset must be 'charge' or 'discharge', not {subdataset!r}")
        self.subdataset = subdataset
        self.remove_outlier_feature = remove_outlier_feature
        self.cache_subdir = subdataset

    def _preprocess(self) -> None:
        preprocessing.nasa_preprocess(
            data_dir=self.data_dir, subdataset=self.subdataset, random_seed=self.random_seed
        )

    def _postprocess(self) -> None:
        if self.remove_outlier_feature and self.subdataset == "charge":
            keep = torch.tensor([0, 1, 3, 4])
            self.X_train = self.X_train[:, ::2, :][:, :, keep]
            self.X_test = self.X_test[:, ::2, :][:, :, keep]
            if not tuple(self.X_train.shape[1:]) == tuple(self.X_test.shape[1:]) == (251, 4):
                raise ValueError(f"NASA charge splits of shapes {tuple(self.X_train.shape)}, "
                                 f"{tuple(self.X_test.shape)}; expected (*, 251, 4)")

    def download_data(self) -> None:
        _kaggle_download("patrickfleith/nasa-battery-dataset", self.data_dir)

    @property
    def dataset_name(self) -> str:
        return "nasa"


class USDroughtsDatamodule(_CachedPreprocessDatamodule):
    """One year of daily meteorological series per county; features {4, 5,
    6, 7, 9} of the sorted order (T2MDEW, T2MWET, T2M_MAX, T2M_MIN, TS: the
    ones that follow T2M) are dropped."""

    def _preprocess(self) -> None:
        preprocessing.droughts_preprocess(data_dir=self.data_dir, random_seed=self.random_seed)

    def _postprocess(self) -> None:
        keep = torch.tensor([i for i in range(self.X_train.shape[2])
                             if i not in {4, 5, 6, 7, 9}])
        self.X_train = self.X_train[:, :, keep]
        self.X_test = self.X_test[:, :, keep]
        if self.X_train.shape[1] % 365 or self.X_test.shape[1] % 365:
            raise ValueError(f"droughts series of length {self.X_train.shape[1]}, "
                             "not a multiple of 365")

    def download_data(self) -> None:
        _kaggle_download("cdminix/us-drought-meteorological-data", self.data_dir)

    @property
    def dataset_name(self) -> str:
        return "droughts"


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


DATAMODULE_REGISTRY: dict[str, type[Datamodule]] = {
    "ecg": ECGDatamodule,
    "synthetic": SyntheticDatamodule,
    "mimiciii": MIMICIIIDatamodule,
    "nasdaq": NASDAQDatamodule,
    "nasa": NASADatamodule,
    "usdroughts": USDroughtsDatamodule,
    "dummy": DummyDatamodule,
}


__all__ = [
    "DATAMODULE_REGISTRY",
    "Datamodule",
    "DiffusionArrays",
    "DummyDatamodule",
    "ECGDatamodule",
    "MIMICIIIDatamodule",
    "NASADatamodule",
    "NASDAQDatamodule",
    "SyntheticDatamodule",
    "USDroughtsDatamodule",
    "make_diffusion_arrays",
]
