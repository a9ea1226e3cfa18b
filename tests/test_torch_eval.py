"""Port parity of the evaluation modules, on the CPU: ``ops/fourier.py``'s
spectral utilities, ``ops/wasserstein.py``, ``sampling/metrics.py``,
``utils/census.py`` and the datamodules' ``test_arrays`` and
``feature_mean_and_std``, each against its JAX counterpart on the same
numpy inputs from a seed; and the port's ``MetricCollection`` on the
committed samples of ``runs_reference/ref-freq42-e200`` against the
committed ``results_cross_our_sampler.yaml``.

Tolerances:

* FFT-based functions: 1e-5 absolute (two FFT libraries in fp32 agree to a
  few fp32 ulps of O(1) values); ``localization_metrics`` 1e-5 relative
  (sums of squared distances up to (L/2)^2).
* Wasserstein distances and every metric key: 1e-5 relative. Both sort
  the same fp32 projections and sum in fp32 in other orders; the
  projections are fp32 products of 2 to 300 terms in other orders.
* The committed samples: marginal and spectral keys to 1e-5 relative
  (their per-feature lists to 1e-4: the JAX package on the CPU parts from
  the file by up to 2.0e-5 on one feature); sliced means to 5e-4 relative
  and sliced maxima to 3e-3. The file's sliced keys came from projections
  computed on another device (the JAX package on the CPU matches its means
  to 1.6e-4 and its maxima, each one projection's distance, only to
  2.2e-3); its marginal and spectral keys need no product.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fourierdiffusion_tpu.data import datamodules as jax_dm
from fourierdiffusion_tpu.ops import fourier as jax_fourier
from fourierdiffusion_tpu.ops import wasserstein as jax_w
from fourierdiffusion_tpu.sampling import metrics as jax_metrics
from fourierdiffusion_tpu.utils import census as jax_census
from fourierdiffusion_tpu_torch.data import SyntheticDatamodule
from fourierdiffusion_tpu_torch.ops import fourier, wasserstein
from fourierdiffusion_tpu_torch.sampling import metrics
from fourierdiffusion_tpu_torch.utils import census

REPO = Path(__file__).resolve().parents[1]
RUN = REPO / "runs_reference" / "ref-freq42-e200"
FFT_TOL = 1e-5
REL = 1e-5
FILE_REL = {"sliced_mean": 5e-4, "sliced_max": 3e-3, "marginal_all": 1e-4}


def _x(shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("max_len", [16, 19, 100, 187])
@pytest.mark.parametrize("apply_dft", [True, False])
def test_spectral_density_matches_jax(max_len: int, apply_dft: bool) -> None:
    x = _x((4, max_len, 3), seed=max_len)
    ours = fourier.spectral_density(torch.from_numpy(x), apply_dft=apply_dft).numpy()
    ref = np.asarray(jax_fourier.spectral_density(jnp.asarray(x), apply_dft=apply_dft))
    assert ours.shape == ref.shape == (4, fourier.n_real_components(max_len), 3)
    np.testing.assert_allclose(ours, ref, atol=FFT_TOL)


@pytest.mark.parametrize("max_len", [16, 19, 100])
def test_localization_metrics_match_jax(max_len: int) -> None:
    x = _x((6, max_len, 2), seed=1)
    ours = fourier.localization_metrics(torch.from_numpy(x))
    ref = jax_fourier.localization_metrics(jnp.asarray(x))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=REL)
    dist = fourier._cyclic_distance_sq(max_len).numpy()
    np.testing.assert_array_equal(dist, np.asarray(jax_fourier._cyclic_distance_sq(max_len)))


@pytest.mark.parametrize("max_len", [16, 19, 187])
@pytest.mark.parametrize("sigma", [1.0, 2.5])
def test_smooth_frequency_matches_jax(max_len: int, sigma: float) -> None:
    x = _x((3, max_len, 2), seed=2)
    ours = fourier.smooth_frequency(torch.from_numpy(x), sigma).numpy()
    ref = np.asarray(jax_fourier.smooth_frequency(jnp.asarray(x), sigma=sigma))
    np.testing.assert_allclose(ours, ref, atol=FFT_TOL)


@pytest.mark.parametrize("n,m", [(50, 50), (40, 70), (7, 3)])
def test_w2_1d_matches_jax(n: int, m: int) -> None:
    x, y = _x((5, n), seed=3), _x((5, m), seed=4) + 0.5
    ours = wasserstein.w2_1d(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    ref = np.asarray(jax_w.w2_1d(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(ours, ref, rtol=REL)


def test_random_directions_are_jax_bit_for_bit() -> None:
    np.testing.assert_array_equal(wasserstein.random_directions(30, 50, 42),
                                  jax_w.random_directions(30, 50, 42))


@pytest.mark.parametrize("normalisation", ["none", "standardise"])
@pytest.mark.parametrize("m", [120, 90])
def test_sliced_and_marginal_w2_match_jax(normalisation: str, m: int) -> None:
    original, other = _x((120, 24), seed=5), 1.3 * _x((m, 24), seed=6) + 0.2
    ours = wasserstein.sliced_w2(original, other, num_directions=64, seed=42,
                                 normalisation=normalisation, device="cpu")
    ref = jax_w.sliced_w2(original, other, num_directions=64, seed=42,
                          normalisation=normalisation)
    np.testing.assert_allclose(ours, ref, rtol=REL)
    ours = wasserstein.marginal_w2(original, other, normalisation=normalisation, device="cpu")
    ref = jax_w.marginal_w2(original, other, normalisation=normalisation)
    np.testing.assert_allclose(ours, ref, rtol=REL)


def test_normalisation_is_checked() -> None:
    with pytest.raises(ValueError, match="Unrecognised normalisation"):
        wasserstein.marginal_w2(_x((4, 3)), _x((4, 3)), normalisation="scale", device="cpu")


def test_check_flat_array_matches_jax() -> None:
    x = _x((5, 4, 3))
    np.testing.assert_array_equal(wasserstein.check_flat_array(x),
                                  jax_w.check_flat_array(x))
    np.testing.assert_array_equal(wasserstein.check_flat_array(torch.from_numpy(x)),
                                  x.reshape(5, 12))
    with pytest.raises(ValueError, match="2d"):
        wasserstein.check_flat_array(np.zeros(3))


def _collection(module, original, device=None, **kw):
    extra = {} if device is None else {"device": device}
    return module.MetricCollection(
        metric_factories=[
            lambda o: module.SlicedWasserstein(o, random_seed=42, num_directions=kw["dirs"],
                                               save_all_distances=True, **extra),
            lambda o: module.MarginalWasserstein(o, random_seed=42, save_all_distances=True,
                                                 **extra),
        ],
        original_samples=original, include_baselines=True, include_spectral_density=True,
        **extra,
    )


def _assert_results_close(ours: dict, ref: dict, rel_of=lambda key: REL) -> None:
    assert list(ours) == list(ref)  # the same keys, both sorted
    for key, want in ref.items():
        np.testing.assert_allclose(np.asarray(ours[key]), np.asarray(want), rtol=rel_of(key),
                                   atol=0, err_msg=key)


@pytest.mark.parametrize("max_len", [20, 19])
def test_metric_collection_matches_jax(max_len: int) -> None:
    """Every key: time and freq sliced and marginal W2 (mean, max, all),
    their _self and _dummy baselines, and the spectral marginal W2."""
    original = _x((160, max_len, 2), seed=7)
    other = 1.2 * _x((120, max_len, 2), seed=8) + 0.1
    ours = _collection(metrics, original, device="cpu", dirs=100)(other)
    ref = _collection(jax_metrics, original, dirs=100)(other)
    assert len(ours) == 4 * 7 + 3 and ours["time_sliced_wasserstein_mean_dummy"] > 0
    _assert_results_close(ours, ref)


def test_metric_collection_scores_tensors() -> None:
    """Tensors score as their numpy arrays do."""
    original, other = _x((40, 8, 1), seed=9), _x((30, 8, 1), seed=10)
    coll = _collection(metrics, torch.from_numpy(original), device="cpu", dirs=16)
    from_numpy = _collection(metrics, original, device="cpu", dirs=16)(other)
    assert coll(torch.from_numpy(other)) == from_numpy


@pytest.mark.parametrize("optional", [False, True])
def test_census_fields_match_jax(optional: bool) -> None:
    x = _x((50, 20, 1), seed=11)
    x[[3, 17]] *= 40.0
    kw = dict(guard_active=optional, num_samples=50, num_diffusion_steps=1000, method="em",
              sampling_seed=42)
    if optional:
        kw.update(train_seed=43, checkpoint="ema", arm="reference")
    ours = census.census_fields(x, **kw)
    assert ours == jax_census.census_fields(x, **kw)
    assert ours["divergence_census_count"] == 2


@pytest.mark.parametrize("fourier_transform", [True, False])
def test_test_arrays_and_feature_stats_match_jax(tmp_path, fourier_transform: bool) -> None:
    dms = []
    for module in (jax_dm, None):
        cls = jax_dm.SyntheticDatamodule if module else SyntheticDatamodule
        dm = cls(data_dir=tmp_path, random_seed=42, fourier_transform=fourier_transform,
                 standardize=True, max_len=24, num_samples=64)
        dm.prepare_data()
        dm.setup()
        dms.append(dm)
    ref, ours = dms
    test_ref, test_ours = ref.test_arrays(), ours.test_arrays()
    assert test_ours.standardize is False
    np.testing.assert_allclose(test_ours.X.numpy(), np.asarray(test_ref.X), atol=FFT_TOL)
    np.testing.assert_allclose(test_ours.standardized().numpy(),
                               np.asarray(test_ref.standardized()), atol=FFT_TOL)
    for a, b in zip(ours.feature_mean_and_std, ref.feature_mean_and_std):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FFT_TOL)


def test_metrics_reproduce_the_committed_cross_sampler_results(tmp_path) -> None:
    """The committed 10,000 samples of the e200 flagship scored against the
    synthetic data (seed 42) with 1000 directions, baselines and the
    spectral density reproduce ``results_cross_our_sampler.yaml``."""
    want = yaml.safe_load((RUN / "results_cross_our_sampler.yaml").read_text())
    dm = SyntheticDatamodule(data_dir=tmp_path, random_seed=42, fourier_transform=True,
                             standardize=True)
    dm.prepare_data()
    dm.setup()
    samples = np.load(RUN / "samples_cross_our_sampler.npy")
    got = _collection(metrics, dm.X_train, device="cpu", dirs=1000)(samples)
    scalars = {k: v for k, v in want.items() if k in got and not k.endswith("_all")}
    assert len(scalars) == 4 * 6 + 2

    def rel_of(key: str) -> float:
        if "sliced" not in key:
            return REL
        return FILE_REL["sliced_max" if "_max" in key else "sliced_mean"]

    _assert_results_close({k: got[k] for k in scalars}, scalars, rel_of)
    for key in ("time_marginal_wasserstein_all", "freq_marginal_wasserstein_all",
                "spectral_marginal_wasserstein_all"):
        np.testing.assert_allclose(got[key], want[key], rtol=FILE_REL["marginal_all"],
                                   err_msg=key)


@pytest.mark.parametrize("name", ["results.yaml", "results_cross_our_sampler.yaml"])
def test_chip_smoke_reads_the_results_scalars(name: str) -> None:
    """``chip_smoke.py``'s line reader (the card's machine has no YAML)
    gives every top-level number of a results file as PyYAML does, the
    gated keys among them."""
    import chip_smoke

    want = {k: v for k, v in yaml.safe_load((RUN / name).read_text()).items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}
    got = chip_smoke.read_scalars(RUN / name)
    assert got == want
    assert all(k in got and f"{k}_dummy" in got for k in chip_smoke.QUALITY_KEYS)
