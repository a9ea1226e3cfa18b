"""Port parity of the dataset-backed datamodules and their preprocessing
(``data/csvio.py``, ``data/preprocessing.py``, ``data/datamodules.py``)
against the JAX package, on the CPU, on raw files that the tests write
from a seed in each dataset's real format (``data/raw_formats.py``).

* Preprocessing: the cached ``X_train.npy``/``X_test.npy`` of the port
  (csv and numpy) and of the JAX package (pandas) are equal bit for bit,
  NaNs in the same places. For the NASA bin means the test would allow
  1 float32 ulp: pandas parses the CSV's numbers with its own C parser,
  which may differ from the correctly rounded float64 in its last bit, and
  each mean sums several of them; on these files they are equal too.
* One test per trap of the pandas pipelines: the MIT-BIH file's first row
  read as a header, NASDAQ's sorted features and averaged duplicate rows,
  the droughts' ``dropna`` and sorted features, an empty NASA bin, and each
  NASA skip rule.
* Every datamodule's splits, ``dataset_parameters`` and
  ``feature_mean_and_std``, Fourier on and off, standardised: values, means
  and stds to 1e-6 of the split's largest magnitude (the DFTs of two FFT
  libraries in fp32 differ by up to 2.3e-7 of it at these lengths),
  standardised values to 1e-6 of it after multiplying the error by the std
  (an ulp of a DFT is divided by stds down to 1e-3); ECG's
  localization subsample with tied scores and its frequency smoothing;
  MIMIC-III on cached arrays with tied variances.
* MIMIC-III's imputation and 3-d reshape against JAX's on a small frame.
* The ECG, NASDAQ, NASA and droughts setups with pandas unimportable.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from fourierdiffusion_tpu.data import datamodules as jax_dm
from fourierdiffusion_tpu.data import preprocessing as jax_pp
from fourierdiffusion_tpu_torch.data import csvio
from fourierdiffusion_tpu_torch.data import datamodules as dm
from fourierdiffusion_tpu_torch.data import preprocessing as pp
from fourierdiffusion_tpu_torch.data import raw_formats as rf

REL = 1e-6
SUBDIR = {"ecg": "ecg", "nasdaq": "nasdaq", "nasa": "nasa", "usdroughts": "droughts",
          "mimiciii": "mimiciii"}


@pytest.fixture(scope="module")
def raw(tmp_path_factory) -> Path:
    """Every dataset's raw files, from seed 0."""
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(0)
    rf.write_mitbih(root, rng, 64, 24)
    rf.write_nasdaq(root, rng, 12)
    rf.write_droughts(root, rng, 12)
    rf.write_nasa(root, rng, 12, "charge")
    rf.write_nasa(root / "discharge", rng, 12, "discharge")
    shutil.move(root / "discharge" / "nasa" / "cleaned_dataset",
                root / "nasa" / "cleaned_dataset_discharge")
    mimic = root / "mimiciii"
    mimic.mkdir()
    x = rng.normal(size=(50, 24, 104)).astype(np.float32)
    x[..., 3] *= 2.0
    x[..., 7] = -x[..., 3]  # the same variance, the largest: a tie at the top
    x[..., 60:] *= 0.5
    x[..., 90] = 1.0  # zero variance
    np.save(mimic / "X_train.npy", x[:40])
    np.save(mimic / "X_test.npy", x[40:])
    return root


def _twins(raw: Path, tmp: Path, name: str, subdataset: str = "charge") -> tuple[Path, Path]:
    """Two copies of one dataset's raw files (the port's and JAX's, each
    writes its own cache): the ``data_dir`` roots."""
    roots = tmp / "port", tmp / "jax"
    for root in roots:
        src = raw / SUBDIR[name]
        shutil.copytree(src, root / SUBDIR[name], ignore=shutil.ignore_patterns(
            "cleaned_dataset_discharge" if subdataset == "charge" else "cleaned_dataset"))
        if name == "nasa" and subdataset == "discharge":
            (root / "nasa" / "cleaned_dataset_discharge").rename(
                root / "nasa" / "cleaned_dataset")
    return roots


def _preprocess(name: str, subdataset: str, data_dir: Path, module) -> tuple[np.ndarray, ...]:
    if name == "nasdaq":
        module.nasdaq_preprocess(data_dir, random_seed=0)
    elif name == "usdroughts":
        module.droughts_preprocess(data_dir, random_seed=0)
    else:
        module.nasa_preprocess(data_dir, subdataset=subdataset, random_seed=0)
        data_dir = data_dir / subdataset
    return tuple(np.load(data_dir / f) for f in ("X_train.npy", "X_test.npy"))


def _assert_same(ours: np.ndarray, ref: np.ndarray, max_ulp: int = 0) -> None:
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    if max_ulp:
        finite = ~np.isnan(ref)
        np.testing.assert_array_max_ulp(ours[finite], ref[finite], maxulp=max_ulp)
    else:
        np.testing.assert_array_equal(ours, ref)


# ---- preprocessing, bit for bit -------------------------------------------------------


@pytest.mark.parametrize("name,subdataset,shape", [
    ("nasdaq", None, (252, 6)), ("usdroughts", None, (365, 18)),
    ("nasa", "charge", (501, 5)), ("nasa", "discharge", (134, 5)),
])
def test_preprocessing_matches_jax_bit_for_bit(raw, tmp_path, name, subdataset, shape) -> None:
    port, jax = _twins(raw, tmp_path, name, subdataset or "charge")
    ours = _preprocess(name, subdataset, port / SUBDIR[name], pp)
    ref = _preprocess(name, subdataset, jax / SUBDIR[name], jax_pp)
    for a, b in zip(ours, ref):
        assert a.shape[1:] == shape
        _assert_same(a, b, max_ulp=1 if name == "nasa" else 0)
    assert sum(len(a) for a in ours) > 1


def test_group_mean_is_pandas_bit_for_bit() -> None:
    """Kahan-compensated sums in row order: equal to pandas' grouped mean
    where a plain sum is not, NaNs skipped, an empty group NaN."""
    rng = np.random.default_rng(1)
    labels = rng.integers(-1, 40, 4000)
    values = rng.normal(size=(4000, 2)) * 10.0 ** rng.integers(-6, 7, (4000, 2))
    values[rng.random((4000, 2)) < 0.1] = np.nan
    values[labels == 5] = np.nan
    frame = pd.DataFrame(values[labels >= 0]).assign(g=labels[labels >= 0])
    ref = frame.groupby("g").mean().reindex(range(41)).to_numpy()
    np.testing.assert_array_equal(pp._group_mean(labels, values, 41), ref)


# ---- the traps of the pandas pipelines, one test each ---------------------------------------


def test_headerless_mitbih_loses_its_first_row_as_in_jax(raw, tmp_path) -> None:
    port, jax = _twins(raw, tmp_path, "ecg")
    ours = dm.ECGDatamodule(data_dir=port)
    ref = jax_dm.ECGDatamodule(data_dir=jax)
    for d in (ours, ref):
        d.setup()
    lines = (raw / "ecg" / "mitbih_train.csv").read_text().splitlines()
    assert len(ours.X_train) == len(lines) - 1 == 63
    second = np.array(lines[1].split(","), dtype=np.float64)
    np.testing.assert_array_equal(ours.X_train[0, :, 0].numpy(), second[:187].astype(np.float32))
    assert ours.y_train[0].item() == int(second[187])
    for a, b in ((ours.X_train, ref.X_train), (ours.y_train, ref.y_train),
                 (ours.X_test, ref.X_test), (ours.y_test, ref.y_test)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ours.y_train.dtype == torch.int64 and ours.X_train.dtype == torch.float32


def test_nasdaq_features_sorted_and_duplicate_rows_averaged(tmp_path) -> None:
    """``pivot_table`` sorts the value names (Adj Close, Close, High, Low,
    Open, Volume) and averages a duplicated (Name, Date) row."""
    rng = np.random.default_rng(3)
    days = rf.trading_days("2018-12-03", "2020-01-15")
    stocks = tmp_path / "raw" / "nasdaq" / "stocks"
    for i in range(4):
        rows = [[str(d), *(f"{100 * (k + 1) + i + j / 1000:.6f}" for k in range(6))]
                for j, d in enumerate(days)]
        if i == 0:
            extra = list(rows[40])
            extra[1:] = [f"{float(v) + 0.5:.6f}" for v in extra[1:]]
            rows.insert(41, extra)
        rf.write_csv(stocks / f"S{i}.csv", rf.NASDAQ_COLUMNS, rows)
    port, jax = _twins(tmp_path / "raw", tmp_path, "nasdaq")
    X = np.concatenate(_preprocess("nasdaq", None, port / "nasdaq", pp))
    ref = np.concatenate(_preprocess("nasdaq", None, jax / "nasdaq", jax_pp))
    _assert_same(X, ref)
    written = ("Open", "High", "Low", "Close", "Adj Close", "Volume")
    hundreds = [100 * (written.index(n) + 1) for n in sorted(written)]
    np.testing.assert_array_equal(np.floor(X[:, 0, :] / 100) * 100,
                                  np.tile(hundreds, (len(X), 1)))
    step = 40 - int(np.searchsorted(days, np.datetime64("2019-01-01")))  # in 2019
    stock0 = X[np.argmin(X[:, 0, 0] % 100)]  # the smallest offset
    opens = [float(f"{100 + 40 / 1000:.6f}"), float(f"{100 + 40 / 1000 + 0.5:.6f}")]
    assert stock0[step, sorted(written).index("Open")] == np.float32(sum(opens) / 2)


def test_droughts_dropna_and_sorted_features(tmp_path) -> None:
    """``dropna(axis=1)`` after the year's window drops the weekly score and
    any feature with a NaN in the year (not one outside it); ``pivot_table``
    sorts the features by string order (T2MDEW, T2MWET before T2M_MAX)."""
    days = np.arange(np.datetime64("2010-12-20"), np.datetime64("2012-01-10"))
    names = rf.DROUGHTS_FEATURES
    rows = []
    for fips in (1001, 1003, 1005):
        for n, d in enumerate(days):
            values = [f"{k + 1}.{fips % 100:02d}" for k in range(len(names))]
            if fips == 1003 and n == 200:
                values[names.index("WS50M")] = ""  # a NaN in 2011
            if n == 2:
                values[names.index("PS")] = ""  # a NaN in 2010 only
            rows.append([str(fips), str(d), *values, "1.0" if n % 7 == 0 else ""])
    rf.write_csv(tmp_path / "raw" / "droughts" / "train_timeseries" / "train_timeseries.csv",
                 ("fips", "date", *names, "score"), rows)
    port, jax = _twins(tmp_path / "raw", tmp_path, "usdroughts")
    X = np.concatenate(_preprocess("usdroughts", None, port / "droughts", pp))
    ref = np.concatenate(_preprocess("usdroughts", None, jax / "droughts", jax_pp))
    _assert_same(X, ref)
    kept = sorted(n for n in names if n != "WS50M")
    assert X.shape[1:] == (365, len(kept))
    np.testing.assert_array_equal(np.floor(X[0, 0]), [names.index(n) + 1 for n in kept])
    assert kept[4:8] == ["T2MDEW", "T2MWET", "T2M_MAX", "T2M_MIN"] and kept[9] == "TS"


def _nasa_with(tmp_path: Path, extra: dict[str, np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    rf.write_nasa(tmp_path / "raw", np.random.default_rng(4), 3, "charge", extra)
    port, jax = _twins(tmp_path / "raw", tmp_path, "nasa")
    ours = np.concatenate(_preprocess("nasa", "charge", port / "nasa", pp))
    ref = np.concatenate(_preprocess("nasa", "charge", jax / "nasa", jax_pp))
    _assert_same(ours, ref, max_ulp=1)
    return ours, ref


def test_nasa_empty_bin_stays_nan(tmp_path) -> None:
    """A cycle sampled from 13 s on has nothing in the bins (-10, 0] and
    (0, 10]: with ``observed=False`` they stay NaN rows."""
    times = rf.cycle_times(np.random.default_rng(5), 5050.0, start=13.0)
    ours, _ = _nasa_with(tmp_path, {"late_start.csv": times})
    nan_steps = np.isnan(ours).all(axis=2)
    assert np.isnan(ours).any(axis=2).sum() == 2
    (series,) = np.flatnonzero(nan_steps.any(axis=1))
    assert list(np.flatnonzero(nan_steps[series])) == [0, 1]


@pytest.mark.parametrize("rule,times", [
    ("ends at the cutoff", np.arange(0.0, 5000.5, 5.0)),
    ("a gap above the bin", np.concatenate([np.arange(0.0, 2000.0, 5.0),
                                            np.arange(2010.5, 5100.0, 5.0)])),
])
def test_nasa_skip_rules(tmp_path, rule: str, times: np.ndarray) -> None:
    ours, _ = _nasa_with(tmp_path, {"skipped.csv": times})
    assert len(ours) == 3


# ---- the datamodules ----------------------------------------------------------------------


def _assert_split_close(got, want) -> None:
    X, ref = got.X.numpy(), np.asarray(want.X)
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(X - ref).max()) <= REL * scale
    for key in ("feature_mean", "feature_std"):
        a, b = getattr(got, key).numpy(), np.asarray(getattr(want, key))
        assert float(np.abs(a - b).max()) <= REL * scale, key
    if got.standardize:
        err = np.abs(got.standardized().numpy() - np.asarray(want.standardized()))
        assert float((err * got.feature_std.numpy()).max()) <= REL * scale


_DATAMODULES = [("ecg", {}), ("nasdaq", {}), ("nasa", {"subdataset": "charge"}),
                ("nasa", {"subdataset": "discharge"}), ("usdroughts", {}), ("mimiciii", {})]


@pytest.mark.parametrize("fourier_transform", [False, True], ids=["time", "freq"])
@pytest.mark.parametrize("name,kwargs", _DATAMODULES,
                         ids=[n + "-" + "-".join(k.values()) for n, k in _DATAMODULES])
def test_datamodules_match_jax(raw, tmp_path, name, kwargs, fourier_transform) -> None:
    port, jax = _twins(raw, tmp_path, name, kwargs.get("subdataset", "charge"))
    kw = dict(random_seed=0, batch_size=4, fourier_transform=fourier_transform,
              standardize=True, **kwargs)
    ours = dm.DATAMODULE_REGISTRY[name](data_dir=port, **kw)
    ref = jax_dm.DATAMODULE_REGISTRY[name](data_dir=jax, **kw)
    for d in (ours, ref):
        d.prepare_data()
        d.setup()
    np.testing.assert_array_equal(ours.X_train.numpy(), np.asarray(ref.X_train))
    np.testing.assert_array_equal(ours.X_test.numpy(), np.asarray(ref.X_test))
    assert ours.dataset_parameters == ref.dataset_parameters
    for split in ("train_arrays", "val_arrays", "test_arrays"):
        _assert_split_close(getattr(ours, split)(), getattr(ref, split)())
    scale = max(1.0, float(np.abs(np.asarray(ref.train_arrays().X)).max()))
    for a, b in zip(ours.feature_mean_and_std, ref.feature_mean_and_std):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= REL * scale
    expected = {"ecg": (187, 1), "nasdaq": (252, 5), "usdroughts": (365, 13),
                "mimiciii": (24, 40)}.get(name, (251, 4) if kw.get("subdataset") == "charge"
                                          else (134, 5))
    assert tuple(ours.X_train.shape[1:]) == expected


def test_ecg_localization_subsample_with_ties(tmp_path) -> None:
    """1100 beats, each distinct one three times: the 1000 lowest scores
    cut a tie, which the stable sort breaks by position, as ``jnp.argsort``."""
    rng = np.random.default_rng(6)
    rf.write_mitbih(tmp_path / "src", rng, 367, 24)
    lines = (tmp_path / "src" / "ecg" / "mitbih_train.csv").read_text().splitlines()
    tripled = [line for line in lines for _ in range(3)][:1101]
    for root in ("port", "jax"):
        (tmp_path / root / "ecg").mkdir(parents=True)
        (tmp_path / root / "ecg" / "mitbih_train.csv").write_text("\n".join(tripled) + "\n")
        shutil.copy(tmp_path / "src" / "ecg" / "mitbih_test.csv", tmp_path / root / "ecg")
    kw = dict(subsample_localization=True)
    ours = dm.ECGDatamodule(data_dir=tmp_path / "port", **kw)
    ref = jax_dm.ECGDatamodule(data_dir=tmp_path / "jax", **kw)
    for d in (ours, ref):
        d.setup()
    assert len(ours.X_train) == 1000
    np.testing.assert_array_equal(ours.X_train.numpy(), np.asarray(ref.X_train))
    np.testing.assert_array_equal(ours.y_train.numpy(), np.asarray(ref.y_train))


@pytest.mark.parametrize("sigma", [1.0, 4.0])
def test_ecg_smooth_frequency_matches_jax(raw, tmp_path, sigma: float) -> None:
    port, jax = _twins(raw, tmp_path, "ecg")
    kw = dict(smooth_frequency=True, smoother_width=sigma)
    ours = dm.ECGDatamodule(data_dir=port, **kw)
    ref = jax_dm.ECGDatamodule(data_dir=jax, **kw)
    for d in (ours, ref):
        d.setup()
    for a, b in ((ours.X_train, ref.X_train), (ours.X_test, ref.X_test)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_mimic_top_variance_ties_follow_jax(raw, tmp_path) -> None:
    port, jax = _twins(raw, tmp_path, "mimiciii")
    ours = dm.MIMICIIIDatamodule(data_dir=port, n_feats=4)
    ref = jax_dm.MIMICIIIDatamodule(data_dir=jax, n_feats=4)
    for d in (ours, ref):
        d.setup()
    np.testing.assert_array_equal(ours.X_train.numpy(), np.asarray(ref.X_train))
    x = np.load(raw / "mimiciii" / "X_train.npy")
    np.testing.assert_array_equal(ours.X_train.numpy()[..., :2], x[..., [3, 7]])


def test_download_names_the_dataset_and_directory(tmp_path) -> None:
    for name, dataset in (("ecg", "shayanfazeli/heartbeat"),
                          ("nasdaq", "jacksoncrow/stock-market-dataset"),
                          ("nasa", "patrickfleith/nasa-battery-dataset"),
                          ("usdroughts", "cdminix/us-drought-meteorological-data")):
        d = dm.DATAMODULE_REGISTRY[name](data_dir=tmp_path)
        with pytest.raises(RuntimeError, match=dataset) as err:
            d.prepare_data()
        assert str(d.data_dir) in str(err.value)
    with pytest.raises(RuntimeError, match="all_hourly_data.h5"):
        dm.MIMICIIIDatamodule(data_dir=tmp_path).prepare_data()


# ---- MIMIC-III's pandas steps ---------------------------------------------------------------


def _mimic_frame() -> pd.DataFrame:
    rng = np.random.default_rng(7)
    index = pd.MultiIndex.from_tuples(
        [(s, 10 + s, 100 + s, h) for s in (1, 2, 3) for h in range(4)],
        names=["subject_id", "hadm_id", "icustay_id", "hours_in"])
    columns = pd.MultiIndex.from_product(
        [["heart rate", "glucose"], ["count", "mean", "std"]],
        names=["LEVEL2", "Aggregation Function"])
    frame = pd.DataFrame(rng.normal(size=(12, 6)), index=index, columns=columns)
    counts = rng.integers(0, 3, size=(12, 2)).astype(float)
    counts[4:8, 1] = 0  # stay 2 never measures glucose: its mean falls to 0
    for k, f in enumerate(("heart rate", "glucose")):
        frame[(f, "count")] = counts[:, k]
        frame.loc[counts[:, k] == 0, (f, "mean")] = np.nan
    return frame


def test_mimic_impute_and_reshape_match_jax() -> None:
    frame = _mimic_frame()
    ours, ref = pp._mimic_impute(frame), jax_pp._mimic_impute(frame)
    pd.testing.assert_frame_equal(ours, ref)
    assert not ours.isnull().any().any()
    means = (slice(None), "mean")
    np.testing.assert_array_equal(pp._mimic_to_3d(ours.loc[:, means]),
                                  jax_pp._mimic_to_3d(ref.loc[:, means]))
    assert pp._mimic_to_3d(ours.loc[:, means]).shape == (3, 2, 4)


# ---- without pandas -----------------------------------------------------------------------------


def test_setups_import_no_pandas(raw, tmp_path, monkeypatch) -> None:
    for name in [m for m in sys.modules if m == "pandas" or m.startswith("pandas.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    for name, kw in (("ecg", {}), ("nasdaq", {}), ("nasa", {}), ("usdroughts", {})):
        port, _ = _twins(raw, tmp_path / name, name)
        d = dm.DATAMODULE_REGISTRY[name](data_dir=port, **kw)
        d.prepare_data()
        d.setup()
        assert torch.isfinite(d.X_train).all() and len(d.X_test)
    assert sys.modules["pandas"] is None


def test_csv_reader_types_and_missing_fields(tmp_path) -> None:
    path = tmp_path / "t.csv"
    path.write_text("Date,A,B,Name\n2019-01-02,1.5,,x\n\n2019-01-03,NA,2,\n2019-01-04,3\n")
    t = csvio.read_csv(path, dates=("Date",))
    ref = pd.read_csv(path)
    assert t.names == list(ref.columns) and len(t) == len(ref) == 3
    np.testing.assert_array_equal(t["A"], ref["A"].to_numpy())
    np.testing.assert_array_equal(t["B"], ref["B"].to_numpy())
    assert list(t["Name"]) == ["x", None, None]
    assert t["Date"].dtype == np.dtype("datetime64[D]")
    np.testing.assert_array_equal(t["Date"], pd.to_datetime(ref["Date"]).to_numpy()
                                  .astype("datetime64[D]"))
    headerless = csvio.read_csv(path, header=False)
    assert headerless.names == ["0", "1", "2", "3"] and len(headerless) == 4
