"""One-shot raw -> array preprocessing pipelines (port of
``fourierdiffusion_tpu/data/preprocessing.py``), run once on the host to
cache ``X_train.npy``/``X_test.npy``.

NASDAQ, NASA and US droughts read their CSV files with ``data/csvio.py``
and numpy; no pandas. Each reproduces what the JAX package's pandas
pipeline computes, bit for bit in float32:

* ``_group_mean`` is pandas' grouped mean: per group and column the
  Kahan-compensated sum of the non-NaN values in row order, over their
  count (NaN where there is none);
* ``_pivot_table`` is ``DataFrame.pivot_table`` with its defaults: the
  mean of each (index, column) group, groups whose values are all NaN
  dropped, rows sorted by index, the value names sorted alphabetically
  (not in the order ``values=`` lists them), then the columns that are all
  NaN dropped;
* NASA's time bins are ``pd.cut``'s right-closed intervals, found with a
  left ``searchsorted`` over the edges; an empty bin stays a NaN row, and
  ``DataFrame.pivot`` keeps the features in the order given.

MIMIC-III reads MIMIC-Extract's HDF5 file, which needs pandas (and
PyTables): ``mimic_preprocess`` imports pandas, the one place in the port
that does; ``MIMICIIIDatamodule`` reads its cached arrays without it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fourierdiffusion_tpu_torch.data.csvio import read_csv

ID_COLS = ["subject_id", "hadm_id", "icustay_id"]
NASDAQ_VALUES = ("Open", "High", "Low", "Close", "Adj Close", "Volume")


def _save_splits(X_train: np.ndarray, X_test: np.ndarray, out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(out_dir / "X_train.npy", X_train.astype(np.float32))
    np.save(out_dir / "X_test.npy", X_test.astype(np.float32))


def _random_split(
    X: np.ndarray, train_frac: float, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(X))
    n_train = int(train_frac * len(X))
    return X[perm[:n_train]], X[perm[n_train:]]


def _group_mean(labels: np.ndarray, values: np.ndarray, n_groups: int) -> np.ndarray:
    """pandas' ``GroupBy.mean`` of ``values`` ``(n, k)`` float64 by
    ``labels`` in ``[0, n_groups)`` (-1: left out), as ``(n_groups, k)``."""
    keep = labels >= 0
    labels, values = labels[keep], values[keep]
    order = np.argsort(labels, kind="stable")
    labels, values = labels[order], values[order]
    # The place of each row within its group: rows of one rank update
    # distinct groups, so each rank is one vectorised step of the loop.
    rank = np.arange(len(labels)) - np.searchsorted(labels, labels, side="left")
    sumx = np.zeros((n_groups, values.shape[1]))
    comp = np.zeros_like(sumx)
    nobs = np.zeros_like(sumx)
    for r in range(int(rank.max()) + 1 if len(rank) else 0):
        at = rank == r
        g, v = labels[at], values[at]
        ok = ~np.isnan(v)
        y = v - comp[g]
        t = sumx[g] + y
        c = t - sumx[g] - y
        c[np.isnan(c)] = 0.0  # an infinite value leaves no compensation
        sumx[g] = np.where(ok, t, sumx[g])
        comp[g] = np.where(ok, c, comp[g])
        nobs[g] += ok
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(nobs > 0, sumx / nobs, np.nan)


def _pivot_table(
    index: np.ndarray, columns: np.ndarray, values: np.ndarray, value_names: list[str]
) -> tuple[np.ndarray, np.ndarray]:
    """``pivot_table(index=, columns=, values=value_names)``: the sorted row
    keys and the table ``(rows, value x column)`` as float64, value names
    in sorted order, each with its columns in sorted order."""
    row_keys, row_of = np.unique(index, return_inverse=True)
    col_keys, col_of = np.unique(columns, return_inverse=True)
    groups, group_of = np.unique(row_of * len(col_keys) + col_of, return_inverse=True)
    agged = _group_mean(group_of, values, len(groups))
    kept = ~np.isnan(agged).all(axis=1)
    groups, agged = groups[kept], agged[kept]
    rows, r = np.unique(groups // len(col_keys), return_inverse=True)
    cols, c = np.unique(groups % len(col_keys), return_inverse=True)
    table = np.full((len(rows), len(value_names), len(cols)), np.nan)
    table[r, :, c] = agged
    table = table[:, np.argsort(value_names, kind="stable"), :].reshape(len(rows), -1)
    return row_keys[rows], table[:, ~np.isnan(table).all(axis=0)]


def _nanmax(x: np.ndarray) -> float:
    """``Series.max()``: the largest non-NaN value, NaN if there is none."""
    x = x[~np.isnan(x)]
    return float(x.max()) if x.size else float("nan")


# --------------------------------------------------------------------------
# MIMIC-III
# --------------------------------------------------------------------------


def _mimic_impute(df):
    """LOCF -> per-stay mean -> 0 imputation of the hourly 'mean'
    aggregates, plus presence masks and time-since-measured channels, on a
    pandas frame (``mimic_preprocess`` passes it)."""
    df = df.copy()
    if len(df.columns.names) > 2:
        df.columns = df.columns.droplevel(("label", "LEVEL1", "LEVEL2"))
    means, counts = (slice(None), "mean"), (slice(None), "count")

    out = df.loc[:, (slice(None), ["mean", "count"])]
    stay_means = out.loc[:, means].groupby(ID_COLS).mean()
    # LOCF within each stay, then the stay's mean aligned to the hourly
    # rows, then 0.
    mean_block = out.loc[:, means].groupby(ID_COLS).ffill()
    stay_aligned = stay_means.reindex(
        type(mean_block.index).from_arrays(
            [mean_block.index.get_level_values(c) for c in ID_COLS]
        )
    )
    stay_aligned.index = mean_block.index
    out.loc[:, means] = mean_block.fillna(stay_aligned).fillna(0)

    out.loc[:, counts] = (df.loc[:, counts] > 0).astype(float)
    out.rename(columns={"count": "mask"}, level="Aggregation Function", inplace=True)

    is_absent = 1 - out.loc[:, (slice(None), "mask")]
    hours_absent = is_absent.cumsum()
    time_since = hours_absent - hours_absent[is_absent == 0].ffill()
    time_since.rename(
        columns={"mask": "time_since_measured"},
        level="Aggregation Function",
        inplace=True,
    )
    out = out.join(time_since)
    since = (slice(None), "time_since_measured")
    out.loc[:, since] = out.loc[:, since].fillna(100)
    out.sort_index(axis=1, inplace=True)
    return out


def _mimic_to_3d(df) -> np.ndarray:
    hours = sorted(set(df.index.get_level_values("hours_in")))
    return np.dstack([df.loc[(slice(None),) * 3 + (h,), :].values for h in hours])


def mimic_preprocess(data_dir: Path, random_seed: int, train_frac: float = 0.8) -> None:
    """MIMIC-Extract ``all_hourly_data.h5`` -> (N, 24, 104) splits. Reading
    HDF5 needs pandas and PyTables."""
    import pandas as pd

    dataset_path = data_dir / "all_hourly_data.h5"
    GAP_TIME, WINDOW_SIZE = 6, 24

    statics = pd.read_hdf(dataset_path, "patients")
    df = pd.read_hdf(dataset_path, "vitals_labs")

    ys = statics[statics.max_hours > WINDOW_SIZE + GAP_TIME][
        ["mort_hosp", "mort_icu", "los_icu"]
    ]
    lvl2 = df[
        df.index.get_level_values("icustay_id").isin(
            set(ys.index.get_level_values("icustay_id"))
        )
        & (df.index.get_level_values("hours_in") < WINDOW_SIZE)
    ]

    subjects = set(lvl2.index.get_level_values("subject_id"))
    if subjects != set(ys.index.get_level_values("subject_id")):
        raise ValueError("Subject ID pools differ!")

    rng = np.random.default_rng(random_seed)
    subj = rng.permutation(sorted(subjects))
    n_train = int(train_frac * len(subj))
    train_subj, test_subj = set(subj[:n_train]), set(subj[n_train:])
    lvl2_train = lvl2[lvl2.index.get_level_values("subject_id").isin(train_subj)]
    lvl2_test = lvl2[lvl2.index.get_level_values("subject_id").isin(test_subj)]

    means = (slice(None), "mean")
    mu = lvl2_train.loc[:, means].mean(axis=0)
    sd = lvl2_train.loc[:, means].std(axis=0)
    lvl2_train = lvl2_train.copy()
    lvl2_test = lvl2_test.copy()
    lvl2_train.loc[:, means] = (lvl2_train.loc[:, means] - mu) / sd
    lvl2_test.loc[:, means] = (lvl2_test.loc[:, means] - mu) / sd

    lvl2_train, lvl2_test = _mimic_impute(lvl2_train), _mimic_impute(lvl2_test)
    for d in (lvl2_train, lvl2_test):
        if d.isnull().any().any():
            raise ValueError("MIMIC-III imputation left a NaN")

    splits = []
    for d in (lvl2_train, lvl2_test):
        arr = _mimic_to_3d(d.loc[:, means]).astype(np.float32)
        arr = np.transpose(arr, (0, 2, 1))  # (example, time, channel)
        if arr.shape[1:] != (24, 104):
            raise ValueError(f"MIMIC-III split of shape {arr.shape}, expected (*, 24, 104)")
        splits.append(arr)
    _save_splits(splits[0], splits[1], data_dir)


# --------------------------------------------------------------------------
# NASDAQ
# --------------------------------------------------------------------------


def nasdaq_preprocess(
    data_dir: Path,
    random_seed: int,
    train_frac: float = 0.9,
    start_date: str = "2019-01-01",
    end_date: str = "2020-01-01",
) -> None:
    """Raw stock CSVs (``stocks/<name>.csv``) -> (N, 252, 6) splits, keeping
    only stocks active over the full interval with no missing trading day;
    the features in sorted order (Adj Close, Close, High, Low, Open, Volume)."""
    names, dates, values = [], [], []
    for path in sorted((data_dir / "stocks").glob("*.csv")):
        t = read_csv(path, dates=("Date",))
        names.append(np.full(len(t), path.stem, dtype=object))
        dates.append(t["Date"])
        values.append(np.stack([t[v] for v in NASDAQ_VALUES], axis=1).astype(np.float64))
    name, date, value = (np.concatenate(a) for a in (names, dates, values))
    day = date.astype(np.int64)
    dated = ~np.isnat(date)
    start = np.datetime64(start_date, "D").astype(np.int64)
    end = np.datetime64(end_date, "D").astype(np.int64)

    stock_names, stock_of = np.unique(name, return_inverse=True)
    first = np.full(len(stock_names), np.iinfo(np.int64).max)
    last = np.full(len(stock_names), np.iinfo(np.int64).min)
    np.minimum.at(first, stock_of[dated], day[dated])
    np.maximum.at(last, stock_of[dated], day[dated])
    valid = (first <= start) & (last >= end)
    keep = valid[stock_of] & dated & (day >= start) & (day < end)

    pairs = np.unique(np.stack([stock_of[keep], day[keep]], axis=1), axis=0)
    n_days = np.bincount(pairs[:, 0], minlength=len(stock_names))
    keep &= (n_days == 252)[stock_of]

    _, table = _pivot_table(name[keep], day[keep], value[keep], list(NASDAQ_VALUES))
    X = table.astype(np.float32).reshape(len(table), 6, 252)
    X = np.transpose(X, (0, 2, 1))
    X_train, X_test = _random_split(X, train_frac, random_seed)
    _save_splits(X_train, X_test, data_dir)


# --------------------------------------------------------------------------
# NASA batteries
# --------------------------------------------------------------------------

_NASA_SPECS = {
    "charge": (
        ["Voltage_measured", "Current_measured", "Temperature_measured",
         "Current_charge", "Voltage_charge"],
        10,
        5000,
    ),
    "discharge": (
        ["Voltage_measured", "Current_measured", "Temperature_measured",
         "Current_load", "Voltage_load"],
        15,
        1995,  # 2000 - 2000 % 15
    ),
}


def nasa_preprocess(
    data_dir: Path,
    subdataset: str = "charge",
    train_frac: float = 0.9,
    random_seed: int = 42,
) -> None:
    """Time-binned battery cycles -> (N, T, 5) splits; a cycle that ends
    at or before the cutoff, or has a sampling gap above the bin size, is
    dropped."""
    features, interval_bin, cutoff_raw = _NASA_SPECS[subdataset]
    cutoff_time = cutoff_raw - cutoff_raw % interval_bin
    edges = np.arange(-interval_bin, int(cutoff_time + interval_bin), interval_bin,
                      dtype=np.float64)

    metadata = read_csv(data_dir / "cleaned_dataset" / "metadata.csv")
    files = metadata["filename"][metadata["type"] == subdataset]

    rows = {}
    for filename in files:
        data = read_csv(data_dir / "cleaned_dataset" / "data" / filename)
        time = data["Time"]
        if _nanmax(time) <= cutoff_time:
            continue
        if _nanmax(np.diff(time)) > interval_bin:
            continue
        before = time < cutoff_time
        ids = np.searchsorted(edges, time[before], side="left")
        bins = np.where((ids == 0) | (ids == len(edges)), -1, ids - 1)
        feats = np.stack([data[f][before] for f in features], axis=1).astype(np.float64)
        if filename in rows:
            raise ValueError("Index contains duplicate entries, cannot reshape")
        rows[filename] = _group_mean(bins, feats, len(edges) - 1)
    if not rows:
        raise ValueError("No objects to concatenate")

    n_steps = cutoff_time // interval_bin + 1
    X = np.stack([rows[f].T for f in sorted(rows)]).astype(np.float32)
    X = X.reshape(len(rows), len(features), n_steps)
    X = np.transpose(X, (0, 2, 1))
    X_train, X_test = _random_split(X, train_frac, random_seed)
    _save_splits(X_train, X_test, data_dir / subdataset)


# --------------------------------------------------------------------------
# US droughts
# --------------------------------------------------------------------------


def droughts_preprocess(
    data_dir: Path,
    random_seed: int,
    train_frac: float = 0.9,
    start_date: str = "2011-01-01",
    end_date: str = "2012-01-01",
) -> None:
    """Daily meteorological CSV -> (N_counties, 365, F) splits for one year:
    the columns with a NaN in the year dropped, the features in sorted order."""
    t = read_csv(data_dir / "train_timeseries" / "train_timeseries.csv", dates=("date",))
    start, end = np.datetime64(start_date, "D"), np.datetime64(end_date, "D")
    window = (t["date"] >= start) & (t["date"] < end)
    columns = {}
    for name, col in zip(t.names, t.columns):
        col = col[window]
        if col.dtype.kind == "M":
            missing = np.isnat(col).any()
        elif col.dtype.kind == "f":
            missing = np.isnan(col).any()
        else:
            missing = any(v is None for v in col)
        if not missing:
            columns[name] = col
    value_names = [n for n in columns if n not in ("fips", "date")]
    values = np.stack([columns[n] for n in value_names], axis=1).astype(np.float64)
    _, table = _pivot_table(columns["fips"], columns["date"], values, value_names)
    n_days = int((end - start).astype(np.int64))
    n_feats = table.shape[1] // n_days
    X = table.astype(np.float32).reshape(len(table), n_feats, n_days)
    X = np.transpose(X, (0, 2, 1))
    X_train, X_test = _random_split(X, train_frac, random_seed)
    _save_splits(X_train, X_test, data_dir)


__all__ = [
    "droughts_preprocess",
    "mimic_preprocess",
    "nasa_preprocess",
    "nasdaq_preprocess",
]
