"""Files in the raw format of each real dataset, written from a numpy
``Generator`` with the stdlib ``csv`` module: the inputs of the
datamodules' ``prepare_data``/``setup`` where the real files are absent
(the tests, ``chip_smoke.py``). The values are random; the layouts are the
real ones:

* MIT-BIH (``ecg/mitbih_{train,test}.csv``): no header, 187 samples in
  [0, 1] and a label column, every field written as ``%.18e``;
* NASDAQ (``nasdaq/stocks/<name>.csv``): ``Date,Open,High,Low,Close,Adj
  Close,Volume``, one row per trading day;
* US droughts (``droughts/train_timeseries/train_timeseries.csv``):
  ``fips,date``, the 18 meteorological columns and a weekly ``score``
  (empty on the other days), rows by county then day;
* NASA batteries (``nasa/cleaned_dataset/metadata.csv`` and ``data/``):
  the metadata's columns, and per cycle the measured and charge (or load)
  columns with its ``Time`` in seconds.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

ECG_LENGTH = 187
# NYSE/NASDAQ holidays of 2019: 261 weekdays less these are 252 trading days.
HOLIDAYS_2019 = ("2019-01-01", "2019-01-21", "2019-02-18", "2019-04-19", "2019-05-27",
                 "2019-07-04", "2019-09-02", "2019-11-28", "2019-12-25")
NASDAQ_COLUMNS = ("Date", "Open", "High", "Low", "Close", "Adj Close", "Volume")
DROUGHTS_FEATURES = ("PRECTOT", "PS", "QV2M", "T2M", "T2MDEW", "T2MWET", "T2M_MAX",
                     "T2M_MIN", "T2M_RANGE", "TS", "WS10M", "WS10M_MAX", "WS10M_MIN",
                     "WS10M_RANGE", "WS50M", "WS50M_MAX", "WS50M_MIN", "WS50M_RANGE")
NASA_METADATA = ("type", "start_time", "ambient_temperature", "battery_id", "test_id",
                 "uid", "filename", "Capacity", "Re", "Rct")
NASA_COLUMNS = {
    "charge": ("Voltage_measured", "Current_measured", "Temperature_measured",
               "Current_charge", "Voltage_charge", "Time"),
    "discharge": ("Voltage_measured", "Current_measured", "Temperature_measured",
                  "Current_load", "Voltage_load", "Time"),
}


def write_csv(path: Path, header: Sequence[str] | None, rows: Iterable[Sequence]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        if header is not None:
            w.writerow(header)
        w.writerows(rows)


def write_mitbih(root: Path, rng: np.random.Generator, n_train: int, n_test: int) -> None:
    """``root/ecg/mitbih_{train,test}.csv``: each beat a bump of random
    place and width on noise, three in four padded with zeros from a random
    step on (as the real beats are), then its label (0-4)."""
    t = np.arange(ECG_LENGTH)
    for name, n in (("mitbih_train.csv", n_train), ("mitbih_test.csv", n_test)):
        centre = rng.uniform(20, 120, size=(n, 1))
        width = rng.uniform(3, 20, size=(n, 1))
        end = rng.integers(80, ECG_LENGTH, size=(n, 1))
        end[::4] = ECG_LENGTH
        x = np.exp(-0.5 * ((t - centre) / width) ** 2) + rng.uniform(0, 0.05, size=(n, ECG_LENGTH))
        x = np.where(t < end, x / x.max(axis=1, keepdims=True), 0.0)
        label = rng.integers(0, 5, size=(n, 1)).astype(np.float64)
        write_csv(root / "ecg" / name, None,
                  ([f"{v:.18e}" for v in row] for row in np.hstack([x, label])))


def trading_days(first: str, last: str) -> np.ndarray:
    """The weekdays from ``first`` to ``last`` that are not 2019 holidays."""
    days = np.arange(np.datetime64(first), np.datetime64(last) + 1)
    return days[np.is_busday(days, holidays=list(HOLIDAYS_2019))]


def write_stock(path: Path, rng: np.random.Generator, days: np.ndarray) -> None:
    """One stock's daily prices (a random walk) and volume."""
    close = 20.0 * np.exp(np.cumsum(rng.normal(0, 0.02, size=len(days))))
    spread = np.abs(rng.normal(0, 0.01, size=(len(days), 2))) * close[:, None]
    rows = []
    for d, c, (up, down) in zip(days, close, spread):
        o = c * (1 + rng.normal(0, 0.005))
        rows.append([str(d), f"{o:.6f}", f"{max(o, c) + up:.6f}", f"{min(o, c) - down:.6f}",
                     f"{c:.6f}", f"{0.9 * c:.6f}", f"{float(rng.integers(1e4, 1e7)):.1f}"])
    write_csv(path, NASDAQ_COLUMNS, rows)


def write_nasdaq(root: Path, rng: np.random.Generator, n_full: int) -> None:
    """``root/nasdaq/stocks``: ``n_full`` stocks that trade every day of
    2019 (from December 2018 to mid-January 2020), one that starts in June
    2019 (``LATE``) and one with a week of May missing (``GAPPY``): the
    pipeline keeps the first ``n_full``."""
    stocks = root / "nasdaq" / "stocks"
    days = trading_days("2018-12-03", "2020-01-15")
    for i in range(n_full):
        write_stock(stocks / f"S{i:03d}.csv", rng, days)
    write_stock(stocks / "LATE.csv", rng, days[days >= np.datetime64("2019-06-03")])
    gap = (days > np.datetime64("2019-05-01")) & (days < np.datetime64("2019-05-10"))
    write_stock(stocks / "GAPPY.csv", rng, days[~gap])


def write_droughts(root: Path, rng: np.random.Generator, n_counties: int,
                   first: str = "2010-12-01", last: str = "2012-01-31") -> None:
    """``root/droughts/train_timeseries/train_timeseries.csv``: every day of
    ``first``..``last`` for each county; ``score`` on Tuesdays only."""
    days = np.arange(np.datetime64(first), np.datetime64(last) + 1)
    tuesday = np.is_busday(days, weekmask="0100000")
    rows = []
    for fips in 1001 + 2 * np.arange(n_counties):
        base = rng.uniform(0, 100, size=len(DROUGHTS_FEATURES))
        walk = np.cumsum(rng.normal(0, 0.5, size=(len(days), len(DROUGHTS_FEATURES))), axis=0)
        score = rng.uniform(0, 5, size=len(days))
        for d, v, s, tue in zip(days, base + walk, score, tuesday):
            rows.append([str(int(fips)), str(d), *(f"{x:.2f}" for x in v),
                         f"{s:.4f}" if tue else ""])
    write_csv(root / "droughts" / "train_timeseries" / "train_timeseries.csv",
              ("fips", "date", *DROUGHTS_FEATURES, "score"), rows)


def cycle_times(rng: np.random.Generator, end: float, step: tuple[float, float] = (1.0, 9.0),
                start: float = 0.0) -> np.ndarray:
    """Sampling times from ``start`` to past ``end``, random steps in ``step``."""
    steps = rng.uniform(*step, size=int((end - start) / step[0]) + 2)
    times = start + np.concatenate([[0.0], np.cumsum(steps)])
    return times[: int(np.searchsorted(times, end)) + 1]


def write_nasa_cycle(path: Path, rng: np.random.Generator, subdataset: str,
                     times: np.ndarray) -> None:
    n = len(times)
    columns = NASA_COLUMNS[subdataset]
    values = np.stack([3.5 + 0.7 * rng.random(n), rng.normal(1.5, 0.2, n),
                       25 + 10 * rng.random(n), rng.normal(1.5, 0.2, n),
                       4.2 * rng.random(n), times], axis=1)
    write_csv(path, columns, ([repr(float(v)) for v in row] for row in values))


def write_nasa(root: Path, rng: np.random.Generator, n_cycles: int,
               subdataset: str = "charge", extra: dict[str, np.ndarray] | None = None) -> None:
    """``root/nasa/cleaned_dataset``: ``n_cycles`` cycles of ``subdataset``
    sampled every 1-9 s from 0 s to past the cutoff, one impedance row in
    the metadata (never read), then the ``extra`` cycles, by file name,
    with the times given."""
    base = root / "nasa" / "cleaned_dataset"
    cutoff = {"charge": 5000.0, "discharge": 1995.0}[subdataset]
    cycles = {f"{i + 1:05d}.csv": cycle_times(rng, cutoff + 50.0) for i in range(n_cycles)}
    cycles.update(extra or {})
    meta = [["impedance", "[2010. 7. 21.]", "24", "B0047", "0", "0", "99999.csv", "", "0.05", "0.2"]]
    for uid, (name, times) in enumerate(cycles.items(), start=1):
        write_nasa_cycle(base / "data" / name, rng, subdataset, times)
        meta.append([subdataset, "[2010. 7. 21. 15. 0. 35.]", "24", "B0047", str(uid),
                     str(uid), name, f"{rng.uniform(1, 2):.6f}", "", ""])
    write_csv(base / "metadata.csv", NASA_METADATA, meta)


__all__ = [
    "DROUGHTS_FEATURES",
    "NASDAQ_COLUMNS",
    "cycle_times",
    "trading_days",
    "write_csv",
    "write_droughts",
    "write_mitbih",
    "write_nasa",
    "write_nasa_cycle",
    "write_nasdaq",
    "write_stock",
]
