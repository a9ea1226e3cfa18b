"""A small CSV reader on the stdlib ``csv`` module and numpy, for the raw
dataset files the datamodules read (the port needs no pandas).

``read_csv`` returns a :class:`Table` of named columns, in file order:

* a column whose every field is a number or empty is float64, an empty
  field NaN (also the other strings pandas reads as NaN by default, such as
  ``NA`` and ``null``); numbers are parsed correctly rounded, so a caller
  casts to float32 afterwards, as ``pd.read_csv(...).to_numpy(np.float32)``
  does (pandas' own C parser may differ from the correctly rounded float64
  in its last bit, which the cast to float32 rounds away);
* any other column holds the strings (an object array, NaN fields ``None``);
* the columns named in ``dates`` are ``numpy.datetime64[D]``, an empty
  field ``NaT``.

With ``header`` the first line names the columns, as ``pd.read_csv`` reads
a file by default, whether or not that line holds data; without it the
columns are named ``"0"``, ``"1"``, .... Blank lines are skipped and short
rows padded with empty fields, as pandas does.
"""

from __future__ import annotations

import csv
import dataclasses
import itertools
from pathlib import Path
from typing import Iterable

import numpy as np

# pandas' default NaN strings (``pandas._libs.parsers.STR_NA_VALUES``).
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_BLOCK_ROWS = 65536


@dataclasses.dataclass
class Table:
    """Columns of equal length, by name and by position."""

    names: list[str]
    columns: list[np.ndarray]

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[self.names.index(name)]

    def __len__(self) -> int:
        return len(self.columns[0]) if self.columns else 0


def _numbers(fields: tuple[str, ...]) -> np.ndarray | None:
    """The fields as float64 (NA strings NaN), or None if one is not a number."""
    try:
        return np.array(fields, dtype=np.float64)
    except ValueError:
        pass
    try:
        return np.array([np.nan if f in NA_VALUES else f for f in fields], dtype=np.float64)
    except ValueError:
        return None


def _strings(fields: Iterable[str]) -> np.ndarray:
    return np.array([None if f in NA_VALUES else f for f in fields], dtype=object)


def _rows(path: Path, skip_header: bool):
    """The file's rows, blank lines skipped."""
    with open(path, newline="") as f:
        rows = (tuple(row) for row in csv.reader(f) if row)
        if skip_header:
            next(rows, None)
        yield from rows


def _padded(rows, width: int, path: Path):
    for row in rows:
        if len(row) > width:
            raise ValueError(f"{path}: a row of {len(row)} fields, {width} expected")
        yield row + ("",) * (width - len(row))


def read_csv(path: str | Path, *, header: bool = True, dates: Iterable[str] = ()) -> Table:
    """Read ``path`` into a :class:`Table` (see the module docstring)."""
    path = Path(path)
    head = _rows(path, False)
    first = next(head, ())
    head.close()
    names = list(first) if header else [str(i) for i in range(len(first))]
    width = len(names)
    rows = _padded(_rows(path, header), width, path)
    blocks = []
    while chunk := list(itertools.islice(rows, _BLOCK_ROWS)):
        blocks.append([_numbers(col) for col in zip(*chunk)])
    dates = set(dates)
    string_cols = [j for j in range(width)
                   if names[j] in dates or any(b[j] is None for b in blocks)]
    strings: dict[int, list[str]] = {j: [] for j in string_cols}
    if string_cols:
        # A second pass for the columns that are not all numbers: their
        # fields as written.
        for row in _padded(_rows(path, header), width, path):
            for j in string_cols:
                strings[j].append(row[j])
    columns = []
    for j, name in enumerate(names):
        if j not in strings:
            columns.append(np.concatenate([b[j] for b in blocks]) if blocks
                           else np.zeros(0, np.float64))
        elif name in dates:
            columns.append(np.array([None if f in NA_VALUES else f for f in strings[j]],
                                    dtype="datetime64[D]"))
        else:
            columns.append(_strings(strings[j]))
    return Table(names=names, columns=columns)


__all__ = ["NA_VALUES", "Table", "read_csv"]
