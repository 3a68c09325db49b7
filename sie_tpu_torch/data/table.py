"""CSV tables with the standard library: what the JAX package reads and
writes with pandas (`read_csv`, `select_dtypes`, `to_csv`), for the
forecast, M4 and anomaly files. A cell parses as a number when `float`
takes it; the cells pandas reads as missing (`NA_VALUES`) parse as NaN."""

from __future__ import annotations

import csv
from typing import List, Optional, Sequence, Tuple

import numpy as np

# pandas.read_csv's default missing-value strings
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def read_table(path: str) -> Tuple[List[str], List[List[str]]]:
    """(header, rows of cells as strings); rows shorter than the header
    are padded with empty cells, as pandas reads a ragged row."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r + [""] * (len(header) - len(r)) for r in reader if r]
    return header, rows


def parse_number(cell: str) -> Optional[float]:
    """The cell as a float (NaN for a missing value), or None when it is
    not a number."""
    s = cell.strip()
    if s in NA_VALUES:
        return float("nan")
    try:
        return float(s)
    except ValueError:
        return None


def numeric_columns(header: Sequence[str],
                    rows: Sequence[Sequence[str]]) -> List[int]:
    """The columns whose every cell parses as a number (pandas'
    `select_dtypes(include=[np.number])` on the frame it reads)."""
    return [j for j in range(len(header))
            if all(parse_number(r[j]) is not None for r in rows)]


def column_matrix(rows: Sequence[Sequence[str]], columns: Sequence[int],
                  dtype=np.float64) -> np.ndarray:
    """(len(rows), len(columns)) array of those columns' numbers; raises
    ValueError on a cell that is not one."""
    out = np.empty((len(rows), len(columns)), np.float64)
    for i, r in enumerate(rows):
        for k, j in enumerate(columns):
            v = parse_number(r[j])
            if v is None:
                raise ValueError(f"row {i + 1}, column {j}: {r[j]!r} is "
                                 f"not a number")
            out[i, k] = v
    return out.astype(dtype)


def write_table(path: str, header: Sequence[str], rows) -> None:
    """header, then one line per row; floats written with repr (every
    digit needed to read the same value back)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(header))
        for r in rows:
            w.writerow([repr(float(v)) if isinstance(v, (float, np.floating))
                        else v for v in r])
