"""CSV tables as pandas reads and writes them, without pandas (the card's
machine has none).

:func:`read_table` types each column as ``pd.read_csv`` does and parses
floats with pandas' default parser (:func:`parse_float`), which is not
Python's ``float``: on 17-digit strings the two differ in about a third of
cases, and an ulp on a probability at a threshold changes a count.
:func:`write_table` and :func:`write_csv` write what ``DataFrame.to_csv``
writes: float64 by its shortest repr, float32 by its shortest float32
repr, NaN and missing cells empty.
"""

from __future__ import annotations

import csv
import math
import re
from typing import Dict, List, Sequence

import numpy as np

Table = Dict[str, np.ndarray]

# pandas' default NA strings.
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
       "n/a", "nan", "null"}
_INT = re.compile(r"[+-]?\d+\Z")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?\Z")
_POW10 = [float(f"1e{k}") for k in range(309)]


def is_na(s: str) -> bool:
    """Whether ``read_csv`` reads the cell ``s`` as missing."""
    return s in _NA


def parse_float(s: str) -> float:
    """A decimal string as pandas' C parser reads it by default
    (``precise_xstrtod``): at most 17 significant digits accumulated as
    ``n * 10 + d`` in float64, then one multiply or divide by a power of
    ten."""
    p, n = 0, len(s)
    negative = s[:1] == "-"
    if s[:1] in "+-" and n:
        p = 1
    number, exponent, digits = 0.0, 0, 0
    while p < n and s[p].isdigit():
        if digits < 17:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == ".":
        p += 1
        decimals = 0
        while digits < 17 and p < n and s[p].isdigit():
            number = number * 10.0 + (ord(s[p]) - 48)
            p, digits, decimals = p + 1, digits + 1, decimals + 1
        while p < n and s[p].isdigit():
            p += 1
        exponent -= decimals
    if negative:
        number = -number
    if p < n and s[p] in "eE":
        p += 1
        sign = -1 if s[p:p + 1] == "-" else 1
        p += s[p:p + 1] in ("+", "-")
        e = 0
        while p < n and s[p].isdigit():
            e, p = e * 10 + ord(s[p]) - 48, p + 1
        exponent += sign * e
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _column(cells: List[str]) -> np.ndarray:
    """A column typed as ``read_csv`` types it: int64 where every cell is
    an integer, float64 where every cell is a number or NA, else strings
    (NA as None)."""
    if cells and all(_INT.match(c) for c in cells):
        return np.array([int(c) for c in cells], np.int64)
    if all(c in _NA or _FLOAT.match(c) for c in cells):
        return np.array([math.nan if c in _NA else parse_float(c)
                         for c in cells], np.float64)
    return np.array([None if c in _NA else c for c in cells], object)


def read_table(path: str) -> Table:
    """A CSV with a header row as ``pd.read_csv(path)`` reads it: column
    name -> array, in file order; an empty header is ``Unnamed: <i>``."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header = [name or f"Unnamed: {i}" for i, name in enumerate(rows[0])]
    body = rows[1:]
    return {name: _column([r[i] if i < len(r) else "" for r in body])
            for i, name in enumerate(header)}


def cell(v) -> str:
    """A value as ``to_csv`` writes it."""
    if v is None:
        return ""
    if isinstance(v, np.floating) and v.dtype == np.float32:
        return "" if np.isnan(v) else str(v)
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    if isinstance(v, np.integer):
        return str(int(v))
    return str(v)


def write_table(path: str, table: Table, index: bool = False) -> None:
    """``pd.DataFrame(table).to_csv(path, index=index)``."""
    names = list(table)
    n = len(next(iter(table.values()))) if table else 0
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(([""] if index else []) + names)
        for i in range(n):
            w.writerow(([str(i)] if index else [])
                       + [cell(table[c][i]) for c in names])


def rows_to_table(rows: Sequence[Dict]) -> Table:
    """Rows of dicts as one table, columns in order of first appearance,
    a missing cell None (``pd.DataFrame(rows)``)."""
    names: List[str] = []
    for row in rows:
        names += [k for k in row if k not in names]
    table = {}
    for c in names:
        col = np.empty(len(rows), object)
        col[:] = [row.get(c) for row in rows]
        table[c] = col
    return table


def write_csv(path: str, rows: Sequence[Dict]) -> None:
    """``rows`` as ``pd.DataFrame(rows).to_csv(path, index=False)`` writes
    them."""
    write_table(path, rows_to_table(rows))
