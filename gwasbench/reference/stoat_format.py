"""stoat's output formats, for the reference and the comparison.

``set_precision`` is a frozen copy of stoat_tpu_torch/formatting.py
set_precision (lines 32-46 at the commit that added this benchmark), the
reference tool's ``std::scientific``/``std::defaultfloat`` with precision
4.  The rest reads the TSVs a job wrote and measures how far a printed
value lies from a reference value: the distance from the reference value
to the interval of values that print as the string, relative to a scale.
A value printed from the exact result is 0 away whatever its rounding.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["set_precision", "format_p", "read_table", "columns",
           "half_unit", "value_gaps", "count_range"]


def set_precision(value: float) -> str:
    v = float(value)
    if v != v:
        return "nan"
    if math.isinf(v):
        return "-inf" if v < 0 else "inf"
    if v != 0.0 and abs(v) < 1e-1:
        return f"{v:.4e}"
    return f"{v:.4g}"


def format_p(value: float) -> str:
    """A printed statistic: NaN is "NA"."""
    if value != value:
        return "NA"
    return set_precision(value)


def read_table(data: bytes) -> Tuple[List[str], List[List[str]]]:
    """(header columns, rows of columns) of a TSV's bytes."""
    lines = data.decode().split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    if not lines:
        return [], []
    return lines[0].split("\t"), [line.split("\t") for line in lines[1:]]


def half_unit(strings: Sequence[str], values: np.ndarray) -> np.ndarray:
    """Half the last printed digit of each string (``set_precision``'s
    five significant digits below 0.1, four above), 0 for an exact 0."""
    out = np.zeros(len(strings))
    for i, (s, v) in enumerate(zip(strings, values)):
        if v == 0 or not np.isfinite(v):
            continue
        exp = int(s.split("e")[1]) if "e" in s else \
            int(math.floor(math.log10(abs(v))))
        digits = 4 if ("e" in s and abs(v) < 0.1) else 3
        out[i] = 0.5 * 10.0 ** (exp - digits)
    return out


def value_gaps(strings: Sequence[str], ref: np.ndarray,
               scale: np.ndarray) -> np.ndarray:
    """Per cell, the distance from ``ref`` to the values that print as the
    cell's string, over ``scale``; NaN where the string is "NA" (the
    caller compares those cells by their NA pattern)."""
    vals = np.array([np.nan if s == "NA" else float(s) for s in strings])
    u = half_unit(strings, vals)
    with np.errstate(invalid="ignore", divide="ignore"):
        gap = np.maximum(np.abs(vals - ref) - u, 0.0) / scale
    return np.where(np.isnan(vals), np.nan, gap)


def count_range(string: str, n_perms: int) -> Tuple[int, int]:
    """The counts n, 0 <= n <= n_perms, whose (1 + n) / (n_perms + 1)
    prints as ``string``: (lowest, highest), or (-1, -1) for none."""
    try:
        v = float(string)
    except ValueError:
        return -1, -1
    centre = int(round(v * (n_perms + 1))) - 1
    hits = [n for n in range(centre - 3, centre + 4)
            if 0 <= n <= n_perms
            and format_p((1 + n) / (n_perms + 1)) == string]
    return (hits[0], hits[-1]) if hits else (-1, -1)


def columns(header: List[str], rows: List[List[str]]) -> Dict[str, List[str]]:
    """The table as {column: cells}."""
    return {name: [r[i] if i < len(r) else "" for r in rows]
            for i, name in enumerate(header)}
