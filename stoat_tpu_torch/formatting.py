"""Numeric string formatting — the output-parity contract.

The reference renders every statistic through ``stoat::set_precision``
(the reference's src/utils.cpp:5-15): C++ ``std::scientific`` with precision 4
when ``|x| < 0.1 && x != 0``, else ``std::defaultfloat`` with precision 4
(printf ``%.4g`` semantics).  Sentinels ``"NA"``, ``"0"``, ``"1"`` come
straight from the test engines (stats_test.cpp:189,268-270,313,322).

Pinned oracles (tests/unittest/utils_unit.cpp:9-30):
    0.00001234   -> "1.2340e-05"
    0.123456     -> "0.1235"
    0.333333333  -> "0.3333"
    1.0          -> "1"
"""

from __future__ import annotations

import math

__all__ = [
    "set_precision",
    "string_to_pvalue",
    "is_na",
    "is_pvalue_significant",
    "vector_to_string",
    "string_to_vector",
    "pair_to_string",
    "string_to_pair",
]


def set_precision(value: float) -> str:
    """Format a float exactly like the reference's ``set_precision``.

    ``std::scientific << std::setprecision(4)`` == Python ``%.4e``;
    ``std::defaultfloat << std::setprecision(4)`` == Python ``%.4g``
    (both are printf-family semantics, so the outputs are byte-identical).
    """
    v = float(value)
    if v != v:  # NaN renders as "nan" in libstdc++ and in Python's %g alike
        return "nan"
    if math.isinf(v):
        return "-inf" if v < 0 else "inf"
    if v != 0.0 and abs(v) < 1e-1:
        return f"{v:.4e}"
    return f"{v:.4g}"


def is_na(s: str) -> bool:
    """utils.cpp:31-33 — empty or literal "NA"."""
    return s == "" or s == "NA"


def string_to_pvalue(s: str) -> float:
    """utils.cpp:35-43 — parse a p-value string; NA/empty maps to 1.0."""
    if is_na(s):
        return 1.0
    return float(s)


def is_pvalue_significant(threshold: float, pvalue_str: str) -> bool:
    """utils.cpp:46-58 — "NA" is never significant; strict < comparison."""
    if pvalue_str == "NA":
        return False
    return float(pvalue_str) < threshold


def vector_to_string(vec) -> str:
    """utils.cpp:102-110 — comma-join with C++ ``operator<<`` rendering."""
    return ",".join(_render_scalar(x) for x in vec)


def _render_scalar(x) -> str:
    if isinstance(x, bool):
        return "1" if x else "0"
    if isinstance(x, float):
        # C++ streams print doubles with %g (precision 6) by default
        return f"{x:g}"
    return str(x)


def string_to_vector(s: str, typ=int) -> list:
    """utils.cpp:115-132 — comma-split with typed parsing."""
    out = []
    for token in s.split(","):
        try:
            out.append(typ(token))
        except ValueError as e:
            raise RuntimeError(f"Failed to parse token: {token}") from e
    return out


def pair_to_string(pair) -> str:
    """snarl_data_t.cpp:181-185 — ``start_end`` snarl id rendering."""
    return f"{pair[0]}_{pair[1]}"


def string_to_pair(s: str) -> tuple:
    """snarl_data_t.cpp:187-200."""
    if "_" not in s:
        raise RuntimeError("Input string does not contain an underscore separator")
    a, b = s.split("_", 1)
    return (int(a), int(b))
