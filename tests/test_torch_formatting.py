"""Formatting-contract parity tests, on the port.

Oracles pinned from the reference's tests/unittest/utils_unit.cpp:9-96 and
the sentinel conventions in stats_test.cpp.  The JAX suite's tests
(tests/test_formatting.py) on the port's ``formatting.py`` and
``corrections.py``; each value is also ``stoat_tpu``'s on the same input.
The BH oracle of post_processing_unit.cpp is tests/test_torch_bhcorrect.py::
test_pinned_bh_oracle.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from stoat_tpu import corrections as jax_corrections
from stoat_tpu import formatting as jax_formatting
from stoat_tpu_torch.formatting import (
    is_pvalue_significant,
    pair_to_string,
    set_precision,
    string_to_pair,
    string_to_pvalue,
    string_to_vector,
    vector_to_string,
)
from stoat_tpu_torch.corrections import adjust_pvalues_bh, adjusted_holm


@pytest.mark.parametrize(
    "value,expected",
    [
        (0.00001234, "1.2340e-05"),
        (0.123456, "0.1235"),
        (0.00001234567890123456789, "1.2346e-05"),
        (0.34567890123456789, "0.3457"),
        (0.333333333, "0.3333"),
        (1.0, "1"),
        (1.000000000, "1"),
        # sentinels / extremes used by the stats engine
        (0.0, "0"),
        (1.7976931348623157e308, "1.798e+308"),   # DBL_MAX (stats_test.cpp:197)
        (0.1573, "0.1573"),
        (0.8857, "0.8857"),
        (9.8233e-03, "9.8233e-03"),
        (-0.2707, "-0.2707"),
        (-0.363, "-0.363"),
        (7.4217e-02, "7.4217e-02"),
        (0.1, "0.1"),
        (247411.0, "2.474e+05"),
    ],
)
def test_set_precision(value, expected):
    assert set_precision(value) == expected
    assert jax_formatting.set_precision(value) == expected


def test_string_to_pvalue():
    assert string_to_pvalue("0.01") == 0.01
    assert string_to_pvalue("NA") == 1.0
    assert string_to_pvalue("") == 1.0
    for text in ("0.01", "NA", "", "1.2340e-05"):
        assert string_to_pvalue(text) == jax_formatting.string_to_pvalue(text)


def test_is_pvalue_significant():
    assert is_pvalue_significant(0.05, "0.01") is True
    assert is_pvalue_significant(0.05, "0.05") is False
    assert is_pvalue_significant(0.05, "NA") is False
    for text in ("0.01", "0.05", "NA"):
        assert is_pvalue_significant(0.05, text) is \
            jax_formatting.is_pvalue_significant(0.05, text)


def test_vector_string_roundtrip():
    assert vector_to_string(["A", "B", "C"]) == "A,B,C"
    assert vector_to_string([1, 2, 3]) == "1,2,3"
    assert string_to_vector("4,578,6") == [4, 578, 6]
    with pytest.raises(RuntimeError):
        string_to_vector("4,abc,6")
    assert string_to_vector("4,578,6") == \
        jax_formatting.string_to_vector("4,578,6")


def test_pair_string_roundtrip():
    assert pair_to_string((4271, 4260)) == "4271_4260"
    assert string_to_pair("4271_4260") == (4271, 4260)
    assert jax_formatting.pair_to_string((4271, 4260)) == "4271_4260"


def test_adjusted_holm_monotone_and_bounded():
    adj = adjusted_holm(np.array([0.01, 0.03, 0.02, 0.05]))
    assert adj.shape == (4,)
    assert np.all(adj <= 1.0) and np.all(adj >= 0.0)
    # Equal inputs stay monotone after reordering
    adj2 = adjusted_holm(np.array([0.01, 0.01, 0.01, 0.01]))
    assert np.all(np.diff(adj2) >= 0)
    np.testing.assert_array_equal(
        adj2, jax_corrections.adjusted_holm(np.array([0.01] * 4)))


def test_adjusted_holm_values():
    # Hand-worked against the reference loop (utils.cpp:61-87)
    raw = np.array([0.01, 0.03, 0.02, 0.05])
    adj = adjusted_holm(raw)
    np.testing.assert_allclose(adj, [0.04, 0.06, 0.06, 0.06])
    np.testing.assert_array_equal(adj, jax_corrections.adjusted_holm(raw))


def test_bh_clamps_and_empty():
    adj = adjust_pvalues_bh(np.array([0.9, 0.95, 0.99]))
    assert np.all(adj <= 1.0)
    np.testing.assert_array_equal(
        adj, jax_corrections.adjust_pvalues_bh(np.array([0.9, 0.95, 0.99])))
    assert adjust_pvalues_bh(np.array([])).size == 0
