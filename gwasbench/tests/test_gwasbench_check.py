"""The comparison that decides ``correct``: the reference agrees with the
port's CPU run, the float32 control fails it, and so does each fault a
cell can have when planted in the timed path."""

import os
import shutil
import tempfile

import pytest
import torch

from gwasbench import calibrate, harness
from gwasbench.reference import regression_perm, stoat_format

from gwasbench.tests.gwasbench_tiny import CELLS, SEED, run_tiny, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(name):
    res = run_tiny(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["checks"]["rows_off"]["value"] == 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_float32_control_is_not_correct(name, seed):
    cell = tiny_cell(name)
    workdir = tempfile.mkdtemp()
    try:
        got, ctrl = calibrate.program_reading(cell, seed, "cpu", workdir,
                                              control=True)
    finally:
        shutil.rmtree(workdir)
    assert all(got[k] <= v for k, v in cell.limits.items()), got
    assert any(ctrl[k] > v for k, v in cell.limits.items()), ctrl


def _scale_row0(real):
    def fault(*args):
        out = real(*args)
        first = out[0] if isinstance(out, tuple) else out
        first[0] *= 1.001
        return out
    return fault


def _half_rows(real):
    """The statistics of the first half of the rows, the rest filled from
    them."""
    def fault(*args):
        rows = args[-1]
        half = rows.shape[0] // 2 + 1
        out = real(*args[:-1], rows[:half])
        fill = lambda t: torch.cat([t, t[1:1 + rows.shape[0] - half]])
        return tuple(fill(t) for t in out) if isinstance(out, tuple) \
            else fill(out)
    return fault


def _stale(real):
    """Every chunk after the first returns the first chunk's result."""
    kept = {}

    def fault(*args):
        out = real(*args)
        return kept.setdefault("first", out)
    return fault


FAULTS = {"answer_altered": _scale_row0, "half_the_rows": _half_rows,
          "state_unchanged": _stale}
TIMED = {"kgp3_quant_perm10k": "perm_ols_stats",
         "kgp3_casecontrol_perm10k": "score_perm_stats"}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    from stoat_tpu_torch.pipeline import permutation
    attr = TIMED[name]
    monkeypatch.setattr(permutation, attr,
                        FAULTS[fault](getattr(permutation, attr)))
    res = run_tiny(name)
    assert not res["correct"], res["checks"]


def test_main_table_value_altered_is_not_correct(monkeypatch):
    """A statistic of the main table altered where it is produced."""
    from stoat_tpu_torch.pipeline import quantitative
    real = quantitative.student_t_pvalues

    def fault(*args, **kwargs):
        out = real(*args, **kwargs)
        out["beta"] = out["beta"] * 1.001
        return out
    monkeypatch.setattr(quantitative, "student_t_pvalues", fault)
    res = run_tiny("kgp3_quant_perm10k")
    assert not res["correct"]
    assert res["checks"]["main_gap"]["value"] > \
        res["checks"]["main_gap"]["limit"]


def test_printed_values_are_measured_against_their_rounding():
    assert stoat_format.value_gaps(["0.1235"], [0.12345], [0.12345])[0] == 0
    gap = stoat_format.value_gaps(["1.2346e-05"], [1.23449e-05],
                                  [1.23449e-05])[0]
    assert 4.8e-5 < gap < 4.9e-5     # 6e-10 below 1.23455e-05
    assert stoat_format.count_range("0.5", 9) == (4, 4)
    lo, hi = stoat_format.count_range(stoat_format.format_p(1235 / 10001),
                                      10000)
    assert lo <= 1234 <= hi
