"""The readers of the program's own spans and counters
(gwasbench/program_trace.py and the metrics that use it), each on a
hand-built Context and program store."""

import importlib

import pytest

from gwasbench.tracing import Context
from stoat_tpu_torch.trace import Record

READERS = ("ingest_wait_s_per_job", "card_wait_s_per_job",
           "writer_wait_s_per_job", "perm_rows_s_per_job",
           "h2d_gib_per_job", "perm_useful_pct", "idle_unattributed_pct")
US = 1000      # ns


def _read(name, ctx):
    return importlib.import_module(f"gwasbench.metrics.{name}").read(ctx)


def _ctx(jobs, device_ops, store):
    """A traced window of ``jobs`` harness job annotations (start, dur),
    in trace us, and ``store`` as the program's."""
    ctx = Context(jobs=len(jobs), peak_bytes=1, card="test card", spans={},
                  calls={}, device_ops=device_ops,
                  annotations=[("job", a, d) for a, d in jobs],
                  trace_window=(0.0, 10_000.0), on_card=True)
    ctx.program_store = store
    return ctx


def _rec(name, start_us, end_us, id_, parent, job, thread=1):
    return Record(name, thread, int(start_us * US), int(end_us * US), id_,
                  parent, job)


def _half_and_half():
    """One job: the harness's annotation over [1000, 2000] trace us, the
    program's root span over [500, 1500] on its own clock (offset 500 us);
    the card busy over [1000, 1400] and [1800, 2000], so idle over [1400,
    1800]: [1400, 1600] under runner.wait_ingest, [1600, 1800] under the
    root span alone (the pass's spans fall in the second busy stretch).
    An earlier window's job comes first in the store."""
    old = [_rec("job", 10, 20, 1, None, 1)]
    recs = [_rec("runner.wait_ingest", 900, 1100, 4, 3, 2),
            _rec("ingest", 850, 1050, 5, 3, 2, thread=2),
            _rec("runner", 550, 1100, 3, 2, 2),
            _rec("perm.rows", 1300, 1350, 6, 2, 2),
            _rec("perm.wait_card", 1350, 1360, 7, 2, 2),
            _rec("job", 500, 1500, 2, None, 2)]
    counters = {1: {"h2d_bytes": 7}, 2: {"h2d_bytes": 2**29, "spans": 6,
                                         "perm.snarls_computed": 400,
                                         "perm.snarls_tested": 73}}
    ops = [("kernel_a", 1000.0, 1400.0), ("kernel_b", 1800.0, 2000.0)]
    return _ctx([(1000.0, 1000.0)], ops, (old + recs, counters))


def test_a_gap_half_under_a_stage_and_half_under_the_root_reads_half():
    ctx = _half_and_half()
    assert _read("idle_unattributed_pct", ctx) == pytest.approx(50.0)
    note = [n for n in ctx.notes if n.startswith("idle of the card")]
    assert note and "runner.wait_ingest 0.0002" in note[0] \
        and "job 0.0002" in note[0]


@pytest.mark.parametrize("name,want", [
    ("ingest_wait_s_per_job", 200e-6), ("card_wait_s_per_job", 10e-6),
    ("writer_wait_s_per_job", 0.0), ("perm_rows_s_per_job", 50e-6),
    ("h2d_gib_per_job", 0.5), ("perm_useful_pct", 18.25)])
def test_the_window_jobs_spans_and_counters(name, want):
    # the ingest span on the prefetch thread is not the job thread's wait
    assert _read(name, _half_and_half()) == pytest.approx(want)


def test_offsets_that_spread_by_3_ms_read_none_with_a_note():
    store = ([_rec("job", 0, 900, 1, None, 1),
              _rec("job", 1000, 1900, 2, None, 2)], {})
    # the second annotation starts 3 ms later against the program's clock
    ctx = _ctx([(5000.0, 1000.0), (9000.0, 1000.0)],
               [("kernel_a", 5000.0, 5100.0)], store)
    assert _read("idle_unattributed_pct", ctx) is None
    assert any("spread by 3000.0 us" in n for n in ctx.notes)


@pytest.mark.parametrize("name", READERS)
def test_a_window_with_no_program_records_reads_none(name):
    ctx = _ctx([(1000.0, 1000.0)], [("kernel_a", 1000.0, 1400.0)], ([], {}))
    assert _read(name, ctx) is None
    assert any("0 program jobs" in n for n in ctx.notes)
