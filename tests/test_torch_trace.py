"""The port's spans and counters (stoat_tpu_torch/trace.py): nothing is
recorded without a profiler; under a CPU ``torch.profiler`` a whole
``vcf -q -c`` and ``vcf -b -c`` job with ``--permutations`` records every
stage span of its path, nested in its job, and counters that agree with
what the job uploaded and printed; and the job's tables do not change."""

import os

import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile

from fixtures import make_fixture
from stoat_tpu_torch import cli, convert, trace
from stoat_tpu_torch.pipeline import permutation

MODES = {"q": ("-q", "quantitative", "quantitative_permutation_vcf.tsv"),
         "b": ("-b", "binary", "binary_permutation_vcf.tsv")}
# every span the single-device path of a vcf job with permutations crosses
PATH_SPANS = {"job", "cli.parse", "runner", "runner.wait_ingest",
              "runner.wait_tokens", "runner.pack", "runner.dispatch",
              "runner.wait_writer", "perm", "perm.ingest", "perm.pack",
              "perm.rows", "perm.dispatch", "perm.wait_card", "perm.write",
              "ingest", "upload"}


def _tables(out):
    got = {}
    for name in sorted(os.listdir(out)):
        if name.endswith(".tsv"):
            with open(os.path.join(out, name), "rb") as fh:
                got[name] = fh.read()
    return got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per mode: the tables of the job with the profiler off, then those
    of the same job under a CPU profiler with its records, counters and
    the bytes of every array handed to ``convert.upload``."""
    base = tmp_path_factory.mktemp("trace")
    paths = make_fixture(str(base / "data"), n_samples=40, n_snarls=60,
                         seed=3, n_chroms=2)
    got = {}
    for mode, (flag, pheno, _perm) in MODES.items():
        argv = ["vcf", "-s", paths["snarl"], "-v", paths["vcf"], flag,
                paths[pheno], "-c", paths["covariate"], "-C", "AGE,SEX",
                "--permutations", "20", "--perm-seed", "5", "--device",
                "cpu", "-o"]
        trace.clear()
        off = str(base / f"off_{mode}")
        assert cli.main(argv + [off]) == 0
        recorded_off = (trace.records(), trace.counters())
        uploaded = []
        real = convert.upload

        def spy(arr, device):
            uploaded.append(np.ascontiguousarray(arr).nbytes)
            return real(arr, device)
        on = str(base / f"on_{mode}")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(convert, "upload", spy)
            mp.setattr(permutation, "upload", spy)
            with profile(activities=[ProfilerActivity.CPU]):
                assert cli.main(argv + [on]) == 0
        got[mode] = dict(off=_tables(off), on=_tables(on),
                         recorded_off=recorded_off, records=trace.records(),
                         counters=trace.counters(), uploaded=uploaded)
    trace.clear()
    return got


def test_off_span_is_the_shared_noop():
    trace.clear()
    assert trace.span("a") is trace.span("b", root=True)
    with trace.span("a"):
        trace.count("h2d_bytes", 8)
    assert trace.current() is None
    assert trace.records() == [] and trace.counters() == {}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_a_job_without_the_profiler_records_nothing(runs, mode):
    assert runs[mode]["recorded_off"] == ([], {})


@pytest.mark.parametrize("mode", sorted(MODES))
def test_every_span_of_the_path_is_recorded(runs, mode):
    names = {r.name for r in runs[mode]["records"]}
    assert names == PATH_SPANS
    counters = list(runs[mode]["counters"].values())
    assert len(counters) == 1
    assert counters[0]["spans"] == len(runs[mode]["records"])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_spans_nest_in_their_job(runs, mode):
    records = runs[mode]["records"]
    by_id = {r.id: r for r in records}
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == ["job"]
    root = roots[0]
    for r in records:
        assert r.job == root.job
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            parent = by_id[r.parent]
            assert parent.start_ns <= r.start_ns
            assert parent.end_ns >= r.end_ns
    # the main table's ingest runs on its prefetch thread, under the
    # runner's span; the pass's runs in line under perm.ingest
    ingest = [r for r in records if r.name == "ingest"]
    on_prefetch = [r for r in ingest if r.thread != root.thread]
    assert on_prefetch and all(by_id[r.parent].name == "runner"
                               for r in on_prefetch)
    assert all(by_id[r.parent].name == "perm.ingest"
               for r in ingest if r.thread == root.thread)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_h2d_bytes_counts_every_upload(runs, mode):
    (counters,) = runs[mode]["counters"].values()
    assert runs[mode]["uploaded"]
    assert counters["h2d_bytes"] == sum(runs[mode]["uploaded"])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_snarls_tested_counts_the_printed_p(runs, mode):
    (counters,) = runs[mode]["counters"].values()
    lines = runs[mode]["on"][MODES[mode][2]].decode().splitlines()
    col = lines[0].split("\t").index("P_ASY")
    printed = sum(1 for line in lines[1:] if line.split("\t")[col] != "NA")
    assert 0 < counters["perm.snarls_tested"] == printed
    assert counters["perm.snarls_computed"] >= len(lines) - 1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_outputs_are_identical_with_the_profiler_on(runs, mode):
    assert runs[mode]["on"] == runs[mode]["off"]
    assert len(runs[mode]["on"]) == 2


def test_each_and_adopt_carry_the_job_to_another_thread():
    import threading
    trace.clear()
    seen = {}
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("job", root=True):
            parent = trace.current()

            def worker():
                with trace.adopt(parent):
                    with trace.span("ingest"):
                        trace.count("h2d_bytes", 3)
                seen["after"] = trace.current()
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
            assert list(trace.each("runner.pack", [1, 2])) == [1, 2]
    records = trace.records()
    root = [r for r in records if r.name == "job"][0]
    ingest = [r for r in records if r.name == "ingest"][0]
    assert ingest.parent == root.id and ingest.job == root.job
    assert ingest.thread != root.thread and seen["after"] is None
    # two items, then the next() that ends the iteration
    assert [r.name for r in records].count("runner.pack") == 3
    assert trace.counters()[root.job]["h2d_bytes"] == 3
    trace.clear()
