"""The port's single-core C++ baseline (``stoat_tpu_torch/native/
baseline.py``) against ``stoat_tpu``'s and the scalar oracle.

``pack_for_baseline`` gives the arrays of ``bench._pack_for_baseline``;
``run_baseline_cpp`` counts what ``stoat_tpu``'s baseline and
``reference_impl`` count, and both libraries write the same p-value sum
through their ``double*``: bitwise, since both build with the same g++
flags (``stoat_tpu/native/__init__.py:45-46``); were the flags to differ,
within 1e-12 relative.  ``stoat_tpu``'s library is built by its own
``get_baseline_lib`` into a temporary directory, so that no other test
process loads it while it is being written.
"""

import ctypes
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import bench
import reference_impl as R
from fixtures import make_fixture
from stoat_tpu import native as jax_native
from stoat_tpu.io.phenotype import (parse_binary_pheno as jax_binary,
                                    parse_quantitative_pheno as jax_quant)
from stoat_tpu.io.snarl_file import parse_snarl_path as jax_snarls
from stoat_tpu.io.vcf import VcfReader as JaxVcfReader
from stoat_tpu.matrix import EdgeHaplotypeMatrix as JaxMatrix
from stoat_tpu.tables import pack_chromosome as jax_pack
from stoat_tpu_torch import native
from stoat_tpu_torch.io.phenotype import (parse_binary_pheno,
                                          parse_quantitative_pheno)
from stoat_tpu_torch.io.snarl_file import parse_snarl_path
from stoat_tpu_torch.io.vcf import VcfReader
from stoat_tpu_torch.matrix import EdgeHaplotypeMatrix
from stoat_tpu_torch.native import baseline
from stoat_tpu_torch.tables import pack_chromosome

# stoat_tpu's g++ command line, stoat_tpu/native/__init__.py:45-46
JAX_FLAGS = ("-O3", "-std=c++17", "-march=native", "-shared", "-fPIC",
             "-pthread")
SAME_FLAGS = native.CXX_FLAGS == JAX_FLAGS


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """stoat_tpu's baseline library, built by its own get_baseline_lib;
    its run_baseline_cpp and run_baseline_graph_cpp use it meanwhile."""
    path = str(tmp_path_factory.mktemp("jax_baseline")
               / "libstoat_baseline.so")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_BASE_LIB", path)
        mp.setattr(jax_native, "_base_lib", None)
        mp.setattr(jax_native, "_base_tried", False)
        lib = jax_native.get_baseline_lib()
        if lib is None:
            pytest.skip("stoat_tpu's baseline toolchain unavailable")
        yield lib


def _workload(tmp_path, n_samples, n_snarls, seed, drop_every):
    """The fixture's first chromosome through both packages: the port's
    (packed, edge matrix, phenotypes), stoat_tpu's (packed, edge matrix),
    and the snarls.  ``drop_every`` > 0 leaves every drop_every-th VCF
    record out of the matrices, so that some paths have edges the matrix
    lacks."""
    fx = make_fixture(str(tmp_path), n_samples=n_samples,
                      n_snarls=n_snarls, seed=seed)
    samples = list(fx["samples"])
    out = []
    for reader_t, matrix_t, snarls_f, pack_f in (
            (VcfReader, EdgeHaplotypeMatrix, parse_snarl_path,
             pack_chromosome),
            (JaxVcfReader, JaxMatrix, jax_snarls, jax_pack)):
        _, recs = next(iter(reader_t(fx["vcf"]).chromosome_chunks()))
        m = matrix_t(2 * n_samples)
        for i, r in enumerate(recs):
            if drop_every and i % drop_every == 0:
                continue
            m.add_record(r)
        snarls = snarls_f(fx["snarl"])["ref"]
        out.append((pack_f(snarls, m), m, snarls))
    pb, _ = parse_binary_pheno(fx["binary"], samples)
    pq = parse_quantitative_pheno(fx["quantitative"], samples)
    jb, _ = jax_binary(fx["binary"], samples)
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(pq, jax_quant(fx["quantitative"], samples))
    return out[0], out[1], pb, pq


def _dense(packed):
    """The uint8 matrix with the all-zero row appended (bench.py:399-401)."""
    return np.ascontiguousarray(
        np.vstack([packed.dense_matrix(),
                   np.zeros((1, packed.n_haplotypes), bool)]), np.uint8)


def _run_handle(lib, dense, rows, offs, soffs, pb, pq):
    """(count, p-value sum) of one library's stoat_baseline_run."""
    pb = np.ascontiguousarray(pb, np.uint8)
    pq = np.ascontiguousarray(pq, np.float64)
    sink = ctypes.c_double()

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n = lib.stoat_baseline_run(
        ptr(dense, ctypes.c_uint8), dense.shape[0], dense.shape[1],
        ptr(rows, ctypes.c_int32), ptr(offs, ctypes.c_int64),
        ptr(soffs, ctypes.c_int64), len(soffs) - 1, ptr(pb, ctypes.c_uint8),
        ptr(pq, ctypes.c_double), len(pb), 3, 5, 0.05, ctypes.byref(sink))
    return n, sink.value


def _same_sum(got, want):
    if SAME_FLAGS:
        assert got == want                       # same flags: bitwise
    else:
        assert got == pytest.approx(want, rel=1e-12, abs=0)


@pytest.mark.parametrize("n_samples,n_snarls,seed,drop_every", [
    pytest.param(30, 20, 8, 0, id="30x20-seed8"),
    pytest.param(200, 300, 21, 0, id="200x300-seed21"),
    pytest.param(60, 80, 5, 4, id="60x80-seed5-unresolved-edges")])
def test_baseline_matches_stoat_tpu_and_the_oracle(
        tmp_path, jax_lib, n_samples, n_snarls, seed, drop_every):
    (packed, m, snarls), (jpacked, jm, _), pb, pq = _workload(
        tmp_path, n_samples, n_snarls, seed, drop_every)
    dense = _dense(packed)
    np.testing.assert_array_equal(dense, _dense(jpacked))
    arrays = baseline.pack_for_baseline(packed, m, dense.shape[0] - 1)
    want = bench._pack_for_baseline(jpacked, jm, dense.shape[0] - 1)
    for got, exp in zip(arrays, want):
        assert got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp)
    rows, offs, soffs = arrays
    if drop_every:                    # some path went to the all-zero row
        assert (rows == dense.shape[0] - 1).any()

    analyzed = baseline.run_baseline_cpp(dense, rows, offs, soffs,
                                         pb.astype(np.uint8), pq, 3, 5, 0.05)
    assert analyzed == jax_native.run_baseline_cpp(
        dense, rows, offs, soffs, pb.astype(np.uint8), pq, 3, 5, 0.05)

    expected = 0
    matrix = packed.dense_matrix()
    for snarl in snarls:
        if R.binary_reference(snarl, m, matrix, pb, 3, 5, 0.05) is not None:
            expected += 1
        res = R.quantitative_reference(snarl, m, matrix, pq, None, 3, 5,
                                       0.05)
        if res is not None and res != "degenerate":
            expected += 1
    assert analyzed == expected > 0

    n_port, sum_port = _run_handle(baseline.get_baseline_lib(), dense,
                                   *arrays, pb, pq)
    n_jax, sum_jax = _run_handle(jax_lib, dense, *arrays, pb, pq)
    assert n_port == n_jax == analyzed
    assert np.isfinite(sum_port) and sum_port > 0
    _same_sum(sum_port, sum_jax)


@pytest.mark.parametrize("n_snarls,n_samples,seed", [
    (300, 50, 0), (2000, 12, 3)])
def test_graph_baseline_matches_stoat_tpu(tmp_path, monkeypatch, jax_lib,
                                          n_snarls, n_samples, seed):
    """A bubble chain made by bench.make_graph_workload (bench.py:503-553)
    at a small size: the same count and p-value sum through both
    libraries."""
    monkeypatch.setattr(bench, "GRAPH_SNARLS", n_snarls)
    monkeypatch.setattr(bench, "GRAPH_SAMPLES", n_samples)
    _gfa, _pheno, steps, offsets, starts, pheno = bench.make_graph_workload(
        str(tmp_path), np.random.default_rng(seed))
    tested = baseline.run_baseline_graph_cpp(steps, offsets, starts, pheno)
    assert tested == jax_native.run_baseline_graph_cpp(steps, offsets,
                                                       starts, pheno)
    assert 0 < tested <= n_snarls

    sums = []
    for lib in (baseline.get_baseline_lib(), jax_lib):
        sink = ctypes.c_double()
        n = lib.stoat_baseline_graph(
            steps.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(offsets) - 1,
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(starts), pheno.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(sink))
        assert n == tested
        sums.append(sink.value)
    assert np.isfinite(sums[0]) and sums[0] > 0
    _same_sum(*sums)


def test_baseline_lives_under_the_build_dir_by_key():
    """Built into build/stoat_tpu_torch/native/ under a name keyed by the
    source, the flags and the host CPU, with no zlib."""
    path = native.library_path(baseline.BASELINE_SRC, baseline.BASELINE_LIBS)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libbaseline_core-")
    assert baseline.BASELINE_LIBS == ()
    assert os.path.samefile(baseline.get_baseline_lib()._name, path)


def test_a_source_that_does_not_compile_raises(tmp_path, monkeypatch):
    """A failed build raises with g++'s message; it never returns None."""
    bad = tmp_path / "baseline_core.cpp"
    bad.write_text("int stoat_baseline_run( { this is not C++\n")
    monkeypatch.setattr(baseline, "BASELINE_SRC", str(bad))
    monkeypatch.setattr(baseline, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(native.NativeBuildError, match="error"):
        baseline.get_baseline_lib()
    with pytest.raises(native.NativeBuildError):
        baseline.run_baseline_cpp(np.zeros((1, 2), np.uint8),
                                  np.zeros(0, np.int32),
                                  np.zeros(1, np.int64),
                                  np.zeros(1, np.int64),
                                  np.zeros(2, np.uint8), np.zeros(2),
                                  3, 5, 0.05)
    assert not any(f.endswith(".so")
                   for f in os.listdir(tmp_path / "build"))


def _chip_smoke():
    from test_torch_cli import _chip_smoke as load
    return load()


@pytest.mark.parametrize("n_samples,n_snarls,seed", [(40, 60, 1),
                                                     (120, 200, 4)])
def test_smoke_count_check_matches_the_oracle(tmp_path, n_samples, n_snarls,
                                              seed):
    """chip_smoke.py's own count of the analyses the baseline must run
    (baseline_reference_count, from the VCF text) equals the baseline's
    count through baseline_inputs, over two chromosomes, and
    reference_impl's."""
    smoke = _chip_smoke()
    paths = make_fixture(str(tmp_path), n_samples=n_samples,
                         n_snarls=n_snarls, seed=seed, n_chroms=2)
    got = sum(baseline.run_baseline_cpp(*args, 3, 5, 0.05)
              for args in smoke.baseline_inputs(paths))
    assert got == smoke.baseline_reference_count(paths)
    expected = 0
    samples = list(paths["samples"])
    pb, _ = parse_binary_pheno(paths["binary"], samples)
    pq = parse_quantitative_pheno(paths["quantitative"], samples)
    for chrom, recs in VcfReader(paths["vcf"]).chromosome_chunks():
        m = EdgeHaplotypeMatrix(2 * n_samples)
        for r in recs:
            m.add_record(r)
        matrix = m.shrink()
        for snarl in parse_snarl_path(paths["snarl"])[chrom]:
            if R.binary_reference(snarl, m, matrix, pb, 3, 5,
                                  0.05) is not None:
                expected += 1
            res = R.quantitative_reference(snarl, m, matrix, pq, None, 3, 5,
                                           0.05)
            expected += res is not None and res != "degenerate"
    assert got == expected > 0


@pytest.mark.parametrize("n_snarls,seed", [(300, 0), (700, 1)])
def test_smoke_graph_arrays_are_flat_steps(tmp_path, jax_lib, n_snarls, seed):
    """chip_smoke.write_graph's baseline arrays are the port's
    graph/partition.py flat_steps of the GFA it writes; the graph loop
    tests as many snarls as the port's ``graph`` table has rows, and
    counts what stoat_tpu's baseline counts."""
    from stoat_tpu_torch import cli
    from stoat_tpu_torch.graph.association import PathPartitioner
    from stoat_tpu_torch.graph.gfa import load_gfa
    from stoat_tpu_torch.graph.partition import flat_steps
    from stoat_tpu_torch.graph.snarls import find_snarls
    smoke = _chip_smoke()
    g = smoke.write_graph(str(tmp_path / "g"), n_snarls, n_samples=12,
                          seed=seed)
    graph = load_gfa(g["gfa"], {"ref"})
    forest = find_snarls(graph)
    part = PathPartitioner(graph, [p for p in graph.paths
                                   if p.sample != "ref"])
    _names, steps, offsets, path_sample, starts = flat_steps(forest, part)
    b = g["baseline"]
    np.testing.assert_array_equal(steps, b["steps"])
    np.testing.assert_array_equal(offsets, b["offsets"])
    np.testing.assert_array_equal(np.sort(starts), np.sort(b["starts"]))
    np.testing.assert_array_equal(path_sample,
                                  np.arange(len(offsets) - 1) // 2)
    out = str(tmp_path / "out")
    assert cli.main(["graph", "-p", g["gfa"], "-d", g["gfa"], "-b",
                     g["pheno"], "-r", "ref", "-o", out, "--device",
                     "cpu"]) == 0
    with open(os.path.join(out, "binary_table_graph.tsv")) as fh:
        rows = sum(1 for _ in fh) - 1
    tested = baseline.run_baseline_graph_cpp(b["steps"], b["offsets"],
                                             b["starts"], b["pheno"])
    assert tested == rows > 0
    assert tested == jax_native.run_baseline_graph_cpp(
        b["steps"], b["offsets"], b["starts"], b["pheno"])
