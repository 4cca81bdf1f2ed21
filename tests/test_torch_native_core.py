"""Native C++ VCF-ingestion core: parity with the Python reader.

The JAX suite's tests (tests/test_native_core.py) on the port's
``native/stoat_core.cpp`` and ``pipeline/packed.py``; the port's native
reader also gives ``stoat_tpu``'s chunks, and its CLI runs write
``stoat_tpu``'s files (``test_torch_end_to_end.cli_main``).

Not held here: the three streamed-words tests
(test_streamed_device_words_match_whole_upload,
test_streamed_words_stale_rows_are_patched,
test_streamed_words_shared_edge_across_batches).  They pin
``assemble_words_device`` and ``iter_chromosome_matrices(...,
stream_device_words=True)``, the TPU tunnel's incremental upload, which
the port leaves out on purpose (ROADMAP §2): it uploads each
chromosome's words once (``runner.upload_words``).
"""

import filecmp
import gzip
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

from stoat_tpu import native as jax_native
from stoat_tpu_torch.io.vcf import VcfReader
from stoat_tpu_torch.matrix import EdgeHaplotypeMatrix

from fixtures import make_fixture
from test_torch_end_to_end import cli_main

native = pytest.importorskip("stoat_tpu_torch.native")


@pytest.fixture(scope="module")
def lib_available():
    if native.get_lib() is None or jax_native.get_lib() is None:
        pytest.skip("native core toolchain unavailable")


def python_reader_only(monkeypatch):
    """stoat_tpu's use_native=False: the port's runner has no such option,
    so its native reader is made to fail and the Python reader runs."""
    def unavailable(path):
        raise RuntimeError("the Python reader is asked for")
    monkeypatch.setattr(native, "NativeVcfMatrixReader", unavailable)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmpdir = tmp_path_factory.mktemp("native")
    return make_fixture(str(tmpdir), n_samples=30, n_snarls=15, seed=9)


def dense_chunks(vcf_path):
    """(chrom, matrix bool [E, H], edges uint64 [E, 4]) per chromosome from
    the port's native reader.  The port reads only the packed words
    (``chunks_packed``); stoat_tpu's ``chunks_arrays`` gives the dense
    matrix, which is held here to the words unpacked."""
    from stoat_tpu_torch.pipeline.packed import unpack_words_to_dense
    reader = native.NativeVcfMatrixReader(vcf_path)
    out = [(chrom, unpack_words_to_dense(words, n_haps), np.array(edges))
           for chrom, words, n_haps, edges in reader.chunks_packed()]
    reader.close()
    jax_reader = jax_native.NativeVcfMatrixReader(vcf_path)
    want = list(jax_reader.chunks_arrays())
    jax_reader.close()
    assert [c for c, _m, _e in out] == [c for c, _m, _e in want]
    for (_c, m, e), (_jc, jm, je) in zip(out, want):
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(e, je)
    return out


def edge_rows(edges):
    return {((int(e[0]), bool(e[1])), (int(e[2]), bool(e[3]))): i
            for i, e in enumerate(edges)}


def python_matrix(vcf_path, n_samples):
    reader = VcfReader(vcf_path)
    out = []
    for chrom, records in reader.chromosome_chunks():
        m = EdgeHaplotypeMatrix(2 * n_samples)
        for rec in records:
            m.add_record(rec)
        out.append((chrom, m.shrink(), dict(m.edge_to_row)))
    reader.close()
    return out


def test_native_matches_python(lib_available, fixture):
    n_samples = len(fixture["samples"])
    py = python_matrix(fixture["vcf"], n_samples)

    reader = native.NativeVcfMatrixReader(fixture["vcf"])
    assert reader.samples == fixture["samples"]
    reader.close()
    native_chunks = [(c, m, edge_rows(e))
                     for c, m, e in dense_chunks(fixture["vcf"])]

    assert len(native_chunks) == len(py)
    for (pc, pm, pe), (nc, nm, ne) in zip(py, native_chunks):
        assert pc == nc
        assert pe.keys() == ne.keys()
        assert pm.shape == nm.shape
        # row order may differ between implementations: compare per edge
        for edge, prow in pe.items():
            nrow = ne[edge]
            np.testing.assert_array_equal(pm[prow], nm[nrow], err_msg=str(edge))


def test_native_reads_gzip(lib_available, fixture, tmp_path):
    gz = str(tmp_path / "test.vcf.gz")
    with open(fixture["vcf"], "rb") as src, gzip.open(gz, "wb") as dst:
        shutil.copyfileobj(src, dst)
    chunks = dense_chunks(gz)
    assert len(chunks) == 1
    assert chunks[0][1].any()


def test_pipeline_uses_native(lib_available, fixture, tmp_path,
                              monkeypatch):
    """End-to-end: results identical whether ingestion is native or Python."""
    import stoat_tpu_torch.pipeline.runner as runner_mod
    out1 = str(tmp_path / "o_native")
    before = dict(runner_mod.INGEST_COUNTS)
    cli_main(["vcf", "-s", fixture["snarl"], "-v", fixture["vcf"],
              "-b", fixture["binary"], "-o", out1])
    assert runner_mod.INGEST_COUNTS["native"] > before["native"]

    out2 = str(tmp_path / "o_python")
    python_reader_only(monkeypatch)
    before = dict(runner_mod.INGEST_COUNTS)
    cli_main(["vcf", "-s", fixture["snarl"], "-v", fixture["vcf"],
              "-b", fixture["binary"], "-o", out2])
    assert runner_mod.INGEST_COUNTS["python"] > before["python"]

    f1 = os.path.join(out1, "binary_table_vcf.tsv")
    f2 = os.path.join(out2, "binary_table_vcf.tsv")
    assert filecmp.cmp(f1, f2, shallow=False), "native vs python TSVs differ"


def test_native_many_tiny_chromosomes(lib_available, tmp_path):
    """Chromosome boundaries inside one reader batch (incl. several tiny
    chromosomes stashed in a single pending tail) chunk correctly and
    match the Python reader."""
    vcf = str(tmp_path / "multi.vcf")
    samples = [f"s{i}" for i in range(5)]
    with open(vcf, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(samples) + "\n")
        nid = 1
        for c in range(30):
            for rec in range(c % 3 + 1):
                at = f">{nid}>{nid+1}>{nid+3},>{nid}>{nid+2}>{nid+3}"
                gts = "\t".join("0/1" if (i + rec) % 2 else "1/1"
                                for i in range(5))
                f.write(f"chr{c}\t{100+rec}\t.\tA\tT\t60\tPASS\t"
                        f"AT={at};LV=0\tGT\t{gts}\n")
                nid += 4

    chunks = dense_chunks(vcf)
    assert [c[0] for c in chunks] == [f"chr{c}" for c in range(30)]

    py = python_matrix(vcf, 5)
    assert len(py) == len(chunks)
    for (pc, pm, pe), (nc, nm, ne_arr) in zip(py, chunks):
        assert pc == nc
        ne = edge_rows(ne_arr)
        assert pe.keys() == ne.keys()
        for edge, prow in pe.items():
            np.testing.assert_array_equal(pm[prow], nm[ne[edge]])


def test_packed_words_match_dense_chunks(lib_available, fixture):
    """chunks_packed words are exactly the bit-packed chunks_arrays matrix
    (incl. the trailing AND-identity row), with identical edge order: here
    stoat_tpu's chunks_arrays, the dense reader the port does not keep."""
    r1 = jax_native.NativeVcfMatrixReader(fixture["vcf"])
    dense = list(r1.chunks_arrays())
    r1.close()
    r2 = native.NativeVcfMatrixReader(fixture["vcf"])
    packed = list(r2.chunks_packed())
    r2.close()

    from stoat_tpu_torch.pipeline.packed import pack_matrix_words
    assert len(dense) == len(packed)
    for (dc, dm, de), (pc, words, n_haps, pe) in zip(dense, packed):
        assert dc == pc
        assert n_haps == dm.shape[1]
        np.testing.assert_array_equal(de, pe)
        np.testing.assert_array_equal(words, pack_matrix_words(dm))
        assert (words[-1] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("mode,flag,pheno_key", [
    ("quantitative", "-q", "quantitative"),
    ("binary_covar", "-b", "binary"),
])
def test_pipeline_native_packed_design_modes(lib_available, fixture,
                                             tmp_path, monkeypatch, mode,
                                             flag, pheno_key):
    """Quant/covar modes: native packed-words design == Python dense design
    byte-for-byte through the full CLI."""
    extra = (["-c", fixture["covariate"], "--covar-name", "AGE,SEX"]
             if mode == "binary_covar" else [])
    out1 = str(tmp_path / "o_native")
    cli_main(["vcf", "-s", fixture["snarl"], "-v", fixture["vcf"],
              flag, fixture[pheno_key], *extra, "-o", out1])

    out2 = str(tmp_path / "o_python")
    python_reader_only(monkeypatch)
    cli_main(["vcf", "-s", fixture["snarl"], "-v", fixture["vcf"],
              flag, fixture[pheno_key], *extra, "-o", out2])

    name = ("quantitative_table_vcf.tsv" if mode == "quantitative"
            else "binary_table_vcf.tsv")
    f1, f2 = os.path.join(out1, name), os.path.join(out2, name)
    assert filecmp.cmp(f1, f2, shallow=False), f"{mode}: TSVs differ"


def test_packed_chunk_zero_copy_lifetime(lib_available, fixture):
    """chunks_packed hands out zero-copy views whose native Chunk stays
    alive through numpy's base-chain collapse (asarray/slice views point
    at the ROOT buffer object; an owner hung on an intermediate array
    would be dropped and the chunk freed under live views — regression
    for a use-after-free that corrupted device inputs)."""
    import gc

    from stoat_tpu_torch.matrix import PackedEdgeMatrix

    reader = native.NativeVcfMatrixReader(fixture["vcf"])
    chrom, words, n_haps, edges = next(iter(reader.chunks_packed()))
    reader.close()

    m = PackedEdgeMatrix(words, n_haps, edges)
    snap_w = np.array(m.words)
    snap_e = np.array(m._edges_arr)
    # views must root at an owner-bearing buffer
    root = m.words
    while getattr(root, "base", None) is not None:
        root = root.base
    assert hasattr(root, "_owner")

    # drop the original views, churn the heap: a freed chunk would be
    # reused and the matrix views would change under us
    del words, edges
    gc.collect()
    junk = [np.random.randint(0, 2**31, (256, 256), np.uint32)
            for _ in range(64)]
    assert np.array_equal(np.array(m.words), snap_w)
    assert np.array_equal(np.array(m._edges_arr), snap_e)
    del junk, m
    gc.collect()  # owner frees the chunk without crashing


def test_fused_chunk_resolver_parity(lib_available, fixture):
    """stoat_chunk_resolve_idx == the Python pack path, end to end.

    The fused resolver (resolution against the chunk's own edge table,
    emitting the pack-ready padded [P, K] indices) must produce exactly
    what resolve_chromosome + pack_path_edge_idx produce."""
    from stoat_tpu_torch.io.snarl_file import parse_snarl_path
    from stoat_tpu_torch.pipeline.runner import iter_chromosome_matrices
    from stoat_tpu_torch.pipeline.packed import pack_path_edge_idx
    from stoat_tpu_torch.tables import pack_chromosome

    snarls_chr = parse_snarl_path(fixture["snarl"])
    n_hap = 2 * len(fixture["samples"])
    gen = iter_chromosome_matrices(fixture["vcf"], n_hap, snarls_chr)
    chrom, matrix = next(gen)
    gen.close()
    assert getattr(matrix, "resolve_idx_native", None) is not None

    snarls = snarls_chr[chrom]
    packed = pack_chromosome(snarls, matrix)
    assert packed.path_idx is not None

    ref_idx = pack_path_edge_idx(packed.coo_path, packed.coo_row,
                                 packed.path_valid, packed.n_rows)
    np.testing.assert_array_equal(packed.path_edge_idx(), ref_idx)

    # and the COO view matches a resolve without the fused path
    matrix.resolve_idx_native = None
    packed2 = pack_chromosome(snarls, matrix)
    np.testing.assert_array_equal(packed2.path_valid, packed.path_valid)
    np.testing.assert_array_equal(packed2.coo_path, packed.coo_path)
    np.testing.assert_array_equal(packed2.coo_row, packed.coo_row)


def test_fused_resolver_unknown_edges(lib_available, fixture, tmp_path):
    """Paths referencing edges absent from the VCF are invalid (all-padding
    rows in idx), star (node-0) edges are skipped — identify_path
    semantics (snarl_analyzer.cpp:326-336)."""
    from stoat_tpu_torch.pipeline.runner import iter_chromosome_matrices
    from stoat_tpu_torch.io.snarl_file import parse_snarl_path

    snarls_chr = parse_snarl_path(fixture["snarl"])
    n_hap = 2 * len(fixture["samples"])
    gen = iter_chromosome_matrices(fixture["vcf"], n_hap, snarls_chr)
    chrom, matrix = next(gen)
    gen.close()
    resolver = matrix.resolve_idx_native
    E = matrix.n_rows

    got = resolver(">999999999>999999998,>0>5>0,")
    assert got is not None
    idx, rows, offs, valid = got
    assert valid.tolist() == [0, 1, 1]       # unknown edge -> invalid
    assert (idx[0] == E).all()               # all padding
    assert (idx[1] == E).all()               # star edges skipped: 0 rows
    assert offs.tolist() == [0, 0, 0, 0]


def test_truncated_gzip_raises(lib_available, tmp_path):
    """Round-5 review: a mid-file gzip error must raise, not masquerade
    as EOF (a silently partial matrix means silently wrong p-values)."""
    import gzip as _gzip

    from stoat_tpu_torch.native import NativeVcfMatrixReader

    samples = [f"s{i}" for i in range(4)]
    body = ["##fileformat=VCFv4.2",
            '##INFO=<ID=AT,Number=R,Type=String,Description="x">',
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + "\t".join(samples)]
    for k in range(5000):
        a = 1 + 3 * k
        body.append(f"c1\t{100+k}\tv{k}\tA\tT\t99\tPASS\t"
                    f"AT=>{a}>{a+2},>{a}>{a+1}>{a+2};LV=0\tGT\t"
                    + "\t".join(["0/1"] * 4))
    raw = ("\n".join(body) + "\n").encode()
    gz = _gzip.compress(raw)
    trunc = tmp_path / "trunc.vcf.gz"
    trunc.write_bytes(gz[: len(gz) // 2])    # cut mid-stream
    for reader_t in (NativeVcfMatrixReader,
                     jax_native.NativeVcfMatrixReader):
        reader = reader_t(str(trunc))
        with pytest.raises(RuntimeError, match="read error"):
            for _chrom, _w, _n, _e in reader.chunks_packed():
                pass
        reader.close()


def test_header_without_trailing_newline(lib_available, tmp_path):
    """A zero-record VCF whose #CHROM line is the unterminated final
    line must still open (the data path handles unterminated final
    lines; the header scan must too)."""
    from stoat_tpu_torch.native import NativeVcfMatrixReader

    vcf = tmp_path / "nonewline.vcf"
    with open(vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
                 "\tsampleA\tsampleB")      # no trailing newline
    reader = NativeVcfMatrixReader(str(vcf))
    assert reader.samples == ["sampleA", "sampleB"]
    reader.close()
