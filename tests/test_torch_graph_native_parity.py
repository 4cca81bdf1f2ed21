"""Native vs Python graph-mode parity.

`stoat graph` now runs through graph_core.cpp's one-call prepare
(stoat_graph_assoc: GFA load + snarl finding + walk-set partitioning +
tree walk) for TSV outputs; the Python twin (association.test_snarls)
remains the readable reference and the FASTA/TRACE path.  Both must
produce byte-identical TSVs — on bubbles, deletion edges (irregular
snarls), and both test methods.  Reference pipeline being twinned:
the reference's src/graph.cpp:217-288, partitioner.cpp:36-268,
graph_path_association_finder.cpp:29-199.

The JAX suite's tests (tests/test_graph_native_parity.py) on the port's
``graph`` run on the CPU, each run also byte for byte ``stoat_tpu``'s
(``test_torch_graph_association.run_graph_association``).
"""

import filecmp
import os
import random

import pytest

pytest.importorskip("torch")

from test_torch_graph_association import run_graph_association


@pytest.fixture(scope="module")
def parity_graph(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gparity")
    random.seed(3)
    S, NSAMP = 400, 16
    gfa = tmp / "g.gfa"
    with open(gfa, "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        node = 1
        chain = []
        for k in range(S):
            a, m1, m2 = node, node + 1, node + 2
            fh.write(f"S\t{a}\tAAAA\nS\t{m1}\tC\nS\t{m2}\tGG\n")
            fh.write(f"L\t{a}\t+\t{m1}\t+\t0M\nL\t{a}\t+\t{m2}\t+\t0M\n")
            fh.write(f"L\t{m1}\t+\t{a+3}\t+\t0M\nL\t{m2}\t+\t{a+3}\t+\t0M\n")
            if k % 7 == 3:
                # deletion edge straight across: irregular snarl shape
                fh.write(f"L\t{a}\t+\t{a+3}\t+\t0M\n")
            chain.append((a, m1, m2))
            node += 3
        fh.write(f"S\t{node}\tTTTT\n")
        ref = []
        for a, m1, _ in chain:
            ref += [f"{a}+", f"{m1}+"]
        ref.append(f"{node}+")
        fh.write("P\tref\t" + ",".join(ref) + "\t*\n")
        for s in range(NSAMP):
            steps = []
            for i, (a, m1, m2) in enumerate(chain):
                steps.append(f"{a}+")
                if i % 7 == 3 and random.random() < 0.3:
                    pass                       # takes the deletion edge
                else:
                    steps.append(f"{m1 if random.random() < 0.5 else m2}+")
            steps.append(f"{node}+")
            fh.write(f"P\ts{s}#0#chr\t" + ",".join(steps) + "\t*\n")
    pheno = tmp / "pheno.tsv"
    with open(pheno, "w") as fh:
        fh.write("FID\tIID\tPHENO\n")
        for s in range(NSAMP):
            fh.write(f"s{s}\ts{s}\t{1 + s % 2}\n")
    return str(gfa), str(pheno), tmp


@pytest.mark.parametrize("method", ["chi2", "exact"])
def test_native_matches_python(parity_graph, method, monkeypatch):
    from stoat_tpu_torch.native import get_graph_lib

    if get_graph_lib() is None:
        pytest.skip("native graph core unavailable")
    gfa, pheno, tmp = parity_graph
    out_n = tmp / f"out_native_{method}"
    out_p = tmp / f"out_python_{method}"
    out_n.mkdir()
    out_p.mkdir()
    rc = run_graph_association(gfa, "", pheno, method, "tsv", 0, "ref",
                               str(out_n))
    assert rc == 0
    monkeypatch.setenv("STOAT_GRAPH_PYTHON", "1")
    rc = run_graph_association(gfa, "", pheno, method, "tsv", 0, "ref",
                               str(out_p))
    assert rc == 0
    assert filecmp.cmp(out_n / "binary_table_graph.tsv",
                       out_p / "binary_table_graph.tsv", shallow=False)


def test_native_path_is_taken(parity_graph, monkeypatch):
    """The TSV flow must actually go native when the core is available."""
    import stoat_tpu_torch.graph.association as assoc
    from stoat_tpu_torch.native import get_graph_lib

    if get_graph_lib() is None:
        pytest.skip("native graph core unavailable")
    gfa, pheno, tmp = parity_graph
    out = tmp / "out_spy"
    out.mkdir()
    calls = []
    real = assoc._run_graph_association_native

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(assoc, "_run_graph_association_native", spy)
    rc = run_graph_association(gfa, "", pheno, "chi2", "tsv", 0, "ref",
                               str(out))
    assert rc == 0
    assert calls, "native graph fast path was not taken"


@pytest.mark.parametrize("method", ["chi2", "exact"])
def test_native_fasta_matches_python(parity_graph, method, monkeypatch):
    """Round-5: the native walk also emits FASTA (writer.cpp:89-178);
    byte parity with the Python _write_fasta_partitions path."""
    from stoat_tpu_torch.native import get_graph_lib

    if get_graph_lib() is None:
        pytest.skip("native graph core unavailable")
    gfa, pheno, tmp = parity_graph
    out_n = tmp / f"fasta_native_{method}"
    out_p = tmp / f"fasta_python_{method}"
    out_n.mkdir()
    out_p.mkdir()
    rc = run_graph_association(gfa, "", pheno, method, "fasta", 0, "ref",
                               str(out_n))
    assert rc == 0
    monkeypatch.setenv("STOAT_GRAPH_PYTHON", "1")
    rc = run_graph_association(gfa, "", pheno, method, "fasta", 0, "ref",
                               str(out_p))
    assert rc == 0
    assert filecmp.cmp(out_n / "binary_output.fasta",
                       out_p / "binary_output.fasta", shallow=False)


@pytest.mark.parametrize("fmt", ["tsv", "fasta"])
def test_mem_entry_matches_file_entry(parity_graph, fmt):
    """stoat_graph_assoc_mem (the in-memory feed used for .hg/.pg/.gbz)
    must reproduce the file-based GFA entry byte for byte."""
    import numpy as np

    from stoat_tpu_torch.graph.gfa import load_gfa
    from stoat_tpu_torch.io.phenotype import parse_binary_pheno
    from stoat_tpu_torch.native import (get_graph_lib,
                                        graph_assoc_mem_native,
                                        graph_assoc_native)

    if get_graph_lib() is None:
        pytest.skip("native graph core unavailable")
    gfa, pheno_path, tmp = parity_graph
    pheno, samples = parse_binary_pheno(pheno_path, [])
    g = load_gfa(gfa, {"ref"})
    a = graph_assoc_native(gfa, {"ref"}, samples, pheno.astype(np.uint8),
                           "chi2", 0, output_format=fmt)
    b = graph_assoc_mem_native(g, {"ref"}, samples,
                               pheno.astype(np.uint8), "chi2", 0,
                               output_format=fmt)
    assert a is not None and b is not None
    assert a[0] == b[0]                          # blob (rows or FASTA)
    from stoat_tpu.native import graph_assoc_native as jax_graph_assoc
    j = jax_graph_assoc(gfa, {"ref"}, samples, pheno.astype(np.uint8),
                        "chi2", 0, output_format=fmt)
    assert j[0] == a[0]
    for x, y in zip(a[1:5], j[1:5]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[1], b[1])    # kinds
    np.testing.assert_array_equal(a[2], b[2])    # part offsets
    np.testing.assert_array_equal(a[3], b[3])    # g0
    np.testing.assert_array_equal(a[4], b[4])    # g1


@pytest.mark.parametrize("fmt", ["tsv", "fasta"])
def test_gbz_native_assoc_matches_python(parity_graph, fmt, monkeypatch):
    """A .gbz graph-mode run takes the native mem path and matches the
    Python pipeline on the same container (round-3/4 verdicts: the
    binary formats fell back to the ~20x slower Python prepare)."""
    import stoat_tpu_torch.graph.association as assoc
    from stoat_tpu_torch.graph.gbz_write import save_gbz
    from stoat_tpu_torch.graph.gfa import load_gfa
    from stoat_tpu_torch.native import get_graph_lib

    if get_graph_lib() is None:
        pytest.skip("native graph core unavailable")
    gfa, pheno, tmp = parity_graph
    gbz = tmp / f"parity_{fmt}.gbz"
    if not gbz.exists():
        save_gbz(load_gfa(gfa, {"ref"}), str(gbz))
    out_n = tmp / f"gbz_native_{fmt}"
    out_p = tmp / f"gbz_python_{fmt}"
    out_n.mkdir()
    out_p.mkdir()
    calls = []
    real = assoc._run_graph_association_native

    def spy(*a, **k):
        res = real(*a, **k)
        calls.append(res)
        return res

    monkeypatch.setattr(assoc, "_run_graph_association_native", spy)
    rc = run_graph_association(str(gbz), "", pheno, "chi2", fmt, 0, "ref",
                               str(out_n))
    assert rc == 0
    assert calls and calls[-1] == 0, "native mem path was not taken"
    monkeypatch.setenv("STOAT_GRAPH_PYTHON", "1")
    rc = run_graph_association(str(gbz), "", pheno, "chi2", fmt, 0, "ref",
                               str(out_p))
    assert rc == 0
    name = ("binary_table_graph.tsv" if fmt == "tsv"
            else "binary_output.fasta")
    assert filecmp.cmp(out_n / name, out_p / name, shallow=False)


def test_fasta_long_names_not_truncated(tmp_path, monkeypatch):
    """Round-5 review: FASTA headers must not truncate when reference
    path + sample names are long (PanSN accession-style names exceed
    the old fixed snprintf buffer)."""
    from stoat_tpu_torch.native import get_graph_lib

    if get_graph_lib() is None:
        pytest.skip("native graph core unavailable")
    long_ref = "GRCh38.chr1_KI270766v1_alt." + "x" * 120
    samp = ["SAMEA" + str(7000000 + i) + ".haplotype." + "y" * 90
            for i in range(4)]
    gfa = tmp_path / "long.gfa"
    with open(gfa, "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        fh.write("S\t1\tAAAA\nS\t2\tC\nS\t3\tGG\nS\t4\tTTTT\n")
        fh.write("L\t1\t+\t2\t+\t0M\nL\t1\t+\t3\t+\t0M\n")
        fh.write("L\t2\t+\t4\t+\t0M\nL\t3\t+\t4\t+\t0M\n")
        fh.write(f"P\t{long_ref}\t1+,2+,4+\t*\n")
        for i, s in enumerate(samp):
            mid = "2+" if i % 2 == 0 else "3+"
            fh.write(f"P\t{s}#0#chr\t1+,{mid},4+\t*\n")
    pheno = tmp_path / "p.tsv"
    with open(pheno, "w") as fh:
        fh.write("FID\tIID\tPHENO\n")
        for i, s in enumerate(samp):
            fh.write(f"{s}\t{s}\t{1 + i % 2}\n")
    out_n = tmp_path / "n"
    out_p = tmp_path / "p"
    out_n.mkdir()
    out_p.mkdir()
    rc = run_graph_association(str(gfa), "", str(pheno), "chi2", "fasta",
                               0, long_ref, str(out_n))
    assert rc == 0
    monkeypatch.setenv("STOAT_GRAPH_PYTHON", "1")
    rc = run_graph_association(str(gfa), "", str(pheno), "chi2", "fasta",
                               0, long_ref, str(out_p))
    assert rc == 0
    native = (out_n / "binary_output.fasta").read_text()
    assert long_ref in native and samp[0] in native
    assert native == (out_p / "binary_output.fasta").read_text()
