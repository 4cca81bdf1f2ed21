"""Graph-mode output contract: the reference's graph_simu truth tables.

Pins every inline truth of the reference's tests/system/graph_simu_test.cpp
on the real ``.hg`` fixtures: exact TSV rows (incl. p-value strings) for
chi2 and exact modes, and the FASTA equivalence classes checked with the
same semantics as the reference's ``fasta_equal``
(tests/system/compare_files_utils.cpp:277-347): every header in the output
must be a known header with the exact sequence, and every equivalence
class must be represented by EXACTLY one record.

Known divergence (DESIGN.md §7): the reference reports SOME cyclic snarls
with boundaries flipped relative to the reference path — an artifact of
vg's cactus anchoring order, not derivable from the graph (compare
loop_with_indel's top snarl ``6_1``, graph_simu_test.cpp:334, with the
near-isomorphic loop_plus's UNflipped ``2_8``, snarl_data_t_unit.cpp:314).
stoat-tpu always reports reference-path orientation, so snarl ids here
compare orientation-normalized (sorted node pair); every other byte is
exact.

The JAX suite's tests (tests/test_graph_contract.py) on the port's
``graph`` run on the CPU; ``stoat_tpu``'s run writes the same bytes on
each fixture.  They skip, as the JAX suite's do, where the reference's
fixtures are not mounted.
"""

import filecmp
import os
import re

import pytest

torch = pytest.importorskip("torch")

from stoat_tpu.graph.association import \
    run_graph_association as jax_run_graph_association
from stoat_tpu_torch.graph.association import run_graph_association

from test_graph_contract import GRAPH_DIR


def norm_ids(line: str) -> str:
    """Render snarl ids (TSV column 4, FASTA ``snarl:a-b``) with the node
    pair sorted — the reference's orientation for cyclic snarls is a vg
    build artifact (see module docstring)."""
    def tsv_sub(m):
        a, b = sorted(int(x) for x in m.group(1).split("_"))
        return f"\t{a}_{b}\t"

    def fasta_sub(m):
        a, b = sorted(int(x) for x in (m.group(1), m.group(2)))
        return f">snarl:{a}-{b}|"

    line = re.sub(r"\t(\d+_\d+)\t", tsv_sub, line)
    return re.sub(r">snarl:(\d+)-(\d+)\|", fasta_sub, line)

pytestmark = pytest.mark.skipif(not os.path.isdir(GRAPH_DIR),
                                reason="reference fixtures unavailable")


def write_pheno(tmp_path, cases, controls):
    """samples.tsv exactly as graph_simu_test.cpp:127-137 writes it."""
    p = tmp_path / "samples.tsv"
    with open(p, "w") as fh:
        fh.write("FID\tIID\tPHENO\n")
        for s in cases:
            fh.write(f"{s}\t{s}\t2\n")
        for s in controls:
            fh.write(f"{s}\t{s}\t1\n")
    return str(p)


def run_graph(tmp_path, graph, pheno, method, fmt="tsv"):
    """The port's run on the CPU into ``out``; stoat_tpu's run writes the
    same file into a twin directory."""
    kwargs = dict(graph_path=os.path.join(GRAPH_DIR, graph + ".hg"),
                  dist_path=os.path.join(GRAPH_DIR, graph + ".dist"),
                  binary_path=pheno, test_method=method, output_format=fmt,
                  allele_size_limit=0, reference_sample="path0")
    out = tmp_path / "out"
    twin = tmp_path / "out_stoat_tpu"
    os.makedirs(out, exist_ok=True)
    os.makedirs(twin, exist_ok=True)
    rc = run_graph_association(**kwargs, output_dir=str(out),
                               device=torch.device("cpu"))
    assert rc == 0
    assert jax_run_graph_association(**kwargs, output_dir=str(twin)) == 0
    name = ("binary_table_graph.tsv" if fmt == "tsv"
            else "binary_output.fasta")
    assert filecmp.cmp(out / name, twin / name, shallow=False)
    return out


def read_tsv(out):
    with open(out / "binary_table_graph.tsv") as fh:
        lines = [norm_ids(ln.rstrip("\n")) for ln in fh if ln.strip()]
    header, rows = lines[0], lines[1:]
    assert header == ("#CHR\tSTART_POS\tEND_POS\tSNARL\tPATH_LENGTHS\t"
                      "P_FISHER\tP_CHI2\tGROUP_PATHS\tDEPTH")
    return rows


def assert_fasta_classes(out, truth):
    """The reference's fasta_equal semantics: truth = [(class_id, header,
    seq)]; each class must appear exactly once, no unknown headers."""
    header_to = {norm_ids(h): (c, s) for c, h, s in truth}
    classes = {c for c, _, _ in truth}
    seen = set()
    records = 0
    with open(out / "binary_output.fasta") as fh:
        text = fh.read()
    for block in text.split(">"):
        if not block.strip("\n"):
            continue
        lines = block.split("\n")
        header = norm_ids(">" + lines[0])
        seq = "".join(lines[1:])
        assert header in header_to, f"unknown FASTA header {header!r}"
        cls, want_seq = header_to[header]
        assert seq == want_seq, (header, seq, want_seq)
        assert cls not in seen, f"class {cls} represented twice ({header})"
        seen.add(cls)
        records += 1
    assert seen == classes, f"missing classes: {classes - seen}"
    assert records == len(classes)


# --- simple_nested_chain (graph_simu_test.cpp:119-290) ---------------------

@pytest.fixture()
def nested_pheno(tmp_path):
    return write_pheno(tmp_path, ["path1", "path3"], ["path0", "path2"])


def test_nested_chain_chi2_tsv(tmp_path, nested_pheno):
    out = run_graph(tmp_path, "simple_nested_chain", nested_pheno, "chi2")
    truth = [
        "path0\t1\t2\t1_4\t1,1\t1\t1\t1:1,1:1\t1",
        "path0\t3\t6\t4_8\t0,3\t1\t0.2482\t2:1,0:1\t1",
        "path0\t4\t5\t5_7\t0,1\t0.3333\t8.3265e-02\t0:1,2:0\t2",
    ]
    assert sorted(read_tsv(out)) == sorted(norm_ids(t) for t in truth)


def test_nested_chain_exact_tsv(tmp_path, nested_pheno):
    out = run_graph(tmp_path, "simple_nested_chain", nested_pheno, "exact")
    truth = ["path0\t4\t5\t5_7\t0,1\tNA\tNA\tNA\t2"]
    assert read_tsv(out) == [norm_ids(t) for t in truth]


def test_nested_chain_chi2_fasta(tmp_path, nested_pheno):
    out = run_graph(tmp_path, "simple_nested_chain", nested_pheno, "chi2",
                    fmt="fasta")
    truth = [
        (1, ">snarl:1-4|path0:1-2|path0:1-2", "C"),
        (1, ">snarl:1-4|path0:1-2|path1:1-2", "C"),
        (2, ">snarl:1-4|path0:1-2|path2:1-2", "C"),
        (2, ">snarl:1-4|path0:1-2|path3:1-2", "C"),
        (3, ">snarl:4-8|path0:3-6|path0:3-6", "TCA"),
        (3, ">snarl:4-8|path0:3-6|path1:3-6", "TA"),
        (3, ">snarl:4-8|path0:3-6|path3:3-6", "TA"),
        (4, ">snarl:4-8|path0:3-6|path2:3-3", ""),
        (5, ">snarl:5-7|path0:4-5|path0:4-5", "C"),
        (6, ">snarl:5-7|path0:4-5|path1:4-4", ""),
        (6, ">snarl:5-7|path0:4-5|path3:4-4", ""),
    ]
    assert_fasta_classes(out, truth)


def test_nested_chain_exact_fasta(tmp_path, nested_pheno):
    out = run_graph(tmp_path, "simple_nested_chain", nested_pheno, "exact",
                    fmt="fasta")
    truth = [
        (2, ">snarl:5-7|path0:4-5|path0:4-5", "C"),
        (1, ">snarl:5-7|path0:4-5|path1:4-4", ""),
        (1, ">snarl:5-7|path0:4-5|path3:4-4", ""),
    ]
    assert_fasta_classes(out, truth)


# --- loop_with_indel (graph_simu_test.cpp:289-470) --------------------------

@pytest.fixture()
def loop_pheno(tmp_path):
    return write_pheno(tmp_path, ["path1", "path2"], ["path0"])


def test_loop_indel_chi2_tsv(tmp_path, loop_pheno):
    out = run_graph(tmp_path, "loop_with_indel", loop_pheno, "chi2")
    truth = [
        "path0\t10\t14\t6_1\t3,4\t0.3333\t8.3265e-02\t0:1,2:0\t1",
        "path0\t11\t12\t2_4\t0,1\tNA\t0.2231\t0:1,1:0,1:0\t2",
    ]
    assert sorted(read_tsv(out)) == sorted(norm_ids(t) for t in truth)


def test_loop_indel_exact_tsv(tmp_path, loop_pheno):
    out = run_graph(tmp_path, "loop_with_indel", loop_pheno, "exact")
    truth = ["path0\t10\t14\t6_1\t3,4\tNA\tNA\tNA\t1"]
    assert read_tsv(out) == [norm_ids(t) for t in truth]


def test_loop_indel_chi2_fasta(tmp_path, loop_pheno):
    out = run_graph(tmp_path, "loop_with_indel", loop_pheno, "chi2",
                    fmt="fasta")
    truth = [
        (1, ">snarl:6-1|path0:10-14|path0:10-14", "AGCT"),
        (2, ">snarl:6-1|path0:10-14|path1:10-16", "ACTACT"),
        (2, ">snarl:6-1|path0:10-14|path2:10-17", "ACTAGCT"),
        (3, ">snarl:2-4|path0:11-12|path0:11-12", "G"),
        (4, ">snarl:2-4|path0:11-12|path1:11-11", ""),
        (5, ">snarl:2-4|path0:11-12|path1:14-14", ""),
        (6, ">snarl:2-4|path0:11-12|path2:11-12", "G"),
        (7, ">snarl:2-4|path0:11-12|path2:15-15", ""),
    ]
    assert_fasta_classes(out, truth)


def test_loop_indel_exact_fasta(tmp_path, loop_pheno):
    out = run_graph(tmp_path, "loop_with_indel", loop_pheno, "exact",
                    fmt="fasta")
    truth = [
        (1, ">snarl:6-1|path0:10-14|path1:10-16", "ACTACT"),
        (1, ">snarl:6-1|path0:10-14|path2:10-17", "ACTAGCT"),
        (2, ">snarl:6-1|path0:10-14|path0:10-14", "AGCT"),
    ]
    assert_fasta_classes(out, truth)
