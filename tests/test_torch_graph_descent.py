"""Graph-mode tree-walk semantics: allele-size eligibility and the
exact-match descent stop (graph_path_association_finder.cpp:100-117,
187-194).

The JAX suite's tests (tests/test_graph_descent.py) on the port's
``graph`` command on the CPU, each run also byte for byte
``stoat_tpu``'s (``test_torch_end_to_end.cli_main``)."""

import os

import pytest

pytest.importorskip("torch")

from test_graph_association import write_pheno
from test_torch_end_to_end import cli_main


def build_nested_graph(tmp_path):
    """Outer bubble (1,7) with nested (3,6); samples split on BOTH levels:
    s1,s2 take the 2-branch (and inside it, s1 via 4, s2 via 5); s3,s4
    take the direct deletion edge 1->7."""
    p = tmp_path / "g.gfa"
    lines = [
        "H\tVN:Z:1.0",
        "S\t1\tAAAA", "S\t2\tCC", "S\t3\tGG", "S\t4\tA", "S\t5\tT",
        "S\t6\tCC", "S\t7\tAAAA",
        "L\t1\t+\t2\t+\t0M", "L\t1\t+\t7\t+\t0M",
        "L\t2\t+\t3\t+\t0M", "L\t3\t+\t4\t+\t0M", "L\t3\t+\t5\t+\t0M",
        "L\t4\t+\t6\t+\t0M", "L\t5\t+\t6\t+\t0M", "L\t6\t+\t7\t+\t0M",
        "P\tref\t1+,2+,3+,4+,6+,7+\t*",
        "P\ts1#1#c\t1+,2+,3+,4+,6+,7+\t*",
        "P\ts2#1#c\t1+,2+,3+,5+,6+,7+\t*",
        "P\ts3#1#c\t1+,7+\t*",
        "P\ts4#1#c\t1+,7+\t*",
    ]
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def run(gfa, pheno, out, method, limit=0):
    os.makedirs(out, exist_ok=True)
    rc = cli_main(["graph", "-p", gfa, "-d", gfa, "-b", pheno,
                   "-T", method, "-O", "tsv", "-l", str(limit),
                   "-r", "ref", "-o", out])
    assert rc == 0
    with open(os.path.join(out, "binary_table_graph.tsv")) as fh:
        fh.readline()
        return [l.rstrip("\n").split("\t") for l in fh if l.strip()]


def test_exact_match_stops_descent(tmp_path):
    gfa = build_nested_graph(tmp_path)
    # cases = {s1,s2}: the OUTER partition matches exactly -> written,
    # and the nested snarl is NOT descended into
    pheno = write_pheno(tmp_path, [("s1", 2), ("s2", 2), ("s3", 1),
                                   ("s4", 1)])
    rows = run(gfa, pheno, str(tmp_path / "o1"), "exact")
    assert [r[3] for r in rows] == ["1_7"]


def test_exact_descends_when_no_match(tmp_path):
    gfa = build_nested_graph(tmp_path)
    # cases = {s1,s3}: outer partitions {s1,s2}/{s3,s4} match nothing,
    # but the nested snarl splits {s1}/{s2} — s1 alone IS... not a
    # phenotype set either; no rows, but descent must have happened
    # (cases={s1} would match the nested {s1} partition):
    pheno2 = write_pheno(tmp_path, [("s1", 2), ("s2", 1), ("s3", 1),
                                    ("s4", 1)])
    rows = run(gfa, pheno2, str(tmp_path / "o2"), "exact")
    assert [r[3] for r in rows] == ["3_6"]


def test_allele_size_limit_filters(tmp_path):
    gfa = build_nested_graph(tmp_path)
    pheno = write_pheno(tmp_path, [("s1", 2), ("s2", 2), ("s3", 1),
                                   ("s4", 1)])
    # outer snarl max length = 2+2+1+2 = 7; nested max = 1
    rows = run(gfa, pheno, str(tmp_path / "o3"), "chi2", limit=2)
    ids = [r[3] for r in rows]
    assert "1_7" in ids and "3_6" not in ids
    rows_all = run(gfa, pheno, str(tmp_path / "o4"), "chi2", limit=0)
    assert {r[3] for r in rows_all} == {"1_7", "3_6"}
