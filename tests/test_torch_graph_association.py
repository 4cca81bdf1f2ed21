"""Graph-mode association tests: sample partitioning + exact/chi2 tests.

Semantics pinned from partitioner.cpp / graph_path_association_finder.cpp
and the inline truth tables of the reference's graph_simu_test.

The JAX suite's tests (tests/test_graph_association.py) on the port's
``graph`` run on the CPU (:func:`run_graph_association`, which the other
ported graph files share), with ``stoat_tpu``'s run of the same arguments
writing the same files into a twin directory.
"""

import inspect
import os

import pytest

torch = pytest.importorskip("torch")

from stoat_tpu.graph import association as jax_association
from stoat_tpu_torch.graph import association as port_association
from stoat_tpu_torch.graph.gfa import load_gfa
from stoat_tpu_torch.graph.snarls import find_snarls
from stoat_tpu_torch.graph.association import PathPartitioner

from test_torch_end_to_end import assert_same_outputs, twin_of


def run_graph_association(*args, **kwargs):
    """The port's ``run_graph_association`` on the CPU (its module
    attribute, so that a test's spy on the module is seen), then
    stoat_tpu's with the same arguments into the twin of
    ``output_dir``: the same exit code and the same files.  Returns the
    port's exit code."""
    port = port_association.run_graph_association
    call = inspect.signature(port).bind(*args, device=torch.device("cpu"),
                                        **kwargs).arguments
    rc = port(**call)
    out = str(call["output_dir"]).rstrip(os.sep)
    twin = twin_of(out)
    os.makedirs(twin, exist_ok=True)
    call = {k: v for k, v in call.items() if k != "device"}
    call["output_dir"] = twin
    assert jax_association.run_graph_association(**call) == rc
    assert_same_outputs(out, twin)
    return rc


def build_graph_with_samples(tmp_path):
    """Bubble 1-(2|3)-4; 4 samples: s1,s2 take node 2; s3,s4 take node 3."""
    p = tmp_path / "g.gfa"
    lines = [
        "H\tVN:Z:1.0",
        "S\t1\tAAAA", "S\t2\tC", "S\t3\tG", "S\t4\tTTTT",
        "L\t1\t+\t2\t+\t0M", "L\t1\t+\t3\t+\t0M",
        "L\t2\t+\t4\t+\t0M", "L\t3\t+\t4\t+\t0M",
        "P\tref\t1+,2+,4+\t*",
        "P\ts1#1#chr\t1+,2+,4+\t*",
        "P\ts2#1#chr\t1+,2+,4+\t*",
        "P\ts3#1#chr\t1+,3+,4+\t*",
        "P\ts4#1#chr\t1+,3+,4+\t*",
    ]
    with open(p, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(p)


def write_pheno(tmp_path, rows):
    p = tmp_path / "pheno.tsv"
    with open(p, "w") as fh:
        fh.write("FID\tIID\tPHENO\n")
        for iid, v in rows:
            fh.write(f"{iid}\t{iid}\t{v}\n")
    return str(p)


def test_partitioner_splits_by_allele(tmp_path):
    gfa = build_graph_with_samples(tmp_path)
    g = load_gfa(gfa, {"ref"})
    forest = find_snarls(g)
    assert len(forest.snarls) == 1
    samples = [p for p in g.paths if p.sample.startswith("s")]
    part = PathPartitioner(g, samples)
    sets = part.partition_samples_in_snarl(forest, 0, regular=True)
    assert sorted(sorted(s) for s in sets) == [["s1", "s2"], ["s3", "s4"]]
    # irregular mode refines identically here
    sets2 = part.partition_samples_in_snarl(forest, 0, regular=False)
    assert sorted(sorted(s) for s in sets2) == [["s1", "s2"], ["s3", "s4"]]
    # stoat_tpu's partitioner gives the same sets
    from stoat_tpu.graph.gfa import load_gfa as jax_load_gfa
    from stoat_tpu.graph.snarls import find_snarls as jax_find_snarls
    jg = jax_load_gfa(gfa, {"ref"})
    jpart = jax_association.PathPartitioner(
        jg, [p for p in jg.paths if p.sample.startswith("s")])
    for regular, got in ((True, sets), (False, sets2)):
        want = jpart.partition_samples_in_snarl(jax_find_snarls(jg), 0,
                                                regular=regular)
        assert sorted(sorted(s) for s in want) == \
            sorted(sorted(s) for s in got)


def test_graph_association_chi2_tsv(tmp_path):
    gfa = build_graph_with_samples(tmp_path)
    pheno = write_pheno(tmp_path, [("s1", 2), ("s2", 2), ("s3", 1),
                                   ("s4", 1)])
    out = tmp_path / "out"
    os.makedirs(out)
    rc = run_graph_association(
        graph_path=gfa, dist_path="", binary_path=pheno,
        test_method="chi2", output_format="tsv", allele_size_limit=0,
        reference_sample="ref", output_dir=str(out))
    assert rc == 0
    with open(out / "binary_table_graph.tsv") as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in fh]
    assert header[0] == "#CHR"
    assert len(rows) == 1
    row = rows[0]
    assert row[3] == "1_4"
    # perfect separation of 2 cases vs 2 controls: table [[2,0],[0,2]]
    assert row[7] == "2:0,0:2"
    # PATH_LENGTHS = min,max allele length
    assert row[4] == "1,1"


def test_graph_association_exact(tmp_path):
    gfa = build_graph_with_samples(tmp_path)
    pheno = write_pheno(tmp_path, [("s1", 2), ("s2", 2), ("s3", 1),
                                   ("s4", 1)])
    out = tmp_path / "out_exact"
    os.makedirs(out)
    rc = run_graph_association(
        graph_path=gfa, dist_path="", binary_path=pheno,
        test_method="exact", output_format="tsv", allele_size_limit=0,
        reference_sample="ref", output_dir=str(out))
    assert rc == 0
    with open(out / "binary_table_graph.tsv") as fh:
        fh.readline()
        rows = [line.rstrip("\n").split("\t") for line in fh]
    # the partition {s1,s2} equals the case set exactly -> written
    assert len(rows) == 1
    assert rows[0][3] == "1_4"


def test_graph_association_exact_no_match(tmp_path):
    gfa = build_graph_with_samples(tmp_path)
    # mixed phenotype: no partition equals a phenotype set
    pheno = write_pheno(tmp_path, [("s1", 2), ("s2", 1), ("s3", 2),
                                   ("s4", 1)])
    out = tmp_path / "out_nomatch"
    os.makedirs(out)
    rc = run_graph_association(
        graph_path=gfa, dist_path="", binary_path=pheno,
        test_method="exact", output_format="tsv", allele_size_limit=0,
        reference_sample="ref", output_dir=str(out))
    assert rc == 0
    with open(out / "binary_table_graph.tsv") as fh:
        fh.readline()
        rows = [l for l in fh if l.strip()]
    assert rows == []


def test_graph_association_fasta(tmp_path):
    gfa = build_graph_with_samples(tmp_path)
    pheno = write_pheno(tmp_path, [("s1", 2), ("s2", 2), ("s3", 1),
                                   ("s4", 1)])
    out = tmp_path / "out_fasta"
    os.makedirs(out)
    rc = run_graph_association(
        graph_path=gfa, dist_path="", binary_path=pheno,
        test_method="chi2", output_format="fasta", allele_size_limit=0,
        reference_sample="ref", output_dir=str(out))
    assert rc == 0
    with open(out / "binary_output.fasta") as fh:
        content = fh.read()
    # one representative per partition: sequences C and G
    records = [r for r in content.split(">") if r.strip()]
    assert len(records) == 2
    seqs = sorted(r.splitlines()[1] for r in records)
    assert seqs == ["C", "G"]
