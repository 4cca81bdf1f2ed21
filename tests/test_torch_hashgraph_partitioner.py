"""Walk-set partitioning on the REAL partitioner fixtures (.hg), pinned
against path_partitioner_unit.cpp's expectations.

The JAX suite's tests (tests/test_hashgraph_partitioner.py) on the port's
``graph/``; ``stoat_tpu``'s partitioner, association finder and native
partition counts give the same results on each fixture.  They skip,
as the JAX suite's do, where the reference's fixtures are not mounted."""

import io
import os

import pytest

torch = pytest.importorskip("torch")

from stoat_tpu.graph import association as jax_association
from stoat_tpu.graph.hashgraph import load_hg as jax_load_hg
from stoat_tpu.graph.snarls import find_snarls as jax_find_snarls
from stoat_tpu_torch.graph.hashgraph import load_hg
from stoat_tpu_torch.graph.snarls import find_snarls
from stoat_tpu_torch.graph.association import PathPartitioner

from test_hashgraph_partitioner import ZOO

pytestmark = pytest.mark.skipif(not os.path.isdir(ZOO),
                                reason="reference fixtures unavailable")

# id of a port partitioner -> stoat_tpu's graph, forest and partitioner
TWINS = {}


def setup(name):
    g = load_hg(os.path.join(ZOO, f"{name}.hg"))
    forest = find_snarls(g)
    part = PathPartitioner(g, g.paths)
    jg = jax_load_hg(os.path.join(ZOO, f"{name}.hg"))
    TWINS[id(part)] = (jg, jax_find_snarls(jg),
                       jax_association.PathPartitioner(jg, jg.paths))
    return g, forest, part


def _sets(forest, part, pair, regular):
    idx = next(i for i, s in enumerate(forest.snarls)
               if {s.start_node, s.end_node} == set(pair))
    return sorted(sorted(s) for s in
                  part.partition_samples_in_snarl(forest, idx, regular))


def sets_of(g, forest, part, pair, regular):
    """The port's sets, after checking that stoat_tpu's are the same."""
    got = _sets(forest, part, pair, regular)
    _jg, jforest, jpart = TWINS[id(part)]
    assert got == _sets(jforest, jpart, pair, regular)
    return got


def test_simple_nested_chain():
    # path_partitioner_unit.cpp:47-190 (nodes here are 1-based: +1)
    g, forest, part = setup("simple_nested_chain")
    ids = sorted(s.id_str for s in forest.snarls)
    assert ids == ["1_4", "4_8", "5_7", "8_10"]
    for regular in (False, True):
        assert sets_of(g, forest, part, (1, 4), regular) == [
            ["path0", "path1"], ["path2", "path3"]]
        assert sets_of(g, forest, part, (4, 8), regular) == [
            ["path0", "path1", "path3"], ["path2"]]
        assert sets_of(g, forest, part, (5, 7), regular) == [
            ["path0"], ["path1", "path3"]]


def test_loop_with_indel():
    g, forest, part = setup("loop_with_indel")
    pairs = {frozenset((s.start_node, s.end_node))
             for s in forest.snarls}
    assert frozenset((1, 6)) in pairs and frozenset((2, 4)) in pairs
    # duplication snarl: {0} vs {1,2} (walks1)
    assert sets_of(g, forest, part, (1, 6), False) == [
        ["path0"], ["path1", "path2"]]
    # nested snarl: 3 distinct ordered walk multisets (walks2/edges2)
    assert len(sets_of(g, forest, part, (2, 4), False)) == 3
    assert len(sets_of(g, forest, part, (2, 4), True)) == 3


def test_simple_bubble():
    g, forest, part = setup("simple_bubble")
    assert [s.id_str for s in forest.snarls] == ["1_5"]
    for regular in (False, True):
        assert sets_of(g, forest, part, (1, 5), regular) == [
            ["path0", "path1"], ["path2"], ["path3"]]


def test_loop_with_indel_two_paths():
    """path_partitioner_unit.cpp:378-467 ('looping snarl same edges
    different order'): outer snarl partitions to one set {path0, path1};
    inner snarl separates them."""
    g, forest, part = setup("loop_with_indel_two_paths")
    assert sets_of(g, forest, part, (1, 6), False) == [["path0", "path1"]]
    inner = sets_of(g, forest, part, (2, 4), False)
    assert inner == [["path0"], ["path1"]]


def test_one_node():
    """path_partitioner_unit.cpp:18-45: a one-node graph constructs a
    partitioner without crashing (there is nothing to partition)."""
    g = load_hg(os.path.join(ZOO, "one_node.hg"))
    assert [p.name for p in g.paths] == ["path"]
    part = PathPartitioner(g, g.paths)
    assert len(part.sample_paths) == 1
    forest = find_snarls(g)
    assert len(forest.snarls) == 0          # no snarls in a single node


def test_association_finder_three_node_bubble():
    """path_partitioner_unit.cpp:469-563 at the test_snarls level: the
    three-node bubble with case={path2} through the full association
    finder (exact + chi2), output rows pinned.

    chi2 truth checked by hand: partitions {path0,path1},{path2},{path3}
    give the 2x3 table [[0,0,1],[2,1,0]] -> Pearson stat 4.0, df 2,
    p = exp(-2) = 0.1353; >2 partitions -> Fisher NA
    (stats_test.cpp:362-380)."""
    from stoat_tpu_torch.graph import association

    g, forest, part = setup("simple_bubble")
    case, control = {"path2"}, {"path0", "path1", "path3"}

    def run(method):
        """The port's rows on the CPU; stoat_tpu's are the same text."""
        buf = io.StringIO()
        n = association.test_snarls(g, forest, part, case, control, method,
                                    "tsv", 0, "", buf, torch.device("cpu"))
        jbuf = io.StringIO()
        assert jax_association.test_snarls(
            *TWINS[id(part)], case, control, method, "tsv", 0, "",
            jbuf) == n
        assert buf.getvalue() == jbuf.getvalue()
        return n, buf

    # exact: the {path2} partition equals the case set -> one NA row,
    # no descent (graph_path_association_finder.cpp:100-117)
    n, buf = run("exact")
    assert n == 1
    row = buf.getvalue().splitlines()[1].split("\t")
    assert row[3] == "1_5" and row[4] == "1,1"
    assert row[5] == "NA" and row[6] == "NA" and row[7] == "NA"

    # chi2: always writes, per-partition case/control counts
    n, buf = run("chi2")
    assert n == 1
    row = buf.getvalue().splitlines()[1].split("\t")
    assert row[3] == "1_5"
    assert row[6] == "0.1353"               # chi2 2x3, stat 4.0, df 2
    assert row[5] == "NA"                   # >2 partitions: Fisher NA
    assert sorted(row[7].split(",")) == ["0:1", "0:2", "1:0"]


def test_native_partition_counts_parity():
    """stoat_graph_partitions == the Python walk-set partitioner on every
    regular snarl of the fixture zoo (counts, order, and representative
    sample)."""
    from stoat_tpu_torch.graph.association import (_NativePartitions,
                                                   _is_regular_snarl)

    pytest.importorskip("stoat_tpu_torch.native")
    from stoat_tpu_torch.native import get_graph_lib
    if get_graph_lib() is None:
        pytest.skip("native graph core unavailable")

    for name in ("simple_nested_chain", "simple_bubble",
                 "loop_with_indel", "loop_with_indel_two_paths"):
        g, forest, part = setup(name)
        samples = {p.sample for p in g.paths}
        case = set(sorted(samples)[: len(samples) // 2])
        control = samples - case
        native = _NativePartitions(forest, part, case, control)
        _jg, jforest, jpart = TWINS[id(part)]
        jnative = jax_association._NativePartitions(jforest, jpart, case,
                                                    control)
        for i, sn in enumerate(forest.snarls):
            if not _is_regular_snarl(g, forest, i):
                continue
            sets = part.partition_samples_in_snarl(forest, i, True)
            want = [(sum(1 for s in p if s in case),
                     sum(1 for s in p if s in control),
                     sorted(p)[0]) for p in sets]
            got = native.counts(i)
            assert got == want, (name, sn.id_str, got, want)
            assert jnative.counts(i) == got
