"""Partitioner fixture zoo: the reference's path_partitioner_unit.cpp
graphs (construction preserved in its comments) ported to GFA, with the
same pinned walk-set truths.  Node ids shift +1 (GFA/HashGraph are
1-based vs the comments' 0-based arrays).

The JAX suite's tests (tests/test_partitioner_zoo.py) on the port's
``graph/partition.py``; ``stoat_tpu``'s partitioner gives the same sets
and regularity on each snarl.
"""

import pytest

pytest.importorskip("torch")

from stoat_tpu.graph import association as jax_association
from stoat_tpu.graph.gfa import load_gfa as jax_load_gfa
from stoat_tpu.graph.snarls import find_snarls as jax_find_snarls
from stoat_tpu_torch.graph.gfa import load_gfa
from stoat_tpu_torch.graph.snarls import find_snarls
from stoat_tpu_torch.graph.association import _is_regular_snarl

from test_graph_decompose import build_gfa

# id of a port graph -> stoat_tpu's graph and forest of the same GFA
TWINS = {}


def load(gfa):
    """The port's graph and snarl forest of ``gfa``; stoat_tpu's are kept
    for :func:`partition`."""
    g = load_gfa(gfa, {"ref"})
    jg = jax_load_gfa(gfa, {"ref"})
    TWINS[id(g)] = (jg, jax_find_snarls(jg))
    return g, find_snarls(g)


def _partition(assoc, g, forest, snarl_id, regular):
    idx = next(i for i, s in enumerate(forest.snarls)
               if {s.start_node, s.end_node} == set(snarl_id))
    samples = [p for p in g.paths if p.sample.startswith("path")]
    part = assoc.PathPartitioner(g, samples)
    sets = part.partition_samples_in_snarl(forest, idx, regular)
    return (sorted(sorted(s) for s in sets),
            assoc._is_regular_snarl(g, forest, idx))


def partition(g, forest, snarl_id, regular):
    """The port's walk-set partition of the snarl, after checking that
    stoat_tpu's gives the same sets and regularity."""
    import stoat_tpu_torch.graph.association as port
    got = _partition(port, g, forest, snarl_id, regular)
    assert got == _partition(jax_association, *TWINS[id(g)], snarl_id,
                             regular)
    return got[0]


def test_nested_bubbles(tmp_path):
    # path_partitioner_unit.cpp:47-190 (0-based graph shifted +1):
    # bubbles (1,4) and (8,10); snarl (4,8) with nested (5,7)
    segs = [(i, s) for i, s in enumerate(
        ["C", "C", "C", "A", "T", "C", "A", "C", "A", "A"], start=1)]
    links_0based = [(0, 1), (0, 2), (1, 3), (2, 3), (3, 4), (3, 7),
                    (4, 5), (4, 6), (5, 6), (6, 7), (7, 8), (7, 9),
                    (8, 9)]
    links = [(a + 1, "+", b + 1, "+") for a, b in links_0based]
    paths_0based = [[0, 1, 3, 4, 5, 6, 7], [0, 1, 3, 4, 6, 7],
                    [0, 2, 3, 7], [0, 2, 3, 4, 6, 7]]
    paths = [(f"path{i}#1#c",
              ",".join(f"{n + 1}+" for n in seq))
             for i, seq in enumerate(paths_0based)]
    # a reference path for rooting
    paths.append(("ref", "1+,2+,4+,5+,7+,8+,10+"))
    gfa = build_gfa(tmp_path, segs, links, paths)
    g, forest = load(gfa)
    ids = sorted(s.id_str for s in forest.snarls)
    assert ids == ["1_4", "4_8", "5_7", "8_10"]

    # snarl1 (1,4): {path0,path1} vs {path2,path3}
    assert partition(g, forest, (1, 4), regular=False) == [
        ["path0", "path1"], ["path2", "path3"]]
    assert partition(g, forest, (1, 4), regular=True) == [
        ["path0", "path1"], ["path2", "path3"]]

    # snarl2 (4,8): the nested chain hides the inner walk difference:
    # {path0,path1,path3} vs {path2}  (unit test walks2)
    assert partition(g, forest, (4, 8), regular=False) == [
        ["path0", "path1", "path3"], ["path2"]]
    assert partition(g, forest, (4, 8), regular=True) == [
        ["path0", "path1", "path3"], ["path2"]]

    # snarl3 (5,7): {path0} vs {path1,path3}; path2 not through
    assert partition(g, forest, (5, 7), regular=False) == [
        ["path0"], ["path1", "path3"]]
    assert partition(g, forest, (5, 7), regular=True) == [
        ["path0"], ["path1", "path3"]]


def test_loop_with_indel(tmp_path):
    # path_partitioner_unit.cpp:182-283: duplication loop 5->2 around the
    # nested bubble (2,4); paths loop through it different numbers of
    # times with/without the insertion node 3
    segs = [(i, s) for i, s in enumerate(
        ["AAAAAAAAAA", "A", "G", "C", "T", "AAAAAAAAA"], start=1)]
    links_0based = [(0, 1), (1, 2), (1, 3), (2, 3), (3, 4), (4, 1),
                    (4, 5)]
    links = [(a + 1, "+", b + 1, "+") for a, b in links_0based]
    paths_0based = [[0, 1, 2, 3, 4, 5], [0, 1, 3, 4, 1, 3, 4, 5],
                    [0, 1, 2, 3, 4, 1, 3, 4, 5]]
    paths = [(f"path{i}#1#c",
              ",".join(f"{n + 1}+" for n in seq))
             for i, seq in enumerate(paths_0based)]
    paths.append(("ref", "1+,2+,3+,4+,5+,6+"))
    gfa = build_gfa(tmp_path, segs, links, paths)
    g, forest = load(gfa)
    ids = sorted(s.id_str for s in forest.snarls)
    assert "1_6" in ids and "2_4" in ids

    # duplication snarl (1,6): {path0} vs {path1,path2} (walks1)
    assert partition(g, forest, (1, 6), regular=False) == [
        ["path0"], ["path1", "path2"]]

    # nested snarl (2,4): all three paths take distinct ordered walk
    # multisets -> 3 singleton sets (walks2 / edges2, both size 3)
    assert partition(g, forest, (2, 4), regular=False) == [
        ["path0"], ["path1"], ["path2"]]
    assert partition(g, forest, (2, 4), regular=True) == [
        ["path0"], ["path1"], ["path2"]]
    # the loop makes it irregular in our netgraph view
    idx = next(i for i, s in enumerate(forest.snarls)
               if s.id_str in ("1_6", "6_1"))
    assert not _is_regular_snarl(g, forest, idx)


def test_three_node_bubble(tmp_path):
    # path_partitioner_unit.cpp:284+: 1-(2|3|4)-5, two paths via node 2
    segs = [(i, s) for i, s in enumerate(
        ["AAAAAAAAAA", "A", "G", "C", "AAAAAAAAA"], start=1)]
    links_0based = [(0, 1), (0, 2), (0, 3), (1, 4), (2, 4), (3, 4)]
    links = [(a + 1, "+", b + 1, "+") for a, b in links_0based]
    paths_0based = [[0, 1, 4], [0, 1, 4], [0, 2, 4], [0, 3, 4]]
    paths = [(f"path{i}#1#c",
              ",".join(f"{n + 1}+" for n in seq))
             for i, seq in enumerate(paths_0based)]
    paths.append(("ref", "1+,2+,5+"))
    gfa = build_gfa(tmp_path, segs, links, paths)
    g, forest = load(gfa)
    assert [s.id_str for s in forest.snarls] == ["1_5"]
    assert partition(g, forest, (1, 5), regular=True) == [
        ["path0", "path1"], ["path2"], ["path3"]]
    assert partition(g, forest, (1, 5), regular=False) == [
        ["path0", "path1"], ["path2"], ["path3"]]
