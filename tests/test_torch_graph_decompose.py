"""Snarl decomposition tests on GFA fixtures.

The simple_snp oracle comes from the reference's own unit test
(tests/unittest/snarl_data_t_unit.cpp:99-115: id 2_5, paths
{>2>3>5,>2>4>5}, start 8, end 9, types {1,1}); the other fixtures mirror
the reference's graph_test zoo topologies (deletion, 3-allele, insertion,
nesting, cyclic loop).

The JAX suite's tests (tests/test_graph_decompose.py) run on the port's
``graph/`` modules; every decomposition is also run through
``stoat_tpu``'s, and both write the same snarl and reject files.
"""

import io
import os

import pytest

pytest.importorskip("torch")

from stoat_tpu.graph import decompose as jax_decompose
from stoat_tpu.graph import gfa as jax_gfa
from stoat_tpu.io import snarl_file as jax_snarl_file
from stoat_tpu_torch.graph.gfa import load_gfa
from stoat_tpu_torch.graph.snarls import find_snarls
from stoat_tpu_torch.io import snarl_file

from test_graph_decompose import REF_GFA, build_gfa  # noqa: F401


def decomposition_files(decompose_mod, load, snarl_mod, path, ref,
                        **kwargs):
    """(chr_map, snarl TSV, reject TSV) of one package's decomposition of
    the graph that ``load(path, ref)`` reads."""
    out, fail = io.StringIO(), io.StringIO()
    snarl_mod.write_snarl_file_header(out)
    snarl_mod.write_snarl_fail_header(fail)
    chr_map = decompose_mod.decompose_graph(
        load(path, ref), ref, out_snarl=out, out_fail=fail, **kwargs)
    return chr_map, out.getvalue(), fail.getvalue()


def decompose(path, ref={"ref"}, port_load=load_gfa,
              jax_load=jax_gfa.load_gfa, **kwargs):
    """The port's decomposition of the graph at ``path`` (a GFA unless
    the loaders say otherwise), after checking that stoat_tpu's writes
    the same snarl and reject files."""
    import stoat_tpu_torch.graph.decompose as port_decompose
    chr_map, tsv, rejects = decomposition_files(
        port_decompose, port_load, snarl_file, path, ref, **kwargs)
    _, jax_tsv, jax_rejects = decomposition_files(
        jax_decompose, jax_load, jax_snarl_file, path, ref, **kwargs)
    assert tsv == jax_tsv
    assert rejects == jax_rejects
    return chr_map


def snarl_record(s):
    """What a decomposition says of one snarl."""
    return (s.snarl_id_str, s.start_pos, s.end_pos, list(s.path_strings),
            list(s.type_variants), s.depth)


def snarl_forest(path, ref={"ref"}):
    """The port's snarl forest of the GFA at ``path``, after checking
    that stoat_tpu's finds the same snarls, parents and chains."""
    from stoat_tpu.graph.snarls import find_snarls as jax_find_snarls

    def shape(forest):
        return ([(s.id_str, s.parent) for s in forest.snarls],
                [list(c) for c in forest.chains])

    forest = find_snarls(load_gfa(path, ref))
    assert shape(forest) == shape(jax_find_snarls(jax_gfa.load_gfa(path,
                                                                   ref)))
    return forest


@pytest.mark.skipif(not os.path.exists(REF_GFA), reason="fixture missing")
def test_simple_snp_reference_fixture():
    chr_map = decompose(REF_GFA)
    assert list(chr_map) == ["ref"]
    snarls = chr_map["ref"]
    assert len(snarls) == 1
    s = snarls[0]
    assert s.snarl_id_str == "2_5"
    assert sorted(s.path_strings) == [">2>3>5", ">2>4>5"]
    assert s.start_pos == 8
    assert s.end_pos == 9
    assert s.type_variants == ["1", "1"]
    assert s.depth == 1


def test_three_allele_bubble(tmp_path):
    # 1 -> {2,3,4} -> 5 (3th_snp oracle: id 2_6 in the reference graph;
    # same topology here with our numbering)
    path = build_gfa(
        tmp_path,
        [(1, "TTTT"), (2, "AAAA"), (3, "C"), (4, "G"), (5, "T"),
         (6, "AAAA")],
        [(1, "+", 2, "+"), (2, "+", 3, "+"), (2, "+", 4, "+"),
         (2, "+", 5, "+"), (3, "+", 6, "+"), (4, "+", 6, "+"),
         (5, "+", 6, "+")],
        [("ref", "1+,2+,3+,6+")])
    chr_map = decompose(path)
    snarls = chr_map["ref"]
    assert len(snarls) == 1
    s = snarls[0]
    assert s.snarl_id_str == "2_6"
    assert sorted(s.path_strings) == [">2>3>6", ">2>4>6", ">2>5>6"]
    assert s.type_variants == ["1", "1", "1"]
    assert s.start_pos == 8


def test_deletion_bubble(tmp_path):
    # 1 -> 2 -> 3 and 1 -> 3 (deletion path)
    path = build_gfa(
        tmp_path,
        [(1, "AAAA"), (2, "CCC"), (3, "GGGG")],
        [(1, "+", 2, "+"), (2, "+", 3, "+"), (1, "+", 3, "+")],
        [("ref", "1+,2+,3+")])
    chr_map = decompose(path)
    s = chr_map["ref"][0]
    assert s.snarl_id_str == "1_3"
    assert sorted(s.path_strings) == [">1>2>3", ">1>3"]
    # deletion path type "0", allele path type = len("CCC")
    by_path = dict(zip(s.path_strings, s.type_variants))
    assert by_path[">1>3"] == "0"
    assert by_path[">1>2>3"] == "3"


def test_nested_bubble_collapses_to_star(tmp_path):
    # outer: 1 -> {2..6 chain, direct} -> 7 ; inner: 3 -> {4,5} -> 6
    # chain 2-[3..6]-6? build: 1->2, 2->3, 3->4, 3->5, 4->6, 5->6, 6->7,
    # 1->7 (outer deletion)
    path = build_gfa(
        tmp_path,
        [(1, "AAAA"), (2, "TT"), (3, "CC"), (4, "G"), (5, "A"),
         (6, "CC"), (7, "AAAA")],
        [(1, "+", 2, "+"), (2, "+", 3, "+"), (3, "+", 4, "+"),
         (3, "+", 5, "+"), (4, "+", 6, "+"), (5, "+", 6, "+"),
         (6, "+", 7, "+"), (1, "+", 7, "+")],
        [("ref", "1+,2+,3+,4+,6+,7+")])
    chr_map = decompose(path)
    snarls = {s.snarl_id_str: s for s in chr_map["ref"]}
    assert set(snarls) == {"1_7", "3_6"}
    outer = snarls["1_7"]
    inner = snarls["3_6"]
    assert inner.depth == outer.depth + 1
    assert sorted(inner.path_strings) == [">3>4>6", ">3>5>6"]
    # outer: direct deletion + collapsed chain through the nested bubble
    assert ">1>7" in outer.path_strings
    starred = [p for p in outer.path_strings if ">0" in p]
    assert len(starred) == 1
    # chain bounds are 2 and 6: rendered >1>2>0>6>7
    assert starred[0] == ">1>2>0>6>7"
    # nested path type is a min/max range (calcul_pos_type_variant)
    by_path = dict(zip(outer.path_strings, outer.type_variants))
    assert by_path[">1>7"] == "0"
    assert by_path[">1>2>0>6>7"] == "7"  # 2+2+1+2 == min == max


def test_cyclic_loop_contained(tmp_path):
    # 1 -> 2 -> 3, 2 -> 2 (self loop): snarl (1,3) with cyclic interior
    path = build_gfa(
        tmp_path,
        [(1, "AAAA"), (2, "C"), (3, "GGGG")],
        [(1, "+", 2, "+"), (2, "+", 2, "+"), (2, "+", 3, "+")],
        [("ref", "1+,2+,3+")])
    forest = snarl_forest(path)
    ids = {s.id_str for s in forest.snarls}
    assert "1_3" in ids


def test_chained_bubbles_share_boundary(tmp_path):
    # 1 -> {2,3} -> 4 -> {5,6} -> 7 : two snarls chained at node 4
    path = build_gfa(
        tmp_path,
        [(1, "AA"), (2, "C"), (3, "G"), (4, "TT"), (5, "A"), (6, "T"),
         (7, "AA")],
        [(1, "+", 2, "+"), (1, "+", 3, "+"), (2, "+", 4, "+"),
         (3, "+", 4, "+"), (4, "+", 5, "+"), (4, "+", 6, "+"),
         (5, "+", 7, "+"), (6, "+", 7, "+")],
        [("ref", "1+,2+,4+,5+,7+")])
    forest = snarl_forest(path)
    ids = sorted(s.id_str for s in forest.snarls)
    assert ids == ["1_4", "4_7"]
    # both top-level, chained together
    assert all(s.parent is None for s in forest.snarls)
    assert len(forest.chains) == 1
    assert len(forest.chains[0]) == 2
    chr_map = decompose(path)
    snarls = {s.snarl_id_str: s for s in chr_map["ref"]}
    assert snarls["1_4"].start_pos == 2   # after node 1 (len 2)
    assert snarls["4_7"].start_pos == 5   # offset(4)=3 + len(4)=2


def test_inversion_bubble(tmp_path):
    # 1 -> 2+ / 1 -> 2- ; 2+ -> 3, 2- -> 3 : inversion allele
    path = build_gfa(
        tmp_path,
        [(1, "AAAA"), (2, "ACGT"), (3, "TTTT")],
        [(1, "+", 2, "+"), (1, "+", 2, "-"), (2, "+", 3, "+"),
         (2, "-", 3, "+")],
        [("ref", "1+,2+,3+")])
    chr_map = decompose(path)
    s = chr_map["ref"][0]
    assert s.snarl_id_str == "1_3"
    assert sorted(s.path_strings) == [">1<2>3", ">1>2>3"]
