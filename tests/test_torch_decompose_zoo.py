"""Decomposition fixture zoo: graph topologies and pinned expectations from
the reference's snarl_data_t_unit.cpp sections (4th, deletion_snp,
insert_deletion, insert_snp, inversion, large_del, loop_simple), rebuilt
as GFA with sequence lengths chosen to reproduce the pinned
positions/types.  Off-reference snarl ids may orient either way (the
reference's orientation is a .dist artifact), so those compare as
unordered node pairs.

The JAX suite's tests (tests/test_decompose_zoo.py) on the port's
``graph/`` and native graph core; each decomposition is also run through
``stoat_tpu``'s (``test_torch_graph_decompose.decompose``: the same snarl
and reject files).
"""

import os

import pytest

pytest.importorskip("torch")

from test_gbz import ZOO
from test_graph_decompose import build_gfa
from test_torch_graph_decompose import decompose


def by_pair(snarls):
    return {frozenset(s.snarl_ids): s for s in snarls}


def test_4th(tmp_path):
    # snarl_data_t_unit.cpp "4th": 7_2 paths {>2>3>5>7,>2>4>6>7,>2>3>6>7}
    # start 8 end 12 types {4,6,5}
    gfa = build_gfa(
        tmp_path,
        [(1, "AAAA"), (2, "CCCC"), (3, "TT"), (4, "GGG"), (5, "AA"),
         (6, "CCC"), (7, "AAAA")],
        [(1, "+", 2, "+"), (2, "+", 3, "+"), (2, "+", 4, "+"),
         (3, "+", 5, "+"), (4, "+", 6, "+"), (3, "+", 6, "+"),
         (5, "+", 7, "+"), (6, "+", 7, "+")],
        [("ref", "1+,2+,3+,5+,7+")])
    snarls = decompose(gfa)["ref"]
    assert len(snarls) == 1
    s = snarls[0]
    assert frozenset(s.snarl_ids) == frozenset((2, 7))
    assert sorted(s.path_strings) == [">2>3>5>7", ">2>3>6>7", ">2>4>6>7"]
    assert s.start_pos == 8
    assert s.end_pos == 12
    assert dict(zip(s.path_strings, s.type_variants)) == {
        ">2>3>5>7": "4", ">2>4>6>7": "6", ">2>3>6>7": "5"}


def test_deletion_snp(tmp_path):
    # "2_4" {>2>4, >2>3>4} start 8 end 9 types {0,1}
    gfa = build_gfa(
        tmp_path,
        [(1, "AAAA"), (2, "CCCC"), (3, "T"), (4, "AAAA")],
        [(1, "+", 2, "+"), (2, "+", 3, "+"), (2, "+", 4, "+"),
         (3, "+", 4, "+")],
        [("ref", "1+,2+,3+,4+")])
    s = decompose(gfa)["ref"][0]
    assert frozenset(s.snarl_ids) == frozenset((2, 4))
    assert sorted(s.path_strings) == [">2>3>4", ">2>4"]
    assert (s.start_pos, s.end_pos) == (8, 9)
    assert dict(zip(s.path_strings, s.type_variants)) == {
        ">2>4": "0", ">2>3>4": "1"}


def test_insert_deletion(tmp_path):
    # "2_4" {>2>4, >2>3>4} start 8 end 11 types {0,3}
    gfa = build_gfa(
        tmp_path,
        [(1, "AAAA"), (2, "CCCC"), (3, "TTT"), (4, "AAAA")],
        [(1, "+", 2, "+"), (2, "+", 3, "+"), (2, "+", 4, "+"),
         (3, "+", 4, "+")],
        [("ref", "1+,2+,3+,4+")])
    s = decompose(gfa)["ref"][0]
    assert frozenset(s.snarl_ids) == frozenset((2, 4))
    assert (s.start_pos, s.end_pos) == (8, 11)
    assert dict(zip(s.path_strings, s.type_variants)) == {
        ">2>4": "0", ">2>3>4": "3"}


def test_insert_snp(tmp_path):
    # "2_5" {>2>3>5, >2>4>5} start 8 end 9 types {1,3}
    gfa = build_gfa(
        tmp_path,
        [(1, "AAAA"), (2, "CCCC"), (3, "T"), (4, "GGG"), (5, "AAAA")],
        [(1, "+", 2, "+"), (2, "+", 3, "+"), (2, "+", 4, "+"),
         (3, "+", 5, "+"), (4, "+", 5, "+")],
        [("ref", "1+,2+,3+,5+")])
    s = decompose(gfa)["ref"][0]
    assert frozenset(s.snarl_ids) == frozenset((2, 5))
    assert (s.start_pos, s.end_pos) == (8, 9)
    assert dict(zip(s.path_strings, s.type_variants)) == {
        ">2>3>5": "1", ">2>4>5": "3"}


def test_inversion_nested(tmp_path):
    # "6_2" {>2>6, >2>3>0>5>6} types {0,6} start 8 end 14;
    # "5_3" {>3>4>5, >3<4>5} types {2,2} start 9 end 11
    gfa = build_gfa(
        tmp_path,
        [(1, "AAAA"), (2, "CCCC"), (3, "T"), (4, "GG"), (5, "AAA"),
         (6, "CCCC"), (7, "AAAA")],
        [(1, "+", 2, "+"), (2, "+", 6, "+"), (2, "+", 3, "+"),
         (3, "+", 4, "+"), (3, "+", 4, "-"), (4, "+", 5, "+"),
         (4, "-", 5, "+"), (5, "+", 6, "+"), (6, "+", 7, "+")],
        [("ref", "1+,2+,3+,4+,5+,6+,7+")])
    snarls = by_pair(decompose(gfa)["ref"])
    outer = snarls[frozenset((2, 6))]
    inner = snarls[frozenset((3, 5))]
    assert sorted(outer.path_strings) == [">2>3>0>5>6", ">2>6"]
    assert dict(zip(outer.path_strings, outer.type_variants)) == {
        ">2>6": "0", ">2>3>0>5>6": "6"}
    assert (outer.start_pos, outer.end_pos) == (8, 14)
    assert sorted(inner.path_strings) == [">3<4>5", ">3>4>5"]
    assert inner.type_variants == ["2", "2"]
    assert (inner.start_pos, inner.end_pos) == (9, 11)
    assert inner.depth == outer.depth + 1


def test_large_del_nested_chain(tmp_path):
    # "9_2" {>2>9, >2>3>0>8>9} types {0, 9/10}; ref skips the interior
    # (start 8 end 8); nested {3..6} and {6..8} inherit the position
    gfa = build_gfa(
        tmp_path,
        [(1, "AAAA"), (2, "CCCC"), (3, "AAAA"), (4, "T"), (5, "G"),
         (6, "CC"), (7, "A"), (8, "CC"), (9, "AAAA"), (10, "TTTT")],
        [(1, "+", 2, "+"), (2, "+", 9, "+"), (2, "+", 3, "+"),
         (3, "+", 4, "+"), (3, "+", 5, "+"), (4, "+", 6, "+"),
         (5, "+", 6, "+"), (6, "+", 8, "+"), (6, "+", 7, "+"),
         (7, "+", 8, "+"), (8, "+", 9, "+"), (9, "+", 10, "+")],
        [("ref", "1+,2+,9+,10+")])
    snarls = by_pair(decompose(gfa)["ref"])
    assert set(snarls) == {frozenset((2, 9)), frozenset((3, 6)),
                           frozenset((6, 8))}
    outer = snarls[frozenset((2, 9))]
    assert (outer.start_pos, outer.end_pos) == (8, 8)
    assert sorted(outer.type_variants) == ["0", "9/10"]
    starred = [p for p in outer.path_strings if ">0" in p]
    assert len(starred) == 1
    # nested snarls inherit the parent's position (REF column 0)
    for pair in (frozenset((3, 6)), frozenset((6, 8))):
        assert (snarls[pair].start_pos, snarls[pair].end_pos) == (8, 8)
        assert snarls[pair].depth == outer.depth + 1
    assert sorted(snarls[frozenset((3, 6))].type_variants) == ["1", "1"]
    assert sorted(snarls[frozenset((6, 8))].type_variants) == ["0", "1"]


def test_loop_simple(tmp_path):
    # "2_5" with a self loop on node 3, cycle_threshold=1:
    # paths {>2>3>5, >2>3>3>5, >2>4>5}
    gfa = build_gfa(
        tmp_path,
        [(1, "AAAA"), (2, "CCCC"), (3, "T"), (4, "GG"), (5, "AAAA"),
         (6, "TTTT")],
        [(1, "+", 2, "+"), (2, "+", 3, "+"), (2, "+", 4, "+"),
         (3, "+", 3, "+"), (3, "+", 5, "+"), (4, "+", 5, "+"),
         (5, "+", 6, "+")],
        [("ref", "1+,2+,3+,5+,6+")])
    s = decompose(gfa)["ref"][0]
    assert frozenset(s.snarl_ids) == frozenset((2, 5))
    assert sorted(s.path_strings) == [">2>3>3>5", ">2>3>5", ">2>4>5"]


def test_magic_byte_dispatch(tmp_path):
    """Format detection is by content like the reference's VPKG
    (register_io.cpp:20-26): a misnamed binary graph still loads and a
    misnamed GFA still parses."""
    import shutil

    from stoat_tpu_torch.graph.formats import load_graph, sniff_graph_format

    zoo = ZOO
    if not os.path.isdir(zoo):
        pytest.skip("reference fixtures unavailable")
    # .hg content behind a misleading name
    masked = str(tmp_path / "mystery.graph")
    shutil.copy(os.path.join(zoo, "simple_snp.hg"), masked)
    assert sniff_graph_format(masked) == "hg"
    g = load_graph(masked, {"ref"})
    assert sorted(g.sequences) == [1, 2, 3, 4, 5, 6]
    # .pg and .gbz magics
    assert sniff_graph_format(os.path.join(zoo, "simple_snp.pg")) == "pg"
    assert sniff_graph_format(os.path.join(zoo, "simple_snp.gbz")) == "gbz"
    # GFA by content
    gfa = str(tmp_path / "noext")
    with open(gfa, "w") as fh:
        fh.write("H\tVN:Z:1.0\nS\t1\tA\n")
    assert sniff_graph_format(gfa) == "gfa"


def test_native_array_decomposition_matches_temp_gfa_path(tmp_path):
    """Binary graphs feed graph_core directly as arrays; the TSV must be
    identical to decomposing the same graph written out as GFA."""
    zoo = ZOO
    if not os.path.isdir(zoo):
        pytest.skip("reference fixtures unavailable")
    from stoat_tpu_torch.graph.hashgraph import load_hg
    from stoat_tpu.graph.hashgraph import load_hg as jax_load_hg
    from stoat_tpu.native import native_decompose_graph as jax_native
    from stoat_tpu_torch.native import (get_graph_lib, native_decompose_gfa,
                                        native_decompose_graph)
    if get_graph_lib() is None:
        pytest.skip("native graph core toolchain unavailable")
    for name in ("simple_snp", "loop_plus", "complex_ins", "nested_plus"):
        g = load_hg(os.path.join(zoo, f"{name}.hg"), {"ref"})
        tsv_arrays, rej_arrays = native_decompose_graph(g)
        gfa = str(tmp_path / f"{name}.gfa")
        g.write_gfa(gfa)
        tsv_gfa, rej_gfa = native_decompose_gfa(gfa, {"ref"}, 50, 10000, 1)
        assert tsv_arrays == tsv_gfa, name
        assert rej_arrays == rej_gfa, name
        assert jax_native(jax_load_hg(os.path.join(zoo, f"{name}.hg"),
                                      {"ref"})) == (tsv_arrays, rej_arrays)
