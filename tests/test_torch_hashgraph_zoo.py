"""Decomposition against the reference's REAL .hg fixtures.

Loads the actual bdsg HashGraph files from the reference's fixture zoo via
our native .hg reader and pins the decomposition results against the
expectations hard-coded in the reference's own unit tests
(tests/unittest/snarl_data_t_unit.cpp).  Snarl ids compare as unordered
node pairs (the reference's id orientation is a .dist-index artifact);
path strings compare after orientation normalization.

The JAX suite's tests (tests/test_hashgraph_zoo.py) on the port's .hg
reader and decomposition; ``stoat_tpu``'s write the same snarl and reject
files on each fixture.  They skip, as the JAX suite's do, where the
reference's fixtures are not mounted.
"""

import os

import pytest

pytest.importorskip("torch")

from stoat_tpu.graph.hashgraph import load_hg as jax_load_hg
from stoat_tpu_torch.graph.hashgraph import load_hg
from stoat_tpu_torch.io.snarl_file import parse_path_string

from test_hashgraph_zoo import ZOO
from test_torch_graph_decompose import decompose

pytestmark = pytest.mark.skipif(not os.path.isdir(ZOO),
                                reason="reference fixtures unavailable")


def rc_path(path_str):
    nodes = parse_path_string(path_str)
    return "".join(("<" if not rev else ">") + str(nid)
                   for nid, rev in reversed(nodes))


def norm(path_str):
    return min(path_str, rc_path(path_str))


def run_ref(name, ref, cycle_threshold=1):
    """The port's decomposition of the fixture, after checking that
    stoat_tpu's writes the same snarl and reject files."""
    return decompose(os.path.join(ZOO, f"{name}.hg"), {ref},
                     port_load=load_hg, jax_load=jax_load_hg,
                     cycle_threshold=cycle_threshold)


def run(name, cycle_threshold):
    return run_ref(name, "ref", cycle_threshold)


def get(chr_map, pair):
    for s in chr_map["ref"]:
        if frozenset(s.snarl_ids) == frozenset(pair):
            return s
    raise AssertionError(
        f"snarl {pair} not found in "
        f"{[s.snarl_id_str for s in chr_map['ref']]}")


def check(s, paths_types, start=None, end=None):
    got = {norm(p): t for p, t in zip(s.path_strings, s.type_variants)}
    want = {norm(p): t for p, t in paths_types.items()}
    assert got == want, (s.snarl_id_str, got, want)
    if start is not None:
        assert s.start_pos == start, s.snarl_id_str
    if end is not None:
        assert s.end_pos == end, s.snarl_id_str


def test_simple_snp():
    cm = run("simple_snp", 0)
    assert len(cm["ref"]) == 1
    check(get(cm, (2, 5)), {">2>3>5": "1", ">2>4>5": "1"}, 8, 9)


def test_3th_snp():
    cm = run("3th_snp", 0)
    assert len(cm["ref"]) == 1
    check(get(cm, (2, 6)),
          {">2>3>6": "1", ">2>4>6": "1", ">2>5>6": "1"}, 8, 9)


def test_4th():
    cm = run("4th", 0)
    assert len(cm["ref"]) == 1
    check(get(cm, (2, 7)),
          {">2>3>5>7": "4", ">2>4>6>7": "6", ">2>3>6>7": "5"}, 8, 12)


def test_deletion_snp():
    cm = run("deletion_snp", 0)
    assert len(cm["ref"]) == 1
    check(get(cm, (2, 4)), {">2>4": "0", ">2>3>4": "1"}, 8, 9)


def test_insert_deletion():
    cm = run("insert_deletion", 0)
    assert len(cm["ref"]) == 1
    check(get(cm, (2, 4)), {">2>4": "0", ">2>3>4": "3"}, 8, 11)


def test_insert_snp():
    cm = run("insert_snp", 0)
    assert len(cm["ref"]) == 1
    check(get(cm, (2, 5)), {">2>3>5": "1", ">2>4>5": "3"}, 8, 9)


def test_inversion():
    cm = run("inversion", 0)
    assert len(cm["ref"]) == 2
    check(get(cm, (2, 6)), {">2>6": "0", ">2>3>0>5>6": "6"}, 8, 14)
    check(get(cm, (3, 5)), {">3>4>5": "2", ">3<4>5": "2"}, 9, 11)


def test_large_del():
    cm = run("large_del", 0)
    assert len(cm["ref"]) == 3
    check(get(cm, (2, 9)), {">2>9": "0", ">2>3>0>8>9": "9/10"}, 8, 8)
    check(get(cm, (6, 8)), {">6>8": "0", ">6>7>8": "1"}, 8, 8)
    check(get(cm, (3, 6)), {">3>5>6": "1", ">3>4>6": "1"}, 8, 8)


def test_loop_simple():
    cm = run("loop_simple", 1)
    assert len(cm["ref"]) == 1
    check(get(cm, (2, 5)),
          {">2>3>5": "1", ">2>3>3>5": "2", ">2>4>5": "2"}, 8, 9)


def test_loop():
    cm = run("loop", 2)
    assert len(cm["ref"]) == 1
    check(get(cm, (1, 5)), {
        ">1>2>3>5": "5", ">1>2>3>2>3>5": "10", ">1>2>3>2>3>2>3>5": "15",
        ">1>2>3>2>3>2>4>5": "16", ">1>2>3>2>4>5": "11", ">1>2>4>5": "6",
    }, 4, 9)


def test_loop_double():
    cm = run("loop_double", 2)
    assert len(cm["ref"]) == 1
    check(get(cm, (2, 7)), {
        ">2>3>4>5>7": "10", ">2>3>4>5>3>4>5>7": "20",
        ">2>3>4>5>3>4>5>3>4>5>7": "30", ">2>3>4>5>3>4>3>4>5>7": "28",
        ">2>3>4>3>4>5>7": "18", ">2>3>4>3>4>5>3>4>5>7": "28",
        ">2>3>4>3>4>3>4>5>7": "26", ">2>6>7": "2",
    }, 8, 10)


def test_loop_plus():
    cm = run("loop_plus", 1)
    assert len(cm["ref"]) == 2
    check(get(cm, (2, 8)), {
        ">2>3>0>6>8": "3/4", ">2>3>0>6>3>0>6>8": "6/8", ">2>7>8": "1",
    }, 8, 9)
    check(get(cm, (3, 6)), {">3>5>6": "2", ">3>4>6": "1"}, 8, 9)


def test_repetition():
    cm = run("repetition", 0)
    assert len(cm["ref"]) == 1
    check(get(cm, (2, 6)), {
        ">2>6": "0", ">2>3>6": "3", ">2>3>4>6": "6", ">2>3>4>5>6": "9",
    }, 8, 8)


def test_complex_ins():
    cm = run("complex_ins", 0)
    assert len(cm["ref"]) == 1
    check(get(cm, (2, 8)), {
        ">2>8": "0", ">2>3>4>6>8": "3", ">2>3>5>6>8": "3",
        ">2>3>5>7>8": "3", ">2>7>8": "1",
    }, 8, 9)


def test_snp_and_nested_snp():
    cm = run("snp_and_nested_snp", 0)
    assert len(cm["ref"]) == 2
    check(get(cm, (2, 8)), {">2>3>0>6>8": "3/4", ">2>7>8": "1"}, 8, 9)
    check(get(cm, (3, 6)), {">3>4>6": "1", ">3>5>6": "2"}, 8, 9)


def test_nested_plus():
    cm = run("nested_plus", 0)
    assert len(cm["ref"]) == 2
    check(get(cm, (2, 8)), {
        ">2>8": "0", ">2>3>0>6>7>8": "5", ">2>3>0>6>8": "4"}, 8, 12)
    check(get(cm, (3, 6)), {">3>5>6": "2", ">3>4>6": "2"}, 9, 11)


# --- fixtures without reference unit truths --------------------------------
# The reference's snarl_data_t_unit.cpp covers 16 fixtures; the remaining
# zoo members are pinned here as regression truths (our own canonical
# output, orientation along the reference path) plus reference-parity
# error behavior for the snarl-less graphs (the reference throws on
# total paths == 0, snarl_data_t.cpp:765 — its own "linear" unit section
# is commented out for the same reason).

def test_jean():
    cm = run("jean", 1)
    assert len(cm["ref"]) == 1
    s = get(cm, (2, 6))
    # 63-step ref path wanders the 3<->4<->5 braid; cycle cap 1 allows one
    # revisit per node: 8 enumerated walks incl. inversions (regression pin)
    assert sorted(s.path_strings) == sorted([
        ">2>3>4>3>4>5<5<4<3<4>5>6", ">2>3>4>3>4>5<5<4>5>6",
        ">2>3>4>3>4>5>6", ">2>3>4>5<5>4>5>6", ">2>3>4>5<5<4<3<4>5>6",
        ">2>3>4>5<5<4>5>6", ">2>3>4>5>6", ">2>6"])
    assert (s.start_pos, s.end_pos) == (8, 14)


def test_looping_chain():
    cm = run("looping_chain", 1)
    ids = sorted(s.snarl_id_str for s in cm["ref"])
    assert ids == ["2_12", "3_6", "8_11"]
    top = get(cm, (2, 12))
    # the chain 3..11 collapses to * in the top-level deletion bubble
    assert sorted(top.path_strings) == [">2>12", ">2>3>0>11>12"]
    assert get(cm, (3, 6)).depth == 2
    assert get(cm, (8, 11)).depth == 2


def test_simple_bubble_decomposition():
    cm = run_ref("simple_bubble", "path0")
    assert len(cm["path0"]) == 1
    s = get({"ref": cm["path0"]}, (1, 5))
    assert sorted(s.path_strings) == [">1>2>5", ">1>3>5", ">1>4>5"]
    assert s.type_variants == ["1", "1", "1"]


def test_simple_nested_chain_decomposition():
    cm = run_ref("simple_nested_chain", "path0")
    ids = sorted(s.snarl_id_str for s in cm["path0"])
    assert ids == ["1_4", "4_8", "5_7", "8_10"]
    s = get({"ref": cm["path0"]}, (4, 8))
    assert sorted(s.path_strings) == [">4>5>0>7>8", ">4>8"]
    assert get({"ref": cm["path0"]}, (5, 7)).depth == 2


def test_loop_with_indel_decomposition():
    for name in ("loop_with_indel", "loop_with_indel_two_paths"):
        cm = run_ref(name, "path0")
        ids = sorted(s.snarl_id_str for s in cm["path0"])
        assert ids == ["1_6", "2_4"], name
        top = get({"ref": cm["path0"]}, (1, 6))
        # one loop unroll at cycle cap 1; types are min/max lengths
        assert sorted(top.path_strings) == [
            ">1>2>0>5>2>0>5>6", ">1>2>0>5>6"], name
        assert sorted(top.type_variants) == ["3/4", "6/8"], name


def test_snarl_less_graphs_error_like_reference():
    """linear/one_node/multicomponent_chain have no reference-path snarl
    paths; the reference throws 'Total number of paths = 0'
    (snarl_data_t.cpp:765) and so do we."""
    for name, ref in (("linear", "ref"), ("one_node", "path"),
                      ("multicomponent_chain", "ref")):
        with pytest.raises(RuntimeError, match="Total number of paths = 0"):
            run_ref(name, ref)
