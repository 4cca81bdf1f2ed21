"""PackedGraph (.pg) reader: exact parity with the HashGraph twins.

Every fixture in the reference zoo ships as both .pg and .hg; the two
must load to identical graphs (nodes+sequences, canonical edge sets,
named oriented paths).  Also pins one decomposition run directly from a
.pg to guard the dispatch path (reference loads .pg via libbdsg,
src/io/register_loader_saver_packed_graph.cpp).

The JAX suite's tests (tests/test_packedgraph.py) on the port's .pg and
.hg readers; ``stoat_tpu``'s readers load the same graphs and its
decomposition writes the same files.  They skip, as the JAX suite's do,
where the reference's fixtures are not mounted."""

import filecmp
import os

import pytest

pytest.importorskip("torch")

from stoat_tpu.graph.packedgraph import load_pg as jax_load_pg
from stoat_tpu_torch.graph.hashgraph import load_hg
from stoat_tpu_torch.graph.packedgraph import load_pg

from test_packedgraph import FIXTURES, ZOO
from test_torch_graph_decompose import snarl_record

pytestmark = pytest.mark.skipif(not os.path.isdir(ZOO),
                                reason="reference fixtures unavailable")


def canon(g):
    nodes = {n: g.sequences[n] for n in g.node_ids()}
    edges = set()
    for n in g.node_ids():
        for rev in (False, True):
            for t in g.successors((n, rev)):
                a, b = (n, rev), t
                edges.add(min((a, b), ((b[0], not b[1]), (a[0], not a[1]))))
    paths = sorted((p.name, tuple(p.steps)) for p in g.paths)
    return nodes, edges, paths


@pytest.mark.parametrize("name", FIXTURES)
def test_pg_matches_hg(name):
    a = canon(load_pg(os.path.join(ZOO, f"{name}.pg"), {"ref"}))
    b = canon(load_hg(os.path.join(ZOO, f"{name}.hg"), {"ref"}))
    assert a[0] == b[0], "node/sequence mismatch"
    assert a[1] == b[1], "edge set mismatch"
    assert a[2] == b[2], "path mismatch"
    assert canon(jax_load_pg(os.path.join(ZOO, f"{name}.pg"), {"ref"})) == a


def test_magic_rejects_hg():
    with pytest.raises(RuntimeError, match="not a PackedGraph"):
        load_pg(os.path.join(ZOO, "linear.hg"))


def test_decompose_from_pg():
    from stoat_tpu_torch.graph.decompose import decompose_graph
    g = load_pg(os.path.join(ZOO, "simple_snp.pg"), {"ref"})
    cm = decompose_graph(g, {"ref"}, cycle_threshold=0)
    assert len(cm["ref"]) == 1
    from stoat_tpu.graph.decompose import decompose_graph as jax_decompose
    jcm = jax_decompose(jax_load_pg(os.path.join(ZOO, "simple_snp.pg"),
                                    {"ref"}), {"ref"}, cycle_threshold=0)
    assert ([snarl_record(x) for x in cm["ref"]]
            == [snarl_record(x) for x in jcm["ref"]])
    s = cm["ref"][0]
    assert frozenset(s.snarl_ids) == frozenset((2, 5))


def test_cli_decompose_from_pg(tmp_path):
    from stoat_tpu_torch.graph.decompose import decompose_to_snarl_file
    out = decompose_to_snarl_file(os.path.join(ZOO, "simple_snp.pg"),
                                  None, str(tmp_path), {"ref"},
                                  cycle_threshold=0)
    assert len(out["ref"]) == 1
    assert os.path.exists(tmp_path / "snarl_analyse.tsv")
    from stoat_tpu.graph.decompose import \
        decompose_to_snarl_file as jax_decompose_to_snarl_file
    jax_decompose_to_snarl_file(os.path.join(ZOO, "simple_snp.pg"), None,
                                str(tmp_path / "jax"), {"ref"},
                                cycle_threshold=0)
    for name in ("snarl_analyse.tsv", "snarl_not_analyse.tsv"):
        assert filecmp.cmp(tmp_path / name, tmp_path / "jax" / name,
                           shallow=False)
