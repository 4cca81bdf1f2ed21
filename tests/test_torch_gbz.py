"""GBZ (.gbz) reader/writer: real-fixture parity + zoo-wide round-trip.

The reference loads GBZ through vg::io::VPKG + gbwtgraph::GBZ
(src/io/register_loader_saver_gbz.cpp:18-39, src/gbzgraph.hpp:22-43); we
read the simple-sds serialization natively.  Only one real .gbz fixture
exists (tests/graph_test/simple_snp.gbz, written by vg), so:

1. pin that file against its .gfa/.hg twins (nodes, edges, paths,
   metadata, naming conventions), and
2. round-trip every .hg zoo topology through our writer+reader (loops,
   inversions, nested chains — the BWT construction/extraction stress).

The JAX suite's tests (tests/test_gbz.py) on the port's readers and GBZ
writer; ``stoat_tpu``'s reader loads the same graph from each file, its
writer writes the same bytes, and its ``graph`` run the same table.  They
skip, as the JAX suite's do, where the reference's fixtures are not
mounted.
"""

import filecmp
import os

import pytest

torch = pytest.importorskip("torch")

from stoat_tpu.graph.gbz import load_gbz as jax_load_gbz
from stoat_tpu.graph.gbz_write import save_gbz as jax_save_gbz
from stoat_tpu.graph.hashgraph import load_hg as jax_load_hg
from stoat_tpu_torch.graph.gbz import GbzIndex, load_gbz
from stoat_tpu_torch.graph.gbz_write import save_gbz
from stoat_tpu_torch.graph.gfa import load_gfa
from stoat_tpu_torch.graph.hashgraph import load_hg

from test_gbz import FIXTURES, GBZ, ZOO

pytestmark = pytest.mark.skipif(not os.path.isdir(ZOO),
                                reason="reference fixtures unavailable")


def canon_edges(g):
    edges = set()
    for n in g.node_ids():
        for rev in (False, True):
            for t in g.successors((n, rev)):
                a, b = (n, rev), t
                edges.add(min((a, b),
                              ((b[0], not b[1]), (a[0], not a[1]))))
    return edges


def path_induced_edges(g):
    edges = set()
    for p in g.paths:
        for a, b in zip(p.steps, p.steps[1:]):
            edges.add(min((a, b), ((b[0], not b[1]), (a[0], not a[1]))))
    return edges


def test_real_gbz_matches_gfa_twin():
    g = load_gbz(GBZ)
    t = load_gfa(os.path.join(ZOO, "simple_snp.gfa"))
    assert g.sequences == t.sequences
    assert canon_edges(g) == canon_edges(t)
    assert [(p.name, p.steps) for p in g.paths] == \
        [(p.name, p.steps) for p in t.paths]
    # generic paths count as reference when no reference set is given
    assert all(p.is_reference for p in g.paths)


def test_real_gbz_matches_hg_twin():
    g = load_gbz(GBZ, {"ref"})
    h = load_hg(os.path.join(ZOO, "simple_snp.hg"), {"ref"})
    assert g.sequences == h.sequences
    assert canon_edges(g) == canon_edges(h)
    assert sorted((p.name, tuple(p.steps)) for p in g.paths) == \
        sorted((p.name, tuple(p.steps)) for p in h.paths)
    refs = {p.name: p.is_reference for p in g.paths}
    assert refs == {"ref": True, "alt": False}


def test_real_gbz_metadata():
    idx = GbzIndex(GBZ)
    assert idx.tags["source"] == "jltsiren/gbwtgraph"
    assert idx.gbwt_tags["source"] == "jltsiren/gbwt"
    assert idx.sample_names == ["_gbwt_ref"]
    assert idx.contig_names == ["ref", "alt"]
    assert idx.n_paths == 2
    assert idx.node_sequences == {1: "TTTT", 2: "AAAA", 3: "C", 4: "G",
                                  5: "AAAA", 6: "TTTT"}


@pytest.mark.parametrize("name", FIXTURES)
def test_roundtrip_zoo(name, tmp_path):
    g = load_hg(os.path.join(ZOO, f"{name}.hg"))
    if not g.paths:
        pytest.skip("GBZ requires embedded paths")
    out = str(tmp_path / f"{name}.gbz")
    save_gbz(g, out)
    g2 = load_gbz(out)
    assert g2.sequences == g.sequences
    assert [(p.name, p.steps) for p in g2.paths] == \
        [(p.name, p.steps) for p in g.paths]
    twin = str(tmp_path / f"{name}_stoat_tpu.gbz")
    jax_save_gbz(jax_load_hg(os.path.join(ZOO, f"{name}.hg")), twin)
    assert filecmp.cmp(out, twin, shallow=False)
    assert canon_edges(jax_load_gbz(out)) == canon_edges(g2)
    # GBZ stores the haplotype-induced subgraph (the GBWTGraph
    # definition) — same lossiness as vg's own conversion
    assert canon_edges(g2) == path_induced_edges(g)


def test_gbz_decomposition_parity(tmp_path):
    """Decomposition from .gbz == decomposition from .hg (simple_snp's
    paths cover every edge, so the induced subgraph is the whole graph)."""
    from stoat_tpu_torch.graph.decompose import decompose_to_snarl_file

    out_hg = str(tmp_path / "hg")
    out_gbz = str(tmp_path / "gbz")
    decompose_to_snarl_file(os.path.join(ZOO, "simple_snp.hg"), None,
                            out_hg, {"ref"})
    decompose_to_snarl_file(GBZ, None, out_gbz, {"ref"})
    a = open(os.path.join(out_hg, "snarl_analyse.tsv")).read()
    b = open(os.path.join(out_gbz, "snarl_analyse.tsv")).read()
    assert a == b
    assert "2_5" in a


def test_graph_association_from_gbz(tmp_path):
    """`stoat graph` runs end-to-end from a .gbz input."""
    from stoat_tpu_torch.graph.association import run_graph_association

    pheno = tmp_path / "pheno.tsv"
    pheno.write_text("FID\tIID\tPHENO\nref\tref\t1\nalt\talt\t2\n")
    out = tmp_path / "out"
    out.mkdir()
    rc = run_graph_association(GBZ, "", str(pheno), "chi2", "tsv",
                               0, "ref", str(out), torch.device("cpu"))
    assert rc == 0
    rows = (out / "binary_table_graph.tsv").read_text()
    assert rows.count("\n") >= 1
    from stoat_tpu.graph.association import \
        run_graph_association as jax_run
    (tmp_path / "jax").mkdir()
    assert jax_run(GBZ, "", str(pheno), "chi2", "tsv", 0, "ref",
                   str(tmp_path / "jax")) == 0
    assert (tmp_path / "jax" / "binary_table_graph.tsv").read_text() == rows


def test_roundtrip_scales(tmp_path):
    """Non-quadratic construction/extraction: a 5k-bubble graph with 9
    embedded paths (~135k steps) round-trips in seconds."""
    import numpy as np
    from stoat_tpu_torch.graph.gfa import GfaGraph, GfaPath

    rng = np.random.default_rng(0)
    g = GfaGraph()
    nid = 1
    ref = []
    hap_steps = [[] for _ in range(8)]
    for b in range(5000):
        for off, seq in ((0, "ACGT"), (1, "A"), (2, "C"), (3, "GGTT")):
            g.add_node(nid + off, seq)
        g.add_edge((nid, False), (nid + 1, False))
        g.add_edge((nid, False), (nid + 2, False))
        g.add_edge((nid + 1, False), (nid + 3, False))
        g.add_edge((nid + 2, False), (nid + 3, False))
        if b:
            g.add_edge((nid - 1, False), (nid, False))
        ref += [(nid, False), (nid + 1, False), (nid + 3, False)]
        for h in range(8):
            mid = nid + 1 if rng.random() < 0.5 else nid + 2
            hap_steps[h] += [(nid, False), (mid, False), (nid + 3, False)]
        nid += 4
    g.add_path(GfaPath("ref", ref, "ref", 0, True))
    for h in range(8):
        g.add_path(GfaPath(f"s{h//2}#{h%2}#chr1", hap_steps[h],
                           f"s{h//2}", h % 2, False))

    out = str(tmp_path / "big.gbz")
    save_gbz(g, out)
    g2 = load_gbz(out)
    assert g2.sequences == g.sequences
    assert [(p.name, p.steps) for p in g2.paths] == \
        [(p.name, p.steps) for p in g.paths]
