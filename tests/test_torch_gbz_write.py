"""The GBZ writer in the port (``stoat_tpu_torch/graph/gbz_write.py``):
the same bytes as stoat_tpu's ``save_gbz``, read back by the port's GBZ
reader to the same graph.

tests/test_gbz.py round-trips the reference's .hg zoo (test_roundtrip_zoo,
:88) and a 5,000-bubble graph (test_roundtrip_scales, :134).  The zoo is
not part of this repository, so the topologies that stress the BWT are
built here from their description, with each package's own GfaGraph:
loops, inversions, nested bubbles, generic and PanSN paths, node ids that
start past 1 and leave gaps, and the 5,000-bubble graph.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from stoat_tpu.graph import gbz as jax_gbz
from stoat_tpu.graph import gbz_write as jax_write
from stoat_tpu.graph import gfa as jax_gfa
from stoat_tpu_torch.graph import gbz as torch_gbz
from stoat_tpu_torch.graph import gbz_write as torch_write
from stoat_tpu_torch.graph import gfa as torch_gfa


def _simple_snp(m):
    g = m.GfaGraph()
    for nid, seq in {1: "TTTT", 2: "AAAA", 3: "C", 4: "G", 5: "AAAA",
                     6: "TTTT"}.items():
        g.add_node(nid, seq)
    for a, b in ((1, 2), (2, 3), (2, 4), (3, 5), (4, 5), (5, 6)):
        g.add_edge((a, False), (b, False))
    g.add_path(m.GfaPath("ref", [(n, False) for n in (1, 2, 3, 5, 6)],
                         "ref", 0, True))
    g.add_path(m.GfaPath("alt", [(n, False) for n in (1, 2, 4, 5, 6)],
                         "alt", 0, False))
    return g


def _loop(m):
    """A cycle walked twice, and a path that enters it once."""
    g = m.GfaGraph()
    for nid in range(1, 6):
        g.add_node(nid, "ACGT"[: nid % 4 + 1])
    steps = [1, 2, 3, 2, 3, 4, 5]
    for a, b in zip(steps, steps[1:]):
        g.add_edge((a, False), (b, False))
    g.add_path(m.GfaPath("ref", [(n, False) for n in steps], "ref", 0,
                         True))
    g.add_path(m.GfaPath("s1#1#chr1", [(n, False) for n in (1, 2, 3, 4, 5)],
                         "s1", 1, False))
    return g


def _inversion(m):
    """A node walked in reverse by one haplotype, a self-loop by another."""
    g = m.GfaGraph()
    for nid, seq in ((1, "AC"), (2, "GGT"), (3, "T"), (4, "CA")):
        g.add_node(nid, seq)
    g.add_edge((1, False), (2, False))
    g.add_edge((1, False), (2, True))
    g.add_edge((2, False), (3, False))
    g.add_edge((2, True), (3, False))
    g.add_edge((3, False), (3, False))
    g.add_edge((3, False), (4, False))
    g.add_path(m.GfaPath("ref", [(1, False), (2, False), (3, False),
                                 (4, False)], "ref", 0, True))
    g.add_path(m.GfaPath("a#1#chr1", [(1, False), (2, True), (3, False),
                                      (4, False)], "a", 1, False))
    g.add_path(m.GfaPath("a#2#chr1", [(1, False), (2, False), (3, False),
                                      (3, False), (4, False)], "a", 2,
                         False))
    g.add_path(m.GfaPath("b#1#chr1", [(4, True), (3, True), (2, False),
                                      (1, True)], "b", 1, False))
    return g


def _nested(m, seed=3, n_bubbles=40, n_haps=6):
    """A chain of bubbles, every third one with a bubble nested in a
    branch, node ids from 7 on with a gap of unused ids in every
    bubble; haplotypes from a seed."""
    rng = np.random.default_rng(seed)
    g = m.GfaGraph()
    nid = 7
    anchor = nid
    g.add_node(anchor, "ACGT")
    hap_steps = [[(anchor, False)] for _ in range(n_haps)]
    ref = [(anchor, False)]
    for b in range(n_bubbles):
        a1, a2, end = nid + 1, nid + 2, nid + 5    # nid + 3, + 4 unused
        branches = [[a1], [a2]]
        nested = b % 3 == 0
        if nested:
            n1, n2, n3 = nid + 6, nid + 7, nid + 8
            for x in (n1, n2, n3):
                g.add_node(x, "GA")
            branches = [[a1], [a2, n1, n3], [a2, n2, n3]]
            nid += 3
        for x, seq in ((a1, "C"), (a2, "TT"), (end, "ACG")):
            g.add_node(x, seq)
        for br in branches:
            chain = [anchor, *br, end]
            for u, v in zip(chain, chain[1:]):
                g.add_edge((u, False), (v, False))
        ref += [(x, False) for x in [*branches[0], end]]
        for h in range(n_haps):
            br = branches[int(rng.integers(len(branches)))]
            hap_steps[h] += [(x, False) for x in [*br, end]]
        anchor = end
        nid = end
    g.add_path(m.GfaPath("ref", ref, "ref", 0, True))
    for h in range(n_haps):
        g.add_path(m.GfaPath(f"s{h // 2}#{h % 2 + 1}#chr2", hap_steps[h],
                             f"s{h // 2}", h % 2 + 1, False))
    return g


def _scales(m):
    """tests/test_gbz.py:134: 5,000 bubbles, a reference and 8 haplotypes
    (about 135,000 steps)."""
    rng = np.random.default_rng(0)
    g = m.GfaGraph()
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
    g.add_path(m.GfaPath("ref", ref, "ref", 0, True))
    for h in range(8):
        g.add_path(m.GfaPath(f"s{h//2}#{h%2}#chr1", hap_steps[h],
                             f"s{h//2}", h % 2, False))
    return g


BUILDERS = {"simple_snp": _simple_snp, "loop": _loop,
            "inversion": _inversion, "nested": _nested, "scales": _scales}


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


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_save_gbz_same_bytes_and_roundtrip(name, tmp_path):
    """The port's save_gbz writes stoat_tpu's bytes; the port's reader
    gives back the sequences, the paths and the path-induced edges, as
    stoat_tpu's reader does on the same file."""
    ours, theirs = str(tmp_path / "torch.gbz"), str(tmp_path / "jax.gbz")
    g = BUILDERS[name](torch_gfa)
    torch_write.save_gbz(g, ours)
    jax_write.save_gbz(BUILDERS[name](jax_gfa), theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        data = a.read()
        assert data == b.read()
    assert data.startswith(b"GBZ ")
    g2 = torch_gbz.load_gbz(ours)
    j2 = jax_gbz.load_gbz(ours)
    assert {n: s for n, s in g2.sequences.items() if s} == g.sequences
    assert g2.sequences == j2.sequences
    assert [(p.name, p.steps) for p in g2.paths] == \
        [(p.name, p.steps) for p in g.paths] == \
        [(p.name, p.steps) for p in j2.paths]
    assert [p.is_reference for p in g2.paths] == \
        [p.is_reference for p in j2.paths]
    assert canon_edges(g2) == path_induced_edges(g) == canon_edges(j2)


def test_save_gbz_needs_a_path(tmp_path):
    g = torch_gfa.GfaGraph()
    g.add_node(1, "A")
    with pytest.raises(ValueError, match="at least one embedded path"):
        torch_write.save_gbz(g, str(tmp_path / "x.gbz"))
