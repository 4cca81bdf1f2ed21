"""Regressions for the round-5 decomposition review (each reproduced
as a bug before the fix):

  1. multi-chromosome TSVs must be contiguous per chromosome (the
     position-only sort interleaved blocks, and parse_snarl_path's
     reference-parity quirk keeps only the LAST block per chromosome —
     snarls silently vanished on cache re-read);
  2. snarls on chromosomes after the first must still orient along
     THEIR reference path (ref_order stopped at the first path);
  3. a bubble wider than the 64-candidate exit budget must still be
     FOUND (and recorded as rejected by the children threshold) instead
     of vanishing from both output files;
  4. gzipped GFA input must load (text-mode open crashed);
  5. a snarl with one off-reference bound must print an ordered
     interval (START_POS <= END_POS).

The JAX suite's tests (tests/test_decompose_regressions.py) on the port's
``graph/``; every decomposition is also run through ``stoat_tpu``'s, and
both write the same files.
"""

import filecmp
import gzip
import os

import pytest

pytest.importorskip("torch")

from stoat_tpu.graph.decompose import \
    decompose_to_snarl_file as jax_decompose_to_snarl_file
from stoat_tpu_torch.graph.gfa import load_gfa
from stoat_tpu_torch.graph.snarls import find_snarls
from stoat_tpu_torch.io.snarl_file import parse_snarl_path

from test_torch_graph_decompose import decompose, snarl_forest


def decompose_to_snarl_file(gfa, dist, out, refs):
    """The port's decompose_to_snarl_file into ``out``, after which
    stoat_tpu's writes the same two files into a twin directory."""
    from stoat_tpu_torch.graph.decompose import \
        decompose_to_snarl_file as port
    chr_map = port(gfa, dist, out, refs)
    twin = f"{out}_stoat_tpu"
    jax_decompose_to_snarl_file(gfa, dist, twin, refs)
    for name in ("snarl_analyse.tsv", "snarl_not_analyse.tsv"):
        assert filecmp.cmp(os.path.join(out, name),
                           os.path.join(twin, name), shallow=False), name
    return chr_map


def _two_chrom_gfa(tmp_path, reverse_second=False):
    gfa = tmp_path / "two.gfa"
    lines = ["H\tVN:Z:1.0"]
    # chr1: two bubbles 1-4 and 4-7 (nodes 1..7)
    for nid, seq in [(1, "A"), (2, "C"), (3, "G"), (4, "T"), (5, "A"),
                     (6, "C"), (7, "G")]:
        lines.append(f"S\t{nid}\t{seq}")
    for a, b in [(1, 2), (1, 3), (2, 4), (3, 4), (4, 5), (4, 6), (5, 7),
                 (6, 7)]:
        lines.append(f"L\t{a}\t+\t{b}\t+\t0M")
    # chr2: one bubble 11-14 (nodes 11..14)
    for nid, seq in [(11, "A"), (12, "C"), (13, "G"), (14, "T")]:
        lines.append(f"S\t{nid}\t{seq}")
    for a, b in [(11, 12), (11, 13), (12, 14), (13, 14)]:
        lines.append(f"L\t{a}\t+\t{b}\t+\t0M")
    lines.append("P\tchr1\t1+,2+,4+,5+,7+\t*")
    if reverse_second:
        lines.append("P\tchr2\t14-,12-,11-\t*")
    else:
        lines.append("P\tchr2\t11+,12+,14+\t*")
    gfa.write_text("\n".join(lines) + "\n")
    return str(gfa)


def test_multichrom_tsv_blocks_are_contiguous(tmp_path):
    gfa = _two_chrom_gfa(tmp_path)
    out = tmp_path / "dec"
    chr_map = decompose_to_snarl_file(gfa, None, str(out),
                                      {"chr1", "chr2"})
    assert len(chr_map.get("chr1", [])) == 2
    assert len(chr_map.get("chr2", [])) == 1
    # the cached TSV must survive the parser's last-block-per-chromosome
    # reference-parity quirk: every chromosome in ONE contiguous block
    reread = parse_snarl_path(str(out / "snarl_analyse.tsv"))
    assert len(reread.get("chr1", [])) == 2, reread
    assert len(reread.get("chr2", [])) == 1
    chroms = []
    with open(out / "snarl_analyse.tsv") as fh:
        fh.readline()
        for line in fh:
            c = line.split("\t")[0]
            if not chroms or chroms[-1] != c:
                chroms.append(c)
    assert len(chroms) == len(set(chroms)), f"interleaved blocks: {chroms}"


def test_second_chromosome_orients_along_its_reference(tmp_path):
    gfa = _two_chrom_gfa(tmp_path, reverse_second=True)
    forest = snarl_forest(gfa, {"chr1", "chr2"})
    ids = {(s.start_node, s.end_node) for s in forest.snarls}
    # chr2's reference path runs 14 -> 11, so its bubble must orient
    # 14_11 (the first-path-only ref_order left it arbitrary/reversed)
    assert (14, 11) in ids, ids


def test_wide_bubble_is_found_and_rejected(tmp_path):
    n_mid = 70          # > the former 64-candidate exit budget
    end = 2 + n_mid
    gfa = tmp_path / "wide.gfa"
    lines = ["H\tVN:Z:1.0", "S\t1\tAAAA"]
    for k in range(n_mid):
        lines.append(f"S\t{2+k}\tC")
        lines.append(f"L\t1\t+\t{2+k}\t+\t0M")
        lines.append(f"L\t{2+k}\t+\t{end}\t+\t0M")
    lines.append(f"S\t{end}\tTTTT")
    # a second, normal bubble keeps the run analyzable (a run whose
    # EVERY snarl is rejected raises by design)
    for nid, seq in [(end + 1, "C"), (end + 2, "G"), (end + 3, "TT")]:
        lines.append(f"S\t{nid}\t{seq}")
    for a, b in [(end, end + 1), (end, end + 2), (end + 1, end + 3),
                 (end + 2, end + 3)]:
        lines.append(f"L\t{a}\t+\t{b}\t+\t0M")
    lines.append(f"P\tref\t1+,2+,{end}+,{end+1}+,{end+3}+\t*")
    gfa.write_text("\n".join(lines) + "\n")
    out = tmp_path / "wdec"
    chr_map = decompose_to_snarl_file(str(gfa), None, str(out),
                                      {"ref"})
    rejects = (out / "snarl_not_analyse.tsv").read_text()
    total = sum(len(v) for v in chr_map.values())
    # the wide snarl must be FOUND: rejected by the children threshold
    # (it vanished entirely before the adaptive exit budget)
    assert f"1_{end}" in rejects or f"{end}_1" in rejects, rejects
    assert total >= 1


def test_gzipped_gfa_loads(tmp_path):
    gfa = _two_chrom_gfa(tmp_path)
    gz = tmp_path / "two.gfa.gz"
    gz.write_bytes(gzip.compress(open(gfa, "rb").read()))
    g = load_gfa(str(gz), {"chr1", "chr2"})
    assert len(g.paths) == 2
    forest = find_snarls(g)
    assert len(forest.snarls) == 3
    assert snarl_forest(str(gz), {"chr1", "chr2"}).snarls == forest.snarls


def test_single_onref_bound_interval_is_ordered(tmp_path):
    # bubble 1-4 whose END (node 4) is off the reference path: the ref
    # path simply ends at the snarl's start; node 1 is long so
    # pos+len > pos+1 (the raw single-bound pair is inverted)
    gfa = tmp_path / "offref.gfa"
    lines = ["H\tVN:Z:1.0",
             "S\t10\tAAAA", "S\t1\tAAAAA", "S\t2\tC", "S\t3\tG",
             "S\t4\tT",
             "L\t10\t+\t1\t+\t0M",
             "L\t1\t+\t2\t+\t0M", "L\t1\t+\t3\t+\t0M",
             "L\t2\t+\t4\t+\t0M", "L\t3\t+\t4\t+\t0M",
             "P\tref\t10+,1+\t*"]
    gfa.write_text("\n".join(lines) + "\n")
    chr_map = decompose(str(gfa))
    for snarls in chr_map.values():
        for s in snarls:
            assert s.start_pos <= s.end_pos, (s.snarl_ids, s.start_pos,
                                              s.end_pos)
