"""GAF emission from binary GWAS results.

The port's copy of stoat_tpu/gaf.py (``vcf -g``).  Equivalent of
gaf_creation (the reference's src/gaf_creator.cpp:108-194):
re-reads the binary results TSV and writes, per snarl path, one line into
each of two files (``_0``/``_1`` suffix per phenotype group) with a 0-60
"proportion" score skewed by -log(p) (calcul_proportion_signi, :5-43).

Deliberate divergences from the reference (whose implementation has
column-offset bugs against its own writer):
  - columns follow the actual binary TSV layout (writer.cpp:8): SNARL at
    index 3, P_FISHER 5, P_CHI2 6, GROUP_PATHS 7 — the reference indexes a
    14-column layout that its own pipeline never produces
    (gaf_creator.cpp:134-140), so its GAF loop drops every row;
  - the ``*`` placeholder is detected as the node id 0 element, not via
    ``path.find("0")`` (which also matches node ids like 10;
    gaf_creator.cpp:167);
  - when GROUP_PATHS has fewer pairs than the snarl has paths (empty
    columns were dropped before writing), the pairing falls back to a
    positional prefix — the SAME blind-positional semantics as the
    reference's own zip (gaf_creator.cpp:167-183); the TSV does not
    record which paths were kept, so exact membership cannot be
    reconstructed here.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

from stoat_tpu_torch.formatting import string_to_pvalue
from stoat_tpu_torch.io.snarl_file import SnarlData, parse_path_string

__all__ = ["calcul_proportion_signi", "gaf_creation"]


def calcul_proportion_signi(n_group0: int, n_group1: int,
                            p_value: float) -> tuple:
    """0-60 proportion pair skewed by -log(p) (gaf_creator.cpp:5-43)."""
    total = n_group0 + n_group1
    if total == 0:
        return 0.0, 0.0
    prop0 = (n_group1 / total) * 60.0
    prop1 = 60.0 - prop0
    adjustment = -math.log(max(p_value, 1e-20))
    if prop0 > prop1:
        adj0 = prop0 + adjustment
        adj1 = prop1 - adjustment
    else:
        adj0 = prop0 - adjustment
        adj1 = prop1 + adjustment
    adj0 = min(max(adj0, 0.0), 60.0)
    adj1 = min(max(adj1, 0.0), 60.0)
    total_adj = adj0 + adj1
    if total_adj != 60.0 and total_adj != 0.0:
        scale = 60.0 / total_adj
        adj0 *= scale
        adj1 *= scale
    return adj0, adj1


def _add_suffix(filename: str, suffix: str) -> str:
    dot = filename.rfind(".")
    if dot == -1:
        return filename + suffix
    return filename[:dot] + suffix + filename[dot:]


def _split_on_star(path_str: str):
    """Split an oriented walk at node-0 (*) elements.

    Yields (rendered sub-path string, node tuples) pairs — the tuples
    feed the length sum directly, avoiding a re-parse of the string the
    emitter just built."""
    nodes = parse_path_string(path_str)
    parts: List[List] = [[]]
    for node in nodes:
        if node[0] == 0:
            parts.append([])
        else:
            parts[-1].append(node)
    return [("".join(("<" if rev else ">") + str(nid)
                     for nid, rev in part), part)
            for part in parts if part]


def _path_length(node_lengths: Dict[int, int], path_str: str) -> int:
    return sum(node_lengths.get(nid, 0)
               for nid, _rev in parse_path_string(path_str))


def gaf_creation(input_tsv: str,
                 snarl_chr: Dict[str, List[SnarlData]],
                 node_lengths: Dict[int, int],
                 output_file: str) -> None:
    """Write the two per-group GAF-like files from a binary results TSV."""
    out0 = _add_suffix(output_file, "_0")
    out1 = _add_suffix(output_file, "_1")

    # index snarls by (chr, id) for path lookup
    index: Dict[tuple, SnarlData] = {}
    for chrom, snarls in snarl_chr.items():
        for s in snarls:
            index[(chrom, s.snarl_id_str)] = s

    with open(input_tsv) as inf, open(out0, "w") as f0, \
            open(out1, "w") as f1:
        inf.readline()  # header
        for line in inf:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 9:
                continue
            chrom, snarl_id = cols[0], cols[3]
            pfisher = string_to_pvalue(cols[5])
            pchi = string_to_pvalue(cols[6])
            group_paths = cols[7]
            snarl = index.get((chrom, snarl_id))
            if snarl is None:
                continue
            pairs = []
            for token in group_paths.split(","):
                if ":" not in token:
                    continue
                a, b = token.split(":", 1)
                pairs.append((int(a), int(b)))
            # GROUP_PATHS covers kept (non-empty) paths in original order;
            # pair them with the snarl paths by position among kept ones.
            paths = snarl.path_strings
            if len(pairs) != len(paths):
                # kept subset unknown here; fall back to positional prefix
                paths = paths[: len(pairs)]
            for (g0, g1), path_str in zip(pairs, paths):
                name0 = (f"{snarl_id}_G0_{g0}_F{pfisher:.6f}_C{pchi:.6f}")
                name1 = (f"{snarl_id}_G1_{g1}_F{pfisher:.6f}_C{pchi:.6f}")
                prop0, prop1 = calcul_proportion_signi(g0, g1, pfisher)
                for sub, sub_nodes in _split_on_star(path_str):
                    length = sum(node_lengths.get(nid, 0)
                                 for nid, _rev in sub_nodes)
                    f0.write(f"{name0}\t{sub}\t{length}\t{prop0:g}\n")
                    f1.write(f"{name1}\t{sub}\t{length}\t{prop1:g}\n")
