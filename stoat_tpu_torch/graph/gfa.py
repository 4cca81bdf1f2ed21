"""GFA v1 parsing into a bidirected sequence graph with embedded paths.

Supports S (segment), L (link), P (path), and W (walk) lines.  Handles are
(node_id, is_reverse) tuples; an L line ``a + b -`` records that traversal
``(a,False)`` can be followed by ``(b,True)`` — and symmetrically that
``(b,False)`` can be followed by ``(a,True)``.

Path senses mirror the reference's handling (utils.cpp:134-157): P-line
names are generic paths (sample name = full path name unless it matches
``sample#hap#contig`` PanSN naming); W lines carry sample/haplotype
explicitly.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

__all__ = ["GfaGraph", "GfaPath", "load_gfa", "Handle"]

Handle = Tuple[int, bool]  # (node_id, is_reverse)


def flip(h: Handle) -> Handle:
    return (h[0], not h[1])


@dataclass
class GfaPath:
    name: str
    steps: List[Handle]
    sample: str
    haplotype: int
    is_reference: bool = False


class GfaGraph:
    """Bidirected graph: node sequences, oriented adjacency, paths."""

    def __init__(self):
        self.sequences: Dict[int, str] = {}
        # successors of an oriented handle
        self._succ: Dict[Handle, List[Handle]] = {}
        self.paths: List[GfaPath] = []

    # --- construction ----------------------------------------------------

    def add_node(self, node_id: int, seq: str) -> None:
        self.sequences[node_id] = seq

    def add_edge(self, a: Handle, b: Handle) -> None:
        """Record a link a->b (and the implied reverse-complement b'->a')."""
        self._add_succ(a, b)
        self._add_succ(flip(b), flip(a))

    def _add_succ(self, u: Handle, v: Handle) -> None:
        lst = self._succ.setdefault(u, [])
        if v not in lst:
            lst.append(v)

    def add_path(self, path: GfaPath) -> None:
        self.paths.append(path)

    # --- queries ---------------------------------------------------------

    def node_ids(self) -> List[int]:
        return sorted(self.sequences)

    def node_length(self, node_id: int) -> int:
        return len(self.sequences[node_id])

    def node_seq(self, handle: Handle) -> str:
        seq = self.sequences[handle[0]]
        if handle[1]:
            return reverse_complement(seq)
        return seq

    def successors(self, h: Handle) -> List[Handle]:
        return self._succ.get(h, [])

    def predecessors(self, h: Handle) -> List[Handle]:
        return [flip(u) for u in self._succ.get(flip(h), [])]

    def degree(self, h: Handle) -> int:
        return len(self.successors(h))


    def write_gfa(self, path: str) -> None:
        """Serialize to GFA v1 (S/L/P lines)."""
        with open(path, "w") as fh:
            fh.write("H\tVN:Z:1.0\n")
            for nid in self.node_ids():
                fh.write(f"S\t{nid}\t{self.sequences[nid]}\n")
            written = set()
            for u, vs in self._succ.items():
                for v in vs:
                    key = (u, v)
                    mirror = (flip(v), flip(u))
                    if key in written or mirror in written:
                        continue
                    written.add(key)
                    fh.write(f"L\t{u[0]}\t{'-' if u[1] else '+'}\t"
                             f"{v[0]}\t{'-' if v[1] else '+'}\t0M\n")
            for p in self.paths:
                steps = ",".join(
                    f"{nid}{'-' if rev else '+'}" for nid, rev in p.steps)
                fh.write(f"P\t{p.name}\t{steps}\t*\n")


_COMPLEMENT = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMPLEMENT)[::-1]


_PANSN = re.compile(r"^([^#]+)#(\d+)#(.+)$")


def _path_identity(name: str) -> Tuple[str, int]:
    """PanSN ``sample#haplotype#contig`` if present, else (name, 0)."""
    m = _PANSN.match(name)
    if m:
        return m.group(1), int(m.group(2))
    return name, 0


def _parse_path_steps(steps_str: str) -> List[Handle]:
    steps = []
    for token in steps_str.split(","):
        token = token.strip()
        if not token:
            continue
        orient = token[-1]
        steps.append((int(token[:-1]), orient == "-"))
    return steps


_WALK_STEP = re.compile(r"([><])(\d+)")


def _parse_walk_steps(walk_str: str) -> List[Handle]:
    return [(int(nid), ch == "<") for ch, nid in _WALK_STEP.findall(walk_str)]


def load_gfa(path: str,
             reference_names: Optional[Set[str]] = None) -> GfaGraph:
    """Parse a GFA v1 file.  ``reference_names`` marks reference paths (the
    ``-r/--chr`` contract, arg_parser.cpp:8-19); when empty, P-line paths
    count as reference (generic sense), matching how the test fixtures flag
    ``ref``."""
    g = GfaGraph()
    reference_names = reference_names or set()
    # transparent gzip: sniff_graph_format routes .gfa.gz here, but a
    # text-mode open on gzip bytes died with UnicodeDecodeError
    with open(path, "rb") as probe:
        magic = probe.read(2)
    opener = (lambda p_: __import__("gzip").open(p_, "rt")) \
        if magic == b"\x1f\x8b" else (lambda p_: open(p_))
    with opener(path) as fh:
        for line in fh:
            if not line or line[0] in "#\n":
                continue
            fields = line.rstrip("\n").split("\t")
            tag = fields[0]
            if tag == "S":
                g.add_node(int(fields[1]), fields[2])
            elif tag == "L":
                a = (int(fields[1]), fields[2] == "-")
                b = (int(fields[3]), fields[4] == "-")
                g.add_edge(a, b)
            elif tag == "P":
                name = fields[1]
                sample, hap = _path_identity(name)
                is_ref = (name in reference_names or sample in reference_names
                          or not reference_names)
                g.add_path(GfaPath(name=name,
                                   steps=_parse_path_steps(fields[2]),
                                   sample=sample, haplotype=hap,
                                   is_reference=is_ref))
            elif tag == "W":
                sample = fields[1]
                hap = int(fields[2]) if fields[2] != "*" else 0
                contig = fields[3]
                name = f"{sample}#{hap}#{contig}"
                is_ref = sample in reference_names
                g.add_path(GfaPath(name=name,
                                   steps=_parse_walk_steps(fields[6]),
                                   sample=sample, haplotype=hap,
                                   is_reference=is_ref))
    return g
