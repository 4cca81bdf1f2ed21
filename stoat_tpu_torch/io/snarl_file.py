"""Snarl decomposition file parsing (the cacheable preprocessing artifact).

Format contract (snarl_data_t.cpp:114-116 writer, :8-112 reader):

    CHR  START_POS  END_POS  SNARL_HANDLEGRAPH  SNARL  PATHS  TYPE  REF  DEPTH

- SNARL is ``startNode_endNode``
- PATHS is a comma-separated list of oriented node walks ``>123<456``;
  node id 0 renders the ``*`` placeholder for collapsed nested chains
- TYPE is a comma-separated per-path variant-type string
- The header must match exactly or parsing aborts (snarl_data_t.cpp:27-46)

Path strings are parsed into (node_id, is_reverse) tuples and then into
consecutive-node edges, matching ``decompose_path_str_to_edge``
(snarl_analyzer.cpp:277-303).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from stoat_tpu_torch.formatting import string_to_pair

__all__ = ["SnarlData", "parse_snarl_path", "parse_path_string",
           "path_to_edges", "EXPECTED_HEADER"]

EXPECTED_HEADER = [
    "CHR", "START_POS", "END_POS", "SNARL_HANDLEGRAPH",
    "SNARL", "PATHS", "TYPE", "REF", "DEPTH",
]

# (node_id, is_reverse)
NodeTraversal = Tuple[int, bool]
# ((id1, rev1), (id2, rev2))
Edge = Tuple[NodeTraversal, NodeTraversal]


def parse_path_string(path_str: str) -> List[NodeTraversal]:
    """Parse ``>123<456`` into [(123, False), (456, True)].

    Mirrors stringToVectorPath (snarl_data_t.cpp:211-240): a ``>``/``<``
    prefix sets the orientation of the following node id.
    """
    nodes: List[NodeTraversal] = []
    i = 0
    n = len(path_str)
    while i < n:
        ch = path_str[i]
        if ch == ">" or ch == "<":
            rev = ch == "<"
            i += 1
            start = i
            while i < n and path_str[i].isdigit():
                i += 1
            nodes.append((int(path_str[start:i] or "0"), rev))
        else:
            i += 1
    return nodes


def node_traversal_to_string(node: NodeTraversal) -> str:
    return ("<" if node[1] else ">") + str(node[0])


def path_to_string(nodes: List[NodeTraversal]) -> str:
    return "".join(node_traversal_to_string(n) for n in nodes)


def path_to_edges(nodes: List[NodeTraversal]) -> List[Edge]:
    """Consecutive node-traversal pairs (snarl_analyzer.cpp:263-274)."""
    return [(nodes[i], nodes[i + 1]) for i in range(len(nodes) - 1)]


class SnarlData:
    """One snarl's decomposition record (snarl_data_t.hpp:98-116).

    ``paths`` (the parsed node-traversal tuples) is derived lazily from
    ``path_strings`` — the vectorized packing path (tables.py) tokenizes
    the raw strings directly and never needs the tuples, so a large snarl
    file loads without paying the per-node Python parse."""

    __slots__ = ("net_handle", "snarl_ids", "_paths", "start_pos",
                 "end_pos", "type_variants", "depth", "path_strings",
                 "_row_prefix", "raw_paths")

    def __init__(self, net_handle: int, snarl_ids: Tuple[int, int],
                 paths=None, start_pos: int = 0, end_pos: int = 0,
                 type_variants=None, depth: int = 1, path_strings=None,
                 raw_paths=None):
        self.net_handle = net_handle
        self.snarl_ids = snarl_ids
        self._paths = paths
        self.start_pos = start_pos
        self.end_pos = end_pos
        self.type_variants = type_variants or []
        self.depth = depth
        self._row_prefix = None
        if path_strings is None:
            path_strings = ([path_to_string(p) for p in paths]
                            if paths is not None else [])
        self.path_strings = path_strings
        # the file's raw comma-joined PATHS column when loaded from a
        # snarl TSV (== ",".join(path_strings)); lets the chromosome
        # tokenizer build its blob without re-joining per-path strings
        self.raw_paths = raw_paths

    @property
    def paths(self) -> List[List[NodeTraversal]]:
        if self._paths is None:
            self._paths = [parse_path_string(p) for p in self.path_strings]
        return self._paths

    @property
    def n_paths(self) -> int:
        """Path count without forcing the tuple parse."""
        if self._paths is not None:
            return len(self._paths)
        return len(self.path_strings)

    @property
    def paths_parsed(self) -> bool:
        return self._paths is not None

    @property
    def snarl_id_str(self) -> str:
        return f"{self.snarl_ids[0]}_{self.snarl_ids[1]}"

    @property
    def type_var_str(self) -> str:
        return ",".join(self.type_variants)

    @property
    def row_prefix(self) -> str:
        """``START\\tEND\\tSNARL\\tTYPES`` — the constant middle of every
        output row (batch writers join these once per chunk)."""
        if self._row_prefix is None:
            self._row_prefix = (f"{self.start_pos}\t{self.end_pos}\t"
                                f"{self.snarl_id_str}\t{self.type_var_str}")
        return self._row_prefix

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"SnarlData({self.snarl_id_str}, "
                f"{len(self.path_strings)} paths)")


def parse_snarl_path(file_path: str) -> Dict[str, List[SnarlData]]:
    """Load a snarl decomposition TSV into {chr: [SnarlData...]}.

    Keeps file order within each chromosome (the reference's per-chromosome
    vectors, snarl_data_t.cpp:49-99).  Note the reference reassigns
    ``chr_snarl_matrix[chr]`` on every chromosome *change*, so a chromosome
    split into non-contiguous blocks keeps only its last block — we
    replicate that quirk for parity.
    """
    chr_map: Dict[str, List[SnarlData]] = {}
    current: List[SnarlData] = []
    save_chr = ""

    with open(file_path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        if header != EXPECTED_HEADER:
            raise RuntimeError(
                f"Error: Invalid header format in file: {file_path}\n"
                f" > Expected: {chr(9).join(EXPECTED_HEADER)}\n"
                f" > Got:      {chr(9).join(header)}"
            )
        for lineno, line in enumerate(fh, start=2):
            line = line.rstrip("\n")
            if not line:
                continue
            cols = line.split("\t")
            if len(cols) < 9:
                raise RuntimeError(
                    f"Error: malformed snarl file {file_path}: line "
                    f"{lineno} has {len(cols)} columns (expected 9): "
                    f"{line[:120]!r}")
            chrom, start_s, end_s, handle_s, snarl_id_s, paths_s, type_s, _ref, depth_s = cols[:9]

            if chrom != save_chr and save_chr != "":
                chr_map[save_chr] = current
                current = []
            save_chr = chrom

            path_strings = paths_s.split(",")
            current.append(SnarlData(
                net_handle=int(handle_s),
                snarl_ids=string_to_pair(snarl_id_s),
                paths=None,  # parsed lazily from path_strings
                start_pos=int(start_s),
                end_pos=int(end_s),
                type_variants=type_s.split(","),
                depth=int(depth_s),
                path_strings=path_strings,
                raw_paths=paths_s,
            ))

    if save_chr != "":
        chr_map[save_chr] = current
    return chr_map


def write_snarl_file_header(fh) -> None:
    fh.write("\t".join(EXPECTED_HEADER) + "\n")


def write_snarl_fail_header(fh) -> None:
    fh.write("SNARL\tREASON\n")
