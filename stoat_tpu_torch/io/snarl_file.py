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

A file is read into columns (:class:`SnarlTable`), one table a
chromosome, in one native pass where the native core can read it exactly
as the Python parser does; the pipeline reads the columns, and an item of
a table is a :class:`SnarlData` built on demand.
"""

from __future__ import annotations

import operator
import os
from collections.abc import Sequence
from typing import Dict, List, Optional, Tuple

import numpy as np

from stoat_tpu_torch import trace
from stoat_tpu_torch.formatting import string_to_pair

__all__ = ["SnarlData", "SnarlTable", "parse_snarl_path",
           "parse_path_string", "path_to_edges", "EXPECTED_HEADER"]

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


def _column(k: int, doc: str):
    return property(lambda self: self._ints[k], doc=doc)


def _blob(fields: List[str], sep: bytes = b""):
    """The fields as one bytes object, each followed by ``sep``, and the
    int64 [n + 1] offsets of their starts."""
    encoded = [f.encode() for f in fields]
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(e) + len(sep) for e in encoded], out=offsets[1:])
    return b"".join(e + sep for e in encoded), offsets


class SnarlTable(Sequence):
    """One chromosome's snarls as columns, in file order: a ``Sequence`` of
    :class:`SnarlData`.

    ``start_pos``, ``end_pos``, ``net_handle``, ``snarl_id0``,
    ``snarl_id1``, ``depth`` and ``n_paths`` are int64 arrays, one entry a
    snarl; the snarls' PATHS and TYPE fields are bytes in two shared blobs
    with row offsets.  The per-chunk consumers (the path tokenizer, the
    writer's row prefixes, the eQTL pairing, the permutation table) read
    the columns.  Indexing builds a :class:`SnarlData` on demand, counted
    as ``snarl_file.objects``; a slice is a table over the same blobs.  A
    table made from objects (:meth:`of`) returns those objects."""

    __slots__ = ("_ints", "_paths", "_paths_off", "_types", "_types_off",
                 "_items")

    def __init__(self, ints: np.ndarray, paths: Optional[bytes],
                 paths_off: np.ndarray, types: bytes, types_off: np.ndarray,
                 items: Optional[List[SnarlData]] = None):
        self._ints = ints              # int64 [7, S], the columns below
        # every snarl's PATHS followed by ','; None when an object's parsed
        # paths disagree with its path strings (the tokenizer then walks
        # the objects' tuples)
        self._paths = paths
        self._paths_off = paths_off    # int64 [S + 1]
        self._types = types            # every snarl's TYPE
        self._types_off = types_off    # int64 [S + 1]
        self._items = items            # the objects, for a table of them

    start_pos = _column(0, "int64 [S] START_POS")
    end_pos = _column(1, "int64 [S] END_POS")
    net_handle = _column(2, "int64 [S] SNARL_HANDLEGRAPH")
    snarl_id0 = _column(3, "int64 [S] SNARL's first id")
    snarl_id1 = _column(4, "int64 [S] SNARL's second id")
    depth = _column(5, "int64 [S] DEPTH")
    n_paths = _column(6, "int64 [S] paths a snarl")

    @classmethod
    def of(cls, snarls: Sequence[SnarlData]) -> "SnarlTable":
        """``snarls`` when it is a table, else a table over the objects."""
        if isinstance(snarls, cls):
            return snarls
        items = list(snarls)
        ints = np.array([(s.start_pos, s.end_pos, s.net_handle,
                          s.snarl_ids[0], s.snarl_ids[1], s.depth, s.n_paths)
                         for s in items], np.int64).reshape(-1, 7).T.copy()
        paths = paths_off = None
        if all(len(s.path_strings) == s.n_paths for s in items):
            if all(s.raw_paths is not None for s in items):
                fields = [s.raw_paths for s in items]
            else:
                fields = [",".join(s.path_strings) for s in items]
            paths, paths_off = _blob(fields, b",")
        types, types_off = _blob([s.type_var_str for s in items])
        return cls(ints, paths, paths_off, types, types_off, items)

    def __len__(self) -> int:
        return self._ints.shape[1]

    def __getitem__(self, i):
        if isinstance(i, slice):
            lo, hi, step = i.indices(len(self))
            if step != 1:
                return [self[j] for j in range(lo, hi, step)]
            hi = max(lo, hi)
            return SnarlTable(
                self._ints[:, lo:hi], self._paths,
                None if self._paths_off is None
                else self._paths_off[lo:hi + 1],
                self._types, self._types_off[lo:hi + 1],
                None if self._items is None else self._items[lo:hi])
        i = operator.index(i)
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError("snarl index out of range")
        if self._items is not None:
            return self._items[i]
        trace.count("snarl_file.objects", 1)
        start, end, handle, id0, id1, depth, _ = self._ints[:, i].tolist()
        raw = self._paths[self._paths_off[i]:
                          self._paths_off[i + 1] - 1].decode()
        types = self._types[self._types_off[i]:self._types_off[i + 1]]
        return SnarlData(net_handle=handle, snarl_ids=(id0, id1),
                         start_pos=start, end_pos=end,
                         type_variants=types.decode().split(","),
                         depth=depth, path_strings=raw.split(","),
                         raw_paths=raw)

    def __iter__(self):
        if self._items is not None:
            return iter(self._items)
        return (self[i] for i in range(len(self)))

    def __eq__(self, other):
        """The same snarls in the same order, by their columns and fields
        (a table of objects out of sync with its paths: by its items)."""
        if not isinstance(other, SnarlTable):
            return NotImplemented
        if self._paths is None or other._paths is None:
            return list(self) == list(other)
        return (np.array_equal(self._ints, other._ints)
                and self.paths_blob() == other.paths_blob()
                and self.row_prefixes() == other.row_prefixes())

    def __add__(self, other):
        return list(self) + list(other)

    def __radd__(self, other):
        return list(other) + list(self)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SnarlTable({len(self)} snarls)"

    def paths_blob(self) -> Optional[bytes]:
        """The snarls' PATHS fields joined by ',' (the path resolvers'
        input), or None when an object's parsed paths disagree with its
        path strings."""
        if self._paths is None:
            return None
        lo, hi = int(self._paths_off[0]), int(self._paths_off[-1])
        return self._paths[lo:max(lo, hi - 1)]

    def row_prefixes(self) -> bytes:
        """Each snarl's ``START\tEND\tSNARL\tTYPES``, NUL-terminated: the
        constant middle of its output rows (:attr:`SnarlData.row_prefix`),
        in C++ where the native core is available."""
        from stoat_tpu_torch import native
        got = native.snarl_prefixes(self.start_pos, self.end_pos,
                                    self.snarl_id0, self.snarl_id1,
                                    self._types, self._types_off)
        if got is not None:
            return got
        off = self._types_off.tolist()
        return "".join(
            f"{s}\t{e}\t{a}_{b}\t{self._types[lo:hi].decode()}\0"
            for s, e, a, b, lo, hi in zip(
                self.start_pos.tolist(), self.end_pos.tolist(),
                self.snarl_id0.tolist(), self.snarl_id1.tolist(), off[:-1],
                off[1:])).encode()


def _parse_python(file_path: str):
    """The snarl file read line by line in Python: the table of every row
    and the blocks ``[(chrom, first row, end row)]`` that
    :func:`parse_snarl_path` keeps."""
    ints: List[Tuple[int, ...]] = []
    paths: List[str] = []
    types: List[str] = []
    blocks = []
    lo = 0
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
                blocks.append((save_chr, lo, len(ints)))
                lo = len(ints)
            save_chr = chrom

            handle = int(handle_s)
            snarl_ids = string_to_pair(snarl_id_s)
            start, end = int(start_s), int(end_s)
            ints.append((start, end, handle, *snarl_ids, int(depth_s),
                         paths_s.count(",") + 1))
            paths.append(paths_s)
            types.append(type_s)

    if save_chr != "":
        blocks.append((save_chr, lo, len(ints)))
    table = SnarlTable(np.array(ints, np.int64).reshape(-1, 7).T.copy(),
                       *_blob(paths, b","), *_blob(types))
    return table, blocks


def parse_snarl_path(file_path: str) -> Dict[str, SnarlTable]:
    """Load a snarl decomposition TSV into {chr: SnarlTable}.

    Keeps file order within each chromosome (the reference's per-chromosome
    vectors, snarl_data_t.cpp:49-99).  Note the reference reassigns
    ``chr_snarl_matrix[chr]`` on every chromosome *change*, so a chromosome
    split into non-contiguous blocks keeps only its last block — we
    replicate that quirk for parity.

    The file is read in one native pass (``native.parse_snarl_file``);
    a file that pass does not read exactly as the line-by-line Python
    parser does, or a host without the native core, takes the Python
    parser, which fills the same columns and raises its errors.  The rows
    read count as ``snarl_file.rows``.
    """
    from stoat_tpu_torch import native
    got = (native.parse_snarl_file(file_path)
           if os.path.isfile(file_path) else None)
    if got is not None:
        *columns, blocks = got
        table = SnarlTable(*columns)
    else:
        table, blocks = _parse_python(file_path)
    trace.count("snarl_file.rows", len(table))
    chr_map: Dict[str, SnarlTable] = {}
    for chrom, lo, hi in blocks:
        chr_map[chrom] = table[lo:hi]
    return chr_map


def write_snarl_file_header(fh) -> None:
    fh.write("\t".join(EXPECTED_HEADER) + "\n")


def write_snarl_fail_header(fh) -> None:
    fh.write("SNARL\tREASON\n")
