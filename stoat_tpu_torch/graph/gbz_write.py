"""GBZ (.gbz) writer — serialize a GfaGraph as GBWT + GBWTGraph.

The port's copy of stoat_tpu/graph/gbz_write.py, on the port's
:class:`~stoat_tpu_torch.graph.gfa.GfaGraph`; it writes the same bytes.
Companion to :mod:`stoat_tpu_torch.graph.gbz` (format notes there).
Provides vg-free GBZ export and, more importantly, lets the test suite
round-trip every fixture topology through the format (the reference ships
only one real ``.gbz`` fixture, tests/graph_test/simple_snp.gbz).

The GBWT is a multi-string BWT over oriented node ids (gbwt node = 2v+o;
sequence 2p / 2p+1 = path p forward / reverse).  Occurrences of a node are
ordered by their reversed prefix (the node sequence before the visit, read
backwards), ties broken by sequence id — the co-lexicographic order the
LF-mapping in the reader inverts.  The construction computes those orders
globally as suffix ranks of the reversed sequences (prefix doubling on
numpy lexsort, O(T log T) for total length T), so multi-million-step path
sets serialize in seconds.

Semantics note: GBZ stores only haplotype-induced edges (the GBWTGraph
definition), so edges of the input graph not traversed by any path are not
representable — same behavior as vg's own GBZ conversion.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

from stoat_tpu_torch.graph.gfa import GfaGraph

__all__ = ["save_gbz"]

_ENDMARKER = 0
_NO_PHASE = 0xFFFFFFFF
_REF_SAMPLE = "_gbwt_ref"


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def word(self, v: int) -> None:
        self.buf += struct.pack("<Q", v)

    def u32_pair(self, a: int, b: int) -> None:
        self.buf += struct.pack("<II", a, b)

    def byte_vec(self, data: bytes) -> None:
        self.word(len(data))
        self.buf += data
        while len(self.buf) % 8:
            self.buf.append(0)

    def word_vec(self, words: Sequence[int]) -> None:
        self.word(len(words))
        for w in words:
            self.word(w)

    def raw_vector(self, nbits: int, words: Sequence[int]) -> None:
        self.word(nbits)
        self.word_vec(words)

    def int_vector(self, values: Sequence[int], width: int) -> None:
        self.word(len(values))
        self.word(width)
        nbits = len(values) * width
        self.raw_vector(nbits, _pack_ints(values, width))

    def bit_vector(self, nbits: int, set_bits: Sequence[int]) -> None:
        words = [0] * ((nbits + 63) // 64)
        for b in set_bits:
            words[b // 64] |= 1 << (b % 64)
        self.word(len(set_bits))       # ones
        self.raw_vector(nbits, words)
        for _ in range(3):             # absent rank/select supports
            self.word(0)

    def sparse_vector(self, values: Sequence[int], length: int) -> None:
        """Elias-Fano encode non-decreasing ``values`` over [0, length)."""
        ones = len(values)
        width = _low_width(length, ones)
        highs = [(v >> width) + i for i, v in enumerate(values)]
        nbits = ones + (length >> width) + 1
        self.word(length)
        self.bit_vector(nbits, highs)
        self.int_vector([v & ((1 << width) - 1) for v in values], width)

    def string_array(self, strings: Sequence[str]) -> None:
        data = "".join(strings)
        alphabet = sorted(set(data))
        rank = {c: i for i, c in enumerate(alphabet)}
        starts = []
        pos = 0
        for s in strings:
            starts.append(pos)
            pos += len(s)
        length = (starts[-1] + 1) if starts else 0
        self.sparse_vector(starts, length)
        self.byte_vec("".join(alphabet).encode())
        width = max(1, (len(alphabet) - 1).bit_length()) if alphabet else 1
        self.int_vector([rank[c] for c in data], width)

    def dictionary(self, strings: Sequence[str]) -> None:
        self.string_array(strings)
        order = sorted(range(len(strings)), key=lambda i: strings[i])
        width = max(1, (len(strings) - 1).bit_length()) if strings else 1
        self.int_vector(order, width)


def _low_width(length: int, ones: int) -> int:
    import math
    if ones == 0 or length <= ones:
        return 1
    return max(1, int(math.log2(length / ones)))


def _pack_ints(values: Sequence[int], width: int) -> List[int]:
    nwords = (len(values) * width + 63) // 64
    words = [0] * nwords
    big = 0
    for i, v in enumerate(values):
        big |= v << (i * width)
    for i in range(nwords):
        words[i] = (big >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
    return words


def _bytecode(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _encode_runs(ranks: Sequence[int], sigma: int) -> bytes:
    """RLE of successor ranks, mirroring gbwt's Run codec."""
    out = bytearray()
    i = 0
    n = len(ranks)
    while i < n:
        c = ranks[i]
        j = i
        while j < n and ranks[j] == c:
            j += 1
        length = j - i
        if sigma >= 255:
            out += _bytecode(c)
            out += _bytecode(length - 1)
        else:
            threshold = 256 // sigma
            if length < threshold:
                out.append(c + sigma * (length - 1))
            else:
                out.append(c + sigma * (threshold - 1))
                out += _bytecode(length - threshold)
        i = j
    return bytes(out)


def _suffix_ranks(arr: "np.ndarray") -> "np.ndarray":
    """Dense ranks of all suffixes of ``arr`` (prefix doubling)."""
    import numpy as np
    n = len(arr)
    if n == 0:
        return np.zeros(0, np.int64)
    rank = np.unique(arr, return_inverse=True)[1].astype(np.int64)
    k = 1
    while int(rank.max()) != n - 1:
        r2 = np.full(n, -1, np.int64)
        if k < n:
            r2[:-k] = rank[k:]
        order = np.lexsort((r2, rank))
        kr, kr2 = rank[order], r2[order]
        diff = (kr[1:] != kr[:-1]) | (kr2[1:] != kr2[:-1])
        sorted_ranks = np.concatenate(
            [[0], np.cumsum(diff.astype(np.int64))])
        rank = np.empty(n, np.int64)
        rank[order] = sorted_ranks
        k *= 2
    return rank


def _build_records(seqs: List[List[int]], alphabet_size: int, offset: int
                   ) -> List[bytes]:
    """BWT records for nodes [ENDMARKER] + [offset+1, alphabet_size).

    Occurrence order at each node = rank of the visit's reversed prefix
    among all reversed prefixes (suffixes of the reversed sequences, each
    terminated by a unique per-sequence sentinel that also breaks ties by
    sequence id).  Edge offset for v->w = number of w-occurrences whose
    predecessor node is < v — a searchsorted over w's (already
    pred-sorted) occurrence list."""
    import numpy as np

    n_seqs = len(seqs)
    parts = []
    starts = []
    pos = 0
    for s, seq in enumerate(seqs):
        starts.append(pos)
        parts.append(np.array(list(reversed(seq)) + [s - n_seqs],
                              dtype=np.int64))
        pos += len(seq) + 1
    concat = (np.concatenate(parts) if parts else np.zeros(0, np.int64))
    ranks = _suffix_ranks(concat)

    # occurrences[v] = list of (reversed-prefix rank, succ, pred)
    occurrences: Dict[int, List[Tuple[int, int, int]]] = {}
    for s, seq in enumerate(seqs):
        L = len(seq)
        st = starts[s]
        for i, v in enumerate(seq):
            key = int(ranks[st + L - i])
            succ = seq[i + 1] if i + 1 < L else _ENDMARKER
            pred = seq[i - 1] if i > 0 else _ENDMARKER
            occurrences.setdefault(v, []).append((key, succ, pred))

    # sort each node's occurrences once; keep pred arrays for offsets
    preds_sorted: Dict[int, "np.ndarray"] = {}
    for v, occ in occurrences.items():
        occ.sort(key=lambda kso: kso[0])
        preds_sorted[v] = np.array([p for _k, _s, p in occ], np.int64)

    def edge_offset(src: int, dst: int) -> int:
        if dst == _ENDMARKER:
            return 0
        return int(np.searchsorted(preds_sorted[dst], src, side="left"))

    # endmarker record: sequence starts in sequence-id order
    occurrences[_ENDMARKER] = [
        (sid, seq[0] if seq else _ENDMARKER, -1)
        for sid, seq in enumerate(seqs)]

    records = []
    node_ids = [_ENDMARKER] + list(range(offset + 1, alphabet_size))
    for v in node_ids:
        occ = occurrences.get(v)
        if not occ:
            records.append(b"")
            continue
        succs = sorted({succ for _k, succ, _p in occ})
        rank = {s: i for i, s in enumerate(succs)}
        body = _encode_runs([rank[s] for _k, s, _p in occ], len(succs))
        rec = bytearray(_bytecode(len(succs)))
        prev = 0
        for s in succs:
            rec += _bytecode(s - prev)
            rec += _bytecode(edge_offset(v, s))
            prev = s
        rec += body
        records.append(bytes(rec))
    return records


def save_gbz(g: GfaGraph, path: str) -> None:
    """Serialize ``g`` (nodes, paths; path-induced edges) as a .gbz file."""
    if not g.paths:
        raise ValueError("GBZ requires at least one embedded path")
    node_ids = g.node_ids()
    min_id, max_id = node_ids[0], node_ids[-1]
    offset = 2 * min_id - 1
    alphabet_size = 2 * max_id + 2

    # sequences: forward + reverse per path (bidirectional GBWT)
    seqs: List[List[int]] = []
    for p in g.paths:
        fwd = [2 * nid + int(rev) for nid, rev in p.steps]
        bwd = [2 * nid + int(not rev) for nid, rev in reversed(p.steps)]
        seqs.append(fwd)
        seqs.append(bwd)

    records = _build_records(seqs, alphabet_size, offset)
    data = bytearray()
    starts = []
    for rec in records:
        starts.append(len(data))
        data += rec

    # metadata naming
    samples: List[str] = []
    contigs: List[str] = []
    path_names: List[Tuple[int, int, int, int]] = []

    def intern(lst: List[str], s: str) -> int:
        try:
            return lst.index(s)
        except ValueError:
            lst.append(s)
            return len(lst) - 1

    for p in g.paths:
        generic = p.sample == p.name
        sample = _REF_SAMPLE if generic else p.sample
        contig = p.name if generic else p.name.split("#")[-1]
        phase = _NO_PHASE if generic else p.haplotype
        path_names.append((intern(samples, sample), intern(contigs, contig),
                           phase, 0))
    haplotypes = len({(s, p) for s, _c, p, _f in path_names})

    w = _Writer()
    # GBZ header + tags
    w.buf += b"GBZ "
    w.buf += struct.pack("<I", 1)          # version
    w.word(0)                              # flags
    w.string_array(["source", "stoat-tpu"])

    # GBWT header
    w.buf += struct.pack("<II", 0x6B376B37, 5)
    w.word(len(seqs))                      # sequences
    w.word(sum(len(s) + 1 for s in seqs))  # size incl endmarkers
    w.word(offset)
    w.word(alphabet_size)
    w.word(0x7)                            # bidirectional|metadata|simple-sds
    w.string_array(["source", "stoat-tpu"])
    # BWT
    w.sparse_vector(starts, len(data) if data else 1)
    w.byte_vec(bytes(data))
    w.word(0)                              # da_samples absent
    # metadata (size-prefixed optional)
    m = _Writer()
    m.buf += struct.pack("<II", 0x6B375E7A, 2)
    m.word(len(samples))
    m.word(haplotypes)
    m.word(len(contigs))
    m.word(0x7)                            # path+sample+contig names
    m.word(len(path_names))
    for s, c, p, f in path_names:
        m.u32_pair(s, c)
        m.u32_pair(p, f)
    m.dictionary(samples)
    m.dictionary(contigs)
    assert len(m.buf) % 8 == 0
    w.word(len(m.buf) // 8)
    w.buf += m.buf

    # GBWTGraph
    w.buf += struct.pack("<II", 0x6B3764AF, 3)
    w.word(len(node_ids))                  # nodes with sequence
    w.word(0x2)                            # simple-sds, no translation
    first_id = (offset + 1) // 2
    max_id = node_ids[-1]
    seq_strings = [g.sequences.get(i, "")
                   for i in range(first_id, max_id + 1)]
    w.string_array(seq_strings)

    with open(path, "wb") as fh:
        fh.write(bytes(w.buf))
