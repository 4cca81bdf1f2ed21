"""Native GBZ (.gbz) reader — GBWT + GBWTGraph in simple-sds serialization.

Closes the last vg-format gap (SURVEY.md §2.2 item 4: the reference loads
``.gbz`` through vg::io::VPKG + gbwtgraph::GBZ, src/io/register_loader_
saver_gbz.cpp:18-39, src/gbzgraph.hpp:22-43).  This module reads the format
directly — no libbdsg/gbwt link, no ``vg convert`` step — and materializes a
:class:`~stoat_tpu_torch.graph.gfa.GfaGraph` with node sequences, the
haplotype-induced edge set, and all embedded paths (extracted from the GBWT
by LF-mapping).

Format notes (reverse-engineered from the fixture and validated against its
``.gfa``/``.hg``/``.pg`` twins; upstream spec: jltsiren/gbwtgraph
SERIALIZATION.md, simple-sds serialization model):

Everything is little-endian 8-byte words.

  Vec<T>        : [count][items... padded to a word]
  Optional      : [body size in words][body]          (absent = [0])
  RawVector     : [len in bits][Vec<u64> words]
  IntVector     : [len in items][width][RawVector]
  BitVector     : [ones][RawVector][3 x Optional rank/select supports]
  SparseVector  : [len][ones][high BitVector][low IntVector]   (Elias-Fano:
                  value_i = ((select(high,i) - i) << width) | low[i],
                  width = max(1, floor(log2(len/ones))))
  StringArray   : [index SparseVector (start offsets; len = last+1)]
                  [alphabet Vec<u8>][strings IntVector of alphabet ranks]
  Dictionary    : [StringArray][sorted_ids IntVector]

  GBZ   : header{tag 0x205A4247 u32, version u32, flags u64}, tags
          StringArray (key/value alternating), GBWT, GBWTGraph
  GBWT  : header{tag 0x6B376B37 u32, version u32, sequences, size, offset,
          alphabet_size, flags}, tags StringArray, BWT{index SparseVector
          of per-record byte offsets, data Vec<u8>}, Optional da_samples,
          Optional metadata
  record: [sigma ByteCode][edges: sigma x (node delta ByteCode, offset
          ByteCode), nodes ascending, first delta from 0]
          [body: runs over ranks 0..sigma)]
  run   : sigma < 255: byte b -> (rank = b % sigma, len = b//sigma + 1);
          if len == 256//sigma it continues with ByteCode extra length.
          sigma >= 255: (rank = ByteCode, len = ByteCode + 1)
  ByteCode: LEB128 (7-bit groups, high bit = continuation)
  metadata: header{tag 0x6B375E7A u32, version u32, sample_count,
          haplotype_count, contig_count, flags}, then per flags:
          path names Vec<{sample,contig,phase,fragment} x u32>,
          sample names Dictionary, contig names Dictionary
  GBWTGraph: header{tag 0x6B3764AF u32, version u32, nodes, flags},
          sequences StringArray (forward strand, ids first_id..), optional
          node-to-segment translation (flag 0x1)

GBWT node encoding: vg node v with orientation o <-> gbwt node 2v+o; the
endmarker is node 0; record j>0 holds gbwt node j + offset; sequence 2p is
path p forward (bidirectional GBWT).  Path p's steps are recovered by
LF-stepping from endmarker position 2p until the walk returns to node 0.

vg naming conventions honoured: sample "_gbwt_ref" marks generic (named)
paths whose display name is the contig name; other paths render PanSN
"sample#phase#contig"; the GBZ tag "reference_samples" marks reference
samples (utils.cpp:134-157 senses in the reference).
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Optional, Set, Tuple

from stoat_tpu_torch.graph.gfa import GfaGraph, GfaPath

__all__ = ["load_gbz", "GBZ_MAGIC", "GbzIndex"]

GBZ_MAGIC = b"GBZ "
_GBWT_TAG = 0x6B376B37
_METADATA_TAG = 0x6B375E7A
_GRAPH_TAG = 0x6B3764AF
_ENDMARKER = 0

# GBWT header flags
_F_BIDIRECTIONAL = 0x1
_F_METADATA = 0x2
# metadata flags
_F_PATH_NAMES = 0x1
_F_SAMPLE_NAMES = 0x2
_F_CONTIG_NAMES = 0x4
# graph header flags
_F_TRANSLATION = 0x1

_REF_SAMPLE = "_gbwt_ref"


class _Reader:
    """Word-oriented little-endian reader for simple-sds structures."""

    def __init__(self, data: bytes):
        self.data = data
        self.o = 0

    def word(self) -> int:
        v = struct.unpack_from("<Q", self.data, self.o)[0]
        self.o += 8
        return v

    def u32_pair(self) -> Tuple[int, int]:
        a, b = struct.unpack_from("<II", self.data, self.o)
        self.o += 8
        return a, b

    def raw_bytes(self, n: int) -> bytes:
        v = self.data[self.o:self.o + n]
        self.o += n
        return v

    def pad(self) -> None:
        self.o = (self.o + 7) & ~7

    # --- simple-sds composites -------------------------------------------

    def byte_vec(self) -> bytes:
        n = self.word()
        v = self.raw_bytes(n)
        self.pad()
        return v

    def word_vec(self) -> List[int]:
        n = self.word()
        return [self.word() for _ in range(n)]

    def raw_vector(self) -> Tuple[int, List[int]]:
        nbits = self.word()
        words = self.word_vec()
        return nbits, words

    def int_vector(self) -> List[int]:
        n = self.word()
        width = self.word()
        _nbits, words = self.raw_vector()
        return _unpack_ints(words, width, n)

    def bit_vector(self) -> Tuple[int, int, List[int]]:
        """Returns (ones, nbits, words); skips the 3 optional supports."""
        ones = self.word()
        nbits, words = self.raw_vector()
        for _ in range(3):
            skip = self.word()
            self.o += 8 * skip
        return ones, nbits, words

    def sparse_vector(self) -> List[int]:
        """Elias-Fano decoded values (non-decreasing)."""
        length = self.word()
        ones, _h_bits, h_words = self.bit_vector()
        lows = self.int_vector()
        if ones == 0:
            return []
        lw = _low_width(length, ones)
        values = []
        i = 0
        for w_idx, w in enumerate(h_words):
            word = w
            base = 64 * w_idx
            while word:
                lsb = word & -word
                pos = base + lsb.bit_length() - 1
                high = pos - i
                low = lows[i] if i < len(lows) else 0
                values.append((high << lw) | low)
                i += 1
                word ^= lsb
        return values

    def string_array(self) -> List[str]:
        starts = self.sparse_vector()
        alphabet = self.byte_vec()
        ranks = self.int_vector()
        chars = "".join(chr(alphabet[r]) for r in ranks)
        ends = starts[1:] + [len(chars)]
        return [chars[s:e] for s, e in zip(starts, ends)]

    def dictionary(self) -> List[str]:
        strings = self.string_array()
        _sorted_ids = self.int_vector()
        return strings


def _low_width(length: int, ones: int) -> int:
    if ones == 0 or length <= ones:
        return 1
    return max(1, int(math.log2(length / ones)))


def _unpack_ints(words: List[int], width: int, n: int) -> List[int]:
    if n == 0 or width == 0:
        return [0] * n
    big = 0
    for i, w in enumerate(words):
        big |= w << (64 * i)
    mask = (1 << width) - 1
    return [(big >> (i * width)) & mask for i in range(n)]


def _bytecode(data: bytes, pos: int) -> Tuple[int, int]:
    """LEB128 read -> (value, new_pos)."""
    result = 0
    offset = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << offset
        if not (b & 0x80):
            return result, pos
        offset += 7


class _Record:
    """One decoded GBWT node record: successor edges + run-coded body."""

    __slots__ = ("edges", "runs")

    def __init__(self, data: bytes, start: int, end: int):
        if start >= end:
            self.edges: List[Tuple[int, int]] = []
            self.runs: List[Tuple[int, int]] = []
            return
        pos = start
        sigma, pos = _bytecode(data, pos)
        edges = []
        prev = 0
        for _ in range(sigma):
            delta, pos = _bytecode(data, pos)
            node = prev + delta
            off, pos = _bytecode(data, pos)
            edges.append((node, off))
            prev = node
        runs = []
        if sigma >= 255:
            while pos < end:
                rank, pos = _bytecode(data, pos)
                length, pos = _bytecode(data, pos)
                runs.append((rank, length + 1))
        elif sigma > 0:
            threshold = 256 // sigma
            while pos < end:
                b = data[pos]
                pos += 1
                rank = b % sigma
                length = b // sigma + 1
                if length == threshold:
                    extra, pos = _bytecode(data, pos)
                    length += extra
                runs.append((rank, length))
        self.edges = edges
        self.runs = runs

    def lf(self, offset: int) -> Tuple[int, int]:
        """LF-map BWT position ``offset`` -> (successor node, offset)."""
        seen = 0
        for rank, length in self.runs:
            if offset < seen + length:
                node, base = self.edges[rank]
                # occurrences of `rank` strictly before `offset`
                return node, base + self._rank_before(rank, offset)
            seen += length
        raise ValueError("BWT offset out of record range")

    def _rank_before(self, rank: int, offset: int) -> int:
        count = 0
        seen = 0
        for r, length in self.runs:
            if seen >= offset:
                break
            take = min(length, offset - seen)
            if r == rank:
                count += take
            seen += length
        return count


class GbzIndex:
    """Parsed GBZ: GBWT records + graph sequences + metadata."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != GBZ_MAGIC:
            raise RuntimeError(f"{path}: not a GBZ (magic {data[:4]!r})")
        r = _Reader(data)
        tag, version = r.u32_pair()
        _flags = r.word()
        self.tags = _pairs(r.string_array())
        self._parse_gbwt(r)
        self._parse_graph(r)

    # --- GBWT -------------------------------------------------------------

    def _parse_gbwt(self, r: _Reader) -> None:
        tag, version = r.u32_pair()
        if tag != _GBWT_TAG:
            raise RuntimeError(f"bad GBWT tag {tag:#x}")
        self.sequences = r.word()
        self.size = r.word()
        self.offset = r.word()
        self.alphabet_size = r.word()
        self.flags = r.word()
        self.gbwt_tags = _pairs(r.string_array())
        # BWT: per-record byte ranges into `data`
        record_offsets = r.sparse_vector()
        bwt_data = r.byte_vec()
        bounds = record_offsets + [len(bwt_data)]
        self._records: List[_Record] = [
            _Record(bwt_data, bounds[i], bounds[i + 1])
            for i in range(len(record_offsets))
        ]
        # document-array samples: skip
        skip = r.word()
        r.o += 8 * skip
        # metadata
        meta_words = r.word()
        meta_end = r.o + 8 * meta_words
        self.path_names: List[Tuple[int, int, int, int]] = []
        self.sample_names: List[str] = []
        self.contig_names: List[str] = []
        if meta_words:
            tag, version = r.u32_pair()
            if tag != _METADATA_TAG:
                raise RuntimeError(f"bad metadata tag {tag:#x}")
            _samples = r.word()
            self.haplotype_count = r.word()
            _contigs = r.word()
            mflags = r.word()
            if mflags & _F_PATH_NAMES:
                count = r.word()
                for _ in range(count):
                    s, c = r.u32_pair()
                    p, f = r.u32_pair()
                    self.path_names.append((s, c, p, f))
            if mflags & _F_SAMPLE_NAMES:
                self.sample_names = r.dictionary()
            if mflags & _F_CONTIG_NAMES:
                self.contig_names = r.dictionary()
            r.o = meta_end

    def record_for_node(self, node: int) -> _Record:
        idx = 0 if node == _ENDMARKER else node - self.offset
        return self._records[idx]

    def extract_path(self, path_id: int) -> List[Tuple[int, bool]]:
        """Forward steps of path ``path_id`` as (node_id, is_reverse)."""
        seq_id = 2 * path_id if self.flags & _F_BIDIRECTIONAL else path_id
        steps: List[Tuple[int, bool]] = []
        node, off = self.record_for_node(_ENDMARKER).lf(seq_id)
        while node != _ENDMARKER:
            steps.append((node >> 1, bool(node & 1)))
            node, off = self.record_for_node(node).lf(off)
        return steps

    def extract_all_paths(self) -> List[List[Tuple[int, bool]]]:
        """All forward paths at once by lockstep LF over flat tables.

        Every record body is expanded once into flat (successor node,
        LF offset) arrays indexed by record start + BWT offset; all
        sequences then advance one LF step per numpy iteration — O(total
        path length) instead of a per-step Python scan over runs."""
        import numpy as np

        rec_nodes = [_ENDMARKER] + list(
            range(self.offset + 1, self.alphabet_size))
        succ_parts, lf_parts, rec_start = [], [], {}
        total = 0
        for node, rec in zip(rec_nodes, self._records):
            rec_start[node] = total
            if rec.runs:
                run_ranks = np.repeat(
                    np.array([r for r, _l in rec.runs], np.int64),
                    np.array([l for _r, l in rec.runs], np.int64))
                n_occ = run_ranks.shape[0]
                # occurrence index within its rank (prefix count)
                within = np.zeros(n_occ, np.int64)
                for r in range(len(rec.edges)):
                    m = run_ranks == r
                    within[m] = np.arange(int(m.sum()))
                succ = np.array([rec.edges[r][0] for r in run_ranks],
                                np.int64)
                base = np.array([rec.edges[r][1] for r in run_ranks],
                                np.int64)
                succ_parts.append(succ)
                lf_parts.append(base + within)
                total += n_occ
        if not succ_parts:
            return [[] for _ in range(self.n_paths)]
        succ_flat = np.concatenate(succ_parts)
        lf_flat = np.concatenate(lf_parts)
        start_arr = np.zeros(self.alphabet_size, np.int64)
        for node, st in rec_start.items():
            start_arr[node] = st

        n_paths = self.n_paths
        stride = 2 if self.flags & _F_BIDIRECTIONAL else 1
        idx = np.arange(0, stride * n_paths, stride, dtype=np.int64)
        node = succ_flat[idx]
        off = lf_flat[idx]
        # lockstep LF-mapping walk with FINISHED LANES COMPACTED each
        # step: the former dense [longest_path, n_paths] matrices cost
        # O(max_len x n_paths) memory (tens of GB for one chromosome-
        # length reference path among thousands of short fragments);
        # this keeps O(total steps).
        lanes = np.arange(n_paths, dtype=np.int64)
        keep = node != _ENDMARKER
        lanes, node, off = lanes[keep], node[keep], off[keep]
        lane_parts: List[np.ndarray] = []
        node_parts: List[np.ndarray] = []
        while lanes.size:
            lane_parts.append(lanes.copy())
            node_parts.append(node.copy())
            pos = start_arr[node] + off
            nxt = succ_flat[pos]
            off = lf_flat[pos]
            node = nxt
            keep = node != _ENDMARKER
            lanes, node, off = lanes[keep], node[keep], off[keep]
        if not lane_parts:
            return [[] for _ in range(n_paths)]
        all_lanes = np.concatenate(lane_parts)
        all_nodes = np.concatenate(node_parts)
        # stable sort by lane keeps each path's iteration (= step) order
        order = np.argsort(all_lanes, kind="stable")
        sl = all_lanes[order]
        sn = all_nodes[order]
        bounds = np.searchsorted(sl, np.arange(n_paths + 1))
        return [[(int(v) >> 1, bool(v & 1))
                 for v in sn[bounds[p]:bounds[p + 1]]]
                for p in range(n_paths)]

    @property
    def n_paths(self) -> int:
        if self.flags & _F_BIDIRECTIONAL:
            return self.sequences // 2
        return self.sequences

    # --- GBWTGraph ---------------------------------------------------------

    def _parse_graph(self, r: _Reader) -> None:
        tag, version = r.u32_pair()
        if tag != _GRAPH_TAG:
            raise RuntimeError(f"bad GBWTGraph tag {tag:#x}")
        self.n_nodes = r.word()
        gflags = r.word()
        seqs = r.string_array()
        first_id = (self.offset + 1) // 2
        self.node_sequences: Dict[int, str] = {
            first_id + i: s for i, s in enumerate(seqs) if s
        }
        self.segment_translation: List[str] = []
        if gflags & _F_TRANSLATION:
            try:
                self.segment_translation = r.string_array()
                r.sparse_vector()  # node-to-segment mapping
            except Exception:
                self.segment_translation = []

    # --- naming -------------------------------------------------------------

    def path_display(self, path_id: int) -> Tuple[str, str, int]:
        """(display_name, sample, haplotype) per vg conventions."""
        if path_id >= len(self.path_names):
            return f"path_{path_id}", f"path_{path_id}", 0
        s, c, p, _f = self.path_names[path_id]
        sample = (self.sample_names[s] if s < len(self.sample_names)
                  else str(s))
        contig = (self.contig_names[c] if c < len(self.contig_names)
                  else str(c))
        phase = 0 if p == 0xFFFFFFFF else p
        if sample == _REF_SAMPLE:
            return contig, contig, 0
        return f"{sample}#{phase}#{contig}", sample, phase


def _pairs(strings: List[str]) -> Dict[str, str]:
    return {strings[i]: strings[i + 1] for i in range(0, len(strings) - 1, 2)}


def load_gbz(path: str,
             reference_names: Optional[Set[str]] = None) -> GfaGraph:
    """Parse a .gbz into a GfaGraph (nodes, edges, embedded paths).

    Edge set = the haplotype-induced edges recorded in the GBWT (the
    GBWTGraph definition).  ``reference_names`` follows the same contract
    as :func:`~stoat_tpu_torch.graph.gfa.load_gfa`; additionally the GBZ tag
    ``reference_samples`` marks reference samples.
    """
    idx = GbzIndex(path)
    g = GfaGraph()
    reference_names = set(reference_names or ())
    ref_samples = set(idx.tags.get("reference_samples", "").split())

    for nid, seq in sorted(idx.node_sequences.items()):
        g.add_node(nid, seq)

    # haplotype-consistent edges from the BWT records
    for node in range(idx.offset + 1, idx.alphabet_size):
        rec = idx.record_for_node(node)
        src = (node >> 1, bool(node & 1))
        for succ, _off in rec.edges:
            if succ == _ENDMARKER:
                continue
            g.add_edge(src, (succ >> 1, bool(succ & 1)))

    all_steps = idx.extract_all_paths()
    for pid in range(idx.n_paths):
        name, sample, hap = idx.path_display(pid)
        steps = all_steps[pid]
        generic = (pid < len(idx.path_names)
                   and idx.sample_names
                   and idx.path_names[pid][0] < len(idx.sample_names)
                   and idx.sample_names[idx.path_names[pid][0]]
                   == _REF_SAMPLE)
        is_ref = (name in reference_names or sample in reference_names
                  or sample in ref_samples
                  or (bool(generic) and not reference_names))
        g.add_path(GfaPath(name=name, steps=steps, sample=sample,
                           haplotype=hap, is_reference=is_ref))
    return g
