"""bdsg PackedGraph (.pg) binary reader.

Native support for vg's default serialization (the ``.pg`` files the
reference's test zoo ships alongside each ``.hg``; loaded by the
reference through libbdsg, see src/stoat_graph.cpp and
src/io/register_loader_saver_packed_graph.cpp).  The packed-vector
container format was reverse-engineered from the fixture files and
validated node/edge/path-exactly against their HashGraph twins.

Container primitives (all integers little-endian):

    int_vector     u64 size_in_bits, u8 bit_width, then
                   ceil(bits/64) data words (values packed LSB-first)
    PackedVector   u64 filled, int_vector
    PackedDeque    u64 begin_idx, u64 filled, PackedVector
                   (circular buffer: element i lives at (begin+i) % cap)
    PagedVector    u64 filled, u64 page_size, PackedVector anchors,
                   then ceil(filled/page_size) PackedVector pages.
                   Page entries are anchor-diff coded:
                       e == 0          -> value 0
                       e % 5 == 0      -> value = anchor - e/5
                       otherwise       -> q, r = divmod(e - 1, 5)
                                          value = anchor + 4*q + r
                   (non-negative diffs d are stored as
                   d + floor(d/4) + 1, freeing every 5th code point for
                   negative diffs.)

File layout:

    u32 magic 0x5df79eb7 (bytes b7 9e f7 5d)
    u64 max_id, u64 min_id
    PagedVector  graph_iv        2 slots/node: [left head, right head],
                                 1-based edge-record indices, 0 = empty
    PagedVector  seq_start_iv    per node (graph order)
    PackedVector seq_length_iv   per node
    PagedVector  edge_lists_iv   2 slots/record: [trav, next-record]
                                 trav = node_id << 1 | is_reverse;
                                 a left-list trav is the traversal
                                 reached when LEAVING the node leftward
    PackedDeque  id_to_graph_iv  (id - min_id) -> 1-based graph index
    PackedVector seq_iv          base codes 0..4 = A C G T N
    PagedVector  path_membership_node_iv   per node: head into ...
    PagedVector  path_membership_id_iv     ... parallel record arrays
    PagedVector  path_membership_offset_iv
    PagedVector  path_membership_next_iv
    u64 + bytes  concatenated path names
    PackedVector (per name char; not needed to reconstruct paths)
    PagedVector  name start per path     PackedVector  name length
    PackedVector is_circular             PackedVector  is_deleted
    PagedVector  head step per path      PagedVector   tail step
    PackedVector per-path scalar (deleted step count)
    per path:    PackedVector links   2 slots/step: [prev, next]
                 PagedVector  links (paged half; populated instead of
                                     the packed half for long paths)
                 PackedVector travs  1 slot/step
                 PagedVector  travs (paged half)
    trailing zero scalars (deleted-record tallies)
"""

from __future__ import annotations

import struct
from typing import List, Optional, Set

from stoat_tpu_torch.graph.gfa import GfaGraph, GfaPath, _path_identity

__all__ = ["load_pg", "PACKEDGRAPH_MAGIC"]

PACKEDGRAPH_MAGIC = b"\xb7\x9e\xf7\x5d"

_BASES = "ACGTN"


def _page_decode(anchor: int, e: int) -> int:
    if e == 0:
        return 0
    if e % 5 == 0:
        return anchor - e // 5
    q, r = divmod(e - 1, 5)
    return anchor + 4 * q + r


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.o = 0

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.data, self.o)[0]
        self.o += 8
        return v

    def int_vector(self) -> List[int]:
        bits = self.u64()
        width = self.data[self.o]
        self.o += 1
        nwords = (bits + 63) // 64
        words = struct.unpack_from("<%dQ" % nwords, self.data, self.o)
        self.o += nwords * 8
        if width == 0:
            return []
        # one shared bit-unpacking primitive with the GBZ reader (the
        # former per-element divmod/shift loop was the .pg load wall at
        # chromosome scale)
        from stoat_tpu_torch.graph.gbz import _unpack_ints
        return _unpack_ints(words, width, bits // width)

    def packed_vector(self) -> List[int]:
        filled = self.u64()
        vals = self.int_vector()
        if filled > len(vals):
            raise RuntimeError("PackedVector filled exceeds capacity")
        return vals[:filled]

    def packed_deque(self) -> List[int]:
        begin = self.u64()
        filled = self.u64()
        vals = self.packed_vector()
        if not filled:
            return []
        cap = len(vals)
        return [vals[(begin + i) % cap] for i in range(filled)]

    def paged_vector(self) -> List[int]:
        filled = self.u64()
        page_size = self.u64()
        anchors = self.packed_vector()
        npages = (filled + page_size - 1) // page_size
        if len(anchors) != npages:
            raise RuntimeError("PagedVector anchor/page count mismatch")
        out: List[int] = []
        for p in range(npages):
            page = self.packed_vector()
            a = anchors[p]
            out.extend(_page_decode(a, e) for e in page)
        return out[:filled]

    def robust_vector(self) -> List[int]:
        """PackedVector half followed by PagedVector half; exactly one
        carries the data (packed below one page, paged above)."""
        packed = self.packed_vector()
        paged = self.paged_vector()
        return packed if packed else paged


def load_pg(path: str,
            reference_names: Optional[Set[str]] = None) -> GfaGraph:
    """Parse a bdsg PackedGraph file into a GfaGraph."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != PACKEDGRAPH_MAGIC:
        raise RuntimeError(f"{path}: not a PackedGraph (magic {data[:4]!r})")
    r = _Reader(data)
    r.o = 4
    max_id = r.u64()
    min_id = r.u64()

    graph_iv = r.paged_vector()
    seq_start = r.paged_vector()
    seq_length = r.packed_vector()
    edge_lists = r.paged_vector()
    id_to_graph = r.packed_deque()
    seq_iv = r.packed_vector()
    # path membership (per-node -> records); redundant with the per-path
    # step lists below, so parsed only to advance the cursor
    r.paged_vector()
    r.paged_vector()
    r.paged_vector()
    r.paged_vector()

    g = GfaGraph()
    reference_names = reference_names or set()

    # ---- nodes and sequences ----
    node_of_gidx = {}          # 1-based graph index -> node id
    for nid in range(min_id, max_id + 1):
        slot = nid - min_id
        if slot >= len(id_to_graph):
            continue
        gidx = id_to_graph[slot]
        if gidx == 0:
            # bdsg stores 0 for absent ids; graph indices are 1-based
            continue
        node_of_gidx[gidx] = nid
        s = seq_start[gidx - 1]
        ln = seq_length[gidx - 1]
        seq = "".join(_BASES[c] for c in seq_iv[s:s + ln])
        g.add_node(nid, seq)

    # ---- edges ----
    def walk(head: int):
        rec = head
        seen = 0
        while rec:
            trav = edge_lists[2 * (rec - 1)]
            yield (trav >> 1, bool(trav & 1))
            rec = edge_lists[2 * (rec - 1) + 1]
            seen += 1
            if seen > len(edge_lists):
                raise RuntimeError("edge list cycle")

    for gidx, nid in node_of_gidx.items():
        left_head = graph_iv[2 * (gidx - 1)]
        right_head = graph_iv[2 * (gidx - 1) + 1]
        for h in walk(right_head):
            g.add_edge((nid, False), h)
        for h in walk(left_head):
            g.add_edge((nid, True), h)

    # ---- paths ----
    nlen = r.u64()
    names_blob = r.data[r.o:r.o + nlen].decode()
    r.o += nlen
    r.packed_vector()                    # per-char vector (unused)
    name_start = r.paged_vector()
    name_len = r.packed_vector()
    circular = r.packed_vector()
    deleted = r.packed_vector()
    head = r.paged_vector()
    r.paged_vector()                     # tail step (unused: we follow links)
    r.packed_vector()                    # per-path deleted-step count

    npaths = len(name_start)
    for pi in range(npaths):
        links = r.robust_vector()
        travs = r.robust_vector()
        if deleted[pi] if pi < len(deleted) else False:
            continue
        name = names_blob[name_start[pi]:name_start[pi] + name_len[pi]]
        steps = []
        rec = head[pi]
        guard = 0
        while rec:
            trav = travs[rec - 1]
            steps.append((trav >> 1, bool(trav & 1)))
            rec = links[2 * (rec - 1) + 1]
            guard += 1
            if guard > len(travs):
                raise RuntimeError("path step cycle")
        sample, hap = _path_identity(name)
        is_ref = (name in reference_names or sample in reference_names
                  or not reference_names)
        g.add_path(GfaPath(name=name, steps=steps, sample=sample,
                           haplotype=hap,
                           is_reference=is_ref))
        if circular[pi] if pi < len(circular) else False:
            pass  # circularity is implied by the step handles for our use

    return g
