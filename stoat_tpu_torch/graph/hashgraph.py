"""bdsg HashGraph (.hg) binary reader.

Native support for the vg ecosystem's HashGraph serialization (the format
the reference's test fixtures ship in), reverse-engineered from the
format itself and validated against the fixture zoo whose construction is
preserved in the reference's unit-test comments
(tests/unittest/path_partitioner_unit.cpp, snarl_data_t_unit.cpp).

Layout (all integers big-endian):

    magic  "(MO8"
    u64    max_node_id
    u64    min_node_id
    u64    next_path_id
    u64    node_count
    per node:
        u64 node_id
        u64 seq_len, seq bytes
        u64 left_edge_count,  u64 handle each   (handle = id<<1 | rev;
        u64 right_edge_count, u64 handle each    the neighbour reached
                                                 when leaving that side)
    u64    path_count
    per path:
        u8  is_circular
        u64 path_id
        u64 name_len, name bytes
        u64 step_count, u64 handle each

Right-side entries of node n are edges (n,+) -> handle; left-side entries
are edges (n,-) -> handle (each edge appears once per incident side).
"""

from __future__ import annotations

import struct
from typing import Optional, Set

from stoat_tpu_torch.graph.gfa import GfaGraph, GfaPath, _path_identity

__all__ = ["load_hg", "HASHGRAPH_MAGIC"]

HASHGRAPH_MAGIC = b"(MO8"


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.o = 0

    def u64(self) -> int:
        v = struct.unpack_from(">Q", self.data, self.o)[0]
        self.o += 8
        return v

    def u8(self) -> int:
        v = self.data[self.o]
        self.o += 1
        return v

    def bytes_(self, n: int) -> bytes:
        v = self.data[self.o:self.o + n]
        self.o += n
        return v


def load_hg(path: str,
            reference_names: Optional[Set[str]] = None) -> GfaGraph:
    """Parse a bdsg HashGraph file into a GfaGraph."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != HASHGRAPH_MAGIC:
        raise RuntimeError(
            f"{path}: not a HashGraph (magic {data[:4]!r})")
    r = _Reader(data)
    r.o = 4
    _max_id = r.u64()
    _min_id = r.u64()
    _next_path_id = r.u64()
    n_nodes = r.u64()

    g = GfaGraph()
    reference_names = reference_names or set()

    for _ in range(n_nodes):
        nid = r.u64()
        slen = r.u64()
        seq = r.bytes_(slen).decode()
        g.add_node(nid, seq)
        left_count = r.u64()
        lefts = [r.u64() for _ in range(left_count)]
        right_count = r.u64()
        rights = [r.u64() for _ in range(right_count)]
        for h in rights:
            g.add_edge((nid, False), (h >> 1, bool(h & 1)))
        for h in lefts:
            g.add_edge((nid, True), (h >> 1, bool(h & 1)))

    n_paths = r.u64()
    for _ in range(n_paths):
        _circular = r.u8()
        _pid = r.u64()
        name_len = r.u64()
        name = r.bytes_(name_len).decode()
        step_count = r.u64()
        steps = [(h >> 1, bool(h & 1))
                 for h in (r.u64() for _ in range(step_count))]
        sample, hap = _path_identity(name)
        is_ref = (name in reference_names or sample in reference_names
                  or not reference_names)
        g.add_path(GfaPath(name=name, steps=steps, sample=sample,
                           haplotype=hap, is_reference=is_ref))

    if r.o != len(data):
        raise RuntimeError(
            f"{path}: trailing bytes ({len(data) - r.o}) — "
            "unrecognized HashGraph variant")
    return g
