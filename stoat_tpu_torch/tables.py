"""Ragged→dense packing of snarl paths for the batched device pipeline.

The reference tests snarls one at a time (identify_path bit scans per path,
snarl_analyzer.cpp:315-356).  Here a whole chromosome's snarls are packed
into padded tensors once:

  - every snarl path becomes a row in a flat path table; its graph edges
    (skipping ``*``/node-0 edges, snarl_analyzer.cpp:328-330) are resolved
    against the chromosome's edge matrix into a COO (path, edge-row) list;
  - haplotype membership for ALL paths is then a single segment-sum +
    compare on device: a haplotype takes a path iff it has every edge
    (counts == n_edges), with zero-edge paths matching every haplotype and
    paths with unresolved edges matching none (identify_path's early-abort,
    snarl_analyzer.cpp:334-336);
  - per-snarl tables are padded [n_snarls, max_paths] gathers over the flat
    path axis.

Shapes are padded to powers of two, so the chunks of a run share one shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from stoat_tpu_torch.io.snarl_file import SnarlData, path_to_edges
from stoat_tpu_torch.matrix import EdgeHaplotypeMatrix

__all__ = ["PackedChromosome", "pack_chromosome", "pack_chromosome_chunks",
           "tokenize_chromosome", "next_pow2", "repad_for_coo_collision"]


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def repad_for_coo_collision(P: int, nnz: int, packs) -> int:
    """Grow the common path dimension if COO padding would collide.

    COO padding entries target slot ``P - 1``, which must be an INVALID
    path slot on every chunk/shard: if any pack's real path count fills
    the common ``P`` exactly (its own pow2 padding added no scratch)
    while the common ``nnz`` adds padding entries, those pads would be
    attributed to a real path and AND edge row 0 into its membership —
    silently wrong p-values (regression-pinned in
    tests/test_edge_cases.py).  ``packs`` may contain ``None`` entries
    (empty shards)."""
    if any(p is not None and p.n_paths >= P
           and nnz > p.coo_path.shape[0] for p in packs):
        return next_pow2(P + 1)
    return P


@dataclass
class PackedChromosome:
    """Dense batch of one chromosome's snarls against its edge matrix.

    Carries the edge×haplotype matrix in one (or both) of two layouts:
    ``matrix`` — dense bool [E, H] — and ``words`` — bit-packed uint32
    [E+1, W] in the device kernels' layout (pipeline/packed.py: 32
    haplotypes/word, little bit order, trailing all-ones AND-identity
    row).  When the native VCF core ingests, only ``words`` exists and
    the dense view is derived lazily (and vice versa for the Python
    reader), so the hot packed pipeline never pays a host unpack/repack.
    """

    matrix: Optional[np.ndarray]  # [E, H] bool (None if words-only)
    coo_path: np.ndarray        # [nnz] int32 — flat path index per edge ref
    coo_row: np.ndarray         # [nnz] int32 — edge matrix row per edge ref
    n_edges_per_path: np.ndarray  # [P] int32 (star edges excluded)
    path_valid: np.ndarray      # [P] bool — False if any edge unresolved
    snarl_path_idx: np.ndarray  # [S, Pmax] int32, -1 padding
    snarl_mask: np.ndarray      # [S] bool — False for padded snarl slots
    n_paths: int                # real flat path count (pre-padding)
    n_snarls: int               # real snarl count
    snarls: List[SnarlData]     # host-side metadata, real snarls only
    words: Optional[np.ndarray] = None  # [E+1, W] uint32 (see above)
    n_haps: int = -1            # set when matrix is None
    # pack-ready [P, K] int32 path→edge-row indices from the fused native
    # resolver (padding = n_rows = the AND-identity row); None when the
    # chromosome was resolved without it — consumers call path_edge_idx()
    path_idx: Optional[np.ndarray] = None

    def path_edge_idx(self) -> np.ndarray:
        """The padded [P, K] edge-row index matrix for the packed kernels
        (pack_path_edge_idx contract: padding entries point at the
        AND-identity row)."""
        if self.path_idx is not None:
            return self.path_idx
        from stoat_tpu_torch.pipeline.packed import pack_path_edge_idx
        return pack_path_edge_idx(self.coo_path, self.coo_row,
                                  self.path_valid, self.n_rows)

    @property
    def n_haplotypes(self) -> int:
        if self.matrix is not None:
            return self.matrix.shape[1]
        return self.n_haps

    @property
    def n_rows(self) -> int:
        """Real edge rows (excluding the words' AND-identity row)."""
        if self.matrix is not None:
            return self.matrix.shape[0]
        return self.words.shape[0] - 1

    def dense_matrix(self) -> np.ndarray:
        """The bool [E, H] matrix, unpacking from words if needed."""
        if self.matrix is None:
            from stoat_tpu_torch.pipeline.packed import unpack_words_to_dense
            self.matrix = unpack_words_to_dense(self.words, self.n_haps)
        return self.matrix

    def packed_words(self) -> np.ndarray:
        """The uint32 [E+1, W] packed words, packing from dense if needed."""
        if self.words is None:
            from stoat_tpu_torch.pipeline.packed import pack_matrix_words
            self.words = pack_matrix_words(self.matrix)
        return self.words


def tokenize_chromosome(snarls: Sequence[SnarlData]):
    """Prepare a chromosome's snarl paths for resolution (cacheable).

    Returns ``(blob, n_per, offsets)``: all path strings comma-joined
    (the native resolver's input — and the numpy tokenizer's), per-snarl
    path counts, and their cumulative offsets.  Cheap and pure-host —
    safe to run on a background thread overlapped with VCF ingestion.
    Returns None when a snarl's cached path strings are out of sync with
    its parsed tuples (callers fall back to the per-chunk tuple walk).
    """
    n_per = np.fromiter((len(s.path_strings) for s in snarls),
                        np.int64, len(snarls))
    n_tup = np.fromiter((s.n_paths for s in snarls),
                        np.int64, len(snarls))
    if not np.array_equal(n_per, n_tup):
        return None
    try:
        # file-loaded snarls carry the raw PATHS column: one join per
        # snarl instead of one per path
        blob = ",".join(s.raw_paths for s in snarls)
    except TypeError:
        blob = ",".join(p for s in snarls for p in s.path_strings)
    offsets = np.zeros(len(snarls) + 1, np.int64)
    np.cumsum(n_per, out=offsets[1:])
    return blob, n_per, offsets


class ResolvedPaths:
    """A chromosome's snarl paths resolved against its edge matrix.

    Per-path edge rows in COO form (sorted by path), resolvable once per
    chromosome and sliced per chunk."""

    __slots__ = ("coo_path", "coo_row", "n_edges", "valid", "n_per",
                 "offsets", "idx")

    def __init__(self, coo_path, coo_row, n_edges, valid, n_per, offsets,
                 idx=None):
        self.coo_path = coo_path    # [nnz] int64, nondecreasing
        self.coo_row = coo_row      # [nnz] int32
        self.n_edges = n_edges      # [P] int32
        self.valid = valid          # [P] bool
        self.n_per = n_per          # [S] int64
        self.offsets = offsets      # [S+1] int64 path offsets
        # optional pack-ready [P, K] int32 edge-row indices from the
        # fused native resolver (padding = matrix n_rows); when present,
        # pack_path_edge_idx becomes pure slicing
        self.idx = idx


def resolve_chromosome(snarls: Sequence[SnarlData], edge_matrix,
                       cache=None) -> ResolvedPaths:
    """Resolve every snarl path of a chromosome to edge-matrix rows.

    Prefers the native C++ resolver (tokenize + open-addressed edge
    lookup in one pass, stoat_core.cpp stoat_resolve_paths); falls back
    to the numpy blob tokenizer + vectorized sorted-key lookup, then to
    the scalar tuple walk.  Semantics in all three: '*' (node-0) edges
    skipped, unknown edges invalidate the whole path
    (snarl_analyzer.cpp:326-336)."""
    if cache is None:
        cache = tokenize_chromosome(snarls)

    if cache is not None:
        blob, n_per, offsets = cache
        flat_index = int(offsets[-1])
        # Fastest path: the fused resolver bound to the native chunk's
        # own edge table (no rebuild) that also emits the pack-ready
        # padded [P, K] index matrix.
        fused = getattr(edge_matrix, "resolve_idx_native", None)
        if fused is not None and flat_index > 0:
            got = fused(blob)
            if got is not None and got[2].shape[0] == flat_index + 1:
                idx, rows, offs, valid = got
                n_edges = np.diff(offs).astype(np.int32)
                coo_path = np.repeat(
                    np.arange(flat_index, dtype=np.int64),
                    n_edges)
                return ResolvedPaths(coo_path, rows.astype(np.int32),
                                     n_edges, valid.astype(bool),
                                     n_per, offsets, idx=idx)
        edges_arr = getattr(edge_matrix, "_edges_arr", None)
        if edges_arr is None:
            to_arr = getattr(edge_matrix, "edges_array", None)
            if to_arr is not None:
                edges_arr = to_arr()
        if edges_arr is not None and flat_index > 0:
            from stoat_tpu_torch.native import resolve_paths_native
            got = resolve_paths_native(edges_arr, blob)
            if got is not None and got[1].shape[0] == flat_index + 1:
                rows, offs, valid = got
                n_edges = np.diff(offs).astype(np.int32)
                coo_path = np.repeat(
                    np.arange(flat_index, dtype=np.int64),
                    n_edges)
                return ResolvedPaths(coo_path, rows.astype(np.int32),
                                     n_edges, valid.astype(bool),
                                     n_per, offsets)
        # numpy fallback: tokenize the blob, vectorized lookup
        got = _quads_from_blob(blob, n_per)
        if got is not None:
            return _resolve_quads(got, edge_matrix, n_per, offsets)

    got = _quads_from_tuples(snarls)
    n_per = got[3]
    offsets = np.zeros(len(snarls) + 1, np.int64)
    np.cumsum(n_per, out=offsets[1:])
    return _resolve_quads(got, edge_matrix, n_per, offsets)


def _resolve_quads(got, edge_matrix, n_per, offsets) -> ResolvedPaths:
    quads_arr, key_path_arr, flat_index, _ = got
    rows = edge_matrix.resolve_edges(quads_arr)
    path_ok = np.ones(max(flat_index, 1), bool)
    path_ok[key_path_arr[rows < 0]] = False
    keep = (path_ok[key_path_arr] if key_path_arr.size else
            np.zeros(0, bool))
    coo_path = key_path_arr[keep]
    coo_row = rows[keep].astype(np.int32)
    n_edges = np.bincount(coo_path, minlength=max(flat_index, 1)
                          ).astype(np.int32)[:flat_index]
    return ResolvedPaths(coo_path, coo_row, n_edges,
                         path_ok[:flat_index], n_per, offsets)


def pack_chromosome_chunks(snarls: Sequence[SnarlData], edge_matrix,
                           chunk_size: int,
                           quad_cache=None) -> List["PackedChromosome"]:
    """Pack a chromosome's snarls in chunks with UNIFORM padded shapes.

    Every chunk gets the same (S, Pmax, P, nnz) padding, so the device
    stages see one shape per mode.  The paths resolve ONCE
    per chromosome (natively where possible) and each chunk slices the
    resolved COO; ``quad_cache`` (from ``tokenize_chromosome``, possibly
    computed on a background thread while the VCF streamed in) feeds the
    resolver.
    """
    resolved = resolve_chromosome(snarls, edge_matrix, cache=quad_cache)
    chunks = [list(snarls[lo:lo + chunk_size])
              for lo in range(0, len(snarls), chunk_size)]
    if not chunks:
        return []
    packs = [_pack_from_resolved(resolved, c, edge_matrix, lo,
                                 min(lo + chunk_size, len(snarls)))
             for lo, c in zip(range(0, len(snarls), chunk_size), chunks)]
    S = max(p.snarl_path_idx.shape[0] for p in packs)
    Pmax = max(p.snarl_path_idx.shape[1] for p in packs)
    P = max(p.n_edges_per_path.shape[0] for p in packs)
    nnz = max(p.coo_path.shape[0] for p in packs)
    P = repad_for_coo_collision(P, nnz, packs)

    out = []
    for p in packs:
        s0, pm0 = p.snarl_path_idx.shape
        idx = np.full((S, Pmax), -1, np.int32)
        idx[:s0, :pm0] = p.snarl_path_idx
        mask = np.zeros(S, bool)
        mask[: p.n_snarls] = True
        n_e = np.zeros(P, np.int32)
        n_e[: p.n_edges_per_path.shape[0]] = p.n_edges_per_path
        valid = np.zeros(P, bool)
        valid[: p.path_valid.shape[0]] = p.path_valid
        valid[p.n_paths:] = False
        coo_p = np.full(nnz, P - 1, np.int32)
        coo_r = np.zeros(nnz, np.int32)
        n0 = p.coo_path.shape[0]
        coo_p[:n0] = p.coo_path
        # repoint this pack's own padding at the common padded slot
        coo_p[coo_p >= p.n_paths] = P - 1
        coo_r[:n0] = p.coo_row
        path_idx = p.path_idx
        if path_idx is not None and path_idx.shape[0] != P:
            # repad the path axis to the common P (padding rows point at
            # the AND-identity row, matrix row E)
            grown = np.full((P, path_idx.shape[1]),
                            np.int32(edge_matrix.n_rows), np.int32)
            grown[: path_idx.shape[0]] = path_idx
            path_idx = grown
        out.append(PackedChromosome(
            matrix=p.matrix, coo_path=coo_p, coo_row=coo_r,
            n_edges_per_path=n_e, path_valid=valid, snarl_path_idx=idx,
            snarl_mask=mask, n_paths=p.n_paths, n_snarls=p.n_snarls,
            snarls=p.snarls, words=p.words, n_haps=p.n_haps,
            path_idx=path_idx))
    return out


def _quads_from_blob(blob: str, n_per: np.ndarray):
    """Tokenize a chromosome's `,`-joined path-string blob with numpy.

    Fallback for when the native resolver is unavailable: vectorized
    byte ops — `<`/`>` token starts and a reduceat-based integer decode.
    Returns ``(quads, key_path, flat_index, n_per)`` with identical
    semantics to the tuple walk (node-0 ``*`` edges skipped,
    snarl_analyzer.cpp:328-330), or ``None`` when the blob contains
    characters the scalar parser treats specially (callers then use the
    tuple walk)."""
    flat_index = int(np.sum(n_per))
    try:
        b = np.frombuffer(blob.encode("ascii"), np.uint8)
    except UnicodeEncodeError:
        return None
    empty = (np.zeros((0, 4), np.uint64), np.zeros(0, np.int64),
             flat_index, n_per)
    if b.size == 0:
        return empty
    digit = (b >= 48) & (b <= 57)
    is_open = (b == 62) | (b == 60)                      # '>' / '<'
    if not bool(np.all(digit | is_open | (b == 44))):    # stray chars
        return None
    # every digit RUN must start immediately after '<'/'>' — a bare
    # digit at a path start (e.g. ',67>8') would otherwise splice into
    # the previous token's decode and corrupt its node id (the scalar
    # walk handles such malformed strings; fall back to it)
    run_start = digit.copy()
    run_start[1:] &= ~digit[:-1]
    bad = run_start.copy()
    bad[1:] &= ~is_open[:-1]
    if bool(bad[0]) or bool(np.any(bad)):
        return None
    starts = np.flatnonzero(is_open)
    if starts.size == 0:
        return empty
    # end of each token's digit run = first non-digit char after its open
    nondigit_pos = np.flatnonzero(~digit)
    ends_idx = np.searchsorted(nondigit_pos, starts, side="right")
    ends = np.where(ends_idx < nondigit_pos.size,
                    nondigit_pos[np.minimum(ends_idx,
                                            nondigit_pos.size - 1)],
                    b.size)
    if int((ends - starts).max()) > 19:                  # >18 digits: int64
        return None
    tok_of_char = np.cumsum(is_open) - 1
    exp = np.where(digit, ends[np.maximum(tok_of_char, 0)] - 1
                   - np.arange(b.size), 0)
    # table lookup: elementwise integer 10**exp is ~10x slower
    pow10 = 10 ** np.arange(20, dtype=np.int64)
    contrib = np.where(digit, b - 48, 0).astype(np.int64) * pow10[exp]
    node_ids = np.add.reduceat(contrib, starts).astype(np.uint64)
    revs = (b[starts] == 60).astype(np.uint64)           # '<'
    path_of_tok = np.searchsorted(np.flatnonzero(b == 44), starts)
    same = path_of_tok[1:] == path_of_tok[:-1]
    keep = same & (node_ids[1:] != 0) & (node_ids[:-1] != 0)
    quads = np.empty((int(keep.sum()), 4), np.uint64)
    quads[:, 0] = node_ids[:-1][keep]
    quads[:, 1] = revs[:-1][keep]
    quads[:, 2] = node_ids[1:][keep]
    quads[:, 3] = revs[1:][keep]
    key_path = path_of_tok[:-1][keep].astype(np.int64)
    return quads, key_path, flat_index, n_per


def _quads_from_tuples(snarls: Sequence[SnarlData]):
    """Scalar tuple-walk fallback (same outputs as the blob tokenizer)."""
    flat_q: List[int] = []          # 4 ints per candidate edge
    counts: List[int] = []          # emitted-edge count per flat path
    q_append = flat_q.append
    flat_index = 0
    n_per = np.empty(len(snarls), np.int64)
    for i, snarl in enumerate(snarls):
        for path in snarl.paths:
            c = 0
            prev = None
            for node in path:
                if prev is not None and prev[0] != 0 and node[0] != 0:
                    q_append(prev[0])
                    q_append(prev[1])
                    q_append(node[0])
                    q_append(node[1])
                    c += 1
                prev = node
            counts.append(c)
            flat_index += 1
        n_per[i] = len(snarl.paths)
    quads = np.array(flat_q, np.uint64).reshape(-1, 4)
    key_path = np.repeat(np.arange(flat_index, dtype=np.int64),
                         np.array(counts, np.int64))
    return quads, key_path, flat_index, n_per


def pack_chromosome(snarls: Sequence[SnarlData],
                    edge_matrix: EdgeHaplotypeMatrix,
                    pad_snarls: bool = True,
                    cache=None) -> PackedChromosome:
    """Resolve snarl paths against the chromosome edge matrix and pack.

    Resolution runs once for the whole chromosome (natively where
    possible — ``resolve_chromosome``); ``cache`` optionally supplies a
    precomputed ``tokenize_chromosome`` result."""
    resolved = resolve_chromosome(snarls, edge_matrix, cache=cache)
    return _pack_from_resolved(resolved, list(snarls), edge_matrix,
                               0, len(snarls), pad_snarls=pad_snarls)


def _pack_from_resolved(resolved: ResolvedPaths, snarls: List[SnarlData],
                        edge_matrix, s_lo: int, s_hi: int,
                        pad_snarls: bool = True) -> PackedChromosome:
    """Pad one snarl range of a resolved chromosome into device tensors."""
    p_lo = int(resolved.offsets[s_lo])
    p_hi = int(resolved.offsets[s_hi])
    flat_index = p_hi - p_lo
    lo, hi = np.searchsorted(resolved.coo_path, [p_lo, p_hi])
    coo_path = resolved.coo_path[lo:hi] - p_lo
    coo_row = resolved.coo_row[lo:hi]
    n_edges = resolved.n_edges[p_lo:p_hi]
    valid = resolved.valid[p_lo:p_hi]
    n_per_snarl = resolved.n_per[s_lo:s_hi]
    max_paths = max(2, int(n_per_snarl.max()) if n_per_snarl.size else 2)

    P = next_pow2(max(flat_index, 1))
    Pmax = next_pow2(max_paths)
    S_real = len(snarls)
    S = next_pow2(max(S_real, 1)) if pad_snarls else max(S_real, 1)

    n_edges_arr = np.zeros(P, np.int32)
    n_edges_arr[:flat_index] = n_edges
    valid_arr = np.zeros(P, bool)
    valid_arr[:flat_index] = valid
    # Padded path slots are invalid: they match no haplotype.

    idx = np.full((S, Pmax), -1, np.int32)
    if flat_index:
        snarl_start = np.zeros(S_real + 1, np.int64)
        np.cumsum(n_per_snarl, out=snarl_start[1:])
        rowi = np.repeat(np.arange(S_real), n_per_snarl)
        coli = np.arange(flat_index) - snarl_start[rowi]
        idx[rowi, coli] = np.arange(flat_index, dtype=np.int32)
    mask = np.zeros(S, bool)
    mask[:S_real] = True

    nnz = len(coo_path)
    nnz_pad = next_pow2(max(nnz, 1))
    coo_path_arr = np.full(nnz_pad, P - 1, np.int32)
    coo_row_arr = np.zeros(nnz_pad, np.int32)
    coo_path_arr[:nnz] = coo_path
    coo_row_arr[:nnz] = coo_row
    # Padding COO entries point at the last (padded, invalid) path slot and
    # edge row 0; they inflate that slot's count but it is already invalid.
    # Guard: if P-1 is a real path (flat_index == P), add a scratch row.
    if flat_index == P and nnz_pad > nnz:
        # extend path axis by one padded slot
        P += 1
        n_edges_arr = np.append(n_edges_arr, np.int32(0))
        valid_arr = np.append(valid_arr, False)
        coo_path_arr[nnz:] = P - 1

    # Slice the fused resolver's pack-ready indices for this snarl range
    # (padding rows point at the AND-identity row, matrix row E).
    path_idx = None
    if resolved.idx is not None:
        K = resolved.idx.shape[1]
        path_idx = np.full((valid_arr.shape[0], K),
                           np.int32(edge_matrix.n_rows), np.int32)
        path_idx[:flat_index] = resolved.idx[p_lo:p_hi]

    # Matrix layout: a words-carrying source (PackedEdgeMatrix from the
    # native core) flows through bit-packed with no host unpack; the
    # Python reader's dense bool matrix flows through as-is.
    words = getattr(edge_matrix, "words", None)
    matrix = None
    n_haps = edge_matrix.n_haplotypes
    if words is None:
        matrix = edge_matrix.shrink()
        if matrix.shape[0] == 0:
            # no resolvable edges on this chromosome (e.g. AT-less
            # records): keep one all-zero row so device gathers stay in
            # bounds; every edge-bearing path is already invalid
            matrix = np.zeros((1, matrix.shape[1]), bool)

    return PackedChromosome(
        matrix=matrix,
        coo_path=coo_path_arr,
        coo_row=coo_row_arr,
        n_edges_per_path=n_edges_arr,
        path_valid=valid_arr,
        snarl_path_idx=idx,
        snarl_mask=mask,
        n_paths=flat_index,
        n_snarls=S_real,
        snarls=list(snarls),
        words=words,
        n_haps=n_haps,
        path_idx=path_idx,
    )
