"""The snarl mesh and the snarl-axis split of a chromosome's snarls.

The port of stoat_tpu/parallel/mesh.py.  Its layout:
  - a 1-D mesh over devices, axis name "snarls" (:class:`SnarlMesh`, an
    ordered tuple of ``torch.device``; a device may appear more than once)
  - each shard a contiguous block of ceil(S / D) snarls, its path tables
    stacked on a leading shard axis
  - the edge x haplotype words, phenotype and covariates replicated
  - results are independent per snarl: the only data that crosses devices
    is the gather of each shard's outputs to the host.

Every shard is padded to the same power-of-two shapes (snarl, path, COO
and edge axes), as in the JAX package, where one compiled program served
every device; here each shard runs the single-device kernels on its own
device (parallel/sharded.py).  The arrays stay numpy on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stoat_tpu_torch.device import resolve_device
from stoat_tpu_torch.io.snarl_file import SnarlData
from stoat_tpu_torch.tables import (PackedChromosome, ResolvedPaths,
                                    _pack_from_resolved, next_pow2,
                                    repad_for_coo_collision,
                                    resolve_chromosome)

__all__ = ["SnarlMesh", "make_snarl_mesh", "resolve_mesh",
           "shard_packed_chromosome", "shard_chromosome_chunks",
           "ShardedChromosome"]


@dataclass(frozen=True)
class SnarlMesh:
    """A 1-D mesh over the snarl axis: shard d runs on ``devices[d]``."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "snarls"

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in mesh order: a replicated
        input is held once on each of them."""
        return tuple(dict.fromkeys(self.devices))


def make_snarl_mesh(devices: Optional[Sequence] = None) -> SnarlMesh:
    """A 1-D mesh over the snarl axis: ``devices`` (names or
    ``torch.device``; one may be named more than once), by default every
    visible CUDA card.

    Without a card the default raises, as ``device.resolve_device`` does:
    a mesh never quietly becomes the CPU.  A CPU mesh is asked for by
    name, e.g. ``[torch.device("cpu")] * 8``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a mesh over the CUDA devices was requested but no CUDA "
                "device is available; name the mesh's devices to run on "
                "the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return SnarlMesh(tuple(devices))


def resolve_mesh(device, mesh: Optional[SnarlMesh] = None
                 ) -> Optional[SnarlMesh]:
    """The mesh of a run, or None for one device (the rule of
    pipeline/runner.py run_vcf_analysis and pipeline/permutation.py
    run_permutation_test): ``mesh`` when given; else every visible card
    when ``device`` is a bare ``cuda`` (no index) and more than one card
    is visible.  ``cuda:N`` is that card alone and ``cpu`` the CPU
    alone."""
    if mesh is not None:
        return mesh
    if device is not None:
        dev = torch.device(device)
        if (dev.type == "cuda" and dev.index is None
                and torch.cuda.is_available()
                and torch.cuda.device_count() > 1):
            return make_snarl_mesh()
    return None


@dataclass
class ShardedChromosome:
    """Per-shard stacked arrays: leading axis = shard.

    The edge x haplotype matrix is carried bit-packed (``words``, uint32
    [E+1, W] in the kernels' layout, replicated across shards) and each
    shard's path -> edge-row references are pre-padded [P, K] indices into
    it (``path_idx``, padding = the AND-identity row E).  The COO arrays
    are kept for callers that build their own layouts; the dense bool
    matrix is derived lazily."""

    words: np.ndarray             # [E+1, W] uint32 (replicated)
    n_haps: int                   # real haplotype count
    path_idx: np.ndarray          # [D, P, K] int32 — rows per path
    coo_path: np.ndarray          # [D, nnz]
    coo_row: np.ndarray           # [D, nnz]
    n_edges_per_path: np.ndarray  # [D, P]
    path_valid: np.ndarray        # [D, P]
    snarl_path_idx: np.ndarray    # [D, S_local, Pmax]
    n_snarls: int                 # real total snarls
    snarls: List[SnarlData]
    shard_sizes: List[int]        # real snarls per shard
    _dense: Optional[np.ndarray] = None

    @property
    def n_shards(self) -> int:
        return self.coo_path.shape[0]

    @property
    def paths_per_shard(self) -> int:
        return self.n_edges_per_path.shape[1]

    @property
    def matrix(self) -> np.ndarray:
        """Dense bool [E, H] view (lazy; prefer ``words``)."""
        if self._dense is None:
            from stoat_tpu_torch.pipeline.packed import unpack_words_to_dense
            self._dense = unpack_words_to_dense(self.words, self.n_haps)
        return self._dense


def shard_packed_chromosome(snarls: Sequence[SnarlData], edge_matrix,
                            n_shards: int) -> ShardedChromosome:
    """Split a chromosome's snarls into contiguous per-device chunks and
    pack each with identical padded shapes (stoat_tpu's, :85-161; the
    paths resolve once for all shards, each shard slices them)."""
    snarls = list(snarls)
    resolved = resolve_chromosome(snarls, edge_matrix) if snarls else None
    return _shard_resolved(resolved, snarls, 0, len(snarls), edge_matrix,
                           _matrix_words(edge_matrix), n_shards)


def shard_chromosome_chunks(snarls: Sequence[SnarlData], edge_matrix,
                            chunk_size: int, n_shards: int,
                            quad_cache=None) -> Iterator[ShardedChromosome]:
    """A chromosome's snarls in chunks of ``chunk_size``, each split over
    ``n_shards`` as :func:`shard_packed_chromosome` splits it.  As
    ``tables.pack_chromosome_chunks`` does for one device, the paths
    resolve once for the chromosome (``quad_cache``: its
    ``tokenize_chromosome`` result, if made already) and the words are
    taken once: every chunk carries the same ``words`` array."""
    snarls = list(snarls)
    if not snarls:
        return
    resolved = resolve_chromosome(snarls, edge_matrix, cache=quad_cache)
    words = _matrix_words(edge_matrix)
    for lo in range(0, len(snarls), chunk_size):
        yield _shard_resolved(resolved, snarls, lo,
                              min(lo + chunk_size, len(snarls)),
                              edge_matrix, words, n_shards)


def _matrix_words(edge_matrix) -> np.ndarray:
    """The chromosome's bit-packed words: straight from a native
    PackedEdgeMatrix, else packed on the host from the dense bool
    matrix."""
    words = getattr(edge_matrix, "words", None)
    if words is None:
        from stoat_tpu_torch.pipeline.packed import pack_matrix_words
        matrix = edge_matrix.shrink()
        if matrix.shape[0] == 0:
            matrix = np.zeros((1, matrix.shape[1]), bool)
        words = pack_matrix_words(matrix)
    return words


def _shard_resolved(resolved: Optional[ResolvedPaths],
                    chrom_snarls: List[SnarlData], s_lo: int, s_hi: int,
                    edge_matrix, words: np.ndarray,
                    n_shards: int) -> ShardedChromosome:
    """Split snarls [s_lo, s_hi) of a resolved chromosome over
    ``n_shards`` and pad every shard to common shapes."""
    snarls = chrom_snarls[s_lo:s_hi]
    S_real = len(snarls)
    per = -(-max(S_real, 1) // n_shards)  # ceil
    bounds = [(min(i * per, S_real), min((i + 1) * per, S_real))
              for i in range(n_shards)]
    packs: List[Optional[PackedChromosome]] = [
        _pack_from_resolved(resolved, snarls[lo:hi], edge_matrix,
                            s_lo + lo, s_lo + hi, pad_snarls=False)
        if hi > lo else None
        for lo, hi in bounds]

    # common padded shapes across shards
    S_local = next_pow2(per)
    Pmax = next_pow2(max((p.snarl_path_idx.shape[1] for p in packs
                          if p is not None), default=2))
    P = next_pow2(max((p.n_edges_per_path.shape[0] for p in packs
                       if p is not None), default=1))
    nnz = next_pow2(max((p.coo_path.shape[0] for p in packs
                         if p is not None), default=1))
    P = repad_for_coo_collision(P, nnz, packs)

    def pad_shard(p: Optional[PackedChromosome]):
        coo_p = np.full(nnz, P - 1, np.int32)
        coo_r = np.zeros(nnz, np.int32)
        n_e = np.zeros(P, np.int32)
        valid = np.zeros(P, bool)
        idx = np.full((S_local, Pmax), -1, np.int32)
        if p is not None:
            n = p.coo_path.shape[0]
            coo_p[:n] = p.coo_path
            coo_r[:n] = p.coo_row
            # re-point this shard's own COO padding at the common slot
            coo_p[coo_p >= p.n_paths] = P - 1
            n_e[: p.n_edges_per_path.shape[0]] = p.n_edges_per_path
            valid[: p.path_valid.shape[0]] = p.path_valid
            valid[p.n_paths:] = False
            s, pm = p.snarl_path_idx.shape
            idx[:s, :pm] = p.snarl_path_idx
        return coo_p, coo_r, n_e, valid, idx

    padded = [pad_shard(p) for p in packs]

    n_rows = words.shape[0] - 1

    # per-shard [P, K] path -> edge-row indices with one K across shards
    # (pack_path_edge_idx rounds K to a power of two; the shards agree by
    # taking the largest)
    from stoat_tpu_torch.pipeline.packed import pack_path_edge_idx
    idx_shards = [pack_path_edge_idx(x[0], x[1], x[3], n_rows)
                  for x in padded]
    K = max(ix.shape[1] for ix in idx_shards)
    path_idx = np.stack([
        np.pad(ix, ((0, 0), (0, K - ix.shape[1])),
               constant_values=n_rows) for ix in idx_shards])

    return ShardedChromosome(
        words=words,
        n_haps=edge_matrix.n_haplotypes,
        path_idx=path_idx,
        coo_path=np.stack([x[0] for x in padded]),
        coo_row=np.stack([x[1] for x in padded]),
        n_edges_per_path=np.stack([x[2] for x in padded]),
        path_valid=np.stack([x[3] for x in padded]),
        snarl_path_idx=np.stack([x[4] for x in padded]),
        n_snarls=S_real,
        snarls=snarls,
        shard_sizes=[hi - lo for lo, hi in bounds],
    )
