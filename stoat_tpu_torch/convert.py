"""Turn the host layer's numpy state into the port's tensors.

``tables.PackedChromosome`` (a chunk of one chromosome's snarls resolved
against its edge matrix), the parsed phenotypes, the permutation test's
masks and phenotype rows and the native graph core's partition counts are
numpy; the device stages take tensors.  Words travel as an int32 view of
the uint32 words, because PyTorch on the CPU has no uint32 shifts or
``index_select``; the bits are unchanged.  On a CUDA device each array is
staged in pinned host memory and copied without blocking.

The CPU tests feed the same numpy arrays to both packages through
:func:`to_device_chunk`, :func:`to_quant_inputs`, :func:`to_perm_inputs`,
:func:`to_graph_counts`, :func:`to_lmm_inputs` and the eQTL uploads
(:func:`to_eqtl_expr`, :func:`to_eqtl_pairs`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from stoat_tpu_torch import trace
from stoat_tpu_torch.pipeline.packed import (pack_hap_mask_words,
                                             pack_matrix_words,
                                             pack_path_edge_idx,
                                             tail_mask_words)

__all__ = ["DeviceChunk", "upload", "upload_words", "chunk_words",
           "pheno_masks", "to_device_chunk", "to_covariates",
           "to_quant_inputs",
           "to_binary_pheno", "PermInputs", "to_perm_inputs",
           "to_graph_counts", "to_lmm_inputs", "to_eqtl_expr",
           "to_eqtl_pairs"]


@dataclass
class DeviceChunk:
    """One chunk's inputs to the device pipelines, on one device."""

    words: torch.Tensor           # int32 [E+1, W], last row all ones
    path_idx: torch.Tensor        # int32 [P, K], padding = row E
    path_valid: torch.Tensor      # bool [P]
    snarl_path_idx: torch.Tensor  # int32 [S, Pmax], -1 padding
    # binary mode only
    tail: Optional[torch.Tensor] = None      # int32 [W], first H bits set
    g1_words: Optional[torch.Tensor] = None  # int32 [W], case haplotypes


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a numpy array to ``device`` (pinned, non-blocking on CUDA);
    its bytes count as ``h2d_bytes``."""
    with trace.span("upload"):
        arr = np.ascontiguousarray(arr)
        trace.count("h2d_bytes", arr.nbytes)
        if device.type != "cuda":
            return torch.from_numpy(arr.copy())
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        staged = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
        staged.numpy()[...] = arr
        return staged.to(device, non_blocking=True)


def upload_words(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 [E+1, W] packed words -> int32 tensor on ``device``."""
    return upload(np.ascontiguousarray(words, np.uint32).view(np.int32),
                  device)


def chunk_words(packed) -> np.ndarray:
    """The chunk's uint32 [E+1, W] words: the native core's as they are,
    else packed on the host from the dense bool matrix."""
    if packed.words is not None:
        return packed.words
    return pack_matrix_words(packed.matrix)


def pheno_masks(binary_phenotype: np.ndarray, n_haplotypes: int,
                n_words: int, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g1_words, tail) int32 [W] each: the case mask of a per-sample
    phenotype expanded to diploid haplotype pairs, and the mask of the
    first ``n_haplotypes`` bits (stoat_tpu's upload_pheno_mask_words)."""
    g1 = pack_hap_mask_words(
        np.repeat(np.asarray(binary_phenotype).astype(bool), 2), n_words)
    tail = tail_mask_words(n_haplotypes, n_words)
    return (upload(g1.view(np.int32), device),
            upload(tail.view(np.int32), device))


def to_device_chunk(packed, binary_phenotype: Optional[np.ndarray],
                    device: torch.device,
                    words: Optional[torch.Tensor] = None,
                    pheno: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> DeviceChunk:
    """A ``PackedChromosome`` plus its phenotype as a :class:`DeviceChunk`.

    ``words`` and ``pheno`` (from :func:`upload_words` and
    :func:`pheno_masks`) may be passed in when the caller shares them
    across chunks; otherwise they are built and uploaded here.  Without
    a binary phenotype (``None``, the quantitative pipeline) the chunk
    carries no masks.  The path index comes from the native resolver when
    it made one, else from the COO lists (``pack_path_edge_idx``, padding
    = the identity row)."""
    device = torch.device(device)
    if words is None:
        words = upload_words(chunk_words(packed), device)
    if pheno is None and binary_phenotype is not None:
        pheno = pheno_masks(binary_phenotype, packed.n_haplotypes,
                            int(words.shape[1]), device)
    g1_words, tail = pheno if pheno is not None else (None, None)
    path_idx = packed.path_idx
    if path_idx is None:
        path_idx = pack_path_edge_idx(packed.coo_path, packed.coo_row,
                                      packed.path_valid, packed.n_rows)
    return DeviceChunk(
        words=words,
        path_idx=upload(np.asarray(path_idx, np.int32), device),
        path_valid=upload(np.asarray(packed.path_valid, bool), device),
        snarl_path_idx=upload(np.asarray(packed.snarl_path_idx, np.int32),
                              device),
        tail=tail,
        g1_words=g1_words,
    )


def to_covariates(covar: Optional[np.ndarray], n_samples: int,
                  device: torch.device) -> torch.Tensor:
    """The parsed covariate table as float64 [N, C] on ``device``; [N, 0]
    when there is none."""
    if covar is None:
        covar = np.zeros((n_samples, 0), np.float64)
    return upload(np.asarray(covar, np.float64), device)


def to_quant_inputs(phenotype: np.ndarray, covar: Optional[np.ndarray],
                    n_samples: int, device: torch.device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(phenotype float64 [N], covariates float64 [N, C]) on ``device``,
    from the parsed quantitative phenotype and covariate table
    (:func:`to_covariates`)."""
    return (upload(np.asarray(phenotype, np.float64), device),
            to_covariates(covar, n_samples, device))


def to_lmm_inputs(lmm_ctx, covar: Optional[np.ndarray], n_samples: int,
                  device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rot float64 [N, N], y_rot [N], covariates [N, C]) on ``device``:
    the mixed model's rotation and rotated phenotype (an
    ``stats.lmm.LmmContext``), uploaded once per run, and the design's
    covariates ([N, 0] when there are none)."""
    return (upload(np.asarray(lmm_ctx.rot, np.float64), device),
            *to_quant_inputs(lmm_ctx.y_rot, covar, n_samples, device))


def to_eqtl_expr(gene_list: Sequence, device: torch.device
                 ) -> torch.Tensor:
    """float64 [G, N] expression of a chromosome's genes (the
    ``io.phenotype.QtlData`` list, in its order) on ``device``, uploaded
    once per chromosome; pairs index its rows."""
    return upload(np.stack([np.asarray(g.sample_expression, np.float64)
                            for g in gene_list]), device)


def to_eqtl_pairs(pair_snarl: List[int], pair_gene: List[int],
                  n_snarls: int, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A chunk's (snarl, gene) pairs, given in (snarl, gene) order, as CSR
    by snarl on ``device``: (pair_off int32 [n_snarls + 1], pair_gene int32
    [B]); ``n_snarls`` counts the chunk's padded snarl slots."""
    counts = np.bincount(np.asarray(pair_snarl, np.int64),
                         minlength=n_snarls)
    off = np.zeros(n_snarls + 1, np.int32)
    np.cumsum(counts, dtype=np.int32, out=off[1:])
    return (upload(off, device),
            upload(np.asarray(pair_gene, np.int32), device))


def to_binary_pheno(binary_phenotype: np.ndarray,
                    device: torch.device) -> torch.Tensor:
    """The parsed binary phenotype (bool [N], True = case) as the float64
    [N] response of the logistic model, on ``device``."""
    return upload(np.asarray(binary_phenotype).astype(np.float64), device)


@dataclass
class PermInputs:
    """The permutation test's phenotype side, on one device; each field is
    None when the test does not use it."""

    masks: Optional[torch.Tensor] = None   # int32 [K, W] case masks (-b)
    phenos: Optional[torch.Tensor] = None  # float64 [K, N] phenotypes (-q)
    Z: Optional[torch.Tensor] = None       # float64 [N, 1 + C] (-b -c)
    w: Optional[torch.Tensor] = None       # float64 [N] working weights
    e: Optional[torch.Tensor] = None       # float64 [K, N] residual rows


def to_perm_inputs(device: torch.device,
                   masks: Optional[np.ndarray] = None,
                   phenos: Optional[np.ndarray] = None,
                   Z: Optional[np.ndarray] = None,
                   w: Optional[np.ndarray] = None,
                   e: Optional[np.ndarray] = None) -> PermInputs:
    """:class:`PermInputs` on ``device`` from the numpy rows the host
    builds (pipeline/permutation.py): the uint32 packed case masks as an
    int32 view, like the words, and the rest as float64."""
    device = torch.device(device)

    def f64(a):
        return None if a is None else upload(np.asarray(a, np.float64),
                                             device)
    return PermInputs(
        masks=None if masks is None else upload(
            np.ascontiguousarray(masks, np.uint32).view(np.int32), device),
        phenos=f64(phenos), Z=f64(Z), w=f64(w), e=f64(e))


def to_graph_counts(kinds: np.ndarray, part_offs: np.ndarray,
                    g0: np.ndarray, g1: np.ndarray, device: torch.device
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               np.ndarray]:
    """The native graph prepare's ragged partition counts as ``(G0, G1,
    mask, k)``: int32 [B, Pmax] control and case counts and bool [B,
    Pmax] column mask on ``device``, one row per tested snarl (``kinds ==
    1``) in walk order, and the host int64 [B] partition counts k.

    Snarl i's partitions are ``g0/g1[part_offs[i]:part_offs[i + 1]]``.
    Pmax is max(k, 2): the 2x2 tests read two columns, and masked columns
    add nothing.  The counts are sample tallies; a count of 2^31 or more
    raises rather than wrapping (stoat_tpu/graph/association.py:529-547)."""
    tested = np.flatnonzero(np.asarray(kinds) == 1)
    lo = np.asarray(part_offs, np.int64)[tested]
    k = np.asarray(part_offs, np.int64)[tested + 1] - lo
    top = max(int(np.max(g0, initial=0)), int(np.max(g1, initial=0)))
    if top >= 2 ** 31:
        raise ValueError(f"partition count {top} does not fit in int32")
    pmax = max(2, int(k.max(initial=0)))
    col = np.arange(pmax)
    mask = col[None, :] < k[:, None]
    src = (lo[:, None] + col[None, :])[mask]
    G0 = np.zeros((len(tested), pmax), np.int32)
    G1 = np.zeros((len(tested), pmax), np.int32)
    G0[mask] = np.asarray(g0)[src]
    G1[mask] = np.asarray(g1)[src]
    return (upload(G0, device), upload(G1, device), upload(mask, device), k)
