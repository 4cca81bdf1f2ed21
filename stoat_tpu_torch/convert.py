"""Turn the reused host layer's numpy state into the port's tensors.

``stoat_tpu.tables.PackedChromosome`` (a chunk of one chromosome's snarls
resolved against its edge matrix) and the parsed binary phenotype are
numpy; the device stages take tensors.  Words travel as an int32 view of
the uint32 words, because PyTorch on the CPU has no uint32 shifts or
``index_select``; the bits are unchanged.  On a CUDA device each array is
staged in pinned host memory and copied without blocking.

The CPU tests feed the same numpy arrays to both packages through
:func:`to_device_chunk`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from stoat_tpu_torch.pipeline.packed import (pack_hap_mask_words,
                                             pack_matrix_words,
                                             pack_path_edge_idx,
                                             tail_mask_words)

__all__ = ["DeviceChunk", "upload", "upload_words", "chunk_words",
           "pheno_masks", "to_device_chunk"]


@dataclass
class DeviceChunk:
    """One chunk's inputs to the binary pipeline, on one device."""

    words: torch.Tensor           # int32 [E+1, W], last row all ones
    path_idx: torch.Tensor        # int32 [P, K], padding = row E
    path_valid: torch.Tensor      # bool [P]
    snarl_path_idx: torch.Tensor  # int32 [S, Pmax], -1 padding
    tail: torch.Tensor            # int32 [W], first H bits set
    g1_words: torch.Tensor        # int32 [W], case haplotypes


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a numpy array to ``device`` (pinned, non-blocking on CUDA)."""
    arr = np.ascontiguousarray(arr)
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


def to_device_chunk(packed, binary_phenotype: np.ndarray,
                    device: torch.device,
                    words: Optional[torch.Tensor] = None,
                    pheno: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> DeviceChunk:
    """A ``PackedChromosome`` plus its phenotype as a :class:`DeviceChunk`.

    ``words`` and ``pheno`` (from :func:`upload_words` and
    :func:`pheno_masks`) may be passed in when the caller shares them
    across chunks; otherwise they are built and uploaded here.  The path
    index comes from the native resolver when it made one, else from the
    COO lists (``pack_path_edge_idx``, padding = the identity row)."""
    device = torch.device(device)
    if words is None:
        words = upload_words(chunk_words(packed), device)
    n_words = int(words.shape[1])
    if pheno is None:
        pheno = pheno_masks(binary_phenotype, packed.n_haplotypes, n_words,
                            device)
    g1_words, tail = pheno
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
