"""Bit-packed membership path: host packing helpers, K1+K2, and the plain
K1 and K7 that the quantitative design starts from.

The edge x haplotype matrix travels as uint32 words, 32 haplotypes per
word in little bit order (bit j of word w is haplotype 32*w + j), with a
trailing all-ones row: the AND identity that pads each path's edge list.
A path's membership is the AND of its edge rows; its binary carrier
counts are population counts of that membership against the packed case
mask.  This is stoat_tpu/pipeline/packed.py, whose layout it keeps.  On
the card the quantitative path never materialises the membership: K1 and
K7 are fused into csrc/quant_design.cu (pipeline/quantitative.py).

The numpy host helpers are copies of stoat_tpu/pipeline/packed.py:60-148;
the port's ``tables.py`` and ``matrix.py`` call them where the JAX
package's call its own module.

On the device the port holds words as an int32 view of the uint32 words:
PyTorch on the CPU has no uint32 shifts or ``index_select``.  The bits are
the same; only the plain version's popcount has to mind the sign bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from stoat_tpu_torch.device import kernels_enabled
from stoat_tpu_torch.kernels import I64, VOIDP, check_tensor, launch

__all__ = [
    "pack_matrix_words",
    "pack_path_edge_idx",
    "pack_hap_mask_words",
    "tail_mask_words",
    "unpack_words_to_dense",
    "membership_counts",
    "membership_counts_plain",
    "membership_words_plain",
    "unpack_membership_plain",
]

_WORD = 32


def _n_words(n_haplotypes: int) -> int:
    return max((n_haplotypes + _WORD - 1) // _WORD, 1)


def pack_matrix_words(matrix: np.ndarray) -> np.ndarray:
    """Pack a bool [E, H] edge matrix into uint32 [E+1, W] words.

    The appended final row is all-ones: the AND identity used as the
    padding target by ``pack_path_edge_idx``.
    """
    E, H = matrix.shape
    W = _n_words(H)
    u8 = np.packbits(np.asarray(matrix, bool), axis=1, bitorder="little")
    buf = np.zeros((E + 1, W * 4), np.uint8)
    buf[:E, : u8.shape[1]] = u8
    buf[E, :] = 0xFF
    return buf.view("<u4").reshape(E + 1, W)


def pack_hap_mask_words(mask: np.ndarray, n_words: int) -> np.ndarray:
    """Pack a bool [H] haplotype mask into uint32 [W] words."""
    u8 = np.packbits(np.asarray(mask, bool), bitorder="little")
    buf = np.zeros(n_words * 4, np.uint8)
    buf[: u8.shape[0]] = u8
    return buf.view("<u4")


def tail_mask_words(n_haplotypes: int, n_words: int) -> np.ndarray:
    """uint32 [W] mask with exactly the first ``n_haplotypes`` bits set."""
    return pack_hap_mask_words(np.ones(n_haplotypes, bool), n_words)


def unpack_words_to_dense(words: np.ndarray,
                          n_haplotypes: int) -> np.ndarray:
    """Dense bool [E, H] from uint32 [E+1, W] words (identity row
    dropped)."""
    E = int(words.shape[0]) - 1
    if E <= 0:
        return np.zeros((0, n_haplotypes), bool)
    return np.unpackbits(
        np.ascontiguousarray(words[:E]).view(np.uint8).reshape(E, -1),
        axis=1, bitorder="little")[:, :n_haplotypes].astype(bool)


def pack_path_edge_idx(coo_path: np.ndarray, coo_row: np.ndarray,
                       path_valid: np.ndarray, n_rows: int,
                       min_k: int = 1) -> np.ndarray:
    """Convert the COO (path, edge-row) list into padded [P, K] indices.

    K = max edges on any valid path (>= ``min_k``), rounded up to a power
    of two; padding entries point at row ``n_rows``, the all-ones
    AND-identity row appended by ``pack_matrix_words``.  COO entries on
    invalid paths are discarded so they cannot inflate K.
    """
    P = path_valid.shape[0]
    real = path_valid[coo_path]
    cp = coo_path[real].astype(np.int64)
    cr = coo_row[real].astype(np.int32)
    counts = np.bincount(cp, minlength=P)
    K = max(min_k, int(counts.max()) if counts.size else min_k)
    k2 = 1
    while k2 < K:
        k2 *= 2
    K = k2
    idx = np.full((P, K), n_rows, np.int32)
    order = np.argsort(cp, kind="stable")
    cp, cr = cp[order], cr[order]
    starts = np.zeros(P + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    col = np.arange(cp.shape[0]) - starts[cp]
    idx[cp, col] = cr
    return idx


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of each 32-bit word of an int32 tensor (int64)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def membership_words_plain(words: torch.Tensor,
                           path_idx: torch.Tensor) -> torch.Tensor:
    """Packed membership int32 [P, W]: the AND of each path's edge rows
    (K1, stoat_tpu/pipeline/packed.py membership_words).

    A K-step AND accumulation of [P, W] row gathers; bits past H and
    invalid paths are left for the caller to mask."""
    mem = words.index_select(0, path_idx[:, 0])
    for k in range(1, path_idx.shape[1]):
        mem &= words.index_select(0, path_idx[:, k])
    return mem


def unpack_membership_plain(mem_words: torch.Tensor, path_valid: torch.Tensor,
                            n_haplotypes: int) -> torch.Tensor:
    """bool [P, H] membership from packed words (K7,
    stoat_tpu/pipeline/packed.py unpack_membership): bit j of word w is
    haplotype 32*w + j; bits past H are dropped and invalid paths are
    all False."""
    P, W = mem_words.shape
    shifts = torch.arange(_WORD, dtype=torch.int32, device=mem_words.device)
    # the arithmetic shift of the int32 view leaves bit 0 as it is
    bits = (mem_words[:, :, None] >> shifts) & 1
    full = bits.reshape(P, W * _WORD)[:, :n_haplotypes] != 0
    return full & path_valid[:, None]


def membership_counts_plain(words: torch.Tensor, path_idx: torch.Tensor,
                            path_valid: torch.Tensor, tail: torch.Tensor,
                            g1_words: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`membership_counts`: the membership
    words, then the popcounts of stoat_tpu's packed_binary_counts."""
    mem = membership_words_plain(words, path_idx) & tail
    mem = torch.where(path_valid[:, None], mem, torch.zeros_like(mem))
    g1 = _popcount32(mem & g1_words[None, :]).sum(dim=-1)
    g_all = _popcount32(mem).sum(dim=-1)
    return ((g_all - g1).to(torch.float64), g1.to(torch.float64))


def _membership_counts_cuda(words, path_idx, path_valid, tail, g1_words):
    device = words.device
    R, W = words.shape
    P, K = path_idx.shape
    check_tensor(words, "words", torch.int32, (R, W), device)
    check_tensor(path_idx, "path_idx", torch.int32, (P, K), device)
    check_tensor(path_valid, "path_valid", torch.bool, (P,), device)
    check_tensor(tail, "tail", torch.int32, (W,), device)
    check_tensor(g1_words, "g1_words", torch.int32, (W,), device)
    g0 = torch.empty(P, dtype=torch.float64, device=device)
    g1 = torch.empty(P, dtype=torch.float64, device=device)
    launch("membership_counts",
           [VOIDP] * 7 + [I64] * 3,
           [words.data_ptr(), path_idx.data_ptr(), path_valid.data_ptr(),
            tail.data_ptr(), g1_words.data_ptr(), g0.data_ptr(),
            g1.data_ptr(), P, K, W],
           device)
    return g0, g1


def membership_counts(words: torch.Tensor, path_idx: torch.Tensor,
                      path_valid: torch.Tensor, tail: torch.Tensor,
                      g1_words: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-path (g0, g1) carrier counts, float64 [P] each (K1+K2).

    The fused counterpart of stoat_tpu's ``membership_words`` followed by
    ``packed_binary_counts``: a haplotype carries path p when it has every
    edge row of ``path_idx[p]`` (int32 [P, K], padded with the identity
    row) in ``words`` (int32 view of uint32 [E+1, W]); invalid paths
    (``path_valid`` False) carry none; ``tail`` masks bits past H;
    ``g1_words`` is the packed case mask.  g1 counts case carriers, g0
    the rest.

    CUDA tensors run csrc/membership_counts.cu; CPU tensors run the plain
    version.  The kernel is bound by memory: it gathers P*K*W*4 bytes of
    word rows, so it keeps the [P, W] membership in registers and writes
    only the counts (one warp per path, lanes over W).
    """
    if kernels_enabled(words.device):
        return _membership_counts_cuda(words, path_idx, path_valid, tail,
                                       g1_words)
    return membership_counts_plain(words, path_idx, path_valid, tail,
                                   g1_words)

