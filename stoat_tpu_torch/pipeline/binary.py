"""Binary-trait pipeline (chi-squared + Fisher exact), packed path only.

The port of stoat_tpu/pipeline/binary.py:76-220.  Per snarl:

  g0/g1[path]   control/case carrier counts over haplotypes (K1+K2)
  total_sum     sum of all counts (over ALL paths, before filtering)
  keep          columns with g0 + g1 != 0
  filtered      total_sum//2 < min_individuals (integer division)
                or total_sum < min_haplotypes or kept columns < 2
                or fewer than 2 kept columns with maf > maf_threshold,
                where maf = min(g1/colsum, 1 - g1/colsum)            (K3)
  kept == 2     chi2 2x2 (K3) + Fisher exact (K4)
  kept != 2     chi2 2xN (K3), Fisher NA
  p_chi2        chi-squared tail (K5, csrc/chi2_tail.cu)

The JAX package's dense float32 membership twin is not ported: dense
sources are packed on the host, which the JAX tests pin as value-identical.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from stoat_tpu_torch.convert import DeviceChunk, to_device_chunk
from stoat_tpu_torch.device import kernels_enabled
from stoat_tpu_torch.kernels import F64, I64, VOIDP, check_tensor, launch
from stoat_tpu_torch.pipeline.fetch import HostResult, fetch_async
from stoat_tpu_torch.pipeline.packed import membership_counts
from stoat_tpu_torch.stats.chi2 import (chi2_2x2_stat, chi2_2xn_stat,
                                        finish_chi2_pvalues)
from stoat_tpu_torch.stats.fisher import fisher_exact_2x2

__all__ = ["binary_tables", "binary_tables_plain", "binary_from_path_counts",
           "binary_tables_packed", "binary_analyze_chromosome"]

TABLE_KEYS = ("filtered", "keep", "g0", "g1", "k", "a", "b", "c", "d",
              "chi2_stat", "chi2_df", "chi2_invalid", "chi2_zexp")


def binary_tables_plain(g0_path: torch.Tensor, g1_path: torch.Tensor,
                        snarl_path_idx: torch.Tensor, min_individuals,
                        min_haplotypes, maf_threshold
                        ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of :func:`binary_tables`."""
    idx = snarl_path_idx
    col_mask = idx >= 0
    safe_idx = torch.where(col_mask, idx, torch.zeros_like(idx)).long()
    zero = torch.zeros((), dtype=torch.float64, device=g0_path.device)
    g0 = torch.where(col_mask, g0_path.to(torch.float64)[safe_idx], zero)
    g1 = torch.where(col_mask, g1_path.to(torch.float64)[safe_idx], zero)
    colsum = g0 + g1
    total_sum = colsum.sum(dim=-1)
    keep = col_mask & (colsum != 0)
    k = keep.sum(dim=-1)
    safe_colsum = torch.where(colsum == 0, torch.ones_like(colsum), colsum)
    freq1 = g1 / safe_colsum
    maf = torch.minimum(freq1, 1.0 - freq1)
    maf_count = (keep & (maf > maf_threshold)).sum(dim=-1)
    filtered = ((torch.floor(total_sum / 2.0) < min_individuals)
                | (total_sum < min_haplotypes) | (k < 2) | (maf_count < 2))

    # g0/g1 of the first two kept columns in column order (the stable
    # argsort of the JAX version); 0 where there is none
    rank = torch.cumsum(keep.to(torch.int32), dim=-1)
    first = keep & (rank == 1)
    second = keep & (rank == 2)
    a = torch.where(first, g0, zero).sum(dim=-1)
    b = torch.where(second, g0, zero).sum(dim=-1)
    c = torch.where(first, g1, zero).sum(dim=-1)
    d = torch.where(second, g1, zero).sum(dim=-1)

    stat2, inv2, zexp2 = chi2_2x2_stat(a, b, c, d)
    statn, dfn, invn = chi2_2xn_stat(g0, g1, keep)
    is_2x2 = k == 2
    return {
        "filtered": filtered,
        "keep": keep,
        "g0": g0,
        "g1": g1,
        "k": k.to(torch.int32),
        "a": a, "b": b, "c": c, "d": d,
        "chi2_stat": torch.where(is_2x2, stat2, statn),
        "chi2_df": torch.where(is_2x2, 1.0, dfn),
        "chi2_invalid": torch.where(is_2x2, inv2, invn),
        "chi2_zexp": is_2x2 & zexp2,
    }


def _binary_tables_cuda(g0_path, g1_path, snarl_path_idx, min_individuals,
                        min_haplotypes, maf_threshold):
    device = g0_path.device
    P = g0_path.shape[0]
    S, Pmax = snarl_path_idx.shape
    check_tensor(g0_path, "g0_path", torch.float64, (P,), device)
    check_tensor(g1_path, "g1_path", torch.float64, (P,), device)
    check_tensor(snarl_path_idx, "snarl_path_idx", torch.int32, (S, Pmax),
                 device)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    out = {
        "filtered": empty((S,), torch.bool),
        "keep": empty((S, Pmax), torch.bool),
        "g0": empty((S, Pmax), torch.float64),
        "g1": empty((S, Pmax), torch.float64),
        "k": empty((S,), torch.int32),
        "a": empty((S,), torch.float64),
        "b": empty((S,), torch.float64),
        "c": empty((S,), torch.float64),
        "d": empty((S,), torch.float64),
        "chi2_stat": empty((S,), torch.float64),
        "chi2_df": empty((S,), torch.float64),
        "chi2_invalid": empty((S,), torch.bool),
        "chi2_zexp": empty((S,), torch.bool),
    }
    launch("binary_tables",
           [VOIDP] * 3 + [I64] * 2 + [F64] * 3 + [VOIDP] * len(TABLE_KEYS),
           [g0_path.data_ptr(), g1_path.data_ptr(),
            snarl_path_idx.data_ptr(), S, Pmax, float(min_individuals),
            float(min_haplotypes), float(maf_threshold),
            *(out[key].data_ptr() for key in TABLE_KEYS)],
           device)
    return out


def binary_tables(g0_path: torch.Tensor, g1_path: torch.Tensor,
                  snarl_path_idx: torch.Tensor, min_individuals,
                  min_haplotypes, maf_threshold) -> Dict[str, torch.Tensor]:
    """Per-snarl table, filter and chi-squared statistic (K3).

    Gathers the per-path counts through ``snarl_path_idx`` (int32
    [S, Pmax], -1 padding) and returns ``TABLE_KEYS``: ``filtered`` [S],
    ``keep``/``g0``/``g1`` [S, Pmax], the kept-column count ``k``, the
    first two kept columns' table ``a, b`` (g0) / ``c, d`` (g1), and the
    chi-squared statistic with its df and ``invalid``/``zexp`` flags (2x2
    when k == 2, else 2xN).  This is stoat_tpu's
    ``_binary_from_path_counts(tails=False)`` without Fisher.

    CUDA tensors run csrc/binary_tables.cu; CPU tensors the plain
    version.  The kernel moves a few bytes per snarl and is bound by
    launch latency: one thread per snarl keeps the table in registers
    and writes each output once."""
    if kernels_enabled(g0_path.device):
        return _binary_tables_cuda(g0_path, g1_path, snarl_path_idx,
                                   min_individuals, min_haplotypes,
                                   maf_threshold)
    return binary_tables_plain(g0_path, g1_path, snarl_path_idx,
                               min_individuals, min_haplotypes,
                               maf_threshold)


def binary_from_path_counts(g0_path, g1_path, snarl_path_idx,
                            min_individuals, min_haplotypes, maf_threshold
                            ) -> Dict[str, torch.Tensor]:
    """stoat_tpu/pipeline/binary.py _binary_from_path_counts: K3, then
    Fisher (K4) on the 2x2 tables and the chi2 tail (K5)."""
    t = binary_tables(g0_path, g1_path, snarl_path_idx, min_individuals,
                      min_haplotypes, maf_threshold)
    p_fisher = fisher_exact_2x2(t["a"], t["b"], t["c"], t["d"])
    return {
        "filtered": t["filtered"],
        "keep": t["keep"],
        "g0": t["g0"],
        "g1": t["g1"],
        "p_fisher": torch.where(t["k"] == 2, p_fisher, float("nan")),
        "p_chi2": finish_chi2_pvalues(t["chi2_stat"], t["chi2_df"],
                                      t["chi2_invalid"], t["chi2_zexp"]),
    }


def binary_tables_packed(chunk: DeviceChunk, min_individuals,
                         min_haplotypes, maf_threshold
                         ) -> Dict[str, torch.Tensor]:
    """stoat_tpu's ``binary_tables_device_packed`` on a device chunk:
    K1+K2 membership counts, then :func:`binary_from_path_counts`."""
    g0_path, g1_path = membership_counts(
        chunk.words, chunk.path_idx, chunk.path_valid, chunk.tail,
        chunk.g1_words)
    return binary_from_path_counts(
        g0_path, g1_path, chunk.snarl_path_idx, min_individuals,
        min_haplotypes, maf_threshold)


def binary_analyze_chromosome(packed, binary_phenotype: np.ndarray,
                              min_individuals: int, min_haplotypes: int,
                              maf_threshold: float, device,
                              words: Optional[torch.Tensor] = None,
                              pheno=None) -> HostResult:
    """Run one packed chunk (a ``tables.PackedChromosome``)
    through the binary pipeline on ``device``.

    ``words``/``pheno`` let the caller upload the chromosome's words and
    the run's phenotype masks once and share them across chunks (see
    convert.py).  Returns a ``fetch.HostResult`` whose copies may still be
    in flight; indexing it waits for them."""
    chunk = to_device_chunk(packed, binary_phenotype, device, words=words,
                            pheno=pheno)
    return fetch_async(binary_tables_packed(
        chunk, min_individuals, min_haplotypes, maf_threshold))
