"""Quantitative-trait pipeline (``vcf -q``, OLS with optional covariates).

The port of stoat_tpu/pipeline/quantitative.py for the linear model.  Per
snarl of a chunk (``_design_from_membership``, :122-259):

  dosage[n, j]   haplotypes (2n, 2n+1) of sample n carrying path j (0-2)
  allele_paths   carrier haplotypes per path; kept = paths with carriers
  used rows      samples carrying a kept path; each row is scaled by the
                 one float64 reciprocal of its row sum
  filtered       kept < 2, used rows < min_individuals, used rows (the
                 total normalised mass) < min_haplotypes, or fewer than 2
                 kept columns with maf > threshold
  merge          identical kept columns are summed when >= 3 are kept
  drop           the last merged column (intercept collinearity guard)
  X              [1 | variant columns in column order | covariates | 0],
                 rows of unused samples all zero, width 1 + Pmax + C
  degenerate     no variant column survives (NA in the output)

then OLS on y = phenotype * used (K9), the Student-t tail (K10) and the NA
masking of degenerate snarls (``_fused_packed_analysis``, :305-350).  A
binary phenotype with covariates (``vcf -b -c``) takes the same design
without the covariates, which the reference never puts in its model, and
IRLS logistic regression (K11, stats/logreg.py) on y = case * used
(``binary_covar_analyze_chromosome``, :545-565).

CUDA tensors run three kernels: csrc/quant_design.cu (K1 + K7 + K8 fused:
words in, X out), csrc/ols.cu (K9) and csrc/student_t.cu (K10 and the
masking); ``vcf -b -c`` runs csrc/quant_design.cu and csrc/logreg.cu.
CPU tensors run the plain versions: membership words, unpack, then
``design_from_membership_plain``.
"""

from __future__ import annotations

from typing import Dict

import torch

from stoat_tpu_torch.convert import DeviceChunk, to_device_chunk
from stoat_tpu_torch.device import kernels_enabled
from stoat_tpu_torch.kernels import F64, I64, VOIDP, check_tensor, launch
from stoat_tpu_torch.pipeline.fetch import HostResult, fetch_async
from stoat_tpu_torch.pipeline.packed import (membership_words_plain,
                                             unpack_membership_plain)
from stoat_tpu_torch.stats.linreg import (linear_regression_stats,
                                          student_t_pvalues)
from stoat_tpu_torch.stats.logreg import logistic_regression

__all__ = ["DESIGN_KEYS", "design_from_membership_plain", "quant_design",
           "quant_design_plain", "quantitative_analyze_chromosome",
           "binary_covar_analyze_chromosome"]

DESIGN_KEYS = ("X", "used", "ncols", "filtered", "degenerate",
               "allele_paths")


def design_from_membership_plain(membership: torch.Tensor,
                                 snarl_path_idx: torch.Tensor,
                                 covar: torch.Tensor, min_individuals,
                                 min_haplotypes, maf_threshold
                                 ) -> Dict[str, torch.Tensor]:
    """Per-snarl OLS designs from the bool [P, H] membership (K8).

    ``snarl_path_idx`` int32 [S, Pmax] (-1 padding), ``covar`` float64
    [N, C] (C may be 0).  Returns ``DESIGN_KEYS``: X float64 [S, N,
    1 + Pmax + C], used bool [S, N], ncols/allele_paths int32, filtered
    and degenerate bool.  Dosages, row sums and the Gram test are exact
    integers; X = float64(count) * (1.0 / float64(row_sum)), one rounding,
    as in stoat_tpu."""
    device = membership.device
    counts_path = membership.sum(dim=1, dtype=torch.int32)           # [P]
    m = membership.to(torch.uint8)
    dosage = m[:, 0::2] + m[:, 1::2]                                 # [P, N]
    idx = snarl_path_idx.long()
    S, Pmax = idx.shape
    C = covar.shape[1]
    col_exists = idx >= 0
    safe_idx = torch.where(col_exists, idx, 0)
    allele_paths = torch.where(col_exists, counts_path[safe_idx], 0)
    kept = col_exists & (allele_paths > 0)                    # [S, Pmax]
    # kept dosages [S, N, Pmax]
    Dk = torch.where(kept[:, :, None], dosage[safe_idx], 0).transpose(1, 2)
    Df = Dk.to(torch.float64)         # float64 holds these integers exactly

    used = (Dk > 0).any(dim=-1)                               # [S, N]
    row_sum = Dk.sum(dim=-1)
    recip = torch.where(row_sum == 0, 0.0,
                        1.0 / row_sum.to(torch.float64))
    n_used = used.sum(dim=-1)
    total_sum = n_used.to(torch.float64)
    colsum = torch.einsum("snp,sn->sp", Df, recip)
    kept_count = kept.sum(dim=-1)
    safe_total = torch.where(total_sum == 0, 1.0, total_sum)
    freq = colsum / safe_total[:, None]
    maf = torch.minimum(freq, 1.0 - freq)
    maf_count = (kept & (maf > maf_threshold)).sum(dim=-1)
    filtered = ((kept_count < 2) | (total_sum < min_individuals)
                | (total_sum < min_haplotypes) | (maf_count < 2))

    # identical-column merge: ||d_i - d_j||^2 == 0 on the integer Gram
    # matrix
    G = torch.einsum("snp,snq->spq", Df, Df)
    gd = torch.diagonal(G, dim1=1, dim2=2)
    eq = ((gd[:, :, None] + gd[:, None, :] - 2.0 * G) == 0.0) \
        & kept[:, :, None] & kept[:, None, :]
    arange = torch.arange(Pmax, device=device)
    big = Pmax + 1
    rep = torch.where(eq, arange[None, :, None], big).amin(dim=1)
    identity = torch.where(kept, arange[None, :], big)
    rep = torch.where((kept_count >= 3)[:, None], rep, identity)
    group = (rep[:, None, :] == arange[None, :, None]).to(torch.float64)
    merged = torch.einsum("snj,sij->sni", Df, group)          # [S, N, Pmax]
    is_rep = kept & (rep == arange[None, :])

    # drop the last representative; the rest are the variant columns
    last_rep = Pmax - 1 - is_rep.flip(-1).to(torch.int8).argmax(dim=-1)
    var_cols = is_rep & (arange[None, :] != last_rep[:, None])
    k3 = var_cols.sum(dim=-1)
    degenerate = is_rep.any(dim=-1) & (k3 == 0)

    # X = [1 | variant columns in column order | covariates | 0]: variant
    # column j goes to slot (number of variant columns up to j)
    PT = 1 + Pmax + C
    slot = torch.where(var_cols, torch.cumsum(var_cols, dim=-1), 0)
    onehot = (slot[:, :, None] == torch.arange(PT, device=device)) \
        & var_cols[:, :, None]                                # [S, Pmax, PT]
    X = torch.einsum("snj,sjt->snt", merged, onehot.to(torch.float64))
    X = X * recip[:, :, None]
    X[:, :, 0] = 1.0
    rows = torch.arange(S, device=device)
    for c in range(C):                  # covariate c at slot 1 + k3 + c
        X[rows, :, 1 + k3 + c] = covar[None, :, c]
    X = torch.where(used[:, :, None], X, 0.0)
    return {
        "X": X.contiguous(),
        "used": used,
        "ncols": (1 + k3 + C).to(torch.int32),
        "filtered": filtered,
        "degenerate": degenerate,
        "allele_paths": allele_paths.to(torch.int32),
    }


def quant_design_plain(chunk: DeviceChunk, covar: torch.Tensor,
                       min_individuals, min_haplotypes, maf_threshold,
                       n_haplotypes: int) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of :func:`quant_design`: membership words
    (K1), unpacked to bool [P, H] (K7), then the design (K8)."""
    mem = membership_words_plain(chunk.words, chunk.path_idx)
    membership = unpack_membership_plain(mem, chunk.path_valid,
                                         n_haplotypes)
    return design_from_membership_plain(
        membership, chunk.snarl_path_idx, covar, min_individuals,
        min_haplotypes, maf_threshold)


def _quant_design_cuda(chunk, covar, min_individuals, min_haplotypes,
                       maf_threshold, n_haplotypes):
    words, path_idx = chunk.words, chunk.path_idx
    device = words.device
    R, W = words.shape
    P, K = path_idx.shape
    S, Pmax = chunk.snarl_path_idx.shape
    N = n_haplotypes // 2
    C = covar.shape[1]
    check_tensor(words, "words", torch.int32, (R, W), device)
    check_tensor(path_idx, "path_idx", torch.int32, (P, K), device)
    check_tensor(chunk.path_valid, "path_valid", torch.bool, (P,), device)
    check_tensor(chunk.snarl_path_idx, "snarl_path_idx", torch.int32,
                 (S, Pmax), device)
    check_tensor(covar, "covar", torch.float64, (N, C), device)
    if W * 32 < n_haplotypes:
        raise ValueError(f"words: {W} words hold fewer than "
                         f"{n_haplotypes} haplotypes")

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    out = {
        "X": empty((S, N, 1 + Pmax + C), torch.float64),
        "used": empty((S, N), torch.bool),
        "ncols": empty((S,), torch.int32),
        "filtered": empty((S,), torch.bool),
        "degenerate": empty((S,), torch.bool),
        "allele_paths": empty((S, Pmax), torch.int32),
    }
    launch("quant_design", [VOIDP] * 11 + [I64] * 7 + [F64] * 3,
           [words.data_ptr(), path_idx.data_ptr(),
            chunk.path_valid.data_ptr(), chunk.snarl_path_idx.data_ptr(),
            covar.data_ptr(), *(out[key].data_ptr() for key in DESIGN_KEYS),
            S, Pmax, K, W, N, C, n_haplotypes, float(min_individuals),
            float(min_haplotypes), float(maf_threshold)], device)
    return out


def quant_design(chunk: DeviceChunk, covar: torch.Tensor, min_individuals,
                 min_haplotypes, maf_threshold,
                 n_haplotypes: int) -> Dict[str, torch.Tensor]:
    """Per-snarl OLS designs of a chunk, from its packed words (K1 + K7 +
    K8): ``DESIGN_KEYS``, as :func:`design_from_membership_plain`.

    CUDA tensors run csrc/quant_design.cu, one block per snarl, which
    never writes the [P, W] or [P, H] membership: it is bound by writing X
    (S * N * (1 + Pmax + C) * 8 bytes).  CPU tensors run the plain
    version."""
    if kernels_enabled(chunk.words.device):
        return _quant_design_cuda(chunk, covar, min_individuals,
                                  min_haplotypes, maf_threshold,
                                  n_haplotypes)
    return quant_design_plain(chunk, covar, min_individuals, min_haplotypes,
                              maf_threshold, n_haplotypes)


def quantitative_analyze_chromosome(packed, pheno: torch.Tensor,
                                    covar: torch.Tensor,
                                    min_individuals: int,
                                    min_haplotypes: int,
                                    maf_threshold: float, device,
                                    words=None) -> HostResult:
    """Run one packed chunk (a ``stoat_tpu.tables.PackedChromosome``)
    through the quantitative pipeline on ``device``: design, OLS of
    y = pheno * used, p-values and NA masking.

    ``pheno`` float64 [N] and ``covar`` float64 [N, C] are on ``device``
    (convert.to_quant_inputs); ``words`` lets the caller share the
    chromosome's uploaded words across chunks.  Returns a
    ``fetch.HostResult`` with filtered, allele_paths, p, beta, se, r2."""
    chunk = to_device_chunk(packed, None, device, words=words)
    d = quant_design(chunk, covar, min_individuals, min_haplotypes,
                     maf_threshold, packed.n_haplotypes)
    used = d["used"]
    y = pheno[None, :] * used
    t1, df_res, beta, se, r2 = linear_regression_stats(d.pop("X"), y, used,
                                                       d["ncols"])
    # X ([S, N, PT] float64, the chunk's largest buffer) is released here;
    # the allocator hands its memory to the next chunk's X only behind the
    # OLS launch on the same stream
    out = student_t_pvalues(t1, df_res, d["degenerate"], beta, se, r2)
    return fetch_async({"filtered": d["filtered"],
                        "allele_paths": d["allele_paths"], **out})


def binary_covar_analyze_chromosome(packed, pheno: torch.Tensor,
                                    min_individuals: int,
                                    min_haplotypes: int,
                                    maf_threshold: float, device,
                                    words=None) -> HostResult:
    """Run one packed chunk through ``vcf -b -c`` on ``device``: the design
    with no covariates (the reference's shadowing, kept on purpose), IRLS
    logistic regression of y = pheno * used, and NA where the snarl is
    degenerate.

    ``pheno`` is the float64 [N] case indicator on ``device``
    (convert.to_binary_pheno).  Returns a ``fetch.HostResult`` with
    filtered, allele_paths, p, beta, se."""
    chunk = to_device_chunk(packed, None, device, words=words)
    no_covar = torch.zeros((pheno.shape[0], 0), dtype=torch.float64,
                           device=pheno.device)
    d = quant_design(chunk, no_covar, min_individuals, min_haplotypes,
                     maf_threshold, packed.n_haplotypes)
    used = d["used"]
    # X, alive through every Newton step, is released once K11 is queued:
    # the allocator reuses it only behind that launch, as after the OLS
    out = logistic_regression(d.pop("X"), pheno[None, :] * used, used,
                              d["ncols"], d["degenerate"])
    del out["iters"]                   # the Newton step counts stay behind
    return fetch_async({"filtered": d["filtered"],
                        "allele_paths": d["allele_paths"], **out})
