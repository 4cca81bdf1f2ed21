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

then OLS on y = phenotype * used (K9; the kernel forms y from the
phenotype row and the mask), the Student-t tail (K10) and the NA
masking of degenerate snarls (``_fused_packed_analysis``, :305-350).  A
binary phenotype with covariates (``vcf -b -c``) takes the same design
without the covariates, which the reference never puts in its model, and
IRLS logistic regression (K11, stats/logreg.py) on y = case * used
(``binary_covar_analyze_chromosome``, :545-565).

The other modes built on the same design:

  dual (``vcf -b -q``)  one K1 pass feeds both the binary tables and the
                 design (``_fused_dual_analysis``, :353-437):
                 :func:`dual_analyze_chromosome`, whose result carries the
                 quantitative keys with a ``q_`` prefix (:class:`PrefixView`)
  mixed model (``-k --lmm``)  EMMAX designs keep every sample
                 (``all_rows``: intercept and covariates on every row,
                 variant columns 0 where the sample has no call), rotated by
                 the null model's W and solved by OLS against the rotated
                 phenotype (``lmm_analyze_chromosome``, :464-499;
                 stats/lmm.py)
  eQTL (``-e -G``)  the design with covariates, then OLS per (snarl, gene)
                 pair against y = expression * used
                 (``eqtl_regress_pairs``, :587-623)

CUDA tensors run three kernels: csrc/quant_design.cu (K1 + K7 + K8 fused:
words in, X out), csrc/ols.cu (K9) and csrc/student_t.cu (K10 and the
masking); ``vcf -b -c`` runs csrc/quant_design.cu and csrc/logreg.cu; the
eQTL pairs run csrc/eqtl_ols.cu (K13), then csrc/student_t.cu.  CPU tensors
run the plain versions: membership words, unpack, then
``design_from_membership_plain``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from stoat_tpu_torch.convert import DeviceChunk, to_device_chunk
from stoat_tpu_torch.device import kernels_enabled
from stoat_tpu_torch.kernels import (F64, I64, VOIDP, build, check_tensor,
                                     launch)
from stoat_tpu_torch.pipeline.binary import (binary_stats_from_words,
                                             with_chi2_tail)
from stoat_tpu_torch.pipeline.fetch import (DeviceTables, HostResult,
                                            fetch_async)
from stoat_tpu_torch.pipeline.packed import (membership_words_plain,
                                             unpack_membership_plain)
from stoat_tpu_torch.stats.linreg import (linear_regression_row_stats,
                                          linear_regression_stats_plain,
                                          student_t_pvalues)
from stoat_tpu_torch.stats.lmm import lmm_regression_batch
from stoat_tpu_torch.stats.logreg import logistic_regression

__all__ = ["DESIGN_KEYS", "TABLE_KEYS", "design_from_membership_plain",
           "quant_design", "quant_design_plain",
           "quantitative_analyze_chromosome",
           "binary_covar_analyze_chromosome",
           "dual_analyze_chromosome", "dual_chunk_tables",
           "PrefixView", "lmm_analyze_chromosome",
           "eqtl_design_for_chromosome", "pair_snarls", "eqtl_ols_stats",
           "eqtl_ols_stats_plain", "eqtl_regress_pairs"]

DESIGN_KEYS = ("X", "used", "ncols", "filtered", "degenerate",
               "allele_paths")
# the -T table view (stoat_tpu's norm and kept, :245-258)
TABLE_KEYS = ("norm", "kept")


def design_from_membership_plain(membership: torch.Tensor,
                                 snarl_path_idx: torch.Tensor,
                                 covar: torch.Tensor, min_individuals,
                                 min_haplotypes, maf_threshold,
                                 all_rows: bool = False,
                                 tables: bool = False
                                 ) -> Dict[str, torch.Tensor]:
    """Per-snarl OLS designs from the bool [P, H] membership (K8).

    ``snarl_path_idx`` int32 [S, Pmax] (-1 padding), ``covar`` float64
    [N, C] (C may be 0).  Returns ``DESIGN_KEYS``: X float64 [S, N,
    1 + Pmax + C], used bool [S, N], ncols/allele_paths int32, filtered
    and degenerate bool.  Dosages, row sums and the Gram test are exact
    integers; X = float64(count) * (1.0 / float64(row_sum)), one rounding,
    as in stoat_tpu.  Rows of unused samples are all zero, unless
    ``all_rows`` (the mixed model's EMMAX designs), where they keep the
    intercept and the covariates.  With ``tables``, also ``TABLE_KEYS``:
    norm float64 [S, N, Pmax], each kept column's dosage times the row's
    reciprocal (0 elsewhere), and kept bool [S, Pmax]."""
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
    if not all_rows:
        X = torch.where(used[:, :, None], X, 0.0)
    out = {
        "X": X.contiguous(),
        "used": used,
        "ncols": (1 + k3 + C).to(torch.int32),
        "filtered": filtered,
        "degenerate": degenerate,
        "allele_paths": allele_paths.to(torch.int32),
    }
    if tables:
        out.update(norm=Df * recip[:, :, None], kept=kept)
    return out


def quant_design_plain(chunk: DeviceChunk, covar: torch.Tensor,
                       min_individuals, min_haplotypes, maf_threshold,
                       n_haplotypes: int, all_rows: bool = False,
                       tables: bool = False) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of :func:`quant_design`: membership words
    (K1), unpacked to bool [P, H] (K7), then the design (K8)."""
    mem = membership_words_plain(chunk.words, chunk.path_idx)
    membership = unpack_membership_plain(mem, chunk.path_valid,
                                         n_haplotypes)
    return design_from_membership_plain(
        membership, chunk.snarl_path_idx, covar, min_individuals,
        min_haplotypes, maf_threshold, all_rows=all_rows, tables=tables)


def _quant_design_cuda(chunk, covar, min_individuals, min_haplotypes,
                       maf_threshold, n_haplotypes, all_rows, tables):
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
    if tables:
        out.update(norm=empty((S, N, Pmax), torch.float64),
                   kept=empty((S, Pmax), torch.bool))
    launch("quant_design", [VOIDP] * 13 + [I64] * 8 + [F64] * 3,
           [words.data_ptr(), path_idx.data_ptr(),
            chunk.path_valid.data_ptr(), chunk.snarl_path_idx.data_ptr(),
            covar.data_ptr(), *(out[key].data_ptr() for key in DESIGN_KEYS),
            *(out[key].data_ptr() if tables else None for key in TABLE_KEYS),
            S, Pmax, K, W, N, C, n_haplotypes, int(all_rows),
            float(min_individuals), float(min_haplotypes),
            float(maf_threshold)], device)
    return out


def quant_design(chunk: DeviceChunk, covar: torch.Tensor, min_individuals,
                 min_haplotypes, maf_threshold, n_haplotypes: int,
                 all_rows: bool = False,
                 tables: bool = False) -> Dict[str, torch.Tensor]:
    """Per-snarl OLS designs of a chunk, from its packed words (K1 + K7 +
    K8): ``DESIGN_KEYS``, as :func:`design_from_membership_plain` (with
    ``all_rows``, the mixed model's designs over every sample; with
    ``tables``, the -T table view ``TABLE_KEYS`` too).

    CUDA tensors run csrc/quant_design.cu, one block per snarl, which
    stages each column's membership words in shared memory and never
    writes the [P, W] or [P, H] membership to device memory: it is bound by
    writing X (S * N * (1 + Pmax + C) * 8 bytes), and norm (S * N * Pmax *
    8) with the table view.  CPU tensors run the plain version."""
    if kernels_enabled(chunk.words.device):
        return _quant_design_cuda(chunk, covar, min_individuals,
                                  min_haplotypes, maf_threshold,
                                  n_haplotypes, all_rows, tables)
    return quant_design_plain(chunk, covar, min_individuals, min_haplotypes,
                              maf_threshold, n_haplotypes, all_rows, tables)


def _finish(d: Dict[str, torch.Tensor], out: Dict[str, torch.Tensor],
            tables: bool) -> HostResult:
    """A chunk's result: ``out`` with the design's filter flags and
    allele counts, its host copies started; with ``tables``, the design's
    table view stays on the device (``HostResult.tables``)."""
    view = (DeviceTables(d["norm"], d["used"], d["kept"]) if tables
            else None)
    return fetch_async({"filtered": d["filtered"],
                        "allele_paths": d["allele_paths"], **out},
                       tables=view)


def quantitative_analyze_chromosome(packed, pheno: torch.Tensor,
                                    covar: torch.Tensor,
                                    min_individuals: int,
                                    min_haplotypes: int,
                                    maf_threshold: float, device,
                                    words=None,
                                    tables: bool = False) -> HostResult:
    """Run one packed chunk (a ``tables.PackedChromosome``)
    through the quantitative pipeline on ``device``: design, OLS of
    y = pheno * used, p-values and NA masking.

    ``pheno`` float64 [N] and ``covar`` float64 [N, C] are on ``device``
    (convert.to_quant_inputs); ``words`` lets the caller share the
    chromosome's uploaded words across chunks.  Returns a
    ``fetch.HostResult`` with filtered, allele_paths, p, beta, se, r2, and
    with ``tables`` the design's -T table view (``HostResult.tables``)."""
    chunk = to_device_chunk(packed, None, device, words=words)
    d = quant_design(chunk, covar, min_individuals, min_haplotypes,
                     maf_threshold, packed.n_haplotypes, tables=tables)
    t1, df_res, beta, se, r2 = linear_regression_row_stats(
        d.pop("X"), pheno, d["used"], d["ncols"])
    # X ([S, N, PT] float64, the chunk's largest buffer) is released here;
    # the allocator hands its memory to the next chunk's X only behind the
    # OLS launch on the same stream
    out = student_t_pvalues(t1, df_res, d["degenerate"], beta, se, r2)
    return _finish(d, out, tables)


def binary_covar_analyze_chromosome(packed, pheno: torch.Tensor,
                                    min_individuals: int,
                                    min_haplotypes: int,
                                    maf_threshold: float, device,
                                    words=None,
                                    tables: bool = False) -> HostResult:
    """Run one packed chunk through ``vcf -b -c`` on ``device``: the design
    with no covariates (the reference's shadowing, kept on purpose), IRLS
    logistic regression of y = pheno * used, and NA where the snarl is
    degenerate.

    ``pheno`` is the float64 [N] case indicator on ``device``
    (convert.to_binary_pheno).  Returns a ``fetch.HostResult`` with
    filtered, allele_paths, p, beta, se (and the table view with
    ``tables``)."""
    chunk = to_device_chunk(packed, None, device, words=words)
    no_covar = torch.zeros((pheno.shape[0], 0), dtype=torch.float64,
                           device=pheno.device)
    d = quant_design(chunk, no_covar, min_individuals, min_haplotypes,
                     maf_threshold, packed.n_haplotypes, tables=tables)
    used = d["used"]
    # X, alive through every Newton step, is released once K11 is queued:
    # the allocator reuses it only behind that launch, as after the OLS
    out = logistic_regression(d.pop("X"), pheno[None, :] * used, used,
                              d["ncols"], d["degenerate"])
    del out["iters"]                   # the Newton step counts stay behind
    return _finish(d, out, tables)


def dual_analyze_chromosome(packed, pheno: Tuple[torch.Tensor, torch.Tensor],
                            qpheno: torch.Tensor, covar: torch.Tensor,
                            min_individuals: int, min_haplotypes: int,
                            maf_threshold: float, device,
                            words=None) -> HostResult:
    """Run one packed chunk through ``vcf -b`` and ``vcf -q`` at once, with
    one K1 pass (stoat_tpu's ``_fused_dual_analysis``, :353-437).

    K1 runs once (``perm_membership``: the chunk's membership words,
    tail-masked, 0 on invalid paths); the binary tables (the count, table
    and Fisher launch, K1+K2 + K3 + K4) and the design (Q1's kernel) then
    read those words as their word rows, one row per path (index
    ``arange(P)``), so their arithmetic is the single-phenotype paths'
    own.  ``pheno`` is the binary run's (g1_words,
    tail) (convert.pheno_masks), ``qpheno`` float64 [N] the quantitative
    phenotype and ``covar`` float64 [N, C] the design's covariates.
    Returns one ``fetch.HostResult``: the binary keys of
    :func:`binary_analyze_chromosome` and the quantitative ones with a
    ``q_`` prefix (:class:`PrefixView`)."""
    chunk = to_device_chunk(packed, None, device, words=words, pheno=pheno)
    return fetch_async(dual_chunk_tables(
        chunk, qpheno, covar, min_individuals, min_haplotypes,
        maf_threshold, packed.n_haplotypes))


def dual_chunk_tables(chunk: DeviceChunk, qpheno: torch.Tensor,
                      covar: torch.Tensor, min_individuals, min_haplotypes,
                      maf_threshold, n_haplotypes: int
                      ) -> Dict[str, torch.Tensor]:
    """The device half of :func:`dual_analyze_chromosome` on a device chunk
    with the binary run's masks: the binary keys and the quantitative ones
    with a ``q_`` prefix, still on the device."""
    from stoat_tpu_torch.pipeline.permutation import perm_membership
    th = (min_individuals, min_haplotypes, maf_threshold)
    mem, _ = perm_membership(chunk.words, chunk.path_idx, chunk.path_valid,
                             chunk.tail)
    rows = torch.arange(mem.shape[0], dtype=torch.int32,
                        device=mem.device)[:, None]
    out = with_chi2_tail(binary_stats_from_words(
        mem, rows, chunk.path_valid, chunk.tail, chunk.g1_words,
        chunk.snarl_path_idx, *th))
    shared = DeviceChunk(mem, rows, chunk.path_valid, chunk.snarl_path_idx)
    d = quant_design(shared, covar, *th, n_haplotypes)
    t1, df_res, beta, se, r2 = linear_regression_row_stats(
        d.pop("X"), qpheno, d["used"], d["ncols"])
    q = student_t_pvalues(t1, df_res, d["degenerate"], beta, se, r2)
    q.update(filtered=d["filtered"], allele_paths=d["allele_paths"])
    out.update({"q_" + key: v for key, v in q.items()})
    return out


class PrefixView:
    """Writer-facing view of a dual result's ``q_``-prefixed keys under
    their plain names (stoat_tpu's PrefixView, :424-437)."""

    def __init__(self, res, prefix: str = "q_"):
        self._res = res
        self._prefix = prefix

    def __getitem__(self, key):
        return self._res[self._prefix + key]

    def __contains__(self, key):
        return (self._prefix + key) in self._res


def lmm_analyze_chromosome(packed, rot: torch.Tensor, y_rot: torch.Tensor,
                           covar: torch.Tensor, min_individuals: int,
                           min_haplotypes: int, maf_threshold: float,
                           device, words=None,
                           tables: bool = False) -> HostResult:
    """Run one packed chunk through the mixed model (``vcf -q -k
    --lmm``) on ``device``: the EMMAX design over every sample (Q1 with
    ``all_rows``), the rotation and OLS against the rotated phenotype (K14,
    stats/lmm.py), the Student-t tail and NA masking (stoat_tpu's
    ``lmm_analyze_chromosome``, :464-499).

    ``rot`` float64 [N, N], ``y_rot`` [N] and ``covar`` [N, C] are on
    ``device`` (convert.to_lmm_inputs).  Returns a ``fetch.HostResult``
    with filtered, allele_paths, p, beta, se, r2 (and the table view with
    ``tables``)."""
    chunk = to_device_chunk(packed, None, device, words=words)
    d = quant_design(chunk, covar, min_individuals, min_haplotypes,
                     maf_threshold, packed.n_haplotypes, all_rows=True,
                     tables=tables)
    t1, df_res, beta, se, r2 = lmm_regression_batch(d.pop("X"), rot, y_rot,
                                                    d["ncols"])
    out = student_t_pvalues(t1, df_res, d["degenerate"], beta, se, r2)
    return _finish(d, out, tables)


def eqtl_design_for_chromosome(packed, covar: torch.Tensor,
                               min_individuals: int, min_haplotypes: int,
                               maf_threshold: float, device,
                               words=None) -> Dict[str, torch.Tensor]:
    """The eQTL mode's design of one packed chunk (Q1 with the
    covariates, :587-596): ``DESIGN_KEYS`` on ``device``; the caller pairs
    the unfiltered snarls with genes (:func:`eqtl_regress_pairs`)."""
    chunk = to_device_chunk(packed, None, device, words=words)
    return quant_design(chunk, covar, min_individuals, min_haplotypes,
                        maf_threshold, packed.n_haplotypes)


Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]

# elements of X gathered at once by the plain version (256 MB of float64)
_PLAIN_BLOCK = 1 << 25


def pair_snarls(pair_off: torch.Tensor, n_pairs: int) -> torch.Tensor:
    """int64 [B] snarl of each pair, from the CSR offsets int32 [S + 1]."""
    S = pair_off.shape[0] - 1
    counts = (pair_off[1:] - pair_off[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(S, device=pair_off.device), counts,
        output_size=n_pairs)


def eqtl_ols_stats_plain(X: torch.Tensor, used: torch.Tensor,
                         ncols: torch.Tensor, pair_off: torch.Tensor,
                         pair_gene: torch.Tensor, expr: torch.Tensor
                         ) -> Stats:
    """Plain PyTorch version of :func:`eqtl_ols_stats`: stoat_tpu's
    per-pair algorithm (X[pair_snarl] against expr[gene] * used through
    :func:`linear_regression_stats_plain`), in blocks of pairs so that all
    of X[pair_snarl] is never held at once."""
    S, N, P = X.shape
    B = pair_gene.shape[0]
    ps = pair_snarls(pair_off, B)
    block = max(1, _PLAIN_BLOCK // max(N * P, 1))
    parts = []
    for lo in range(0, B, block):
        s = ps[lo:lo + block]
        u = used[s]
        parts.append(linear_regression_stats_plain(
            X[s], expr[pair_gene[lo:lo + block].long()] * u, u, ncols[s]))
    if not parts:
        empty = torch.empty(0, dtype=torch.float64, device=X.device)
        return (empty,) * 5
    return tuple(torch.cat(col) for col in zip(*parts))


def _eqtl_ols_cuda(X, used, ncols, pair_off, pair_gene, expr) -> Stats:
    device = X.device
    S, N, P = X.shape
    B = pair_gene.shape[0]
    G = expr.shape[0]
    check_tensor(X, "X", torch.float64, (S, N, P), device)
    check_tensor(used, "used", torch.bool, (S, N), device)
    check_tensor(ncols, "ncols", torch.int32, (S,), device)
    check_tensor(pair_off, "pair_off", torch.int32, (S + 1,), device)
    check_tensor(pair_gene, "pair_gene", torch.int32, (B,), device)
    check_tensor(expr, "expr", torch.float64, (G, N), device)
    lib = build.load("eqtl_ols")
    lib.eqtl_ols_work_doubles.argtypes = [I64]
    lib.eqtl_ols_work_doubles.restype = I64
    work = torch.empty((S, lib.eqtl_ols_work_doubles(P)),
                       dtype=torch.float64, device=device)
    out = [torch.empty(B, dtype=torch.float64, device=device)
           for _ in range(5)]
    launch("eqtl_ols", [VOIDP] * 12 + [I64] * 3,
           [X.data_ptr(), used.data_ptr(), ncols.data_ptr(),
            pair_off.data_ptr(), pair_gene.data_ptr(), expr.data_ptr(),
            work.data_ptr(), *(t.data_ptr() for t in out), S, N, P], device)
    return tuple(out)


def eqtl_ols_stats(X: torch.Tensor, used: torch.Tensor, ncols: torch.Tensor,
                   pair_off: torch.Tensor, pair_gene: torch.Tensor,
                   expr: torch.Tensor) -> Stats:
    """(t1, df_res, beta1, se1, r2), float64 [B] each, of the (snarl, gene)
    pairs (K13): pair b of snarl s (``pair_off`` int32 [S + 1], CSR by
    snarl) with gene ``pair_gene[b]`` (int32 [B]) is the OLS of y =
    expr[gene] * used[s] (``expr`` float64 [G, N]) on the snarl's design
    X[s] (float64 [S, N, P], rows of unused samples zero), with the
    pad-diagonal rule, the LDL^T rank probe and the pseudo-inverse of
    stoat_tpu's linear_regression_stats_batch.

    CUDA tensors run csrc/eqtl_ols.cu (ols_block_device.cuh), one block
    per snarl, which holds the snarl's first rows of X in shared memory,
    inverts X^T X once and takes the genes 16 at a time, each pair's
    expression row read from L2 in its passes over the rows; it is bound
    by reading X once.  CPU tensors run the plain version."""
    if kernels_enabled(X.device):
        return _eqtl_ols_cuda(X, used, ncols, pair_off, pair_gene, expr)
    return eqtl_ols_stats_plain(X, used, ncols, pair_off, pair_gene, expr)


def eqtl_regress_pairs(design: Dict[str, torch.Tensor],
                       pair_off: torch.Tensor, pair_gene: torch.Tensor,
                       expr: torch.Tensor) -> HostResult:
    """OLS for the (snarl, gene) pairs of one chunk (stoat_tpu's
    ``eqtl_regress_pairs``, :599-623): K13, then the Student-t tail and the
    NA of pairs of degenerate snarls over [B].  The pairs come as CSR by
    snarl on the design's device (convert.to_eqtl_pairs) and ``expr`` is
    the chromosome's [G, N] expression (convert.to_eqtl_expr).  Returns a
    ``fetch.HostResult`` with p, beta, se, r2 [B], in pair order."""
    t1, df_res, beta, se, r2 = eqtl_ols_stats(
        design["X"], design["used"], design["ncols"], pair_off, pair_gene,
        expr)
    deg = design["degenerate"][pair_snarls(pair_off, pair_gene.shape[0])]
    return fetch_async(student_t_pvalues(t1, df_res, deg, beta, se, r2))
