"""Permutation testing (``vcf --permutations N``), Westfall–Young min-P.

The port of stoat_tpu/pipeline/permutation.py (single device).  Each
chunk's phenotype-independent part is computed once on the device, and the
observed phenotype and its K permutations go through the same kernels as
one batch of 1 + K rows:

  -b        K15: the chunk's membership words once (perm_membership), then
            per (k, snarl) the case counts against the packed case mask
            k, the table, filter and chi-squared statistic of K3
            (perm_binary_stats, csrc/perm_binary.cu), then the chi-squared
            tail (K5, csrc/chi2_tail.cu)
  -q        Q1 (the design, with the covariates when given), then per
            (k, snarl) the OLS t statistic of y = phenos[k] * used with the
            snarl's inverse computed once (perm_ols_stats, csrc/perm_ols.cu),
            then the Student-t tail (Q3, csrc/student_t.cu)
  -b -c     Q1 without covariates, then the covariate-adjusted logistic
            score test: D, V^-1, df and the flags once per chunk
            (score_precompute), then T = U^T V^-1 U with U = D^T (used e_k)
            (score_perm_stats), both csrc/score_test.cu; then the
            chi-squared tail (K5, csrc/chi2_tail.cu)

Every p-value is then sanitised: filtered, invalid and non-finite tests
score +inf (never significant, never in the null minimum).  Per snarl the
empirical p is (1 + #{k : p_k <= p_obs}) / (K + 1); the family-wise p is
(1 + #{k : min over all snarls of p_k <= p_obs}) / (K + 1).  The rows
permute whole samples (both haplotypes), one permutation set per run
(``permutation_indices``): masks for ``-b``, Freedman–Lane phenotypes for
``-q`` (the reduced fit y ~ [1 | covariates] plus permuted residuals; plain
label permutation without covariates), permuted residuals of the reduced
logistic fit for ``-b -c``.  The host pieces are numpy copies of the JAX
package's, so a seed gives the same permutations.

Each kernel's plain PyTorch version stands beside its wrapper: a CUDA
tensor launches the kernel or raises, a CPU tensor runs the plain version.
The plain versions take the permutations one row at a time.

On a mesh of several devices (``mesh``; parallel/) the pass
takes blocks of ``snarl_chunk_size`` snarls a device, one shard a device,
each block's invariants computed once per shard for every job, the
observed phenotype as row 0 (stoat_tpu's :493-557); the p-values come back
in snarl order and go through the same accounting, so the tables are
byte-identical to one device's.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from stoat_tpu_torch import trace
from stoat_tpu_torch import writer as W
from stoat_tpu_torch.convert import (DeviceChunk, chunk_words,
                                     to_device_chunk, to_perm_inputs, upload,
                                     upload_words)
from stoat_tpu_torch.device import kernels_enabled, resolve_device
from stoat_tpu_torch.kernels import F64, I64, VOIDP, check_tensor, launch
from stoat_tpu_torch.pipeline.binary import binary_tables_plain
from stoat_tpu_torch.pipeline.packed import (_popcount32,
                                             membership_words_plain,
                                             pack_hap_mask_words,
                                             tail_mask_words)
from stoat_tpu_torch.pipeline.quantitative import quant_design
from stoat_tpu_torch.stats.linalg import ldlt_factor, ldlt_solve
from stoat_tpu_torch.stats.linreg import (linear_pvalues,
                                          normal_inverse_plain,
                                          ols_from_inverse_plain)
from stoat_tpu_torch.stats.special import chi2_sf

logger = logging.getLogger("stoat")

__all__ = ["permutation_indices", "permutation_masks",
           "freedman_lane_phenos", "logistic_null_context", "sanitize_p",
           "perm_membership", "perm_membership_plain", "perm_binary_stats",
           "perm_binary_stats_plain", "perm_ols_stats",
           "perm_ols_stats_plain", "score_precompute",
           "score_precompute_plain", "score_perm_stats",
           "score_perm_stats_plain", "binary_perm_pvalues",
           "quant_perm_pvalues", "score_perm_pvalues", "accumulate_chunk",
           "run_permutation_test"]


# ---------------------------------------------------------------- host

def permutation_indices(n_samples: int, n_perms: int,
                        seed: int) -> np.ndarray:
    """[n_perms, n_samples] sample-level permutation index matrix,
    deterministic in ``seed`` — the ONE rng protocol every permutation
    consumer derives from (stoat_tpu's, :217-224)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n_samples)
                     for _ in range(n_perms)])


def permutation_masks(pheno_bin: np.ndarray, n_perms: int, seed: int,
                      n_words: int,
                      perm_idx: Optional[np.ndarray] = None
                      ) -> np.ndarray:
    """[n_perms, W] uint32 packed case masks built ON TOP of
    :func:`permutation_indices` (haplotype pairs move together)."""
    pheno = np.asarray(pheno_bin).astype(bool)
    if perm_idx is None:
        perm_idx = permutation_indices(pheno.shape[0], n_perms, seed)
    out = np.empty((perm_idx.shape[0], n_words), np.uint32)
    for i, idx in enumerate(perm_idx):
        out[i] = pack_hap_mask_words(np.repeat(pheno[idx], 2), n_words)
    return out


def freedman_lane_phenos(pheno_q: np.ndarray, covar,
                         perm_idx: np.ndarray) -> np.ndarray:
    """[K, N] Freedman–Lane permuted phenotypes: reduced-model fit
    (``y ~ [1 | covariates]``, ordinary least squares on host) plus
    permuted residuals.  With no covariates this is exactly plain label
    permutation (the reduced fit is the permutation-invariant mean).  The
    reduced model is fit on all samples once, while each snarl's OLS runs
    on its called samples, so the adjusted null is approximate where a
    snarl's call rate is low (stoat_tpu's note, :278-298)."""
    y = np.asarray(pheno_q, np.float64)
    C = (np.zeros((y.shape[0], 0))
         if covar is None else np.asarray(covar, np.float64))
    Z = np.concatenate([np.ones((y.shape[0], 1)), C], axis=1)
    beta, *_ = np.linalg.lstsq(Z, y, rcond=None)
    fit = Z @ beta
    resid = y - fit
    return fit[None, :] + resid[perm_idx]


def logistic_null_context(pheno_bin: np.ndarray, covar):
    """Reduced-model logistic fit ``y ~ [1 | covariates]`` (host f64
    IRLS, tiny ridge for stability).  Returns (Z, w, e): the reduced
    design, the working weights p̂(1-p̂), and the response residuals
    y − p̂ — the ingredients of the covariate-adjusted score test."""
    y = np.asarray(pheno_bin, np.float64)
    C = (np.zeros((y.shape[0], 0))
         if covar is None else np.asarray(covar, np.float64))
    Z = np.concatenate([np.ones((y.shape[0], 1)), C], axis=1)
    beta = np.zeros(Z.shape[1])
    for _ in range(50):
        eta = Z @ beta
        p = 1.0 / (1.0 + np.exp(-eta))
        w = np.clip(p * (1.0 - p), 1e-8, None)
        H = Z.T @ (w[:, None] * Z) + 1e-8 * np.eye(Z.shape[1])
        step = np.linalg.solve(H, Z.T @ (y - p))
        beta = beta + step
        if np.max(np.abs(step)) < 1e-10:
            break
    p = 1.0 / (1.0 + np.exp(-(Z @ beta)))
    w = np.clip(p * (1.0 - p), 1e-8, None)
    return Z, w, y - p


def sanitize_p(p: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
    """Filtered/invalid/non-finite → +inf (never significant, never in
    the null minimum); real p clipped into [0, 1] (:71-75)."""
    p = torch.clamp(p, 0.0, 1.0)
    return torch.where(bad | ~torch.isfinite(p), float("inf"), p)


# ---------------------------------------------------------------- K15

def perm_membership_plain(words: torch.Tensor, path_idx: torch.Tensor,
                          path_valid: torch.Tensor, tail: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`perm_membership`."""
    mem = membership_words_plain(words, path_idx) & tail
    mem = torch.where(path_valid[:, None], mem, torch.zeros_like(mem))
    return mem, _popcount32(mem).sum(dim=-1).to(torch.int32)


def _perm_membership_cuda(words, path_idx, path_valid, tail):
    device = words.device
    R, W = words.shape
    P, K = path_idx.shape
    check_tensor(words, "words", torch.int32, (R, W), device)
    check_tensor(path_idx, "path_idx", torch.int32, (P, K), device)
    check_tensor(path_valid, "path_valid", torch.bool, (P,), device)
    check_tensor(tail, "tail", torch.int32, (W,), device)
    mem = torch.empty((P, W), dtype=torch.int32, device=device)
    g_all = torch.empty(P, dtype=torch.int32, device=device)
    launch("perm_membership", [VOIDP] * 6 + [I64] * 3,
           [words.data_ptr(), path_idx.data_ptr(), path_valid.data_ptr(),
            tail.data_ptr(), mem.data_ptr(), g_all.data_ptr(), P, K, W],
           device, source="perm_binary")
    return mem, g_all


def perm_membership(words: torch.Tensor, path_idx: torch.Tensor,
                    path_valid: torch.Tensor, tail: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A chunk's membership words, int32 [P, W] (the AND of each path's
    edge rows, ANDed with ``tail``, 0 on invalid paths), and their
    popcounts g_all int32 [P]: K1 once per chunk (stoat_tpu's
    _ChunkDevice, membership_words).

    CUDA tensors run csrc/perm_binary.cu perm_membership, one warp per
    path, which is bound by gathering P * K * W * 4 bytes of word rows and
    writing the P * W * 4 bytes of membership; CPU tensors the plain
    version."""
    if kernels_enabled(words.device):
        return _perm_membership_cuda(words, path_idx, path_valid, tail)
    return perm_membership_plain(words, path_idx, path_valid, tail)


Stats3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def perm_binary_stats_plain(mem: torch.Tensor, g_all: torch.Tensor,
                            masks: torch.Tensor, snarl_path_idx: torch.Tensor,
                            min_individuals, min_haplotypes,
                            maf_threshold) -> Stats3:
    """Plain PyTorch version of :func:`perm_binary_stats`: per mask, the
    case counts, then :func:`binary_tables_plain`."""
    S = snarl_path_idx.shape[0]
    K = masks.shape[0]
    device = mem.device
    stat = torch.empty((K, S), dtype=torch.float64, device=device)
    df = torch.empty((K, S), dtype=torch.float64, device=device)
    bad = torch.empty((K, S), dtype=torch.bool, device=device)
    for k in range(K):
        g1 = _popcount32(mem & masks[k][None, :]).sum(dim=-1)
        g0 = g_all.to(torch.int64) - g1
        t = binary_tables_plain(g0.to(torch.float64), g1.to(torch.float64),
                                snarl_path_idx, min_individuals,
                                min_haplotypes, maf_threshold)
        stat[k], df[k] = t["chi2_stat"], t["chi2_df"]
        bad[k] = t["filtered"] | t["chi2_invalid"] | t["chi2_zexp"]
    return stat, df, bad


def _perm_binary_cuda(mem, g_all, masks, snarl_path_idx, min_individuals,
                      min_haplotypes, maf_threshold):
    device = mem.device
    P, W = mem.shape
    K = masks.shape[0]
    S, Pmax = snarl_path_idx.shape
    check_tensor(mem, "mem", torch.int32, (P, W), device)
    check_tensor(g_all, "g_all", torch.int32, (P,), device)
    check_tensor(masks, "masks", torch.int32, (K, W), device)
    check_tensor(snarl_path_idx, "snarl_path_idx", torch.int32, (S, Pmax),
                 device)
    # the kernel copies 16-byte blocks from the word buffers' starts on: a
    # view that starts elsewhere goes as a fresh copy
    mem, masks = (t if t.data_ptr() % 16 == 0 else t.clone()
                  for t in (mem, masks))
    stat = torch.empty((K, S), dtype=torch.float64, device=device)
    df = torch.empty((K, S), dtype=torch.float64, device=device)
    bad = torch.empty((K, S), dtype=torch.bool, device=device)
    launch("perm_binary", [VOIDP] * 4 + [I64] * 4 + [F64] * 3 + [VOIDP] * 3,
           [mem.data_ptr(), g_all.data_ptr(), masks.data_ptr(),
            snarl_path_idx.data_ptr(), K, S, Pmax, W,
            float(min_individuals), float(min_haplotypes),
            float(maf_threshold), stat.data_ptr(), df.data_ptr(),
            bad.data_ptr()], device, source="perm_binary")
    return stat, df, bad


def perm_binary_stats(mem: torch.Tensor, g_all: torch.Tensor,
                      masks: torch.Tensor, snarl_path_idx: torch.Tensor,
                      min_individuals, min_haplotypes,
                      maf_threshold) -> Stats3:
    """(chi2_stat, chi2_df, bad), [K, S] each, of K packed case masks
    (int32 [K, W]) against a chunk's membership (:func:`perm_membership`):
    g1 = popcount(mem & mask_k), g0 = g_all - g1 per path, then K3's
    table, filter and statistic per snarl, bad = filtered | invalid |
    zero expected (stoat_tpu's _perm_binary_pvalues without its tail).

    CUDA tensors run csrc/perm_binary.cu perm_binary: the case counts as
    a product of 0/1 matrices on the tensor cores' binary AND + POPC
    product (exact), bound by its 2 * (real paths) * K * 32 W operations,
    then K3's device code, so the statistic has K3's and the plain
    version's bits; CPU tensors the plain version."""
    if kernels_enabled(mem.device):
        return _perm_binary_cuda(mem, g_all, masks, snarl_path_idx,
                                 min_individuals, min_haplotypes,
                                 maf_threshold)
    return perm_binary_stats_plain(mem, g_all, masks, snarl_path_idx,
                                   min_individuals, min_haplotypes,
                                   maf_threshold)


def binary_perm_pvalues(stat: torch.Tensor, df: torch.Tensor,
                        bad: torch.Tensor) -> torch.Tensor:
    """[K, S] sanitised chi-squared p-values (K5 on the statistics)."""
    return sanitize_p(chi2_sf(stat, df), bad)


# ---------------------------------------------------------------- K16a

def perm_ols_stats_plain(X: torch.Tensor, used: torch.Tensor,
                         ncols: torch.Tensor, phenos: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`perm_ols_stats`: the inverse once,
    then the y-dependent part of the plain OLS per phenotype."""
    K = phenos.shape[0]
    S = X.shape[0]
    inv = normal_inverse_plain(X, ncols)
    t1 = torch.empty((K, S), dtype=torch.float64, device=X.device)
    df = torch.empty((K, S), dtype=torch.float64, device=X.device)
    for k in range(K):
        y = phenos[k][None, :] * used
        t1[k], df[k], *_ = ols_from_inverse_plain(X, y, used, ncols, inv)
    return t1, df


def _perm_ols_cuda(X, used, ncols, phenos):
    device = X.device
    S, N, P = X.shape
    K = phenos.shape[0]
    check_tensor(X, "X", torch.float64, (S, N, P), device)
    check_tensor(used, "used", torch.bool, (S, N), device)
    check_tensor(ncols, "ncols", torch.int32, (S,), device)
    check_tensor(phenos, "phenos", torch.float64, (K, N), device)
    # per snarl: X^T X, its factor, the inverse and Jacobi's V (P x P
    # each), D and a solve column (P each), df_res (1)
    work = torch.empty((S, 4 * P * P + 2 * P + 1), dtype=torch.float64,
                       device=device)
    t1 = torch.empty((K, S), dtype=torch.float64, device=device)
    df = torch.empty((K, S), dtype=torch.float64, device=device)
    launch("perm_ols", [VOIDP] * 7 + [I64] * 4,
           [X.data_ptr(), used.data_ptr(), ncols.data_ptr(),
            phenos.data_ptr(), work.data_ptr(), t1.data_ptr(),
            df.data_ptr(), S, N, P, K], device)
    return t1, df


def perm_ols_stats(X: torch.Tensor, used: torch.Tensor, ncols: torch.Tensor,
                   phenos: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t1, df_res), float64 [K, S] each: for every phenotype row k
    (float64 [K, N]) the OLS t statistic of y = phenos[k] * used against
    each snarl's design X (float64 [S, N, P], rows of unused samples
    zero), with the pad-diagonal rule, the LDL^T rank probe and the
    pseudo-inverse of stoat_tpu's linear_regression_stats_batch.

    CUDA tensors run csrc/perm_ols.cu: one warp per snarl inverts X^T X
    once, then blocks of snarl groups x phenotype tiles form X^T Y and the
    residuals on the float64 tensor cores (csrc/perm_gemm_device.cuh); it
    is bound by its ~4 K S N P float64 operations.  CPU tensors run the
    plain version."""
    if kernels_enabled(X.device):
        return _perm_ols_cuda(X, used, ncols, phenos)
    return perm_ols_stats_plain(X, used, ncols, phenos)


def quant_perm_pvalues(t1: torch.Tensor, df: torch.Tensor,
                       bad: torch.Tensor) -> torch.Tensor:
    """[K, S] sanitised Student-t p-values (Q3 over the [K * S]
    statistics); ``bad`` [S] marks filtered and degenerate snarls."""
    return sanitize_p(linear_pvalues(t1, df), bad[None, :])


# ---------------------------------------------------------------- K16b/c

def _ldlt_ill(Dpiv: torch.Tensor) -> torch.Tensor:
    """Per-batch flag: any LDL^T pivot tiny relative to the largest (the
    factorization substitutes safe pivots, so conditioning is judged from
    the pivots, :145-152); NaN pivots propagate to False, as in JAX."""
    a = Dpiv.abs()
    amax = torch.clamp(a.amax(dim=1), min=1e-300)
    return a.amin(dim=1) <= 1e-10 * amax


Score = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def score_precompute_plain(X: torch.Tensor, used: torch.Tensor,
                           ncols: torch.Tensor, bad: torch.Tensor,
                           Z: torch.Tensor, w: torch.Tensor) -> Score:
    """Plain PyTorch version of :func:`score_precompute`."""
    S, N, PT = X.shape
    t = torch.arange(PT, device=X.device)
    varmask = (t[None, :] >= 1) & (t[None, :] < ncols[:, None])
    D = X * varmask[:, None, :]
    wt = w[None, :] * used
    DW = D * wt[:, :, None]
    Vfull = torch.einsum("snp,snq->spq", DW, D)
    A = torch.einsum("snp,nc->spc", DW, Z)
    G = torch.einsum("sn,nc,nd->scd", wt, Z, Z)
    Lg, Dg = ldlt_factor(G)
    GinvAt = ldlt_solve(Lg, Dg, A.transpose(1, 2))
    V = Vfull - torch.einsum("spc,scq->spq", A, GinvAt)
    pad = (~varmask).to(torch.float64)
    Vp = V + torch.diag_embed(pad)
    Lv, Dv = ldlt_factor(Vp)
    eye = torch.eye(PT, dtype=X.dtype, device=X.device).expand(S, PT, PT)
    Vinv = ldlt_solve(Lv, Dv, eye)
    df = (ncols - 1).to(torch.float64)
    allbad = (bad | _ldlt_ill(Dg) | _ldlt_ill(Dv)
              | ~torch.isfinite(Vinv.sum(dim=(1, 2))) | (df < 1))
    return D, Vinv, torch.clamp(df, min=1.0), allbad


def _score_precompute_cuda(X, used, ncols, bad, Z, w):
    device = X.device
    S, N, PT = X.shape
    C1 = Z.shape[1]
    check_tensor(X, "X", torch.float64, (S, N, PT), device)
    check_tensor(used, "used", torch.bool, (S, N), device)
    check_tensor(ncols, "ncols", torch.int32, (S,), device)
    check_tensor(bad, "bad", torch.bool, (S,), device)
    check_tensor(Z, "Z", torch.float64, (N, C1), device)
    check_tensor(w, "w", torch.float64, (N,), device)
    # per snarl, where the kernel's shared memory cannot hold its algebra:
    # the Gram of [D | Z] ((PT + C1)^2), G and L_g (C1 x C1 each), G^-1 Z^T
    # W D (PT x C1), V, L_v and V^-1's columns (PT x PT each) and the
    # pivots (C1 + PT)
    stride = ((PT + C1) ** 2 + 2 * C1 * C1 + C1 + PT * C1 + 3 * PT * PT
              + PT)
    work = torch.empty((S, stride), dtype=torch.float64, device=device)
    D = torch.empty_like(X)
    Vinv = torch.empty((S, PT, PT), dtype=torch.float64, device=device)
    df = torch.empty(S, dtype=torch.float64, device=device)
    allbad = torch.empty(S, dtype=torch.bool, device=device)
    launch("score_precompute", [VOIDP] * 11 + [I64] * 5,
           [X.data_ptr(), used.data_ptr(), ncols.data_ptr(), bad.data_ptr(),
            Z.data_ptr(), w.data_ptr(), work.data_ptr(), D.data_ptr(),
            Vinv.data_ptr(), df.data_ptr(), allbad.data_ptr(), S, N, PT, C1,
            stride], device, source="score_test")
    return D, Vinv, df, allbad


def score_precompute(X: torch.Tensor, used: torch.Tensor,
                     ncols: torch.Tensor, bad: torch.Tensor, Z: torch.Tensor,
                     w: torch.Tensor) -> Score:
    """(D, Vinv, df, allbad): the permutation-invariant pieces of the
    covariate-adjusted logistic score test per snarl (stoat_tpu's
    _score_precompute_jit, :155-197).  D float64 [S, N, PT] is X on the
    variant columns 1 <= t < ncols; Vinv [S, PT, PT] the inverse efficient
    information (D^T W D - D^T W Z (Z^T W Z)^-1 Z^T W D, the other
    columns' diagonal padded with 1) with W = w on the used rows; df =
    max(ncols - 1, 1); allbad = bad, an ill-conditioned Z^T W Z or V (LDL^T
    pivot test), a non-finite Vinv or no variant column.  Z float64 [N,
    1 + C] and w float64 [N] come from :func:`logistic_null_context`.

    CUDA tensors run csrc/score_test.cu score_precompute, one warp per
    snarl (the Gram of [D | Z] on the float64 tensor cores, the algebra
    spread over the warp), bound by reading X and writing D; CPU tensors
    the plain version."""
    if kernels_enabled(X.device):
        return _score_precompute_cuda(X, used, ncols, bad, Z, w)
    return score_precompute_plain(X, used, ncols, bad, Z, w)


def score_perm_stats_plain(D: torch.Tensor, used: torch.Tensor,
                           Vinv: torch.Tensor,
                           e: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`score_perm_stats`."""
    K = e.shape[0]
    T = torch.empty((K, D.shape[0]), dtype=torch.float64, device=D.device)
    for k in range(K):
        U = torch.einsum("snp,sn->sp", D, used * e[k][None, :])
        T[k] = torch.einsum("sp,spq,sq->s", U, Vinv, U)
    return T


def _score_perm_cuda(D, used, Vinv, e):
    device = D.device
    S, N, PT = D.shape
    K = e.shape[0]
    check_tensor(D, "D", torch.float64, (S, N, PT), device)
    check_tensor(used, "used", torch.bool, (S, N), device)
    check_tensor(Vinv, "Vinv", torch.float64, (S, PT, PT), device)
    check_tensor(e, "e", torch.float64, (K, N), device)
    T = torch.empty((K, S), dtype=torch.float64, device=device)
    launch("score_perm", [VOIDP] * 5 + [I64] * 4,
           [D.data_ptr(), used.data_ptr(), Vinv.data_ptr(), e.data_ptr(),
            T.data_ptr(), S, N, PT, K], device, source="score_test")
    return T


def score_perm_stats(D: torch.Tensor, used: torch.Tensor, Vinv: torch.Tensor,
                     e: torch.Tensor) -> torch.Tensor:
    """T float64 [K, S] = U^T Vinv U with U = D^T (used * e_k), for every
    residual row of ``e`` (float64 [K, N]) (stoat_tpu's
    _perm_score_pvalues without its tail).

    CUDA tensors run csrc/score_test.cu score_perm, blocks of snarl groups
    x residual tiles forming U on the float64 tensor cores
    (csrc/perm_gemm_device.cuh), bound by its 2 K S N PT float64
    operations; CPU tensors the plain version."""
    if kernels_enabled(D.device):
        return _score_perm_cuda(D, used, Vinv, e)
    return score_perm_stats_plain(D, used, Vinv, e)


def score_perm_pvalues(T: torch.Tensor, df: torch.Tensor,
                       allbad: torch.Tensor) -> torch.Tensor:
    """[K, S] sanitised score-test p-values: the chi-squared tail of
    max(T, 0) on df; +inf where allbad or T is not finite."""
    p = chi2_sf(torch.clamp(T, min=0.0), df[None, :])
    return sanitize_p(p, allbad[None, :] | ~torch.isfinite(T))


# ---------------------------------------------------------------- the pass

@trace.spanned("perm.dispatch")
def _chunk_pvalues(kind: str, chunk: DeviceChunk, inputs, covar, th,
                   n_haplotypes: int) -> torch.Tensor:
    """[1 + K, S] sanitised p-values of one chunk for one job: row 0 the
    observed phenotype, then the permutations (its S snarls, padding
    included, count as ``perm.snarls_computed``)."""
    trace.count("perm.snarls_computed", chunk.snarl_path_idx.shape[0])
    if kind == "binary":
        mem, g_all = perm_membership(chunk.words, chunk.path_idx,
                                     chunk.path_valid, chunk.tail)
        return binary_perm_pvalues(*perm_binary_stats(
            mem, g_all, inputs.masks, chunk.snarl_path_idx, *th))
    d = quant_design(chunk, covar, *th, n_haplotypes)
    bad = d["filtered"] | d["degenerate"]
    if kind == "binary_score":
        D, Vinv, df, allbad = score_precompute(d.pop("X"), d["used"],
                                               d["ncols"], bad, inputs.Z,
                                               inputs.w)
        return score_perm_pvalues(
            score_perm_stats(D, d["used"], Vinv, inputs.e), df, allbad)
    t1, df = perm_ols_stats(d.pop("X"), d["used"], d["ncols"],
                            inputs.phenos)
    return quant_perm_pvalues(t1, df, bad)


def accumulate_chunk(state: Dict, chrom: str, snarls, p: torch.Tensor
                     ) -> None:
    """The Westfall–Young accounting of one chunk (:476-486): per snarl the
    observed p (row 0) and the number of permutations at or below it, and
    the running minimum of each permutation over all snarls.  The counts
    and minima are taken on the device; [S] and [K] come back.  The
    snarls with a finite observed p count as ``perm.snarls_tested``."""
    S = len(snarls)
    obs, perm = p[0, :S], p[1:, :S]
    exc = (perm <= obs[None, :]).sum(dim=0)
    with trace.span("perm.wait_card"):
        if S:
            state["null_min"] = np.minimum(
                state["null_min"], perm.amin(dim=1).cpu().numpy())
        obs = obs.cpu().numpy()
        exc = exc.cpu().numpy()
    trace.count("perm.snarls_tested", np.isfinite(obs).sum())
    state["rows"].extend((chrom, sn, float(obs[i]), int(exc[i]))
                         for i, sn in enumerate(snarls))


@trace.spanned("perm.write")
def _write_permutation_tsv(out_path: str, state: Dict, n_perms: int) -> int:
    """The permutation TSV (:593-613); returns the tested snarls."""
    n_tested = 0
    null_sorted = np.sort(state["null_min"])
    with open(out_path, "w", newline="") as fh:
        fh.write("#CHR\tSTART_POS\tEND_POS\tSNARL\tP_ASY\tP_EMP\tP_FWER\n")
        for chrom, sn, obs_p, exc in state["rows"]:
            if not np.isfinite(obs_p):
                fh.write(f"{chrom}\t{sn.start_pos}\t{sn.end_pos}\t"
                         f"{sn.snarl_id_str}\tNA\tNA\tNA\n")
                continue
            n_tested += 1
            p_emp = (1 + exc) / (n_perms + 1)
            fw = int(np.searchsorted(null_sorted, obs_p, side="right"))
            p_fwer = (1 + fw) / (n_perms + 1)
            fh.write(f"{chrom}\t{sn.start_pos}\t{sn.end_pos}\t"
                     f"{sn.snarl_id_str}\t{W.format_p(obs_p)}\t"
                     f"{W.format_p(p_emp)}\t{W.format_p(p_fwer)}\n")
    return n_tested


@trace.spanned("perm")
def run_permutation_test(vcf_path: str, snarls_chr: Dict[str, List],
                         output_tsv: Optional[str] = None,
                         pheno_bin: Optional[np.ndarray] = None,
                         n_perms: int = 1000, seed: int = 0,
                         min_individuals: int = 3,
                         min_haplotypes: int = 5,
                         maf_threshold: float = 0.05,
                         snarl_chunk_size: int = 8192,
                         quantitative_phenotype: Optional[np.ndarray]
                         = None,
                         output_tsv_quant: Optional[str] = None,
                         covariate: Optional[np.ndarray] = None,
                         device=None, mesh=None) -> int:
    """Genome-wide permutation pass on ``device`` (default: the CUDA card;
    "cpu" runs the plain versions), or on a mesh: ``mesh``, else every
    visible card when ``device`` is None or a bare ``cuda`` and more than
    one is visible (parallel/mesh.py resolve_mesh).

    With BOTH phenotypes supplied, one VCF pass serves both.  Writes per
    snarl the observed asymptotic p (``P_ASY``), the empirical p and the
    min-P FWER p, byte-identical to stoat_tpu's run_permutation_test;
    with ``covariate`` the binary pass runs the covariate-adjusted score
    test and the quantitative pass Freedman–Lane.  Returns the number of
    tested (non-filtered) snarls across all outputs."""
    from stoat_tpu_torch.parallel.mesh import resolve_mesh
    from stoat_tpu_torch.parallel.sharded import Replicated
    from stoat_tpu_torch.pipeline.runner import iter_chromosome_matrices
    from stoat_tpu_torch.tables import pack_chromosome_chunks

    device = "cuda" if device is None else device
    mesh = resolve_mesh(device, mesh)
    if mesh is not None:
        logger.info("Permutations: sharding snarls over %d devices: %s",
                    len(mesh), ", ".join(str(d) for d in mesh.devices))
        device = mesh.devices[0]
    device = resolve_device(device)
    jobs = []   # (kind, output path, phenotype)
    if pheno_bin is not None:
        if output_tsv is None:
            raise ValueError("output_tsv required for the binary pass")
        kind = "binary" if covariate is None else "binary_score"
        jobs.append((kind, output_tsv, np.asarray(pheno_bin)))
    if quantitative_phenotype is not None:
        q_out = output_tsv_quant or output_tsv
        if q_out is None or (pheno_bin is not None
                             and output_tsv_quant is None):
            raise ValueError("output_tsv_quant required when both "
                             "phenotypes run")
        jobs.append(("quantitative", q_out,
                     np.asarray(quantitative_phenotype)))
    if not jobs:
        raise ValueError("a binary or quantitative phenotype is required")

    n_samples = len(jobs[0][2])
    n_hap = 2 * n_samples
    with trace.span("perm.rows"):
        perm_idx = permutation_indices(n_samples, n_perms, seed)
    th = (min_individuals, min_haplotypes, maf_threshold)
    covar_q = upload(np.zeros((n_samples, 0)) if covariate is None
                     else np.asarray(covariate, np.float64), device)
    no_covar = torch.zeros((n_samples, 0), dtype=torch.float64,
                           device=device)
    inputs = {}     # per job: PermInputs of the observed row + K rows
    state = {kind: {"rows": [], "null_min": np.full(n_perms, np.inf)}
             for kind, _o, _p in jobs}
    replicated = None if mesh is None else Replicated(mesh)

    for chrom, matrix in trace.each("perm.ingest", iter_chromosome_matrices(
            vcf_path, n_hap, snarls_chr)):
        if chrom not in snarls_chr:
            continue
        if mesh is not None:
            _mesh_blocks(jobs, state, inputs, chrom, matrix,
                         snarls_chr[chrom], mesh, replicated,
                         snarl_chunk_size, covariate, perm_idx, n_perms,
                         seed, th)
            continue
        words = tail = None
        for packed in trace.each("perm.pack", pack_chromosome_chunks(
                snarls_chr[chrom], matrix, snarl_chunk_size)):
            if words is None:
                # one upload per chromosome: every chunk shares its words
                words = upload_words(chunk_words(packed), device)
                tail = upload(tail_mask_words(
                    n_hap, int(words.shape[1])).view(np.int32), device)
            chunk = to_device_chunk(packed, None, device, words=words)
            chunk.tail = tail
            for kind, _out, pheno in jobs:
                if kind not in inputs:
                    with trace.span("perm.rows"):
                        inputs[kind] = to_perm_inputs(device, **_job_rows(
                            kind, pheno, covariate, perm_idx, n_perms, seed,
                            int(words.shape[1])))
                covar = covar_q if kind == "quantitative" else no_covar
                p = _chunk_pvalues(kind, chunk, inputs[kind], covar, th,
                                   packed.n_haplotypes)
                accumulate_chunk(state[kind], chrom, packed.snarls, p)

    n_tested = 0
    for kind, out_path, _pheno in jobs:
        n_tested += _write_permutation_tsv(out_path, state[kind], n_perms)
        logger.info("Permutation test (%s): %d permutations -> %s",
                    kind, n_perms, out_path)
    return n_tested


def _job_rows(kind: str, pheno: np.ndarray, covariate, perm_idx,
              n_perms: int, seed: int, n_words: int) -> Dict[str, np.ndarray]:
    """The observed row and the K permuted rows of one job, on the host
    (``convert.to_perm_inputs``' keywords)."""
    if kind == "binary":
        obs = pack_hap_mask_words(np.repeat(pheno.astype(bool), 2), n_words)
        masks = permutation_masks(pheno, n_perms, seed, n_words, perm_idx)
        return {"masks": np.concatenate([obs[None, :], masks])}
    if kind == "binary_score":
        Z, w, e = logistic_null_context(pheno, covariate)
        return {"Z": Z, "w": w,
                "e": np.concatenate([e[None, :], e[perm_idx]])}
    ph = np.asarray(pheno, np.float64)
    return {"phenos": np.concatenate(
        [ph[None, :], freedman_lane_phenos(ph, covariate, perm_idx)])}


def _mesh_blocks(jobs, state, rows, chrom, matrix, snarls, mesh, replicated,
                 snarl_chunk_size, covariate, perm_idx, n_perms, seed,
                 th) -> None:
    """One chromosome of the pass on the mesh (stoat_tpu, :493-557):
    blocks of ``snarl_chunk_size`` snarls a device, one
    ``ShardedPermState`` a block serving every job; ``rows`` keeps each
    job's host rows (:func:`_job_rows`) for the run."""
    from stoat_tpu_torch.parallel.mesh import shard_chromosome_chunks
    from stoat_tpu_torch.parallel.sharded import (
        ShardedPermState, binary_perm_pvalues_sharded,
        logistic_score_perm_sharded, quant_perm_pvalues_sharded)

    for sharded in trace.each("perm.pack", shard_chromosome_chunks(
            snarls, matrix, snarl_chunk_size * len(mesh), len(mesh))):
        pstate = ShardedPermState(sharded, mesh, replicated)
        n_shards, s_local = sharded.snarl_path_idx.shape[:2]
        for kind, _out, pheno in jobs:
            if kind not in rows:
                with trace.span("perm.rows"):
                    rows[kind] = _job_rows(kind, pheno, covariate, perm_idx,
                                           n_perms, seed,
                                           int(sharded.words.shape[1]))
            r = rows[kind]
            # the sharded calls return host p-values: the card's time is
            # inside the dispatch span
            trace.count("perm.snarls_computed", n_shards * s_local)
            with trace.span("perm.dispatch"):
                if kind == "binary":
                    p = binary_perm_pvalues_sharded(
                        sharded, r["masks"], mesh, *th, state=pstate)
                elif kind == "binary_score":
                    p = logistic_score_perm_sharded(
                        sharded, r["Z"], r["w"], r["e"], mesh, *th,
                        state=pstate)
                else:
                    p = quant_perm_pvalues_sharded(
                        sharded, r["phenos"], covariate, mesh, *th,
                        state=pstate)
            accumulate_chunk(state[kind], chrom, sharded.snarls,
                             torch.from_numpy(p))
