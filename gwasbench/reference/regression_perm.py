"""Plain PyTorch reference of ``vcf -q|-b ... -c -C AGE,SEX --permutations K``.

What a job of these cells must write, worked out again from the cohort's
arrays and the seed: nothing of the program is imported or read.  It
follows stoat's definitions as stoat_tpu_torch's docstrings state them
(pipeline/quantitative.py, stats/linreg.py, stats/logreg.py and
pipeline/permutation.py at the commit that added this benchmark), with
its own arithmetic:

- membership: a haplotype carries a snarl's path when the edges of the
  path lie among the edges its allele's AT path gives it; every edge of a
  snarl's paths is checked to occur in no other record, so the edges of
  one record decide (``inclusion``);
- the design: per sample the dosage of each path carried (0-2); kept
  paths have carriers; used samples carry a kept path; each row divided
  by its sum; filtered when fewer than 2 paths are kept, fewer used
  samples than min_individuals or min_haplotypes, or fewer than 2 kept
  columns with a minor frequency above the MAF; with 3 or more kept,
  identical columns summed; the last column dropped; X = [1 | variant
  columns | covariates] on the used rows; degenerate (NA) when no variant
  column is left;
- ``-q -c``: OLS of the trait on X, the first variant column's t, its
  two-sided Student-t p on n_used - ncols + 1 degrees of freedom
  (scipy's stdtr), beta, se and R^2 = 1 - rss / tss; a singular X^T X
  (a Cholesky pivot below 1e-10) takes the eigenvalue pseudo-inverse with
  the absolute tolerance 1e-6;
- ``-b -c``: the logistic model on X without covariates (stoat leaves
  them out), Newton steps on the log-likelihood with a 1e-4 ridge,
  weights clamped to [1e-8, 1], stopping when the step moves beta by less
  than 1e-6, NA after 100 steps or a step that is not finite; the Wald
  p = 2 (1 - Phi(|z|)) of each variant column with se from the ridged
  information at the last beta, and Holm's adjustment over them, the
  first column with the smallest adjusted p reported;
- the permutation pass: one sample permutation per row from
  ``numpy.random.default_rng(seed)`` (a frozen copy of the program's
  ``permutation_indices``); ``-q -c`` permutes the residuals of the
  trait on [1 | covariates] (Freedman-Lane) and tests each row as the
  main table does; ``-b -c`` permutes the residuals of the logistic fit
  of the case indicator on [1 | covariates] and takes the score test
  T = U^T V^-1 U with U = D^T (used * e_k), V the efficient information
  of the variant columns D, and stoat's chi-squared tail on ncols - 1
  degrees of freedom (``chi2_tail``: above 85 the upper tail, else 1 - the
  double-precision CDF, which is 0 below 1.1e-16); P_EMP = (1 + #{k :
  p_k <= p_obs}) / (K + 1) and P_FWER = (1 + #{k : min over snarls of
  p_k <= p_obs}) / (K + 1); filtered, degenerate and ill-conditioned
  snarls are NA.

The counts are taken on the device.  For the t test p_k <= p_obs exactly
when |t_k| >= |t_obs| (a snarl's rows share their degrees of freedom and
the tail is monotone), and the family-wise minimum takes, per row, the
largest |t| of each group of snarls that share their degrees of freedom
through the tail (scipy's stdtr).  stoat's chi-squared tail is not
monotone (0 between about T = 70 and 85, positive above), so the score
test's counts are taken on p itself (torch's gammaincc).  The statistics
run in ``dtype``: float64 is the reference, float32 its control.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["Expected", "expected", "render", "permutation_indices",
           "freedman_lane_rows", "logistic_null_rows"]

LDLT_TOL = 1e-10      # a Cholesky pivot below this takes the pseudo-inverse
PINV_TOL = 1e-6       # the pseudo-inverse's absolute eigenvalue tolerance
ILL_RATIO = 1e-10     # score test: pivot ratio of an ill-conditioned matrix
LOGIT_RIDGE = 1e-4
LOGIT_TOL = 1e-6
LOGIT_MAX_ITER = 100
NULL_RIDGE = 1e-8     # the reduced logistic fit's ridge
NEIGHBOURS = 4        # permuted p kept on each side of the observed
CHUNK = 4096          # snarls a block
ROW_BLOCK = 2048      # permutation rows a product


@dataclass
class Expected:
    """Per snarl of the cohort (file order), what the tables must say."""

    kind: str                 # "quantitative" or "binary"
    n_perms: int
    filtered: np.ndarray      # bool [S]: no row in the main table
    na: np.ndarray            # bool [S]: NA statistics in the main table
    allele_paths: np.ndarray  # int [S, 4]
    main: Dict[str, np.ndarray]   # P, BETA, SE (and RSQUARE), float64 [S]
    perm_na: np.ndarray       # bool [S]: an NA row of the permutation table
    p_obs: np.ndarray         # float64 [S]
    stat_obs: np.ndarray      # float64 [S], the observed statistic
    exc: np.ndarray           # int [S], permutations with p_k <= p_obs
    p_lo: np.ndarray          # float64 [S, NEIGHBOURS]: the p of the
    #                           permutations counted, nearest p_obs first
    p_hi: np.ndarray          # and of those not counted (NaN where fewer)
    null_min: np.ndarray      # float64 [K], sorted ascending
    df: np.ndarray            # float64 [S], the test's degrees of freedom
    p_floor: np.ndarray       # float64 [S], the least scale of a p's gap


# ------------------------------------------------------------ host rows

def permutation_indices(n_samples: int, n_perms: int, seed: int):
    """[K, N] sample permutations: the program's rng protocol
    (stoat_tpu_torch/pipeline/permutation.py:87-94)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n_samples) for _ in range(n_perms)])


def freedman_lane_rows(y: np.ndarray, covar: np.ndarray,
                       perm: np.ndarray) -> np.ndarray:
    """[1 + K, N]: the trait, then the fit on [1 | covariates] plus the
    permuted residuals."""
    Z = np.concatenate([np.ones((y.shape[0], 1)), covar], axis=1)
    beta = np.linalg.lstsq(Z, y, rcond=None)[0]
    fit = Z @ beta
    return np.concatenate([y[None, :], fit[None, :] + (y - fit)[perm]])


def logistic_null_rows(case: np.ndarray, covar: np.ndarray,
                       perm: np.ndarray):
    """(Z [N, 3], w [N], E [1 + K, N]): the logistic fit of the case
    indicator on [1 | covariates] (Newton steps with a 1e-8 ridge, at most
    50, until a step moves no coefficient by 1e-10), its weights p (1 - p)
    clamped at 1e-8, and its residuals y - p, then their permutations."""
    y = case.astype(np.float64)
    Z = np.concatenate([np.ones((y.shape[0], 1)), covar], axis=1)
    beta = np.zeros(Z.shape[1])
    for _ in range(50):
        p = 1.0 / (1.0 + np.exp(-(Z @ beta)))
        w = np.clip(p * (1.0 - p), 1e-8, None)
        H = Z.T @ (w[:, None] * Z) + NULL_RIDGE * np.eye(Z.shape[1])
        step = np.linalg.solve(H, Z.T @ (y - p))
        beta = beta + step
        if np.max(np.abs(step)) < 1e-10:
            break
    p = 1.0 / (1.0 + np.exp(-(Z @ beta)))
    w = np.clip(p * (1.0 - p), 1e-8, None)
    e = y - p
    return Z, w, np.concatenate([e[None, :], e[perm]])


# ------------------------------------------------------------ membership

def _nodes(path: str) -> List[int]:
    return [int(x) for x in path.replace("<", ">").split(">") if x]


def inclusion(cohort) -> np.ndarray:
    """bool [S, 4, 4]: [s, a, p] when a haplotype with allele a of snarl s
    carries path p, i.e. every edge of path p is an edge of path a.
    Raises where an edge of one record's paths occurs in another record:
    then the edges of one record would not decide.  Snarls whose paths
    repeat the same pattern of nodes share the table."""
    S = cohort.n_snarls
    out = np.zeros((S, 4, 4), bool)
    tables: Dict[tuple, np.ndarray] = {}
    keys, owners = [], []
    for s, paths in enumerate(cohort.path_strings):
        nodes = [_nodes(p) for p in paths]
        label: Dict[int, int] = {}
        sig = tuple(tuple(label.setdefault(n, len(label)) for n in path)
                    for path in nodes)
        table = tables.get(sig)
        if table is None:
            edges = [set(zip(p[:-1], p[1:])) for p in sig]
            table = np.zeros((4, 4), bool)
            for a, ea in enumerate(edges):
                for q, eq in enumerate(edges):
                    table[a, q] = eq <= ea
            tables[sig] = table
        out[s] = table
        for path in nodes:
            keys.extend(u << 32 | v for u, v in zip(path[:-1], path[1:]))
            owners.extend([s] * (len(path) - 1))
    keys_np, owners_np = np.array(keys, np.int64), np.array(owners)
    order = np.argsort(keys_np, kind="stable")
    k, o = keys_np[order], owners_np[order]
    clash = (k[1:] == k[:-1]) & (o[1:] != o[:-1])
    if clash.any():
        i = int(np.nonzero(clash)[0][0])
        raise ValueError(f"edge {k[i] >> 32}->{k[i] & 0xffffffff} in "
                         f"records {o[i]} and {o[i + 1]}")
    return out


# ------------------------------------------------------------ the tails

CHI2_HIGH_PRECISION = 85.0
DOUBLE_P_FLOOR = 1e-9  # a p computed as 1 - a double CDF moves in steps of
#                        2^-53: it is compared relative to max(p, this)


def _t_tail(stat, df):
    """Two-sided Student-t p of |t| (scipy's stdtr)."""
    from scipy.special import stdtr
    with np.errstate(invalid="ignore"):
        return 2.0 * stdtr(df, -np.abs(stat))


def chi2_tail(stat: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """stoat's chi-squared p of each row of ``stat`` [S, R] on df [S]:
    above 85 the upper tail Q(df/2, T/2) in full precision, else 1 - the
    double-precision CDF, 1 - (1 - Q), which is 0 below 1.1e-16 (the
    reference tool's two branches, stoat_tpu/stats/special.py chi2_sf);
    a subnormal p is 0.  torch's gammaincc, on the device."""
    q = torch.special.gammaincc((0.5 * df)[:, None].expand_as(stat),
                                0.5 * stat)
    p = torch.where(stat > CHI2_HIGH_PRECISION, q, 1.0 - (1.0 - q))
    return torch.where(p < torch.finfo(p.dtype).tiny, 0.0, p)


# ------------------------------------------------------------ the design

def _design(alleles, T, n_alleles, covar, thresholds, dtype):
    """One block's design: dict of X [S, N, P] (dtype), used, ncols,
    filtered, degenerate, allele_paths, n_used."""
    min_ind, min_hap, maf = thresholds
    S, H = alleles.shape
    N = H // 2
    dev = alleles.device
    a = alleles.long()
    called = a >= 0
    carry = torch.gather(T, 1, a.clamp(min=0)[:, :, None].expand(S, H, 4))
    carry = carry & called[:, :, None]                         # [S, 2N, 4]
    dosage = carry[:, 0::2].to(torch.int32) + carry[:, 1::2].to(torch.int32)
    exists = torch.arange(4, device=dev)[None, :] < n_alleles[:, None]
    allele_paths = torch.where(exists, carry.sum(dim=1), 0)
    kept = exists & (allele_paths > 0)
    Dk = dosage * kept[:, None, :]                             # [S, N, 4]
    row_sum = Dk.sum(dim=-1)
    used = row_sum > 0
    n_used = used.sum(dim=-1)
    recip = torch.where(used, 1.0 / row_sum.clamp(min=1).double(), 0.0)
    colsum = (Dk.double() * recip[:, :, None]).sum(dim=1)
    total = n_used.double()
    freq = colsum / total.clamp(min=1.0)[:, None]
    minor = torch.minimum(freq, 1.0 - freq)
    kept_count = kept.sum(dim=-1)
    filtered = ((kept_count < 2) | (total < min_ind) | (total < min_hap)
                | ((kept & (minor > maf)).sum(dim=-1) < 2))

    # identical kept columns, when 3 or more are kept, go to the first
    eq = (Dk[:, :, :, None] == Dk[:, :, None, :]).all(dim=1)   # [S, 4, 4]
    eq = eq & kept[:, :, None] & kept[:, None, :]
    idx = torch.arange(4, device=dev)
    rep = torch.where(eq, idx[None, :, None], 9).amin(dim=1)   # [S, 4]
    rep = torch.where((kept_count >= 3)[:, None], rep,
                      torch.where(kept, idx[None, :], 9))
    is_rep = kept & (rep == idx[None, :])
    merged = torch.einsum("snj,sij->sni", Dk.double(),
                          (rep[:, None, :] == idx[None, :, None]).double())
    last = 3 - is_rep.flip(-1).int().argmax(dim=-1)
    var = is_rep & (idx[None, :] != last[:, None])
    k3 = var.sum(dim=-1)
    degenerate = is_rep.any(dim=-1) & (k3 == 0)

    C = 0 if covar is None else covar.shape[1]
    P = 1 + 3 + C
    X = torch.zeros((S, N, P), dtype=torch.float64, device=dev)
    X[:, :, 0] = 1.0
    slot = torch.cumsum(var.int(), dim=-1)                     # 1-based
    for j in range(4):
        rows = var[:, j].nonzero().squeeze(-1)
        if rows.numel():
            X[rows, :, slot[rows, j]] = merged[rows, :, j] * recip[rows]
    s_idx = torch.arange(S, device=dev)
    for c in range(C):
        X[s_idx, :, 1 + k3 + c] = covar[None, :, c]
    X = torch.where(used[:, :, None], X, 0.0).to(dtype)
    return {"X": X, "used": used, "ncols": 1 + k3 + C, "filtered": filtered,
            "degenerate": degenerate, "allele_paths": allele_paths,
            "n_used": n_used}


def _pad_eye(ncols, P, dtype, dev):
    return torch.diag_embed((torch.arange(P, device=dev)[None, :]
                             >= ncols[:, None]).to(dtype))


def _normal_inverse(A, ncols):
    """A^-1 (X^T X with its padded columns' diagonal 1) by Cholesky, or the
    eigenvalue pseudo-inverse where a pivot of a real column is below
    LDLT_TOL or the factor fails."""
    L, info = torch.linalg.cholesky_ex(A)
    piv = torch.diagonal(L, dim1=1, dim2=2) ** 2
    real = torch.arange(A.shape[1], device=A.device)[None, :] \
        < ncols[:, None]
    bad = (info != 0) | (real & ((piv < LDLT_TOL)
                                 | ~torch.isfinite(piv))).any(dim=-1)
    eye = torch.eye(A.shape[1], dtype=A.dtype, device=A.device)
    inv = torch.cholesky_solve(eye.expand_as(A), L)
    if bool(bad.any()):
        rows = bad.nonzero().squeeze(-1)
        w, V = torch.linalg.eigh(A[rows])
        winv = torch.where(w.abs() > PINV_TOL, 1.0 / w, 0.0)
        inv = inv.clone()
        inv[rows] = (V * winv[:, None, :]) @ V.transpose(1, 2)
    return inv


def _ols_t(d, Y):
    """t of the first variant column for each row of Y [R, N]: (t [S, R],
    df [S], and for row 0: beta, se, r2)."""
    X, used, ncols = d["X"], d["used"], d["ncols"]
    S, N, P = X.shape
    dtype = X.dtype
    XtX = torch.einsum("snp,snq->spq", X, X) \
        + _pad_eye(ncols, P, dtype, X.device)
    inv = _normal_inverse(XtX, ncols)
    u = used.to(dtype)
    n_used = d["n_used"].to(dtype)
    df = torch.clamp(n_used - ncols.to(dtype) + 1.0, min=1.0)
    Xt = X.transpose(1, 2).reshape(S * P, N)
    ts = []
    first = None
    for lo in range(0, Y.shape[0], ROW_BLOCK):
        Yb = Y[lo:lo + ROW_BLOCK]
        XtY = (Xt @ Yb.T).view(S, P, -1)                        # [S, P, R]
        B = inv @ XtY
        yy = u @ (Yb * Yb).T                                    # [S, R]
        rss = yy - (XtY * B).sum(dim=1)
        se = torch.sqrt(inv[:, 1, 1, None] * rss / df[:, None])
        ts.append(B[:, 1, :] / se)
        if first is None:
            y0 = Yb[0]
            mean = (u * y0).sum(dim=1) / n_used.clamp(min=1.0)
            tss = (u * (y0[None, :] - mean[:, None]) ** 2).sum(dim=1)
            first = (B[:, 1, 0], se[:, 0], 1.0 - rss[:, 0] / tss)
    return torch.cat(ts, dim=1), df, first


def _logistic(d, case):
    """(p, beta, se) of the reported column, NaN where NA."""
    X, used, ncols = d["X"], d["used"], d["ncols"]
    S, N, P = X.shape
    dtype = X.dtype
    dev = X.device
    y = case[None, :].to(dtype) * used.to(dtype)
    eye = torch.eye(P, dtype=dtype, device=dev)
    beta = torch.zeros((S, P), dtype=dtype, device=dev)
    active = torch.ones(S, dtype=torch.bool, device=dev)
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    failed = torch.zeros(S, dtype=torch.bool, device=dev)

    def hessian(b, rows):
        Xr = X[rows]
        prob = 1.0 / (1.0 + torch.exp(-(Xr @ b[:, :, None])[:, :, 0]))
        w = torch.clamp(prob * (1.0 - prob), 1e-8, 1.0)
        H = torch.einsum("snp,sn,snq->spq", Xr, w, Xr) + LOGIT_RIDGE * eye
        return H, prob

    for _ in range(LOGIT_MAX_ITER):
        rows = active.nonzero().squeeze(-1)
        if rows.numel() == 0:
            break
        b = beta[rows]
        H, prob = hessian(b, rows)
        g = torch.einsum("snp,sn->sp", X[rows], y[rows] - prob) \
            - LOGIT_RIDGE * b
        step = torch.linalg.solve_ex(H, g)[0]
        ok = torch.isfinite(step).all(dim=-1)
        new = b + step
        conv = ok & (torch.linalg.vector_norm(new - b, dim=-1) < LOGIT_TOL)
        beta[rows] = torch.where(ok[:, None], new, b)
        failed[rows[~ok]] = True
        done[rows[conv]] = True
        active[rows[conv | ~ok]] = False
    na = failed | ~done
    all_rows = torch.arange(S, device=dev)
    H, _ = hessian(beta, all_rows)
    cov = torch.linalg.inv_ex(H)[0]
    se = torch.sqrt(torch.diagonal(cov, dim1=1, dim2=2))
    z = (beta / se).double().cpu().numpy()
    from scipy.special import ndtr
    p = 2.0 * (1.0 - ndtr(np.abs(z)))                            # [S, P]
    ncol = ncols.cpu().numpy()
    out_p = np.full(S, np.nan)
    sel = np.zeros(S, np.int64)
    for s in range(S):
        m = int(ncol[s]) - 1
        if m < 1:
            continue
        ps = p[s, 1:1 + m]
        order = sorted(range(m), key=lambda i: (np.isnan(ps[i]), ps[i]))
        adj = np.empty(m)
        run = -np.inf
        for rank, i in enumerate(order):
            run = max(run, min((m - rank) * ps[i], 1.0))
            adj[i] = run
        j = int(np.argmin(np.where(np.isnan(adj), np.inf, adj)))
        out_p[s], sel[s] = adj[j], 1 + j
    b = beta.double().cpu().numpy()[np.arange(S), sel]
    e = se.double().cpu().numpy()[np.arange(S), sel]
    bad = na.cpu().numpy() | np.isnan(out_p)
    return (np.where(bad, np.nan, out_p), np.where(bad, np.nan, b),
            np.where(bad, np.nan, e))


def _score_T(d, Z, w, E):
    """(T [S, R], df [S], ill [S]): the covariate-adjusted score
    statistic of each residual row of E."""
    X, used, ncols = d["X"], d["used"], d["ncols"]
    S, N, P = X.shape
    dtype = X.dtype
    dev = X.device
    t = torch.arange(P, device=dev)
    var = (t[None, :] >= 1) & (t[None, :] < ncols[:, None])
    D = X * var[:, None, :].to(dtype)
    wt = w[None, :] * used.to(dtype)
    DW = D * wt[:, :, None]
    Vfull = torch.einsum("snp,snq->spq", DW, D)
    A = torch.einsum("snp,nc->spc", DW, Z)
    G = torch.einsum("sn,nc,nd->scd", wt, Z, Z)
    Lg, info_g = torch.linalg.cholesky_ex(G)
    V = Vfull - A @ torch.cholesky_solve(A.transpose(1, 2), Lg)
    Vp = V + torch.diag_embed((~var).to(dtype))
    Lv, info_v = torch.linalg.cholesky_ex(Vp)
    eye = torch.eye(P, dtype=dtype, device=dev).expand(S, P, P)
    Vinv = torch.cholesky_solve(eye, Lv)

    def ill(L, info):
        piv = torch.diagonal(L, dim1=1, dim2=2) ** 2
        return (info != 0) | (piv.amin(dim=1)
                              <= ILL_RATIO * piv.amax(dim=1))
    df = (ncols - 1).to(dtype)
    bad = (ill(Lg, info_g) | ill(Lv, info_v)
           | ~torch.isfinite(Vinv.sum(dim=(1, 2))) | (df < 1))
    Dt = D.transpose(1, 2).reshape(S * P, N)
    Ts = []
    for lo in range(0, E.shape[0], ROW_BLOCK):
        U = (Dt @ E[lo:lo + ROW_BLOCK].T).view(S, P, -1)
        Ts.append((U * (Vinv @ U)).sum(dim=1))
    return torch.cat(Ts, dim=1), torch.clamp(df, min=1.0), bad


# ------------------------------------------------------------ the job

def expected(cohort, config: Dict, n_perms: int, seed: int,
             device, dtype=torch.float64) -> Expected:
    """What a job on ``cohort`` must write (``config["trait"]`` picks
    ``-q -c`` or ``-b -c``), with ``n_perms`` permutations from ``seed``,
    its statistics computed on ``device`` in ``dtype`` (float32 with TF32
    off: the control)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = config["trait"]
    thresholds = (config["min_individuals"], config["min_haplotypes"],
                  config["maf"])
    S, N = cohort.n_snarls, cohort.n_samples
    covar_np = cohort.covariates
    perm = permutation_indices(N, n_perms, seed)
    if kind == "quantitative":
        rows = freedman_lane_rows(cohort.quantitative, covar_np, perm)
        Y = torch.from_numpy(rows).to(device=device, dtype=dtype)
        covar = torch.from_numpy(covar_np).to(device)
    else:
        Z, w, E = logistic_null_rows(cohort.case, covar_np, perm)
        Y = torch.from_numpy(E).to(device=device, dtype=dtype)
        Zt = torch.from_numpy(Z).to(device=device, dtype=dtype)
        wt = torch.from_numpy(w).to(device=device, dtype=dtype)
        case = torch.from_numpy(cohort.case).to(device)
        covar = None
    del perm
    T_all = torch.from_numpy(inclusion(cohort)).to(device)
    alleles_all = torch.from_numpy(cohort.alleles)
    n_all = torch.from_numpy(cohort.n_alleles).to(device)

    filtered = np.zeros(S, bool)
    na = np.zeros(S, bool)
    allele_paths = np.zeros((S, 4), np.int64)
    main = {k: np.full(S, np.nan) for k in ("P", "BETA", "SE", "RSQUARE")}
    perm_na = np.zeros(S, bool)
    stat_obs = np.full(S, np.nan)
    key_obs = np.full(S, np.nan)
    df_all = np.zeros(S)
    exc = np.zeros(S, np.int64)
    key_lo = np.full((S, NEIGHBOURS), np.nan)
    key_hi = np.full((S, NEIGHBOURS), np.nan)
    group_max: Dict[float, torch.Tensor] = {}

    for lo in range(0, S, CHUNK):
        hi = min(lo + CHUNK, S)
        d = _design(alleles_all[lo:hi].to(device), T_all[lo:hi],
                    n_all[lo:hi], covar, thresholds, dtype)
        filtered[lo:hi] = d["filtered"].cpu().numpy()
        deg = d["degenerate"]
        allele_paths[lo:hi] = d["allele_paths"].cpu().numpy()
        if kind == "quantitative":
            t, df, (beta, se, r2) = _ols_t(d, Y)
            stat = t.abs()
            # p_k <= p_obs exactly when |t_k| >= |t_obs|: the same degrees
            # of freedom, a monotone tail
            key = stat
            group = df
            bad = d["filtered"] | deg
            na[lo:hi] = deg.cpu().numpy()
            df_np = df.double().cpu().numpy()
            t0 = t[:, 0].double().cpu().numpy()
            p_main = _t_tail(t0, df_np)
            ok = ~na[lo:hi]
            for name, v in (("P", p_main), ("BETA", beta), ("SE", se),
                            ("RSQUARE", r2)):
                v = v if isinstance(v, np.ndarray) else \
                    v.double().cpu().numpy()
                main[name][lo:hi] = np.where(ok, v, np.nan)
        else:
            p_l, b_l, se_l = _logistic(d, case)
            logit_na = np.isnan(p_l) | deg.cpu().numpy()
            na[lo:hi] = logit_na
            main["P"][lo:hi] = np.where(logit_na, np.nan, p_l)
            main["BETA"][lo:hi] = np.where(logit_na, np.nan, b_l)
            main["SE"][lo:hi] = np.where(logit_na, np.nan, se_l)
            T, df, ill = _score_T(d, Zt, wt, Y)
            stat = torch.where(torch.isfinite(T), torch.clamp(T, min=0.0),
                               float("nan"))
            # stoat's tail is not monotone in T (below, p under 1.1e-16 is
            # 0), so the counts are taken on p: key = -p
            key = -chi2_tail(stat, df)
            group = torch.zeros_like(df)
            bad = d["filtered"] | deg | ill
            df_np = df.double().cpu().numpy()
        del d
        k0 = key[:, 0]
        bad = bad | ~torch.isfinite(k0)
        perm_k = key[:, 1:]
        finite = torch.isfinite(perm_k)
        counted = finite & (perm_k >= k0[:, None])
        m = min(NEIGHBOURS, perm_k.shape[1])
        nb_lo = torch.where(counted, -perm_k, -float("inf")).topk(m, dim=1)
        nb_hi = torch.where(finite & ~counted, perm_k,
                            -float("inf")).topk(m, dim=1)
        klo = (-nb_lo.values).double().cpu().numpy()
        khi = nb_hi.values.double().cpu().numpy()
        bad_np = bad.cpu().numpy()
        perm_na[lo:hi] = bad_np
        stat_obs[lo:hi] = stat[:, 0].double().cpu().numpy()
        key_obs[lo:hi] = k0.double().cpu().numpy()
        exc[lo:hi] = counted.sum(dim=1).cpu().numpy()
        key_lo[lo:hi, :m] = np.where(np.isfinite(klo), klo, np.nan)
        key_hi[lo:hi, :m] = np.where(np.isfinite(khi), khi, np.nan)
        df_all[lo:hi] = df_np
        # each row's largest key of each group of snarls that share their
        # degrees of freedom (one group where the key is -p)
        good = ~bad
        for g in torch.unique(group[good]).tolist():
            sel = good & (group == g)
            gm = torch.where(sel[:, None] & finite, perm_k,
                             -float("inf")).amax(dim=0).double()
            prev = group_max.get(g)
            group_max[g] = gm if prev is None else torch.maximum(prev, gm)
        del stat, key, perm_k, finite, counted

    exp = Expected(kind=kind, n_perms=n_perms, filtered=filtered, na=na,
                   allele_paths=allele_paths, main=main, perm_na=perm_na,
                   p_obs=np.full(S, np.inf), stat_obs=stat_obs, exc=exc,
                   p_lo=key_lo, p_hi=key_hi,
                   null_min=np.full(n_perms, np.inf), df=df_all,
                   p_floor=np.full(S, np.finfo(np.float64).tiny),
)
    ok = ~perm_na
    if kind == "quantitative":
        exp.p_obs[ok] = _t_tail(stat_obs[ok], df_all[ok])
        exp.p_lo = _t_tail(key_lo, df_all[:, None])
        exp.p_hi = _t_tail(key_hi, df_all[:, None])
    else:
        exp.p_obs[ok] = -key_obs[ok]
        exp.p_lo, exp.p_hi = -key_lo, -key_hi
        exp.p_floor = np.where(stat_obs <= CHI2_HIGH_PRECISION,
                               DOUBLE_P_FLOOR, exp.p_floor)
    for g, gm in group_max.items():
        v = gm.cpu().numpy()
        pg = (_t_tail(v, g) if kind == "quantitative" else -v)
        exp.null_min = np.minimum(exp.null_min,
                                  np.where(np.isfinite(v), pg, np.inf))
    exp.null_min = np.sort(exp.null_min)
    return exp


# ------------------------------------------------------------ as tables

MAIN_TABLE = {"quantitative": "quantitative_table_vcf.tsv",
              "binary": "binary_table_vcf.tsv"}
PERM_TABLE = {"quantitative": "quantitative_permutation_vcf.tsv",
              "binary": "binary_permutation_vcf.tsv"}
MAIN_HEADER = {
    "quantitative": ["#CHR", "START_POS", "END_POS", "SNARL",
                     "PATH_LENGTHS", "P", "RSQUARE", "BETA", "SE",
                     "ALLELE_PATHS", "DEPTH"],
    "binary": ["#CHR", "START_POS", "END_POS", "SNARL", "PATH_LENGTHS", "P",
               "BETA", "SE", "ALLELE_PATHS", "DEPTH"]}
PERM_HEADER = ["#CHR", "START_POS", "END_POS", "SNARL", "P_ASY", "P_EMP",
               "P_FWER"]


def row_keys(cohort, s: int) -> List[str]:
    """The text columns a row of snarl ``s`` starts with."""
    p = int(cohort.pos[s])
    return [cohort.chroms[cohort.chrom_of[s]], str(p), str(p + 10),
            cohort.snarl_id(s)]


def render(exp: Expected, cohort) -> Dict[str, bytes]:
    """The two tables ``exp`` describes, as a job would print them (the
    control's output)."""
    from gwasbench.reference.stoat_format import format_p
    K = exp.n_perms
    header = MAIN_HEADER[exp.kind]
    lines = ["\t".join(header)]
    cols = [c for c in header[5:-2]]
    fw = np.searchsorted(exp.null_min, exp.p_obs, side="right")
    plines = ["\t".join(PERM_HEADER)]
    for s in range(cohort.n_snarls):
        keys = row_keys(cohort, s)
        if not exp.filtered[s]:
            ap = ",".join(str(int(x)) for x in
                          exp.allele_paths[s, :cohort.n_alleles[s]])
            vals = [format_p(exp.main[c][s]) for c in cols]
            lines.append("\t".join(keys + [cohort.types[s]] + vals
                                   + [ap, "1"]))
        if exp.perm_na[s]:
            plines.append("\t".join(keys + ["NA"] * 3))
        else:
            plines.append("\t".join(keys + [
                format_p(exp.p_obs[s]),
                format_p((1 + exp.exc[s]) / (K + 1)),
                format_p((1 + fw[s]) / (K + 1))]))
    return {MAIN_TABLE[exp.kind]: ("\n".join(lines) + "\n").encode(),
            PERM_TABLE[exp.kind]: ("\n".join(plines) + "\n").encode()}


# ------------------------------------------------------------ comparison

R2_FLOOR = 1e-6        # R^2 = 1 - rss / tss of a null snarl cancels


def _count_gaps(strings, n_ref, p_obs, p_lo, p_hi, floor, K):
    """Per row, the relative shift of p_obs that would explain the printed
    count of permuted p-values at or below it: 0 when the count printed is
    the reference's.  ``p_lo`` [R, m]: the p of the permutations counted,
    nearest first, ``p_hi``: of those not counted; a count off by more
    than m reads the m-th neighbour's shift, a lower bound.  Shifts are
    relative to max(p_obs, ``floor``)."""
    from gwasbench.reference.stoat_format import count_range
    out = np.zeros(len(strings))
    for i, s in enumerate(strings):
        lo, hi = count_range(s, K)
        if lo < 0:
            out[i] = np.inf
            continue
        if lo <= n_ref[i] <= hi:
            continue
        if hi < n_ref[i]:            # fewer counted: a p <= p_obs moved up
            row, j = p_lo[i], n_ref[i] - hi
        else:                        # more counted: a p > p_obs moved down
            row, j = p_hi[i], lo - n_ref[i]
        j = min(j, int(np.sum(np.isfinite(row))))
        out[i] = abs(row[j - 1] - p_obs[i]) / max(p_obs[i], floor[i]) \
            if j else np.inf
    return out


def _fwer_gaps(strings, p, null_sorted, floor, K):
    """Per row, the relative shift of p_obs that would explain the printed
    family-wise count against the sorted null minima: 0 when the count
    printed is the reference's; relative to max(p_obs, ``floor``)."""
    from gwasbench.reference.stoat_format import count_range
    fw = np.searchsorted(null_sorted, p, side="right")
    out = np.zeros(len(strings))
    for i, s in enumerate(strings):
        lo, hi = count_range(s, K)
        if lo < 0:
            out[i] = np.inf
        elif hi < fw[i]:            # fewer counted: a minimum <= p moved up
            out[i] = (p[i] - null_sorted[hi]) / max(p[i], floor[i])
        elif lo > fw[i]:            # more counted: a minimum > p moved down
            out[i] = (null_sorted[lo - 1] - p[i]) / max(p[i], floor[i])
    return np.abs(out)


def compare(exp: Expected, tables: Dict[str, bytes], cohort,
            worst: Optional[List[str]] = None) -> Dict:
    """The numbers that decide ``correct`` for one job's ``tables``
    ({file name: bytes}): ``rows_off``, the rows, files or text cells that
    differ from the reference (missing, extra, out of order, another NA
    pattern or text column); ``main_gap``, the widest relative distance of
    a main-table value from the reference; ``perm_gap``, the same of the
    permutation table's P_ASY and the relative shift of the observed
    statistic or p that would explain its P_EMP and P_FWER counts.
    ``worst``, when given, gets a line on the row behind each gap."""
    from gwasbench.reference.stoat_format import (columns, read_table,
                                                  value_gaps)
    K = exp.n_perms
    S = cohort.n_snarls
    main_name, perm_name = MAIN_TABLE[exp.kind], PERM_TABLE[exp.kind]
    off = len(set(tables) ^ {main_name, perm_name})
    keys = [tuple(row_keys(cohort, s)) for s in range(S)]

    def rows_of(name, header_want, want):
        nonlocal off
        header, rows = read_table(tables.get(name, b""))
        if header != header_want:
            off += 1 + len(want)
            return None
        got = [tuple(r[:4]) for r in rows]
        if got != [keys[s] for s in want] or any(
                len(r) != len(header_want) for r in rows):
            off += max(len(got), len(want))
            return None
        return columns(header, rows)

    gaps = {"main_gap": 0.0, "perm_gap": 0.0}
    want = np.nonzero(~exp.filtered)[0]
    cols = rows_of(main_name, MAIN_HEADER[exp.kind], want)
    if cols is not None:
        text = [",".join(str(int(x)) for x in
                         exp.allele_paths[s, :cohort.n_alleles[s]])
                for s in want]
        off += sum(a != b for a, b in zip(cols["ALLELE_PATHS"], text))
        off += sum(a != cohort.types[s]
                   for a, s in zip(cols["PATH_LENGTHS"], want))
        off += sum(d != "1" for d in cols["DEPTH"])
        na = exp.na[want]
        ref = {k: exp.main[k][want] for k in exp.main}
        se = np.abs(ref["SE"])
        scales = {"P": (np.maximum(np.abs(ref["P"]), DOUBLE_P_FLOOR)
                        if exp.kind == "binary" else np.abs(ref["P"])),
                  "BETA": np.maximum(np.abs(ref["BETA"]), se),
                  "SE": se,
                  "RSQUARE": np.maximum(np.abs(ref["RSQUARE"]), R2_FLOOR)}
        for name in MAIN_HEADER[exp.kind][5:-2]:
            g = value_gaps(cols[name], ref[name], scales[name])
            printed_na = np.array([c == "NA" for c in cols[name]])
            off += int(np.sum(printed_na != na))
            live = ~printed_na & ~na
            if live.any():
                i = int(np.argmax(np.where(live, g, -1.0)))
                gaps["main_gap"] = max(gaps["main_gap"], float(g[i]))
                if worst is not None and g[i] > 0:
                    s = int(want[i])
                    worst.append(f"main {name} {cohort.snarl_id(s)}: "
                                 f"printed {cols[name][i]}, reference "
                                 f"{ref[name][i]!r}, gap {g[i]!r}")
    cols = rows_of(perm_name, PERM_HEADER, np.arange(S))
    if cols is not None:
        printed_na = np.array([c == "NA" for c in cols["P_ASY"]])
        off += int(np.sum(printed_na != exp.perm_na))
        off += sum((a == "NA") != (b == "NA") or (a == "NA") != (c == "NA")
                   for a, b, c in zip(cols["P_ASY"], cols["P_EMP"],
                                      cols["P_FWER"]))
        live = np.nonzero(~printed_na & ~exp.perm_na)[0]
        if live.size:
            pick = lambda name: [cols[name][i] for i in live]
            p = exp.p_obs[live]
            floor = np.maximum(exp.p_floor[live], np.finfo(np.float64).tiny)
            g_asy = value_gaps(pick("P_ASY"), p, np.maximum(np.abs(p), floor))
            g_emp = _count_gaps(pick("P_EMP"), exp.exc[live], p,
                                exp.p_lo[live], exp.p_hi[live], floor, K)
            g_fw = _fwer_gaps(pick("P_FWER"), p, exp.null_min, floor, K)
            gaps["perm_gap"] = float(max(np.max(g_asy), np.max(g_emp),
                                         np.max(g_fw)))
            for name, g in (("P_ASY", g_asy), ("P_EMP", g_emp),
                            ("P_FWER", g_fw)):
                i = int(np.argmax(g))
                if worst is not None and g[i] > 0:
                    s = int(live[i])
                    worst.append(
                        f"perm {name} {cohort.snarl_id(s)}: printed "
                        f"{cols[name][s]}, reference p_obs {p[i]!r}, "
                        f"stat {exp.stat_obs[s]!r}, df {exp.df[s]!r}, "
                        f"count {exp.exc[s]}, counted {exp.p_lo[s]}, "
                        f"not {exp.p_hi[s]}, "
                        f"gap {g[i]!r}")
    return {"rows_off": off, **gaps}
