"""Plain reference of stoat's cis-eQTL mode (``vcf -e EXPR -G GENES -c
COVAR -C NAMES``): what the eQTL table must say, worked out from a
cohort's arrays with numpy, torch and scipy's Student-t tail, and nothing
of stoat_tpu or stoat_tpu_torch.

For each snarl (file order) and each gene of its chromosome whose
[start, end] overlaps the snarl's window [start - w (0 when start <= w),
end + w] (snarl_analyzer.cpp:471-491), in the gene list's order:

- the snarl's table (snarl_analyzer.cpp:541-732): a haplotype carries a
  path when every edge of the path is an edge of its allele's path; per
  sample the dosage of each path (0-2); kept paths have carriers; used
  samples carry a kept path; each row divided by its sum; filtered when
  fewer than 2 paths are kept, fewer used samples than -I or -H, or fewer
  than 2 kept columns with a minor frequency above the MAF (filtered
  snarls write no row); with 3 or more kept, identical columns summed;
  the last column dropped; degenerate (every statistic NA) when no
  variant column is left;
- the design X = [1 | variant columns | covariates] on the used rows;
- y = the gene's expression on the used rows; A = X^T X (1 on the
  diagonal of padded columns), its inverse by Cholesky (stoat's LDL^T),
  or the eigenvalue pseudo-inverse (absolute tolerance 1e-6) when a pivot
  of a real column is below 1e-10 (stats_test.cpp:383-506);
- beta = A^-1 X^T y; rss = y^T y - (X^T y) . beta; df = max(n_used -
  ncols + 1, 1); the first variant column's beta, se = sqrt(inv_11 rss /
  df), t = beta / se and its two-sided Student-t p (1 where t is not
  finite, 0 below the least normal double), R^2 = 1 - rss / tss over the
  used rows;
- stoat's printed strings (utils.cpp:5-15: %.4e below 0.1, else %.4g).

The statistics are computed in ``dtype`` on ``device``, the snarls in
blocks and every gene of the cohort at once in each block.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

LDLT_TOL = 1e-10
PINV_TOL = 1e-6
BLOCK = 4096          # snarls a block
R2_FLOOR = 1e-6       # R^2 of a null pair is a small difference
HEADER = ["#CHR", "START_POS", "END_POS", "SNARL", "PATH_LENGTHS", "GENE",
          "P", "RSQUARE", "BETA", "SE", "ALLELE_PATHS", "DEPTH"]
TABLE = "eqtl_table_vcf.tsv"
VALUES = ("P", "RSQUARE", "BETA", "SE")


# ------------------------------------------------------------ membership

def _nodes(path: str) -> List[int]:
    return [int(x) for x in path.replace("<", ">").split(">") if x]


def inclusion(path_strings: Sequence[Sequence[str]]) -> np.ndarray:
    """bool [S, 4, 4]: [s, a, p] when a haplotype with allele a of snarl s
    carries path p (every edge of path p is an edge of path a)."""
    out = np.zeros((len(path_strings), 4, 4), bool)
    for s, paths in enumerate(path_strings):
        edges = [set(zip(n[:-1], n[1:])) for n in map(_nodes, paths)]
        for a, ea in enumerate(edges):
            for q, eq in enumerate(edges):
                out[s, a, q] = eq <= ea
    return out


def design(alleles, T, n_alleles, covar, thresholds, dtype):
    """One block's design: X [S, N, 1 + 3 + C] (dtype), used, ncols,
    n_used, filtered, degenerate, allele_paths."""
    min_ind, min_hap, maf = thresholds
    S, H = alleles.shape
    dev = alleles.device
    a = alleles.long()
    carry = torch.gather(T, 1, a.clamp(min=0)[:, :, None].expand(S, H, 4))
    carry = carry & (a >= 0)[:, :, None]
    dosage = carry[:, 0::2].to(torch.int32) + carry[:, 1::2].to(torch.int32)
    idx = torch.arange(4, device=dev)
    exists = idx[None, :] < n_alleles[:, None]
    allele_paths = torch.where(exists, carry.sum(dim=1), 0)
    kept = exists & (allele_paths > 0)
    Dk = dosage * kept[:, None, :]
    row_sum = Dk.sum(dim=-1)
    used = row_sum > 0
    n_used = used.sum(dim=-1)
    recip = torch.where(used, 1.0 / row_sum.clamp(min=1).double(), 0.0)
    freq = (Dk.double() * recip[:, :, None]).sum(dim=1) \
        / n_used.double().clamp(min=1.0)[:, None]
    minor = torch.minimum(freq, 1.0 - freq)
    kept_count = kept.sum(dim=-1)
    total = n_used.double()
    filtered = ((kept_count < 2) | (total < min_ind) | (total < min_hap)
                | ((kept & (minor > maf)).sum(dim=-1) < 2))
    eq = (Dk[:, :, :, None] == Dk[:, :, None, :]).all(dim=1)
    eq = eq & kept[:, :, None] & kept[:, None, :]
    rep = torch.where(eq, idx[None, :, None], 9).amin(dim=1)
    rep = torch.where((kept_count >= 3)[:, None], rep,
                      torch.where(kept, idx[None, :], 9))
    is_rep = kept & (rep == idx[None, :])
    merged = torch.einsum("snj,sij->sni", Dk.double(),
                          (rep[:, None, :] == idx[None, :, None]).double())
    last = 3 - is_rep.flip(-1).int().argmax(dim=-1)
    var = is_rep & (idx[None, :] != last[:, None])
    k3 = var.sum(dim=-1)
    degenerate = is_rep.any(dim=-1) & (k3 == 0)
    C = covar.shape[1]
    X = torch.zeros((S, H // 2, 4 + C), dtype=torch.float64, device=dev)
    X[:, :, 0] = 1.0
    slot = torch.cumsum(var.int(), dim=-1)
    for j in range(4):
        rows = var[:, j].nonzero().squeeze(-1)
        if rows.numel():
            X[rows, :, slot[rows, j]] = merged[rows, :, j] * recip[rows]
    s_idx = torch.arange(S, device=dev)
    for c in range(C):
        X[s_idx, :, 1 + k3 + c] = covar[None, :, c]
    X = torch.where(used[:, :, None], X, 0.0).to(dtype)
    return {"X": X, "used": used, "ncols": 1 + k3 + C, "n_used": n_used,
            "filtered": filtered, "degenerate": degenerate,
            "allele_paths": allele_paths}


def normal_inverse(A, ncols):
    """A^-1 by Cholesky, or the eigenvalue pseudo-inverse where a pivot of
    a real column is below LDLT_TOL, not finite, or the factor fails."""
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


def t_tail(t: np.ndarray, df: np.ndarray) -> np.ndarray:
    """Two-sided Student-t p (scipy's stdtr), 1 where t is not finite, 0
    below the least normal double."""
    from scipy.special import stdtr
    with np.errstate(invalid="ignore"):
        p = 2.0 * stdtr(df, -np.abs(t))
    p = np.where(np.isfinite(t), p, 1.0)
    return np.where(p < np.finfo(np.float64).tiny, 0.0, p)


def pair_stats(d, E):
    """(p, r2, beta, se), float64 [S, G]: every snarl of the block against
    every gene's expression E [G, N]."""
    X, used, ncols = d["X"], d["used"], d["ncols"]
    S, N, P = X.shape
    dtype = X.dtype
    A = torch.einsum("snp,snq->spq", X, X) + torch.diag_embed(
        (torch.arange(P, device=X.device)[None, :]
         >= ncols[:, None]).to(dtype))
    inv = normal_inverse(A, ncols)
    XtE = (X.transpose(1, 2).reshape(S * P, N) @ E.T).view(S, P, -1)
    B = inv @ XtE
    u = used.to(dtype)
    n_used = d["n_used"].to(dtype)
    yy = u @ (E * E).T
    ysum = u @ E.T
    rss = yy - (XtE * B).sum(dim=1)
    mean = ysum / n_used.clamp(min=1.0)[:, None]
    tss = yy - 2.0 * mean * ysum + n_used[:, None] * mean * mean
    df = torch.clamp(n_used - ncols.to(dtype) + 1.0, min=1.0)
    se = torch.sqrt(inv[:, 1, 1, None] * rss / df[:, None])
    beta = B[:, 1, :]
    r2 = 1.0 - rss / tss
    host = lambda v: v.double().cpu().numpy()
    t = host(beta / se)
    p = t_tail(t, host(df)[:, None].repeat(t.shape[1], axis=1))
    return p, host(r2), host(beta), host(se)


# ------------------------------------------------------------ the job

@dataclass
class EqtlExpected:
    """The table's rows in order: per row its snarl and gene, and P,
    RSQUARE, BETA, SE (NaN where NA)."""

    snarl: np.ndarray         # int [R]
    gene: np.ndarray          # int [R]
    values: Dict[str, np.ndarray]
    allele_paths: np.ndarray  # int [S, 4]


def window_genes(start, end, gene_start, gene_end, window):
    """bool [S, G]: gene g overlaps snarl s's window."""
    start = np.asarray(start, np.int64)
    lo = np.where(start > window, start - window, 0)
    hi = np.asarray(end, np.int64) + window
    return ~((np.asarray(gene_end)[None, :] < lo[:, None])
             | (np.asarray(gene_start)[None, :] > hi[:, None]))


def expected(cohort, config: Dict, device, dtype=torch.float64
             ) -> EqtlExpected:
    """The eQTL table of ``cohort`` (its arrays: alleles, path_strings,
    n_alleles, chrom_of, pos, covariates, gene_chrom, tss, expression) at
    the thresholds and window of ``config``, computed on ``device`` in
    ``dtype`` (float32 with TF32 off: a control)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    thresholds = (config["min_individuals"], config["min_haplotypes"],
                  config["maf"])
    window = int(config["window"])
    S = cohort.n_snarls
    T = torch.from_numpy(inclusion(cohort.path_strings)).to(device)
    alleles = torch.from_numpy(cohort.alleles)
    n_all = torch.from_numpy(np.asarray(cohort.n_alleles)).to(device)
    covar = torch.from_numpy(np.asarray(cohort.covariates,
                                        np.float64)).to(device)
    E = torch.from_numpy(np.asarray(cohort.expression, np.float64)).to(
        device=device, dtype=dtype)
    gene_chrom = np.asarray(cohort.gene_chrom)
    tss = np.asarray(cohort.tss)
    pos = np.asarray(cohort.pos)
    snarls, genes = [], []
    values = {k: [] for k in VALUES}
    allele_paths = np.zeros((S, 4), np.int64)
    for lo in range(0, S, BLOCK):
        hi = min(lo + BLOCK, S)
        d = design(alleles[lo:hi].to(device), T[lo:hi], n_all[lo:hi], covar,
                   thresholds, dtype)
        allele_paths[lo:hi] = d["allele_paths"].cpu().numpy()
        stats = pair_stats(d, E)
        na = d["degenerate"].cpu().numpy()
        live = ~d["filtered"].cpu().numpy()
        inside = window_genes(pos[lo:hi], pos[lo:hi] + 10, tss, tss, window)
        inside &= gene_chrom[None, :] == np.asarray(
            cohort.chrom_of)[lo:hi, None]
        inside &= live[:, None]
        s_i, g_i = np.nonzero(inside)            # row-major: (snarl, gene)
        snarls.append(lo + s_i)
        genes.append(g_i)
        for k, v in zip(VALUES, stats):
            values[k].append(np.where(na[s_i], np.nan, v[s_i, g_i]))
    snarl = np.concatenate(snarls)
    gene = np.concatenate(genes)
    # chromosomes in file order, then snarls, then genes in list order
    order = np.lexsort((gene, snarl))
    return EqtlExpected(snarl[order], gene[order],
                        {k: np.concatenate(v)[order]
                         for k, v in values.items()}, allele_paths)


# ------------------------------------------------------------ as a table

def set_precision(value: float) -> str:
    v = float(value)
    if v != v:
        return "nan"
    if math.isinf(v):
        return "-inf" if v < 0 else "inf"
    if v != 0.0 and abs(v) < 1e-1:
        return f"{v:.4e}"
    return f"{v:.4g}"


def format_p(value: float) -> str:
    return "NA" if value != value else set_precision(value)


def row_text(cohort, exp: EqtlExpected, r: int) -> List[str]:
    """The text columns of row ``r`` (every column but the four values)."""
    s, g = int(exp.snarl[r]), int(exp.gene[r])
    p = int(cohort.pos[s])
    ap = ",".join(str(int(x)) for x in
                  exp.allele_paths[s, :cohort.n_alleles[s]])
    return [cohort.chroms[cohort.chrom_of[s]], str(p), str(p + 10),
            f"{cohort.node_start[s]}_{cohort.node_end[s]}", cohort.types[s],
            cohort.gene_names[g], ap, "1"]


def render(exp: EqtlExpected, cohort) -> Dict[str, bytes]:
    """The table ``exp`` describes, as a job prints it."""
    lines = ["\t".join(HEADER)]
    for r in range(exp.snarl.shape[0]):
        t = row_text(cohort, exp, r)
        vals = [format_p(exp.values[k][r]) for k in VALUES]
        lines.append("\t".join(t[:6] + vals + t[6:]))
    return {TABLE: ("\n".join(lines) + "\n").encode()}


# ------------------------------------------------------------ comparison

def half_unit(strings: Sequence[str], values: np.ndarray) -> np.ndarray:
    """Half the last printed digit of each string, 0 for an exact 0."""
    out = np.zeros(len(strings))
    for i, (s, v) in enumerate(zip(strings, values)):
        if v == 0 or not np.isfinite(v):
            continue
        exp = int(s.split("e")[1]) if "e" in s else \
            int(math.floor(math.log10(abs(v))))
        digits = 4 if ("e" in s and abs(v) < 0.1) else 3
        out[i] = 0.5 * 10.0 ** (exp - digits)
    return out


def value_gaps(strings, ref, scale) -> np.ndarray:
    """Per cell, the distance from ``ref`` to the values that print as the
    cell's string, over ``scale``; NaN where the string is "NA"."""
    vals = np.array([np.nan if s == "NA" else float(s) for s in strings])
    u = half_unit(strings, vals)
    with np.errstate(invalid="ignore", divide="ignore"):
        gap = np.maximum(np.abs(vals - ref) - u, 0.0) / scale
    return np.where(np.isnan(vals), np.nan, gap)


def scales(exp: EqtlExpected) -> Dict[str, np.ndarray]:
    """What each value's gap is relative to: P to |P|, BETA to max(|BETA|,
    SE), SE to itself, RSQUARE to max(R^2, 1e-6) (1 - rss / tss of a null
    pair is a small difference)."""
    v = exp.values
    se = np.abs(v["SE"])
    return {"P": np.abs(v["P"]), "BETA": np.maximum(np.abs(v["BETA"]), se),
            "SE": se, "RSQUARE": np.maximum(np.abs(v["RSQUARE"]), R2_FLOOR)}


def compare(exp: EqtlExpected, tables: Dict[str, bytes], cohort,
            worst: Optional[List[str]] = None) -> Dict:
    """``rows_off``: rows, files and text cells that differ from the
    reference (missing, extra, out of order, another NA pattern);
    ``main_gap``: the widest relative distance of a printed value from the
    reference."""
    off = len(set(tables) ^ {TABLE})
    lines = tables.get(TABLE, b"").decode().split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    header = lines[0].split("\t") if lines else []
    rows = [line.split("\t") for line in lines[1:]]
    R = exp.snarl.shape[0]
    if header != HEADER or len(rows) != R or any(
            len(r) != len(HEADER) for r in rows):
        return {"rows_off": off + 1 + max(len(rows), R),
                "main_gap": math.inf}
    for r, row in enumerate(rows):
        t = row_text(cohort, exp, r)
        off += int(row[:6] != t[:6]) + int(row[10:] != t[6:])
    gap = 0.0
    sc = scales(exp)
    for j, k in enumerate(VALUES):
        cells = [row[6 + j] for row in rows]
        printed_na = np.array([c == "NA" for c in cells])
        na = np.isnan(exp.values[k])
        off += int(np.sum(printed_na != na))
        live = ~printed_na & ~na
        if live.any():
            g = value_gaps(cells, exp.values[k], sc[k])
            i = int(np.argmax(np.where(live, g, -1.0)))
            gap = max(gap, float(g[i]))
            if worst is not None and g[i] > 0:
                worst.append(f"{k} row {i}: printed {cells[i]}, reference "
                             f"{exp.values[k][i]!r}, gap {g[i]!r}")
    return {"rows_off": off, "main_gap": gap}
