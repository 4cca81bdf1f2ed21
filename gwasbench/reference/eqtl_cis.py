"""Plain PyTorch reference of ``vcf -e EXPR -G GENES -c COVAR -C NAMES
--maf M`` (stoat's cis-eQTL mode), for the ``gtex_eqtl`` cell.

A frozen copy of tests/plain_eqtl_reference.py at the commit that added
this cell, with its design, inverse and formatting taken from
``regression_perm`` and ``stoat_format`` (the same definitions): nothing
of the program is imported or read.  What a job must write, worked out
from the cohort's arrays (gwasbench/inputs/gtex_cohort.py): for each
snarl in file order and each gene of its chromosome whose [start, end]
overlaps the snarl's window [start - w (0 when start <= w), end + w]
(snarl_analyzer.cpp:471-491), in the gene list's order, one row unless
the snarl is filtered:

- the design X = [1 | variant columns | covariates] on the used rows, as
  ``regression_perm._design`` builds it (the snarl's table, filters,
  column merge and last-column drop); degenerate (every statistic NA)
  when no variant column is left;
- y = the gene's expression on the used rows; A = X^T X, its inverse by
  Cholesky, or the eigenvalue pseudo-inverse (absolute tolerance 1e-6)
  where a pivot of a real column is below 1e-10 (stats_test.cpp:383-506);
- beta = A^-1 X^T y; rss = y^T y - (X^T y) . beta; df = max(n_used -
  ncols + 1, 1); the first variant column's beta, se = sqrt(inv_11 rss /
  df), t = beta / se and its two-sided Student-t p (scipy's stdtr; 1
  where t is not finite, 0 below the least normal double), R^2 = 1 -
  rss / tss over the used rows;
- stoat's printed strings.

The statistics run in ``dtype`` on ``device`` (float64 the reference,
float32 with TF32 off its control), the snarls in blocks of 4,096 and
every gene of the cohort at once in each block.  ``compare`` reports
``rows_off`` (rows, files and text cells that differ: missing, extra,
out of order, another NA pattern) and ``main_gap`` (the widest distance
from a reference value to the interval of values that print as the
table's string, relative: P to |P|, BETA to max(|BETA|, SE), SE to
itself, RSQUARE to max(R^2, 1e-6)).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from gwasbench.reference.regression_perm import (_design, _normal_inverse,
                                                 _pad_eye, inclusion)
from gwasbench.reference.stoat_format import format_p, value_gaps

__all__ = ["EqtlExpected", "expected", "render", "compare"]

BLOCK = 4096          # snarls a block
R2_FLOOR = 1e-6       # R^2 of a null pair is a small difference
HEADER = ["#CHR", "START_POS", "END_POS", "SNARL", "PATH_LENGTHS", "GENE",
          "P", "RSQUARE", "BETA", "SE", "ALLELE_PATHS", "DEPTH"]
TABLE = "eqtl_table_vcf.tsv"
VALUES = ("P", "RSQUARE", "BETA", "SE")


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
    A = torch.einsum("snp,snq->spq", X, X) + _pad_eye(ncols, P, dtype,
                                                      X.device)
    inv = _normal_inverse(A, ncols)
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


def expected(cohort, config: Dict, n_perms: int, seed: int, device,
             dtype=torch.float64) -> EqtlExpected:
    """The eQTL table of ``cohort`` at the thresholds and window of
    ``config``, computed on ``device`` in ``dtype``; the job has no
    permutations (``n_perms`` 0) and draws nothing from ``seed``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    thresholds = (config["min_individuals"], config["min_haplotypes"],
                  config["maf"])
    window = int(config["window"])
    S = cohort.n_snarls
    T = torch.from_numpy(inclusion(cohort)).to(device)
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
        d = _design(alleles[lo:hi].to(device), T[lo:hi], n_all[lo:hi],
                    covar, thresholds, dtype)
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
