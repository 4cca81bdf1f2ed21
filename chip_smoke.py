#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (stoat_tpu_torch) on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
g++:

    python3 chip_smoke.py

It builds the port's CUDA kernels (seventeen entry points in fourteen
sources, one nvcc per source, all at once) and the native VCF and graph
cores from the sources in the checkout, then runs six phases, each
printing lines and each fatal on failure (phases 1-5 on the first card, a
bare ``--device cuda`` held to it where several are visible):

  1. card: nvidia-smi name and power limit, torch and CUDA versions, the
     kernels' nvcc build with ptxas register and spill counts;
  2. native cores: the VCF core, the graph core and the single-core C++
     baseline built into build/stoat_tpu_torch/native under their
     host-keyed names and loaded (a baseline that does not build fails);
  3. kernels against their plain PyTorch versions, on the card, at the
     main paths' shapes (the first chunk of ``vcf -b`` (binary_from_words
     also on the dual's rows and with invalid paths, and on its grid),
     of ``vcf -q -c``
     and of ``vcf -b -c``, the main graph's partition counts, and the
     permutation kernels on the first chunk with 16 permutations and
     again with the main path's 1,001 rows, perm_ols at both the ``-q``
     and the ``-q -c`` design; quant_design with ``all_rows``, eqtl_ols on
     the first chunk's (snarl, gene) pairs and the mixed model's chain
     of rotation, OLS and tail; the chi-squared tail chi2_tail on the
     tail grid, a random grid of 10^6, a grid of large df, fault 3.2's
     draw of 4 x 10^6 (df 1-400), the first chunk's statistics and the
     permutation pass's [K, S] statistics of K15 and of the score test;
     quant_design's -T table view on the OLS and all-rows designs) and on
     edge cases, the permutation kernels' tile edges, perm_binary's and
     score_precompute's grids, quant_design's grid in its four
     instantiations, logreg's grid and the two OLS kernels' grid among
     them (tolerances printed; the OLS's phenotype row bit for bit its
     [S, N] y);
  4. main paths: the port's CLI with ``--device cuda``: ``vcf -b``, ``vcf
     -q``, ``vcf -q -c -C AGE,SEX`` and ``vcf -b -c -C AGE,SEX`` on a
     generated cohort of 2,504 samples (the 1000 Genomes phase-3 size)
     and 65,536 snarls on 2 chromosomes, each path's kernels launched on
     every chunk; ``graph`` on a generated graph of 100,000 snarls walked
     by 90 haplotype paths (the HPRC release-1 count), through the native
     path; then the same runs with ``--device cpu`` (the binary and graph
     outputs byte for byte, the regression TSVs as phase 4 states), numpy
     and scipy references built from the inputs' text, and graph mode's
     Python twin against its native path; then each ``vcf`` mode again
     with ``--permutations 1000`` at full size (every kernel on every
     chunk, P_EMP and P_FWER recounted in numpy from the captured
     p-values), and CUDA against CPU with 50 permutations on a sub-cohort
     of 2,048 snarls, then the two quantitative passes once more; then the
     dual run ``vcf -b -q`` (alone, equal to the single runs, and with
     ``--permutations 1000``), eQTL ``vcf -e -G -c -C AGE,SEX`` on a gene
     set written here (one gene per 150 kb, a 1 Mb window) and the mixed
     model ``vcf -q -k --lmm -c -C AGE,SEX`` on a rank-200 kinship and a
     phenotype y = g + e written here, each against its numpy reference
     at full size and CUDA against CPU on the sub-cohort; then ``-T
     0.01`` at full size (``-q -c`` and ``-b -c``: the table view on every
     chunk, one table per significant row) and ``-T 0.05`` CUDA against
     CPU on the sub-cohort in five modes, the ``regression/`` files
     included; then ``vcf -b -p <cohort GFA> -g`` on a GFA written here
     (a node of a seeded length for every node of the snarl file's
     paths), on the card and on the CPU: the binary table byte for byte
     the ``vcf -b`` table, both GAF files byte for byte across the
     devices, 1,000 rows' GAF lines recomputed from GROUP_PATHS,
     P_FISHER and the node lengths; ``simulate -n 2504 -s 8192 --seed
     7``, then ``vcf -b`` and ``vcf -q`` on its data on both devices and
     ``truth`` on each table, equal across the devices; ``BHcorrect`` on
     copies of the ``-g`` and the simulated ``-b`` tables against a numpy
     BH written here, ``top_variant.tsv`` included (``plot`` is host work
     and is not run); then the decomposition alone (``vcf -p -d``); then
     the single-core C++ baseline on the host CPU: its count on the
     sub-cohort against the scalar oracle's, its rate on the first 2,000
     snarls of the cohort and its graph loop on the main graph, printed
     with the host CPU and the card's name and power limit.
     While the CUDA CLI runs the binary, graph, permutation and ``-g``
     paths, the plain chi-squared tail must not be called: every
     chi-squared tail runs on the card (chi2_tail, or graph_stats' own
     tails);
  5. each kernel's time and its plain version's, on the card, at the main
     paths' shapes (CUDA events, after a warm-up, and profiler device
     time; binary_from_words beside the two launches it replaced), its
     bound (bytes over the card's memory rate or operations
     over its peak rate, whichever is larger), the wall of each
     permutation pass, and the mixed model's rotation (one float64 GEMM)
     beside its bound; chi2_tail and student_t at both of their launch
     shapes, a chunk's [S] and the permutation pass's [K, S]; chi2_tail
     beside torch.special.gammaincc on the same inputs (its library_ms,
     a yardstick on another algorithm), perm_ols and score_perm beside one
     torch.matmul of their GEMM core alone (theirs), perm_binary beside
     torch._int_mm of its 0/1 count product and score_precompute beside
     torch.bmm of its weighted Gram (theirs), quant_design's
     table view, and X.zero_() on a tensor of quant_design's X, the rate
     the card writes those bytes at.  The profiler loses the first one
     or two device records of a window: each window opens with
     torch.cuda._sleep launches that no sum counts, a device time a call
     is each kernel's mean record times its launches a call, every window
     that is not whole is printed, and so are ten windows of the table
     view, all_rows and the GEMM with and without the spins;
  6. the snarl mesh (parallel/): ``vcf -b``, ``-q``, ``-q -c``, ``-b
     -c``, the dual, ``--lmm``, eQTL and ``-q -c -T 0.01`` at full size,
     and ``--permutations 1000`` for ``-b``, ``-q`` and ``-b -c``, through
     the CLI with run_vcf_analysis and run_permutation_test on a mesh of
     four shards on the first card (and on a mesh of every card where
     several are visible): every output byte-identical to phase 4's
     one-device run, every kernel launched shards x chunks times
     (permutation blocks of 8,192 snarls a shard: shards x blocks), the
     words uploaded once a chromosome and a device, the mesh ``vcf -b``'s
     peak memory within half a chromosome's words of a one-device run's
     (a second copy of the words fails it); the sub-cohort's runs on a
     mesh of the card and one of the CPU, each byte-identical to the same
     device's one-device run of phase 4 (the binary tables also across
     the two meshes); one ``vcf -b`` chunk on one device and on the mesh:
     bitwise equal, ms by events, device ms, and the bound of its
     kernels' work on each.

The last two lines of standard output are a JSON object of the kernels and
the contract line {"ok": true, "device": {...}}, whose ``count`` is the
cards the run used (it fails unless that is every visible card).  Without
a CUDA device,
or outside a checkout of the repository, it exits non-zero and prints no
result.  The generated data lives under build/stoat_tpu_torch/ and is
removed at the end.  It imports nothing of JAX and nothing of the JAX
package: the port's own modules, tests/fixtures.py (numpy) and its own
numpy and scipy references (copies of tests/reference_impl.py's).
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from functools import partial

HERE = os.path.dirname(os.path.abspath(__file__))

# the 1000 Genomes phase-3 cohort size, and two chromosomes so that the
# runner's per-chromosome pipelining runs
N_SAMPLES = 2504
N_CHROMS = 2
# graph mode: 45 samples x 2 haplotype paths (the 90 haplotypes of the
# HPRC release-1 graph) over 100,000 snarls of one chromosome
GRAPH_SAMPLES = 45
GRAPH_SNARLS = 100000
# the Python twin (STOAT_GRAPH_PYTHON=1) walks a smaller graph
TWIN_SNARLS = 2000
# the single-core C++ baseline is timed, best of BASELINE_REPS, on the
# first BASELINE_SAMPLE snarls of the full cohort (bench.py:67)
BASELINE_SAMPLE = 2000
BASELINE_REPS = 3

# tests/test_stats_oracle.py:105, the reference's pinned strings
FISHER_CASES = [
    ((10, 20, 20, 10), "1.9383e-02"),
    ((30, 5, 2, 25), "3.5379e-10"),
    ((0, 0, 0, 0), "NA"),
    ((0, 0, 0, 1), "NA"),
    ((1, 0, 0, 1), "1"),
    ((79, 18, 96, 23), "1"),
    ((122, 78, 27, 173), "1.4799e-23"),
]
# tests/test_extreme_tails.py:65, scans that overflow: "0"
OVERFLOW_TABLES = [(1000, 2, 3, 1500), (2000, 1, 1, 3000),
                   (5000, 10, 4, 8000)]
# tests/test_extreme_tails.py:23-26
TAIL_STATS = [60.0, 80.0, 84.9, 85.0001, 86.0, 100.0, 200.0, 500.0,
              1000.0, 1400.0]
TAIL_DFS = [1, 2, 3, 7]

KERNELS = {
    "membership_counts": ("stoat_tpu_torch/csrc/membership_counts.cu",
                          "stoat_tpu/pipeline/packed.py:294"),
    "binary_tables": ("stoat_tpu_torch/csrc/binary_tables.cu",
                      "stoat_tpu/pipeline/binary.py:98"),
    "binary_stats": ("stoat_tpu_torch/csrc/binary_stats.cu",
                     "stoat_tpu/pipeline/binary.py:98"),
    "binary_from_words": ("stoat_tpu_torch/csrc/binary_stats.cu",
                          "stoat_tpu/pipeline/binary.py:77"),
    "fisher": ("stoat_tpu_torch/csrc/fisher.cu",
               "stoat_tpu/stats/fisher.py:165"),
    "quant_design": ("stoat_tpu_torch/csrc/quant_design.cu",
                     "stoat_tpu/pipeline/quantitative.py:122"),
    "ols": ("stoat_tpu_torch/csrc/ols.cu", "stoat_tpu/stats/linreg.py:141"),
    "student_t": ("stoat_tpu_torch/csrc/student_t.cu",
                  "stoat_tpu/stats/linreg.py:206"),
    "graph_stats": ("stoat_tpu_torch/csrc/graph_stats.cu",
                    "stoat_tpu/graph/association.py:496"),
    "logreg": ("stoat_tpu_torch/csrc/logreg.cu",
               "stoat_tpu/stats/logreg.py:44"),
    "perm_membership": ("stoat_tpu_torch/csrc/perm_binary.cu",
                        "stoat_tpu/pipeline/permutation.py:256"),
    "perm_binary": ("stoat_tpu_torch/csrc/perm_binary.cu",
                    "stoat_tpu/pipeline/permutation.py:79"),
    "perm_ols": ("stoat_tpu_torch/csrc/perm_ols.cu",
                 "stoat_tpu/pipeline/permutation.py:104"),
    "score_precompute": ("stoat_tpu_torch/csrc/score_test.cu",
                         "stoat_tpu/pipeline/permutation.py:194"),
    "score_perm": ("stoat_tpu_torch/csrc/score_test.cu",
                   "stoat_tpu/pipeline/permutation.py:201"),
    "eqtl_ols": ("stoat_tpu_torch/csrc/eqtl_ols.cu",
                 "stoat_tpu/pipeline/quantitative.py:599"),
    "chi2_tail": ("stoat_tpu_torch/csrc/chi2_tail.cu",
                  "stoat_tpu/stats/special.py:30"),
}
# the kernel sources (one nvcc each), by their build names
SOURCES = sorted({os.path.basename(src)[:-3] for src, _ in KERNELS.values()})
# K1+K2, K3 and K4 are one launch on the main paths (binary_from_words);
# the standalone membership_counts, binary_stats (on given counts),
# binary_tables and fisher kernels run in phases 3 and 5 only
BINARY_KERNELS = ("binary_from_words", "chi2_tail")
QUANT_KERNELS = ("quant_design", "ols", "student_t")
BC_KERNELS = ("quant_design", "logreg")
# K6 with its two chi-squared tails (2x2 and 2xN) in one launch
GRAPH_KERNELS = ("graph_stats",)
PERM_KERNELS = ("perm_membership", "perm_binary", "perm_ols",
                "score_precompute", "score_perm")
# the dual run: K1 once (perm_membership), then the binary and the
# quantitative kernels on its words
DUAL_KERNELS = ("perm_membership", "binary_from_words", "chi2_tail",
                "quant_design", "ols", "student_t")
EQTL_KERNELS = ("quant_design", "eqtl_ols", "student_t")
LMM_KERNELS = ("quant_design", "ols", "student_t")
# eQTL: one gene every 150 kb, 30 kb long (GTEx v8: ~20k genes over
# 3.1 Gb), in GTEx's +-1 Mb cis window (the CLI's default -w)
GENE_STEP = 150000
GENE_LEN = 30000
# the mixed model: tests/test_lmm.py:26's random kinship of rank 200
KIN_RANK = 200
# permutations: phase 3 checks the kernels with PERM_K; phase 4 runs each
# mode's CLI with PERM_FULL (users run 1,000) at full size, and CUDA
# against CPU with PERM_SUB on a sub-cohort of SUB_SNARLS snarls (the plain
# CPU path at full size would take hours)
PERM_K = 16
PERM_FULL = 1000
PERM_SUB = 50
SUB_SNARLS = 2048
# the score test, kernel vs plain on the card: V^-1 relative to each
# snarl's largest entry, T relative to max(T, 1) (rows summed in another
# order); a P_EMP/P_FWER count of two runs may differ only at a tie that
# the p-values resolve within TIE_REL
SCORE_REL = 1e-10
TIE_REL = 1e-9
# the chi-squared tail, kernel vs plain (JAX's igammac, run on the card's
# tensors): one algorithm, every operation separately rounded, the card's
# math library on both sides; checked where p > 1e-300, with the same
# strings, zeros, NaNs and DBL_MAX, on every grid.  Against the plain
# version on the CPU (glibc's logarithms) the special values must agree.
CHI2_REL = 1e-13
LARGE_DF = "large-df grid"
# -T: the full-size runs' threshold, and the sub-cohort's
T_FULL = "0.01"
T_SUB = "0.05"
# the bound of a kernel's time: the H100 SXM's 3.35 TB/s of HBM3, its
# float64 peak, 67 TFLOP/s (the tensor cores), and its dense int8
# tensor-core peak, 1,979 TOP/s (NVIDIA's data sheet); for int32 work
# (AND, shifts) 132 SMs x 64 int32 lanes x 1.98 GHz (the Hopper white
# paper), and for population counts 16 an SM a clock (the CUDA C
# Programming Guide's throughput table, compute capability 9.0)
HBM_BYTES_S = 3.35e12
F64_FLOPS = 67e12
INT8_OPS = 1979e12
INT32_OPS = 132 * 64 * 1.98e9
POPC_OPS = 132 * 16 * 1.98e9
PEAKS = {"float64": F64_FLOPS, "int8": INT8_OPS, "int32": INT32_OPS}
COVAR_NAMES = ["AGE", "SEX"]
THRESHOLDS = (3, 5, 0.05)
# the Student-t grid of tests/test_torch_linreg.py
T_DFS = [1.0, 2.0, 5.0, 30.0, 1000.0, 2500.0]
T_ABS = [0.0, 1e-8, 0.5, 2.0, 10.0, 40.0, 1e3]
# bounds, kernel vs plain on the card: OLS on well-conditioned designs
# (rows summed in another order), OLS on rank-deficient ones (the
# pseudo-inverse), the t tail (the same arithmetic and CUDA math library);
# phase 4: CUDA vs CPU values behind a differing string, and the values
# against the numpy reference.  The OLS statistics are held to them in
# the scale their strings carry (stat_err): t1 relative above |t1| = 1 and
# absolute below, beta relative to max(|beta|, se), r2 through 1 - r2 =
# rss / tss (an r2 near 0 cancels), se, df and p relative
OLS_REL = 1e-10
OLS_PINV_REL = 1e-8
T_REL = 1e-12
# the t tail, kernel vs the plain version on the CPU: torch's CPU lgamma
# (glibc) is not CUDA's; at df = 2,500, lgamma(1250) ~ 7.6e3 carries ~1e-12
# of relative error into the prefactor, amplified up to ~10x where the
# mirrored branch takes 1 - result
T_CPU_REL = 1e-10
TSV_REL = 1e-9
REF_REL = 1e-8
# logistic regression, kernel vs plain on the card: rows summed in another
# order; p = 2 (1 - ndtr) moves in absolute steps of 2^-52 near 0, so a p
# below P_FLOOR is held to the bound times P_FLOOR instead (every logistic
# comparison: here, phase 4's TSVs and the reference)
LOGREG_REL = 1e-10
P_FLOOR = 1e-5
# graph mode: P_FISHER / P_CHI2 of the sampled rows against
# chi2_p / fisher_p (scipy); a 4-digit string may flip at a rounding
# boundary, never by more than one unit
GRAPH_REF_ROWS = 2000
GRAPH_REF_REL = 1e-3


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(line):
    print(line, flush=True)


def nvidia_smi_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0].strip()


# ---------------------------------------------------------------- compare

def same_bits(a, b):
    """float64 arrays equal bit for bit (any NaN equals any NaN)."""
    import numpy as np
    a = np.ascontiguousarray(a, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    if a.shape != b.shape:
        return False
    na, nb = np.isnan(a), np.isnan(b)
    return bool(np.array_equal(na, nb)) and bool(np.array_equal(
        a[~na].view(np.uint64), b[~nb].view(np.uint64)))


def max_abs_err(a, b):
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    both_nan = np.isnan(a) & np.isnan(b)
    d = np.abs(np.where(both_nan, 0.0, a - b))
    return float(np.nanmax(np.where(np.isnan(d), np.inf, d))) \
        if d.size else 0.0


def rel_ok(a, b, rel):
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        return False
    ok = ~np.isnan(a)
    return bool(np.all(np.abs(a[ok] - b[ok]) <= rel * np.abs(b[ok])))


def to_np(t):
    return t.detach().cpu().numpy()


class PlainTailCounter:
    """Counts the calls of the plain chi-squared tail (stats/special.py
    igammac_plain, JAX's igammac, which chi2_sf_plain runs) while entered:
    on the CUDA CLI every chi-squared tail runs on the card (chi2_tail, or
    inside graph_stats), so the count stays 0."""

    def __enter__(self):
        from stoat_tpu_torch.stats import special
        self.special = special
        self.real = special.igammac_plain
        self.calls = 0

        def counted(*a, **k):
            self.calls += 1
            return self.real(*a, **k)
        special.igammac_plain = counted
        return self

    def __exit__(self, *exc):
        self.special.igammac_plain = self.real
        return False


def memory_note(peak, held):
    """A run's peak device memory, and how much of it earlier phases'
    tensors (kept for phase 5) already held when the run started."""
    return (f"{peak / 2**20:.1f} MiB ({(peak - held) / 2**20:.1f} MiB above "
            f"the {held / 2**20:.1f} MiB held before the run)")


# ---------------------------------------------------------------- reference

def chi2_p(g0, g1):
    """scipy's chi-squared p of a 2 x N table (NaN where a margin is 0).
    This and the functions below to irls_reference are copies of
    tests/reference_impl.py, an independent per-snarl reading of the
    reference's C++ sources."""
    import numpy as np
    import scipy.stats
    g0 = np.asarray(g0, float)
    g1 = np.asarray(g1, float)
    colsum = g0 + g1
    if (colsum.sum() == 0 or g0.sum() == 0 or g1.sum() == 0
            or np.any(colsum == 0)):
        return np.nan
    return scipy.stats.chi2_contingency(np.stack([g0, g1]),
                                        correction=False)[1]


def fisher_p(a, b, c, d):
    import numpy as np
    import scipy.stats
    if (a + b == 0) or (c + d == 0) or (a + c == 0) or (b + d == 0):
        return np.nan
    return scipy.stats.fisher_exact([[a, b], [c, d]])[1]


def filtration_quantitative(df, min_individuals, min_haplotypes, maf):
    import numpy as np
    if df.size == 0 or df.shape[1] < 2 or df.shape[0] < min_individuals:
        return True
    total = df.sum()
    if total < min_haplotypes:
        return True
    freq = df.sum(axis=0) / total
    m = np.minimum(freq, 1 - freq)
    return int(np.sum(m > maf)) < 2


def combine_identical_columns(df):
    import numpy as np
    n_cols = df.shape[1]
    if n_cols < 3:
        return df
    merged = [False] * n_cols
    new_cols = []
    for i in range(n_cols):
        if merged[i]:
            continue
        col = df[:, i].copy()
        for j in range(i + 1, n_cols):
            if not merged[j] and np.array_equal(df[:, j], df[:, i]):
                col += df[:, j]
                merged[j] = True
        new_cols.append(col)
    return np.stack(new_cols, axis=1)


def ols_reference(df, y, covar):
    """OLS reporting the first variant column (stats_test.cpp:423-506)."""
    import numpy as np
    n = df.shape[0]
    parts = [np.ones((n, 1)), df]
    if covar is not None and covar.shape[1] > 0:
        parts.append(covar)
    return ols_of(np.concatenate(parts, axis=1), y)


def gls_reference(df_all, covar, rot, y_rot):
    """The mixed model's test of one snarl (stoat_tpu/stats/lmm.py): the
    design [1 | dosage fractions, 0 on uncalled rows | covariates] over
    every sample, rotated by ``rot``, against ``y_rot``."""
    import numpy as np
    n = df_all.shape[0]
    parts = [np.ones((n, 1)), df_all]
    if covar is not None and covar.shape[1] > 0:
        parts.append(covar)
    return ols_of(rot @ np.concatenate(parts, axis=1), y_rot)


def ols_of(X, y):
    """(p, beta, se, r2) of the first variant column of the OLS of y on
    the full design X."""
    import numpy as np
    import scipy.stats
    n = X.shape[0]
    XtXinv = np.linalg.inv(X.T @ X)
    beta = XtXinv @ (X.T @ y)
    resid = y - X @ beta
    rss = float(resid @ resid)
    tss = float(((y - y.mean()) ** 2).sum())
    df_res = max(n - X.shape[1] + 1, 1)
    se = np.sqrt(np.diag(XtXinv) * rss / df_res)
    t = beta / se
    p = (1.0 if not np.isfinite(t[1])
         else 2 * scipy.stats.t.sf(abs(t[1]), df_res))
    return p, beta[1], se[1], 1 - rss / tss


def adjusted_holm(p):
    """Holm's step-down with monotonicity (stoat_tpu/corrections.py)."""
    import numpy as np
    p = np.asarray(p, np.float64)
    order = np.argsort(p, kind="stable")
    raw = np.minimum(p[order] * np.arange(p.size, 0, -1, dtype=np.float64),
                     1.0)
    out = np.empty_like(raw)
    out[order] = np.maximum.accumulate(raw)
    return out


def irls_reference(df, y):
    """Logistic IRLS, Wald test and Holm (stats_test.cpp:49-176); None
    when it does not converge in 100 steps."""
    import numpy as np
    import scipy.stats
    n = df.shape[0]
    X = np.concatenate([np.ones((n, 1)), df], axis=1)
    pdim = X.shape[1]
    beta = np.zeros(pdim)
    beta_old = beta.copy()
    for _ in range(100):
        prob = 1 / (1 + np.exp(-(X @ beta)))
        w = np.clip(prob * (1 - prob), 1e-8, 1.0)
        H = (X * w[:, None]).T @ X + 1e-4 * np.eye(pdim)
        beta = beta + np.linalg.solve(H, X.T @ (y - prob) - 1e-4 * beta)
        if np.linalg.norm(beta - beta_old) < 1e-6:
            break
        beta_old = beta.copy()
    else:
        return None
    prob = 1 / (1 + np.exp(-(X @ beta)))
    w = np.clip(prob * (1 - prob), 1e-8, 1.0)
    cov = np.linalg.inv((X * w[:, None]).T @ X + 1e-4 * np.eye(pdim))
    se = np.sqrt(np.diag(cov))
    pvals = np.array([2 * (1 - scipy.stats.norm.cdf(abs(beta[i] / se[i])))
                      for i in range(1, pdim)])
    if len(pvals) > 1:
        adj = adjusted_holm(pvals)
        k = int(np.argmin(adj))
        return adj[k], beta[k + 1], se[k + 1]
    return pvals[0], beta[1], se[1]


def reference_rows(paths, min_individuals=3, min_haplotypes=5, maf=0.05):
    """The rows ``vcf -b`` must write for a ``make_fixture`` cohort, from
    the VCF text and the phenotype file alone, in numpy.

    In the fixture each allele's path is its own bubble, so a haplotype
    carries path i exactly when its allele is i; a missing genotype
    carries none.  Returns ``(rows, filtered)``: ``rows`` lists
    ``(chrom, snarl, group_paths)`` of the snarls that pass the filter
    (stoat_tpu/pipeline/binary.py:109-127), in file order; ``filtered``
    lists ``(chrom, snarl, why)`` of the others."""
    import numpy as np
    with open(paths["binary"]) as fh:
        next(fh)
        case = np.array([line.split("\t")[2].strip() == "2" for line in fh])
    case_hap = np.repeat(case, 2)
    rows, filtered = [], []
    with open(paths["vcf"], "rb") as fh:
        for line in fh:
            if line.startswith(b"#"):
                continue
            f = line.rstrip(b"\n").split(b"\t", 9)
            at = f[7].split(b";")[0]
            check(at.startswith(b"AT="), f"no AT in {f[2]!r}")
            n_paths = at.count(b",") + 1
            # every genotype is "a/b" or "./.": 3 bytes and a tab
            gt = np.frombuffer(f[9] + b"\t", np.uint8).reshape(-1, 4)
            check(gt.shape[0] == case.size, f"{f[2]!r}: genotypes not "
                  f"3 bytes wide")
            hap = gt[:, [0, 2]].reshape(-1).astype(np.int64) - ord("0")
            called = hap >= 0
            g1 = np.bincount(hap[called & case_hap], minlength=n_paths)
            g0 = np.bincount(hap[called & ~case_hap], minlength=n_paths)
            colsum = g0 + g1
            total = int(colsum.sum())
            keep = colsum != 0
            freq1 = g1[keep] / colsum[keep]
            maf_count = int(np.sum(np.minimum(freq1, 1.0 - freq1) > maf))
            chrom, snarl = f[0].decode(), f[2].decode()
            if (total // 2 < min_individuals or total < min_haplotypes
                    or int(keep.sum()) < 2 or maf_count < 2):
                filtered.append((chrom, snarl, (
                    f"total {total}, kept columns {int(keep.sum())}, "
                    f"g0:g1 {g0.tolist()}:{g1.tolist()}, columns with "
                    f"maf > {maf}: {maf_count}")))
            else:
                rows.append((chrom, snarl, ",".join(
                    f"{a}:{b}" for a, b in zip(g0[keep], g1[keep]))))
    return rows, filtered


def quant_reference(paths, pheno, covar, case, n_sample=512, seed=0,
                    thresholds=THRESHOLDS, genes=None, lmm=None):
    """What ``vcf -q`` and ``vcf -b -c`` (and eQTL and the mixed model)
    must compute for a ``make_fixture`` cohort, from the VCF text, the
    phenotypes and the covariates alone, in numpy.

    Returns ``(table, stats, eqtl, gls)``: ``table`` maps (chrom, snarl)
    to (filtered, allele_paths) for every snarl, in file order (the modes
    filter alike); ``stats`` maps (chrom, snarl) of up to ``n_sample``
    random unfiltered snarls to ((p, beta, se, r2) of OLS without
    covariates, the same with them, (p, beta, se) of the logistic model of
    the bool phenotype ``case``), from the references above (NaN for a
    degenerate snarl, whose merged columns all drop, and for a logistic
    fit that never converges).  With ``genes`` ({chrom: [(name, start,
    end, expression [N])]}), ``eqtl`` maps (chrom, snarl, gene) of the
    sampled snarls and every gene of the 1 Mb window to the OLS of the
    gene's expression with the covariates; with ``lmm`` ((rot, y_rot) of
    the null model), ``gls`` maps the sampled snarls to gls_reference.
    A haplotype carries path i exactly when its allele is i
    (reference_rows)."""
    import numpy as np
    N = pheno.shape[0]
    span = {}
    with open(paths["snarl"]) as fh:
        next(fh)
        for line in fh:
            c = line.split("\t", 5)
            span[(c[0], c[4])] = (int(c[1]), int(c[2]))
    sample_of = np.arange(2 * N) // 2
    records = []
    with open(paths["vcf"], "rb") as fh:
        for line in fh:
            if not line.startswith(b"#"):
                records.append(line)
    rng = np.random.default_rng(seed)
    chosen = set(rng.choice(len(records), min(len(records), n_sample + 64),
                            replace=False).tolist())
    table, stats, eqtl, gls = {}, {}, {}, {}
    nan4 = (np.nan,) * 4
    for r, line in enumerate(records):
        f = line.rstrip(b"\n").split(b"\t", 9)
        at = f[7].split(b";")[0]
        check(at.startswith(b"AT="), f"no AT in {f[2]!r}")
        n_paths = at.count(b",") + 1
        gt = np.frombuffer(f[9] + b"\t", np.uint8).reshape(-1, 4)
        check(gt.shape[0] == N, f"{f[2]!r}: genotypes not 3 bytes wide")
        hap = gt[:, [0, 2]].reshape(-1).astype(np.int64) - ord("0")
        called = hap >= 0
        counts = np.bincount(sample_of[called] * n_paths + hap[called],
                             minlength=N * n_paths).reshape(N, n_paths)
        allele = counts.sum(axis=0)
        ck = counts[:, allele > 0].astype(np.float64)
        rows = ck.sum(axis=1)
        used = rows > 0
        df = ck[used] / rows[used][:, None]
        filtered = filtration_quantitative(df, *thresholds)
        key = (f[0].decode(), f[2].decode())
        table[key] = (bool(filtered), tuple(int(a) for a in allele))
        if filtered or r not in chosen or len(stats) >= n_sample:
            continue
        merged = combine_identical_columns(df)[:, :-1]
        start, end = span[key]
        lo, hi = max(start - 1000000, 0), end + 1000000
        window = [g for g in (genes or {}).get(key[0], [])
                  if not (g[2] < lo or g[1] > hi)]
        if merged.shape[1] == 0:
            stats[key] = (nan4, nan4, (np.nan,) * 3)
            eqtl.update({(*key, g[0]): nan4 for g in window})
            if lmm is not None:
                gls[key] = nan4
            continue
        logit = irls_reference(merged, case[used].astype(float))
        stats[key] = (ols_reference(merged, pheno[used], None),
                      ols_reference(merged, pheno[used], covar[used]),
                      (np.nan,) * 3 if logit is None else logit)
        for g in window:
            eqtl[(*key, g[0])] = ols_reference(merged, g[3][used],
                                               covar[used])
        if lmm is not None:
            full = np.zeros((N, merged.shape[1]))
            full[used] = merged
            gls[key] = gls_reference(full, covar, *lmm)
    return table, stats, eqtl, gls


def baseline_reference_count(paths, thresholds=THRESHOLDS):
    """The analyses the single-core baseline must run to a p-value on a
    ``make_fixture`` cohort, counted as tests/test_baseline_core.py:40-49
    counts the scalar oracle's: each snarl's binary row when it passes
    the filter (reference_rows), and its quantitative row when it is
    neither filtered nor degenerate (no variant column left once the
    identical columns are merged and the last dropped), from the VCF text
    alone (quant_reference's tables)."""
    import numpy as np
    binary = len(reference_rows(paths, *thresholds)[0])
    with open(paths["binary"]) as fh:
        next(fh)
        N = sum(1 for _ in fh)
    sample_of = np.arange(2 * N) // 2
    quantitative = 0
    with open(paths["vcf"], "rb") as fh:
        for line in fh:
            if line.startswith(b"#"):
                continue
            f = line.rstrip(b"\n").split(b"\t", 9)
            n_paths = f[7].split(b";")[0].count(b",") + 1
            gt = np.frombuffer(f[9] + b"\t", np.uint8).reshape(-1, 4)
            hap = gt[:, [0, 2]].reshape(-1).astype(np.int64) - ord("0")
            called = hap >= 0
            counts = np.bincount(sample_of[called] * n_paths + hap[called],
                                 minlength=N * n_paths).reshape(N, n_paths)
            ck = counts[:, counts.sum(axis=0) > 0].astype(np.float64)
            rows = ck.sum(axis=1)
            df = ck[rows > 0] / rows[rows > 0][:, None]
            if (not filtration_quantitative(df, *thresholds)
                    and combine_identical_columns(df).shape[1] > 1):
                quantitative += 1
    return binary + quantitative


def host_cpu():
    """The host CPU as /proc/cpuinfo gives its first processor: the model
    name, or, where the machine hides it ("unknown"), the vendor, family,
    model and stepping; and the count of logical CPUs."""
    try:
        with open("/proc/cpuinfo") as fh:
            blocks = [b for b in fh.read().split("\n\n") if b.strip()]
    except OSError:
        return "unknown host CPU"
    info = {}
    for line in blocks[0].splitlines() if blocks else ():
        key, _, value = line.partition(":")
        info.setdefault(key.strip(), value.strip())
    name = info.get("model name", "")
    if name.lower() in ("", "unknown"):
        name = (f"{info.get('vendor_id', 'unknown vendor')} family "
                f"{info.get('cpu family', '?')} model "
                f"{info.get('model', '?')} stepping "
                f"{info.get('stepping', '?')} (model name {name or 'absent'})")
    return f"{name}, {len(blocks)} logical CPUs"


def baseline_inputs(paths, snarl_limit=None):
    """Per chromosome of a ``make_fixture`` cohort, the single-core
    baseline's inputs as bench.py:386-400 builds them, through the port:
    (dense uint8 [E + 1, H] with the all-zero row last, path_rows,
    row_offsets, snarl_offsets, binary phenotype uint8, quantitative
    phenotype), for the chromosome's first ``snarl_limit`` snarls (all
    when None) and, with a limit, the first chromosome alone."""
    import numpy as np
    from stoat_tpu_torch.io import (parse_binary_pheno,
                                    parse_quantitative_pheno,
                                    parse_snarl_path)
    from stoat_tpu_torch.native.baseline import pack_for_baseline
    from stoat_tpu_torch.pipeline.runner import iter_chromosome_matrices
    from stoat_tpu_torch.tables import pack_chromosome
    pheno, samples = parse_binary_pheno(paths["binary"],
                                        list(paths["samples"]))
    pheno_q = parse_quantitative_pheno(paths["quantitative"], samples)
    snarls_chr = parse_snarl_path(paths["snarl"])
    out = []
    chroms = iter_chromosome_matrices(paths["vcf"], 2 * len(samples),
                                      snarls_chr)
    try:
        for chrom, matrix in chroms:
            packed = pack_chromosome(snarls_chr[chrom][:snarl_limit], matrix)
            dense = np.ascontiguousarray(np.vstack([
                packed.dense_matrix(),
                np.zeros((1, packed.n_haplotypes), bool)]), np.uint8)
            out.append((dense, *pack_for_baseline(packed, matrix,
                                                  dense.shape[0] - 1),
                        pheno.astype(np.uint8), pheno_q))
            if snarl_limit is not None:
                break
    finally:
        chroms.close()
    return out


def phase_baseline(paths, sub, graph, twin, work, smi):
    """The single-core C++ baseline (native/baseline.py), on the host CPU
    of the card's machine: its count on the sub-cohort against
    baseline_reference_count; its rate, best of BASELINE_REPS, on the
    first BASELINE_SAMPLE snarls of the full cohort, the inputs built
    before the timer (bench.py:386-420); the graph loop on phase 4's
    graph from the native cores' flat arrays (write_graph's, held here to
    the port's own graph/partition.py flat_steps on the twin graph), its
    count against the rows of phase 4's graph table."""
    import numpy as np
    from stoat_tpu_torch.graph.association import PathPartitioner
    from stoat_tpu_torch.graph.gfa import load_gfa
    from stoat_tpu_torch.graph.partition import flat_steps
    from stoat_tpu_torch.graph.snarls import find_snarls
    from stoat_tpu_torch.native.baseline import (run_baseline_cpp,
                                                 run_baseline_graph_cpp)
    t0 = time.perf_counter()
    got = sum(run_baseline_cpp(*args, *THRESHOLDS)
              for args in baseline_inputs(sub))
    want = baseline_reference_count(sub)
    check(got == want, f"baseline: {got} analyses on the sub-cohort, the "
          f"scalar oracle's count is {want}")
    count_s = time.perf_counter() - t0

    (dense, rows, offs, soffs, pb, pq), = baseline_inputs(
        paths, BASELINE_SAMPLE)
    check(len(soffs) - 1 == BASELINE_SAMPLE, f"baseline sample: "
          f"{len(soffs) - 1} snarls")
    run_baseline_cpp(dense, rows, offs, soffs, pb, pq, *THRESHOLDS)   # warm
    times = []
    for _ in range(BASELINE_REPS):
        t1 = time.perf_counter()
        n_sample = run_baseline_cpp(dense, rows, offs, soffs, pb, pq,
                                    *THRESHOLDS)
        times.append(time.perf_counter() - t1)
    vcf_rate = 2 * BASELINE_SAMPLE / min(times)

    g = load_gfa(twin["gfa"], {"ref"})
    forest = find_snarls(g)
    part = PathPartitioner(g, [p for p in g.paths if p.sample != "ref"])
    _names, steps, offsets, path_sample, starts = flat_steps(forest, part)
    b = twin["baseline"]
    check(np.array_equal(steps, b["steps"])
          and np.array_equal(offsets, b["offsets"])
          and np.array_equal(np.sort(starts), np.sort(b["starts"]))
          and np.array_equal(path_sample, np.arange(len(offsets) - 1) // 2),
          "baseline: write_graph's flat arrays differ from flat_steps' on "
          "the twin graph")
    b = graph["baseline"]
    g_times = []
    for _ in range(BASELINE_REPS):
        t1 = time.perf_counter()
        tested = run_baseline_graph_cpp(b["steps"], b["offsets"],
                                        b["starts"], b["pheno"])
        g_times.append(time.perf_counter() - t1)
    with open(os.path.join(work, "g_cuda", "binary_table_graph.tsv")) as fh:
        rows_written = sum(1 for _ in fh) - 1
    check(tested == rows_written, f"baseline graph loop tested {tested} "
          f"snarls; phase 4's graph table has {rows_written} rows")
    return (f"phase 4 single-core C++ baseline (host CPU: {host_cpu()}; "
            f"card {smi}): {got} analyses on the sub-cohort of "
            f"{sub['n_snarls']} snarls, equal to the scalar oracle's count "
            f"({count_s:.1f}s); vcf loop on the first {BASELINE_SAMPLE} "
            f"snarls of the full cohort ({n_sample} analyses) "
            f"{vcf_rate:.1f} snarl-tests/s (2 a snarl, best of "
            f"{BASELINE_REPS}: {', '.join(f'{t:.4f}' for t in times)} s); "
            f"graph loop on {len(b['starts'])} snarls x "
            f"{len(b['offsets']) - 1} haplotype paths, {tested} tested, as "
            f"many as the table's rows: {tested / min(g_times):.1f} "
            f"snarls/s (best of {BASELINE_REPS}: "
            f"{', '.join(f'{t:.4f}' for t in g_times)} s); the twin "
            f"graph's flat arrays equal flat_steps'")


def write_graph(out_dir, n_snarls, n_samples=GRAPH_SAMPLES, seed=0):
    """A GFA for ``graph`` mode and its binary phenotype, from a seed.

    One chromosome: a backbone of anchor nodes with one snarl between
    each pair, walked by ``2 * n_samples`` haplotype paths named
    ``S####1#chr1`` and ``S####2#chr1`` (PanSN) and a reference path
    ``ref`` through the first branch of every snarl.  Snarl k is a
    biallelic bubble, triallelic when k % 5 == 0 (a 2xN test), with a
    deletion edge straight across when k % 7 == 3 (an irregular snarl;
    tests/test_graph_native_parity.py:35-37) and with a nested bubble in
    its second branch when k % 11 == 4 (depth 2).  Allele frequencies
    are random; one snarl in ten shifts them in cases, and one in fifty
    splits cases from controls exactly (``-T exact`` reports those).
    Returns {"gfa", "pheno", "n_snarls", "n_samples", "baseline"}:
    "baseline" holds the single-core baseline's inputs, the native
    cores' flat view of the haplotype paths and snarls
    (graph/partition.py flat_steps: "steps" uint64, "offsets" int64,
    "starts" uint64 of every snarl, the nested ones too, in snarl order)
    and "pheno" uint8 per path, 1 for a case."""
    import numpy as np
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    H = 2 * n_samples
    case = np.zeros(n_samples, bool)
    case[rng.permutation(n_samples)[:n_samples // 2]] = True
    case_hap = np.repeat(case, 2)
    lines, tokens, offs = [], [], [0]
    nid = 1

    def node(seq):
        nonlocal nid
        lines.append(f"S\t{nid}\t{seq}\n")
        nid += 1
        return nid - 1

    def link(u, v):
        lines.append(f"L\t{u}\t+\t{v}\t+\t0M\n")

    choice = np.zeros((H, n_snarls), np.int64)
    anchor = node("ACGT")
    ref_steps, codes, starts = [], [], []
    for k in range(n_snarls):
        m1, m2 = node("C"), node("GG")
        alleles = [[m1]]
        starts.append(anchor)
        if k % 11 == 4:                       # m2 -> (n1 | n2) -> m3
            starts.append(m2)
            n1, n2, m3 = node("A"), node("CC"), node("G")
            for u, v in ((m2, n1), (m2, n2), (n1, m3), (n2, m3)):
                link(u, v)
            alleles += [[m2, n1, m3], [m2, n2, m3]]
            ends = [m1, m3]
        else:
            alleles.append([m2])
            ends = [m1, m2]
        if k % 5 == 0:
            m4 = node("TTT")
            alleles.append([m4])
            ends.append(m4)
        if k % 7 == 3:
            alleles.append([])                # the deletion edge
        nxt = node("ACGT")
        for branch in alleles:
            if branch:
                link(anchor, branch[0])
        for e in ends:
            link(e, nxt)
        if k % 7 == 3:
            link(anchor, nxt)
        for branch in alleles:
            tokens.append("".join(f"{n}+," for n in [anchor, *branch])
                          .encode())
            codes.append(np.array([anchor, *branch], np.uint64) << 1)
        offs.append(len(tokens))
        ref_steps.append(f"{anchor}+,{m1}+,".encode())
        freq = rng.dirichlet(np.ones(len(alleles)))
        cum = np.cumsum(freq)
        u = rng.random(H)
        if k % 10 == 7:                       # associated: cases shift
            u = np.where(case_hap, u ** 3, u)
        choice[:, k] = np.minimum(np.searchsorted(cum, u), len(alleles) - 1)
        if k % 50 == 17:                      # an exact partition
            choice[:, k] = np.where(case_hap, 0, 1)
        anchor = nxt
    table = np.empty(len(tokens), object)
    table[:] = tokens
    code_table = np.empty(len(codes), object)
    code_table[:] = codes
    base = np.asarray(offs[:-1], np.int64)
    tail_code = np.array([anchor << 1], np.uint64)
    path_steps = [np.concatenate([*code_table[base + choice[h]], tail_code])
                  for h in range(H)]
    baseline = {"steps": np.concatenate(path_steps),
                "offsets": np.cumsum([0] + [len(p) for p in path_steps],
                                     dtype=np.int64),
                "starts": np.array(starts, np.uint64) << 1,
                "pheno": case_hap.astype(np.uint8)}
    gfa = os.path.join(out_dir, "graph.gfa")
    with open(gfa, "wb") as fh:
        fh.write(b"H\tVN:Z:1.0\n")
        fh.write("".join(lines).encode())
        tail = f"{anchor}+\t*\n".encode()
        fh.write(b"P\tref\t" + b"".join(ref_steps) + tail)
        for h in range(H):
            name = f"S{h // 2:03d}#{h % 2 + 1}#chr1"
            fh.write(f"P\t{name}\t".encode()
                     + b"".join(table[base + choice[h]]) + tail)
    pheno = os.path.join(out_dir, "pheno.tsv")
    with open(pheno, "w") as fh:
        fh.write("FID\tIID\tPHENO\n")
        for s in range(n_samples):
            fh.write(f"S{s:03d}\tS{s:03d}\t{2 if case[s] else 1}\n")
    return {"gfa": gfa, "pheno": pheno, "n_snarls": n_snarls,
            "n_samples": n_samples, "baseline": baseline}


def write_genes(paths, seed=0):
    """An eQTL gene set for a ``make_fixture`` cohort, from a seed: along
    each chromosome of the snarl file, a gene every GENE_STEP bases from 0
    to its last snarl's end, GENE_LEN long, with expression N(0, 1) per
    sample.  Writes the gene position and expression files beside the
    cohort (their paths as ``genes`` and ``qtl_smoke`` in ``paths``) and
    returns {chrom: [(name, start, end, expression [N])]} in file order."""
    import numpy as np
    ends = {}
    with open(paths["snarl"]) as fh:
        next(fh)
        for line in fh:
            c = line.split("\t", 3)
            ends[c[0]] = max(ends.get(c[0], 0), int(c[2]))
    rows = [(f"g{c}_{i}", c, lo, lo + GENE_LEN) for c, end in ends.items()
            for i, lo in enumerate(range(0, end + 1, GENE_STEP))]
    samples = paths["samples"]
    expr = np.random.default_rng(seed).standard_normal((len(rows),
                                                        len(samples)))
    base = os.path.dirname(paths["snarl"])
    paths["genes"] = os.path.join(base, "smoke_genes.tsv")
    paths["qtl_smoke"] = os.path.join(base, "smoke_expression.tsv")
    with open(paths["genes"], "w") as fh:
        fh.write("gene_name\tchr\tstart\tend\n")
        fh.writelines(f"{g}\t{c}\t{lo}\t{hi}\n" for g, c, lo, hi in rows)
    out = {}
    with open(paths["qtl_smoke"], "w") as fh:
        fh.write("gene\t" + "\t".join(samples) + "\n")
        for (g, c, lo, hi), e in zip(rows, expr):
            text = [f"{v:.6f}" for v in e]
            fh.write(g + "\t" + "\t".join(text) + "\n")
            # the values as the CLI parses them
            out.setdefault(c, []).append((g, lo, hi, np.array(text, float)))
    return out


def random_kinship(n, rng, rank=None):
    """tests/test_lmm.py:26's random kinship (a copy: that module imports
    the JAX package), and the factor A with K = A A^T."""
    import numpy as np
    G = rng.normal(size=(n, rank or n))
    K = G @ G.T / (rank or n)
    d = np.sqrt(np.diag(K))
    return K / np.outer(d, d), G / np.sqrt(rank or n) / d[:, None]


def write_kinship(paths, seed=0, rank=KIN_RANK):
    """The mixed model's inputs for a ``make_fixture`` cohort, from a
    seed: the kinship K = random_kinship(N, rng, rank) as the tab-separated
    matrix the CLI reads (``kinship`` in ``paths``), and a phenotype y =
    g + e with g ~ N(0, K) and e ~ N(0, I), so that REML lands near
    h2 = 0.5 (``lmm_pheno``)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    samples = paths["samples"]
    K, A = random_kinship(len(samples), rng, rank)
    y = 5.0 + A @ rng.standard_normal(A.shape[1]) \
        + rng.standard_normal(len(samples))
    base = os.path.dirname(paths["snarl"])
    paths["kinship"] = os.path.join(base, "smoke_kinship.tsv")
    paths["lmm_pheno"] = os.path.join(base, "smoke_lmm.pheno.tsv")
    with open(paths["kinship"], "w") as fh:
        fh.write("id\t" + "\t".join(samples) + "\n")
        for s, row in zip(samples, K):
            fh.write(s + "\t" + "\t".join(f"{v:.8f}" for v in row) + "\n")
    with open(paths["lmm_pheno"], "w") as fh:
        fh.write("FID\tIID\tPHENO\n")
        fh.writelines(f"{s}\t{s}\t{v:.6f}\n" for s, v in zip(samples, y))


# ---------------------------------------------------------------- kernels

def compare_membership(cuda_args, err):
    """K1+K2 kernel vs plain (same CUDA inputs, and on the CPU): exact."""
    import numpy as np
    from stoat_tpu_torch.pipeline.packed import (membership_counts,
                                                 membership_counts_plain)
    got = membership_counts(*cuda_args)
    plain = membership_counts_plain(*cuda_args)
    cpu = membership_counts_plain(*(t.cpu() for t in cuda_args))
    for g, p, c in zip(got, plain, cpu):
        check(np.array_equal(to_np(g), to_np(p)),
              "membership_counts: kernel != plain on the card")
        check(np.array_equal(to_np(g), c.numpy()),
              "membership_counts: kernel != plain on the CPU")
        err["membership_counts"] = max(err["membership_counts"],
                                       max_abs_err(to_np(g), to_np(p)))
    return got


def compare_tables(g0p, g1p, sidx, thresholds, err):
    """K3 kernel vs plain: integers and flags exact, statistic to a
    relative 1e-12."""
    import numpy as np
    from stoat_tpu_torch.pipeline.binary import (binary_tables,
                                                 binary_tables_plain)
    got = binary_tables(g0p, g1p, sidx, *thresholds)
    for plain in (binary_tables_plain(g0p, g1p, sidx, *thresholds),
                  binary_tables_plain(g0p.cpu(), g1p.cpu(), sidx.cpu(),
                                      *thresholds)):
        for key, g in got.items():
            a, b = to_np(g), to_np(plain[key])
            if key == "chi2_stat":
                check(rel_ok(a, b, 1e-12), "binary_tables: chi2_stat "
                      "beyond relative 1e-12")
            else:
                check(np.array_equal(a, b), f"binary_tables: {key} differs")
            if a.dtype != np.bool_:
                err["binary_tables"] = max(err["binary_tables"],
                                           max_abs_err(a, b))
    return got


def compare_fisher(cols, err, expected=None):
    """K4 kernel vs plain: bitwise, on the card and against the CPU."""
    from stoat_tpu_torch.writer import format_p
    from stoat_tpu_torch.stats.fisher import (fisher_exact_2x2,
                                              fisher_exact_2x2_plain)
    got = to_np(fisher_exact_2x2(*cols))
    plain = to_np(fisher_exact_2x2_plain(*cols))
    cpu = fisher_exact_2x2_plain(*(c.cpu() for c in cols)).numpy()
    check(same_bits(got, plain), "fisher: kernel != plain bitwise (card)")
    check(same_bits(got, cpu), "fisher: kernel != plain bitwise (CPU)")
    err["fisher"] = max(err["fisher"], max_abs_err(got, plain))
    if expected is not None:
        strings = [format_p(v) for v in got]
        check(strings == expected, f"fisher strings {strings} != {expected}")
    return got


def compare_binary_stats(g0p, g1p, sidx, thresholds, err, what):
    """binary_stats (K3 and K4 in one launch) vs its plain version on the
    card and on the CPU: every output bitwise.  Returns the kernel's
    outputs as numpy arrays."""
    import numpy as np
    from stoat_tpu_torch.pipeline.binary import (binary_stats,
                                                 binary_stats_plain)
    got = {k: to_np(v) for k, v in
           binary_stats(g0p, g1p, sidx, *thresholds).items()}
    for where, plain in (
            ("card", binary_stats_plain(g0p, g1p, sidx, *thresholds)),
            ("CPU", binary_stats_plain(g0p.cpu(), g1p.cpu(), sidx.cpu(),
                                       *thresholds))):
        check(set(plain) == set(got), f"binary_stats ({what}): keys "
              f"{sorted(got)} != the plain version's {sorted(plain)}")
        for key, g in got.items():
            want = to_np(plain[key])
            ok = same_bits(g, want) if g.dtype == np.float64 \
                else np.array_equal(g, want)
            check(ok, f"binary_stats ({what}): {key} differs from the plain "
                  f"version on the {where}")
            if g.dtype != np.bool_:
                err["binary_stats"] = max(err["binary_stats"],
                                          max_abs_err(g, want))
    return got


def compare_binary_from_words(args, sidx, thresholds, err, what):
    """binary_from_words (K1+K2, K3 and K4 in one launch) vs its plain
    version (membership_counts_plain, then binary_stats_plain) on the card
    and on the CPU: every output bitwise.  ``args`` are membership_counts'
    five; returns the kernel's outputs as numpy arrays."""
    import numpy as np
    from stoat_tpu_torch.pipeline.binary import (
        binary_stats_from_words, binary_stats_from_words_plain)
    got = {k: to_np(v) for k, v in
           binary_stats_from_words(*args, sidx, *thresholds).items()}
    for where, plain in (
            ("card", binary_stats_from_words_plain(*args, sidx,
                                                   *thresholds)),
            ("CPU", binary_stats_from_words_plain(
                *(t.cpu() for t in args), sidx.cpu(), *thresholds))):
        check(set(plain) == set(got), f"binary_from_words ({what}): keys "
              f"{sorted(got)} != the plain version's {sorted(plain)}")
        for key, g in got.items():
            want = to_np(plain[key])
            ok = same_bits(g, want) if g.dtype == np.float64 \
                else np.array_equal(g, want)
            check(ok, f"binary_from_words ({what}): {key} differs from the "
                  f"plain version on the {where}")
            if g.dtype != np.bool_:
                err["binary_from_words"] = max(err["binary_from_words"],
                                               max_abs_err(g, want))
    return got


def from_words_variants(chunk, seed=12):
    """The first chunk's inputs to binary_from_words as the main paths
    give them, and two variants: (name, membership_counts' five args,
    snarl_path_idx).  "main chunk" as it is; "dual rows", the dual's
    (perm_membership's words of the chunk's paths, one row a path, K =
    1); "invalid and zero-edge paths", an eighth of the paths made
    invalid and another eighth valid with every row the identity (no
    edge)."""
    import numpy as np
    import torch
    from stoat_tpu_torch.pipeline.permutation import perm_membership
    args = (chunk.words, chunk.path_idx, chunk.path_valid, chunk.tail,
            chunk.g1_words)
    out = [("main chunk", args, chunk.snarl_path_idx)]
    mem, _ = perm_membership(*args[:4])
    P = int(chunk.path_idx.shape[0])
    rows = torch.arange(P, dtype=torch.int32, device=mem.device)[:, None]
    out.append(("dual rows", (mem, rows, *args[2:]), chunk.snarl_path_idx))
    rng = np.random.default_rng(seed)
    valid = chunk.path_valid.clone()
    idx = chunk.path_idx.clone()
    dead = torch.from_numpy(rng.choice(P, P // 8, replace=False))
    zero = torch.from_numpy(rng.choice(P, P // 8, replace=False))
    valid[dead.to(valid.device)] = False
    idx[zero.to(idx.device)] = int(chunk.words.shape[0]) - 1
    valid[zero.to(valid.device)] = True
    out.append(("invalid and zero-edge paths",
                (chunk.words, idx, valid, *args[3:]), chunk.snarl_path_idx))
    return out


def from_words_grid_cases(seed=21):
    """binary_from_words' grid: numpy (words uint32 [E+1, W], path_idx,
    path_valid, tail, g1_words, snarl_path_idx) of membership_case's paths
    grouped into snarls, at H = 7, 31, 32, 101 and 5,008 (W = 1 and a
    part-filled last word), at H = 9,000 (W = 282: two batches of a
    lane's words), and two shapes past the kernel's shared memory: K = 70
    edge rows a path (row indices read from global memory; dense rows, so
    that the ANDs of 70 rows keep carriers) and Pmax = 700 paths a snarl
    (fewer snarls a block)."""
    import numpy as np
    cases = []
    for i, (H, P, Pmax, max_k, density) in enumerate(
            ((7, 40, 3, 5, 0.6), (31, 60, 4, 5, 0.6), (32, 50, 2, 5, 0.6),
             (101, 90, 5, 5, 0.6), (5008, 120, 4, 5, 0.6),
             (9000, 60, 4, 5, 0.6), (101, 200, 4, 70, 0.995),
             (64, 1500, 700, 3, 0.6))):
        words, idx, valid, tail, g1w = membership_case(
            seed + i, 37, H, P, max_k=max_k, density=density)
        rng = np.random.default_rng(seed + 100 + i)
        # snarls of 1..Pmax paths in order, some paths in two snarls
        sidx, p = [], 0
        while p < P:
            n = int(rng.integers(1, Pmax + 1))
            row = list(range(p, min(p + n, P)))
            sidx.append(row + [-1] * (Pmax - len(row)))
            p += n
        sidx = np.array(sidx + [[-1] * Pmax], np.int32)
        sidx[0, 0] = P - 1
        cases.append((f"H {H}, P {P}, Pmax {Pmax}, K {idx.shape[1]}",
                      (words, idx, valid, tail, g1w, sidx)))
    return cases


def fisher_grid_cases(rng):
    """K4's grids: (name, tables [n, 4] as (a, b, c, d), the expected
    strings or None).  The pinned strings and the overflow tables; 4,096
    random tables at hi = 60, 400 and 5,000 with zero margins (drawn from
    ``rng``, in that order), 4,096 of tiny and fractional counts; and 8,192
    tables drawn like a 2,504-sample
    cohort's (5,008 haplotypes, half of them cases, carrier frequency
    uniform on 0.01-0.5, the case carriers hypergeometric), seeds 0 and 1:
    the scans of ~45-320 steps that the main path runs."""
    import numpy as np
    cases = [("pinned", np.array([t for t, _ in FISHER_CASES], float),
              [s for _, s in FISHER_CASES]),
             ("overflow", np.array(OVERFLOW_TABLES, float),
              ["0"] * len(OVERFLOW_TABLES))]
    for hi in (60, 400, 5000):
        tables = rng.integers(0, hi, (4096, 4)).astype(float)
        tables[:64, 0] = 0
        tables[64:96, :2] = 0
        cases.append((f"hi {hi}", tables, None))
    # counts outside [2^-50, 2^60], where the scan divides with '/', and
    # fractional ones
    tables = np.random.default_rng(2).choice(
        [0.0, 1e-300, 1e-20, 0.3, 1.7, 3.0, 7.5, 12.0], (4096, 4))
    cases.append(("tiny and fractional", tables, None))
    n, h1 = 2 * N_SAMPLES, N_SAMPLES
    for seed in (0, 1):
        draw = np.random.default_rng(seed)
        k = np.round(draw.uniform(0.01, 0.5, 8192) * n).astype(np.int64)
        d = draw.hypergeometric(k, n - k, h1)
        b = k - d
        tables = np.stack([(n - h1) - b, b, h1 - d, d], 1).astype(float)
        cases.append((f"cohort seed {seed}", tables, None))
    return cases


def tables_as_snarls(tables, device):
    """2x2 tables (a, b, c, d) as snarls of two paths for binary_stats:
    g0 = (a, b), g1 = (c, d) of paths (2 i, 2 i + 1)."""
    import numpy as np
    import torch
    n = len(tables)
    g0 = np.ascontiguousarray(tables[:, :2]).reshape(-1)
    g1 = np.ascontiguousarray(tables[:, 2:]).reshape(-1)
    sidx = np.arange(2 * n, dtype=np.int32).reshape(n, 2)
    return tuple(torch.from_numpy(v).to(device) for v in (g0, g1, sidx))


def membership_case(seed, E, H, P, max_k=5, density=0.6):
    import numpy as np
    from stoat_tpu_torch.pipeline import packed as pk
    rng = np.random.default_rng(seed)
    matrix = rng.random((E, H)) < density
    valid = rng.random(P) < 0.85
    coo_path, coo_row = [], []
    for p in range(P):
        for _ in range(int(rng.integers(0, max_k + 1))):
            coo_path.append(p)
            coo_row.append(int(rng.integers(0, E)))
    words = pk.pack_matrix_words(matrix)
    idx = pk.pack_path_edge_idx(np.array(coo_path, np.int32),
                                np.array(coo_row, np.int32), valid, E)
    W = words.shape[1]
    tail = pk.tail_mask_words(H, W)
    g1w = pk.pack_hap_mask_words(rng.random(H) < 0.5, W)
    return words, idx, valid, tail, g1w


def cuda_args_of(device, words, idx, valid, tail, g1w):
    import numpy as np
    import torch
    return (torch.from_numpy(words.view(np.int32).copy()).to(device),
            torch.from_numpy(idx.copy()).to(device),
            torch.from_numpy(valid.copy()).to(device),
            torch.from_numpy(tail.view(np.int32).copy()).to(device),
            torch.from_numpy(g1w.view(np.int32).copy()).to(device))


def edge_cases(device, err):
    """Phase 3 edge cases; returns a short description."""
    import numpy as np
    import torch

    # K1+K2: zero-edge valid path, invalid path, H % 32 != 0, W = 1
    zero_edge = (np.vstack([np.zeros((3, 1), np.uint32),
                            np.full((1, 1), 0xFFFFFFFF, np.uint32)]),
                 np.full((2, 1), 3, np.int32), np.array([True, False]),
                 np.array([0x3FF], np.uint32), np.array([0x7], np.uint32))
    got = compare_membership(cuda_args_of(device, *zero_edge), err)
    check(to_np(got[0]).tolist() == [7.0, 0.0]
          and to_np(got[1]).tolist() == [3.0, 0.0],
          "membership_counts: zero-edge/invalid path counts wrong")
    for seed, H in ((0, 101), (1, 32), (2, 7), (3, 5008), (4, 31)):
        compare_membership(cuda_args_of(
            device, *membership_case(seed, 37, H, 23)), err)
    # K1+K2, K3 and K4 in one launch on its grid
    grid = from_words_grid_cases()
    for name, (*margs, sidx) in grid:
        compare_binary_from_words(
            cuda_args_of(device, *margs), torch.from_numpy(sidx).to(device),
            THRESHOLDS, err, f"grid {name}")

    # K4: pinned strings, overflow tables, random batches, cohort draws;
    # the same tables as two-path snarls through binary_stats
    from stoat_tpu_torch.writer import format_p
    rng = np.random.default_rng(1)
    grids = fisher_grid_cases(rng)
    for name, tables, expected in grids:
        t = torch.from_numpy(tables).to(device)
        compare_fisher(tuple(t[:, i].contiguous() for i in range(4)), err,
                       expected=expected)
        got = compare_binary_stats(*tables_as_snarls(tables, device),
                                   THRESHOLDS, err, f"K4 grid {name}")
        if expected is not None:
            strings = [format_p(v) for v in got["p_fisher"]]
            check(strings == expected, f"binary_stats: Fisher strings "
                  f"{strings} != {expected}")

    # K3: 2x2 and 2xN tables with zero margins and zero columns
    P, S, Pmax = 512, 256, 8
    g0 = rng.integers(0, 60, P).astype(np.float64)
    g1 = rng.integers(0, 60, P).astype(np.float64)
    g0[rng.random(P) < 0.2] = 0
    g1[rng.random(P) < 0.2] = 0
    sidx = rng.integers(0, P, (S, Pmax)).astype(np.int32)
    n_real = rng.integers(1, Pmax + 1, S)
    sidx[np.arange(Pmax)[None, :] >= n_real[:, None]] = -1
    sidx[:32, 2:] = -1                         # 2x2 tables
    for thr in ((3, 5, 0.05), (2, 2, 0.0), (40, 5, 0.45)):
        args = (torch.from_numpy(g0).to(device),
                torch.from_numpy(g1).to(device),
                torch.from_numpy(sidx).to(device))
        compare_tables(*args, thr, err)
        compare_binary_stats(*args, thr, err, f"K3 grid {thr}")

    return (f"edge cases ok (zero-edge/invalid paths, H=7/31/32/101/5008,"
            f" binary_from_words on "
            + ", ".join(name for name, _ in grid)
            + f", Fisher and binary_stats on "
            + ", ".join(f"{name} ({len(t)})" for name, t, _ in grids)
            + ", binary_stats on the zero-margin 2x2/2xN K3 grid)")


def chi2_grids(seed=0, n=1_000_000, draw=4_000_000):
    """The chi-squared tail's test grids: tests/test_extreme_tails.py's
    TAIL_STATS x TAIL_DFS, and n statistics uniform in [0, 1500] on df
    1-8 (the binary tables' and the graph's dfs) with zeros, NaNs and
    85 +- 1e-9 (both sides of the tail's switch); df up to 2,000 with
    statistics near df, where both loops of JAX's igammac run long; and
    the draw of fault 3.2 (ROADMAP.md): ``draw`` pairs, df uniform on
    1-400, stat = |df + 4 z sqrt(2 df)|, numpy default_rng(0)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    stat = rng.uniform(0.0, 1500.0, n)
    df = rng.integers(1, 9, n).astype(np.float64)
    stat[:1000] = 0.0
    stat[1000:1100] = np.nan
    stat[1100:1600] = 85.0 + 1e-9
    stat[1600:2100] = 85.0 - 1e-9
    big_df = rng.integers(1, 2001, n // 5).astype(np.float64)
    big_stat = big_df * rng.uniform(0.3, 1.7, big_df.size)
    rng = np.random.default_rng(0)
    fault_df = rng.integers(1, 401, draw).astype(np.float64)
    fault_stat = np.abs(fault_df + 4.0 * rng.standard_normal(draw)
                        * np.sqrt(2.0 * fault_df))
    return {"tail grid": (np.repeat(TAIL_STATS, len(TAIL_DFS)),
                          np.tile(np.asarray(TAIL_DFS, np.float64),
                                  len(TAIL_STATS))),
            f"random grid of {n}": (stat, df),
            LARGE_DF: (big_stat, big_df),
            f"fault 3.2's draw of {draw}": (fault_stat, fault_df)}


def hold_tail(got, want, what, rel_bound, strings=True):
    """chi2_tail's p against a plain version's: NaN, zeros and DBL_MAX in
    the same places and (with ``strings``) the same format_p strings
    (compared where the bits differ); where p > 1e-300, relative
    ``rel_bound`` (None: report only).  Returns (max relative error, max
    ulps, elements whose bits differ, elements whose strings differ)."""
    import numpy as np
    from stoat_tpu_torch.writer import format_p
    dbl_max = np.finfo(np.float64).max
    for name, mask in (("NaN", np.isnan), ("zero", lambda v: v == 0),
                       ("DBL_MAX", lambda v: v == dbl_max)):
        check(np.array_equal(mask(got), mask(want)),
              f"chi2_tail ({what}): {name} in other places")
    both_nan = np.isnan(got) & np.isnan(want)
    differ = np.nonzero((got.view(np.uint64) != want.view(np.uint64))
                        & ~both_nan)[0]
    bad = [i for i in differ if format_p(got[i]) != format_p(want[i])]
    check(not (strings and bad), f"chi2_tail ({what}): {len(bad)} strings "
          f"differ, first {got[bad[0]]!r} / {want[bad[0]]!r}" if bad else "")
    big = want > 1e-300
    rel = np.abs(got[big] - want[big]) / want[big]
    worst = float(rel.max()) if rel.size else 0.0
    at = np.nonzero(big)[0][int(np.argmax(rel))] if rel.size else 0
    check(rel_bound is None or worst <= rel_bound,
          f"chi2_tail ({what}): relative error {worst:.3g} > {rel_bound} at "
          f"element {at}: {got[at]!r} against {want[at]!r}")
    fin = np.isfinite(got) & np.isfinite(want)
    ulps = int(np.abs(got[fin].view(np.int64)
                      - want[fin].view(np.int64)).max()) if fin.any() else 0
    return worst, ulps, len(differ), len(bad)


def compare_chi2_tail(torch, device, tables, err):
    """K5: chi2_tail against its plain version, chi2_sf_plain (JAX's
    igammac), run on the card's tensors, at CHI2_REL with the same strings,
    zeros, NaNs and DBL_MAX, on every grid of chi2_grids and on the main
    chunk's statistics with their masks (finish_chi2_pvalues against its
    plain version); the plain version on the CPU (the C library's
    logarithms and exponentials, not CUDA's) is reported beside it, but
    on the fault's draw.  Returns a description."""
    from stoat_tpu_torch.stats.chi2 import (finish_chi2_pvalues,
                                            finish_chi2_pvalues_plain)
    from stoat_tpu_torch.stats.special import chi2_sf, chi2_sf_plain
    notes = []
    cases = {what: [torch.from_numpy(v) for v in sd]
             for what, sd in chi2_grids().items()}
    cases["main chunk"] = [tables[k] for k in ("chi2_stat", "chi2_df",
                                               "chi2_invalid", "chi2_zexp")]
    for what, args in cases.items():
        card_args = [a.to(device) for a in args]
        cpu_args = [a.cpu() for a in args]
        tail = chi2_sf if len(args) == 2 else finish_chi2_pvalues
        plain = chi2_sf_plain if len(args) == 2 else finish_chi2_pvalues_plain
        got = to_np(tail(*card_args))
        want = to_np(plain(*card_args))
        r_card = hold_tail(got, want, f"{what}, card", CHI2_REL)
        err["chi2_tail"] = max(err["chi2_tail"], max_abs_err(got, want))
        note = (f"{what} ({got.size}): max rel {r_card[0]:.3g}, "
                f"{r_card[1]} ulps, {r_card[2]} differing")
        if not what.startswith("fault"):
            r_cpu = hold_tail(got, plain(*cpu_args).numpy(), f"{what}, CPU",
                              None, strings=False)
            note += (f"; the CPU's plain version max rel {r_cpu[0]:.3g}, "
                     f"{r_cpu[1]} ulps, {r_cpu[2]} differing, {r_cpu[3]} "
                     f"strings")
        notes.append(note)
    return "; ".join(notes)


def table_view_equal(got, want, what):
    """Q1's -T table view against a plain version's: norm bit for bit, kept
    exactly.  Returns norm's max abs error (0)."""
    from stoat_tpu_torch.pipeline.quantitative import TABLE_KEYS
    for key in TABLE_KEYS:
        a, b = to_np(got[key]), to_np(want[key])
        check(same_bits(a, b) if key == "norm" else bool((a == b).all()),
              f"quant_design table view ({what}): {key} differs from the "
              f"plain version")
    return max_abs_err(to_np(got["norm"]), to_np(want["norm"]))


def compare_table_view(chunk, covar, n_haplotypes, err, what, all_rows=False):
    """Q1's -T table view on the card: norm and kept bitwise against the
    plain version, and the design of the table instantiation equal to the
    OLS instantiation's.  Returns a description."""
    from stoat_tpu_torch.pipeline.quantitative import (DESIGN_KEYS,
                                                       quant_design,
                                                       quant_design_plain)
    got = quant_design(chunk, covar, *THRESHOLDS, n_haplotypes,
                       all_rows=all_rows, tables=True)
    plain = quant_design_plain(chunk, covar, *THRESHOLDS, n_haplotypes,
                               all_rows=all_rows, tables=True)
    e = table_view_equal(got, plain, what)
    design = quant_design(chunk, covar, *THRESHOLDS, n_haplotypes,
                          all_rows=all_rows)
    for key in DESIGN_KEYS:
        check(bool((got[key] == design[key]).all()), f"quant_design table "
              f"view ({what}): {key} differs from the OLS instantiation's")
    err["quant_design"] = max(err["quant_design"], e)
    return (f"{what}: norm {tuple(got['norm'].shape)} bitwise, kept exact "
            f"({int(to_np(got['kept']).sum())} kept columns), design equal")


# ---------------------------------------------------------------- quantitative

def rel_err(a, b):
    """Max relative error of ``a`` against ``b``: inf unless both have NaN
    and infinities in the same places (same signs) and ``a`` is 0 where
    ``b`` is."""
    import numpy as np
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        return float("inf")
    inf_b = np.isinf(b)
    if not np.array_equal(np.isinf(a), inf_b) or \
            not np.array_equal(a[inf_b], b[inf_b]):
        return float("inf")
    fin = np.isfinite(b)
    d = np.abs(a[fin] - b[fin])
    scale = np.abs(b[fin])
    if np.any(d[scale == 0] != 0):
        return float("inf")
    return float(np.max(d[scale > 0] / scale[scale > 0])) \
        if np.any(scale > 0) else 0.0


def stat_err(name, a, b, se=None, p_floor=0.0):
    """Max error of statistic ``name`` of ``a`` against ``b`` in the scale
    its printed string carries (see the bounds above; a p below
    ``p_floor`` is held in units of ``p_floor``); inf unless NaN and
    infinities agree."""
    import numpy as np
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    if name == "r2":
        a, b = 1.0 - a, 1.0 - b
    if not (np.array_equal(np.isnan(a), np.isnan(b))
            and np.array_equal(a[np.isinf(b)], b[np.isinf(b)])
            and np.array_equal(np.isinf(a), np.isinf(b))):
        return float("inf")
    fin = np.isfinite(b)
    scale = np.abs(b[fin])
    if name == "t1":
        scale = np.maximum(scale, 1.0)
    elif name == "p":
        scale = np.maximum(scale, p_floor)
    elif name in ("beta1", "beta") and se is not None:
        scale = np.maximum(scale, np.abs(np.asarray(se, np.float64)
                                         .ravel()[fin]))
    d = np.abs(a[fin] - b[fin])
    if np.any(d[scale == 0] != 0):
        return float("inf")
    return float(np.max(d[scale > 0] / scale[scale > 0])) \
        if np.any(scale > 0) else 0.0


def design_equal(got, want, what):
    """Q1 outputs against a plain version's: integers and flags exactly,
    X bit for bit.  Returns X's max abs error (0)."""
    import numpy as np
    from stoat_tpu_torch.pipeline.quantitative import DESIGN_KEYS
    for key in DESIGN_KEYS:
        a, b = to_np(got[key]), to_np(want[key])
        ok = same_bits(a, b) if key == "X" else np.array_equal(a, b)
        check(ok, f"quant_design: {key} differs from the plain version "
              f"({what})")
    return max_abs_err(to_np(got["X"]), to_np(want["X"]))


def compare_quant_design(chunk, covar, n_haplotypes, err, all_rows=False):
    """Q1 kernel vs its plain version on the card and on the CPU (with
    ``all_rows``, the mixed model's designs)."""
    from stoat_tpu_torch.convert import DeviceChunk
    from stoat_tpu_torch.pipeline.quantitative import (quant_design,
                                                       quant_design_plain)
    got = quant_design(chunk, covar, *THRESHOLDS, n_haplotypes,
                       all_rows=all_rows)
    what = f"all_rows={all_rows}"
    e = design_equal(got, quant_design_plain(chunk, covar, *THRESHOLDS,
                                             n_haplotypes, all_rows),
                     f"card, {what}")
    host = DeviceChunk(chunk.words.cpu(), chunk.path_idx.cpu(),
                       chunk.path_valid.cpu(), chunk.snarl_path_idx.cpu())
    e = max(e, design_equal(got, quant_design_plain(
        host, covar.cpu(), *THRESHOLDS, n_haplotypes, all_rows),
        f"CPU, {what}"))
    err["quant_design"] = max(err["quant_design"], e)
    return got


OLS_NAMES = ("t1", "df_res", "beta1", "se1", "r2")


def compare_ols(X, row, mask, ncols, err, bound, what, noise_rows=(),
                pinv=(), pinv_bound=None, plain_on_cpu=False):
    """Q2 kernel vs plain on the card (or on the CPU: the grid's wide
    designs' Jacobi sweeps are a minute of small launches on the card):
    each output's max error (stat_err),
    held to ``bound``, and to ``pinv_bound`` on the ``pinv`` rows (those
    that take the pseudo-inverse).  ``noise_rows`` have a constant
    phenotype (tss = 0): there r2 must not be finite in either, and beta1
    and se1 are rounding noise (below 1e-9) whose ratio t1 no summation
    order reproduces.  ``row`` is the phenotype row [N] as the pipelines
    pass it (linear_regression_row_stats: the kernel forms y = row * mask;
    ``mask`` None uses every row); the plain version takes that [S, N]
    y."""
    import torch
    from stoat_tpu_torch.stats.linreg import (linear_regression_row_stats,
                                              linear_regression_stats_plain)
    got = linear_regression_row_stats(X, row, mask, ncols)
    if mask is None:
        mask = torch.ones(X.shape[:2], dtype=torch.bool, device=X.device)
    args = (X, row[None, :] * mask, mask, ncols)
    plain = linear_regression_stats_plain(
        *(t.cpu() for t in args) if plain_on_cpu else args)
    return got, hold_ols_stats(got, plain, "ols", err, bound, what,
                               noise_rows, pinv, pinv_bound)


def hold_ols_stats(got, plain, key, err, bound, what, noise_rows=(),
                   pinv=(), pinv_bound=None):
    """Hold OLS statistics (t1, df_res, beta1, se1, r2) of kernel ``key``
    to its plain version's, row by row as compare_ols states; df_res
    exactly.  Returns each statistic's largest error."""
    import numpy as np
    groups = np.zeros(len(to_np(got[0])), np.int8)  # 0 normal, 1 pinv, 2 noise
    groups[list(pinv)] = 1
    groups[list(noise_rows)] = 2
    se_plain = to_np(plain[3])
    check(np.array_equal(to_np(got[1]), to_np(plain[1])),
          f"{key} ({what}): df_res differs")
    errs = {}
    for name, g, p in zip(OLS_NAMES, got, plain):
        a, b = to_np(g), to_np(p)
        for group, limit in ((0, bound), (1, pinv_bound)):
            rows = groups == group
            if not rows.any():
                continue
            e = stat_err(name, a[rows], b[rows], se_plain[rows])
            check(e <= limit, f"{key} ({what}"
                  f"{', pinv rows' if group else ''}): {name} error "
                  f"{e:.3g} > {limit:g}")
            errs[name] = max(errs.get(name, 0.0), e)
        keep = groups != 2
        err[key] = max(err[key], max_abs_err(a[keep], b[keep]))
        for r in noise_rows:
            if name == "r2":
                check(not np.isfinite(a[r]) and not np.isfinite(b[r]),
                      f"{key} ({what}): r2 of a constant phenotype is "
                      f"finite")
            if name in ("beta1", "se1"):
                check(abs(a[r]) < 1e-9 and abs(b[r]) < 1e-9,
                      f"{key} ({what}): {name} of a constant phenotype")
    return errs


def compare_student_t(t1, df, deg, beta, se, r2, err, what):
    """Q3 kernel vs plain on the card and on the CPU."""
    from stoat_tpu_torch.stats.linreg import (STUDENT_T_KEYS,
                                              student_t_pvalues,
                                              student_t_pvalues_plain)
    args = (t1, df, deg, beta, se, r2)
    got = student_t_pvalues(*args)
    worst = [0.0, 0.0]
    for i, (plain, bound) in enumerate((
            (student_t_pvalues_plain(*args), T_REL),
            (student_t_pvalues_plain(*(t.cpu() for t in args)), T_CPU_REL))):
        for key in STUDENT_T_KEYS:
            a, b = to_np(got[key]), to_np(plain[key])
            e = rel_err(a, b)
            check(e <= bound, f"student_t ({what}): {key} relative error "
                  f"{e:.3g} > {bound:g} against the plain version on the "
                  f"{('card', 'CPU')[i]}")
            worst[i] = max(worst[i], e)
            if i == 0:
                err["student_t"] = max(err["student_t"], max_abs_err(a, b))
    return got, worst


def ols_cases(device, seed, B, N, P, C=1):
    """ols_case_arrays' (X, phenotype row, mask, ncols) on ``device``."""
    import torch
    X, mask, ncols, pheno, _dense = ols_case_arrays(seed, B, N, P, C)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (X, pheno, mask, ncols))


def ols_case_arrays(seed, B, N, P, C=1):
    """B OLS designs [1 | dosage fractions | covariates], padded to
    [B, N, P] with their own used rows: snarl 0 has two equal dosage
    columns and snarl 1 a covariate collinear with a dosage (both take the
    pseudo-inverse).  numpy (X, mask, ncols, the phenotype row [N], the
    dense [N, ncols] design of each snarl before masking)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    X = np.zeros((B, N, P))
    mask = rng.random((B, N)) < 0.8
    ncols = np.zeros(B, np.int32)
    pheno = rng.standard_normal(N) * 2.0 + 5.0
    covar = rng.standard_normal((N, C))
    dense = []
    for b in range(B):
        k = 2 if b == 0 else int(rng.integers(1, P - C))
        counts = rng.integers(0, 3, (N, k + 1)).astype(float)
        counts[counts.sum(1) == 0, 0] = 1.0
        frac = counts / counts.sum(1, keepdims=True)
        cols = [np.ones(N), *frac[:, :k].T, *covar.T]
        if b == 0:
            cols[2] = cols[1].copy()
        if b == 1:
            cols[-1] = 2.0 * cols[1] - 0.5
        Xb = np.stack(cols, axis=1)
        dense.append(Xb)
        ncols[b] = Xb.shape[1]
        X[b, :, :ncols[b]] = Xb
    X[~mask] = 0.0
    return X, mask, ncols, pheno, dense


def ols_grid_designs():
    """[(name, X [S, N, P], row, mask, ncols, noise_rows)] numpy OLS
    designs at the edges of ols_block_device.cuh, from seeds.  ``row`` is
    the phenotype row [N] as the pipelines pass it (y = row * mask);
    ``mask`` None uses every row; ``noise_rows`` have a constant y (tss =
    0).  Snarls 0 and 1 of every case but p2 take the pseudo-inverse
    (equal dosage columns, a covariate collinear with a dosage):

      p2, p5_n37, p8, p12  P = 2 (a constant dosage on snarl 0), 5, 8 and
                 12: [X | m] and [X | y] in one, two and two 8-wide tiles
                 (three output tiles at P = 8 and 12); N = 37 at P = 5,
                 not a multiple of 32
      p7_over_r  P = 7, [X | y] exactly one tile, at N = 3,000: past the
                 rows a block holds (about 1,200), not a multiple of 32
      p7         P = 7 at N = 300, the main path's width
      const_row  a constant phenotype row: tss = 0 on every (full-rank)
                 snarl
      no_used    a snarl with no used row (every statistic but df NaN or 0)
      rotated    the mixed model's: dense rotated rows, every row used (no
                 mask), the rotated phenotype row
      p40, p90   wide designs: the algebra in shared memory beside fewer
                 rows (P = 40), and in the wrapper's scratch (P = 90)
    """
    import numpy as np
    out = []

    def case(name, seed, S, N, P, edit=None):
        X, mask, ncols, row, dense = ols_case_arrays(seed, S, N, P, C=2)
        noise = ()
        if edit is not None:
            X, row, mask, ncols, noise = edit(X, row, mask, ncols, dense)
        out.append((name, X, row, mask, ncols, noise))

    def const_row(X, row, mask, ncols, dense):
        # the full-rank snarls only: on a rank-deficient design the fit of
        # a constant is exact but its beta1 is no noise, so t1 is noise
        return X[2:].copy(), np.full_like(row, 3.0), mask[2:].copy(), \
            ncols[2:].copy(), tuple(range(X.shape[0] - 2))

    def no_used(X, row, mask, ncols, dense):
        mask[0] = False
        X[0] = 0.0
        return X, row, mask, ncols, ()

    def rotated(X, row, mask, ncols, dense):
        N = X.shape[1]
        rng = np.random.default_rng(37)
        Q = np.linalg.qr(rng.standard_normal((N, N)))[0]
        X = np.zeros_like(X)
        for b, Xb in enumerate(dense):
            X[b, :, :Xb.shape[1]] = Q @ Xb
        return X, Q @ row, None, ncols, ()

    # P = 2, [1 | dosage]; snarl 0's dosage is constant (the
    # pseudo-inverse)
    rng = np.random.default_rng(41)
    S, N = 12, 300
    mask = rng.random((S, N)) < 0.8
    X = np.zeros((S, N, 2))
    X[:, :, 0] = 1.0
    X[:, :, 1] = rng.integers(0, 3, (S, N)) / 2.0
    X[0, :, 1] = 0.5
    X[~mask] = 0.0
    out.append(("p2", X, rng.standard_normal(N) * 2.0 + 5.0, mask,
                np.full(S, 2, np.int32), ()))
    case("p5_n37", 42, 16, 37, 5)
    case("p8", 43, 16, 301, 8)
    case("p12", 44, 16, 300, 12)
    case("p7_over_r", 45, 8, 3000, 7)
    case("p7", 46, 16, 300, 7)
    case("const_row", 47, 8, 200, 5, edit=const_row)
    case("no_used", 48, 8, 200, 7, edit=no_used)
    case("rotated", 49, 12, 200, 7, edit=rotated)
    case("p40", 50, 6, 400, 40)
    case("p90", 51, 4, 400, 90)
    return out


def eqtl_grid_designs():
    """[(name, X [S, N, P], mask, ncols, pair_snarl, pair_gene, expr [G, N],
    noise_genes)] numpy eQTL chunks at the edges of eqtl_ols.cu's gene
    batches (16 genes, 4 a residual pass), from seeds: snarls with 0, 1, 8,
    9 and 33 genes, in
    (snarl, gene) order; the rank-deficient snarls 0 and 1 (the
    pseudo-inverse) with genes; a gene of constant expression (3.0: tss =
    0) on full-rank snarls.  At P = 7 (N = 300), P = 12 (two tiles of
    [X | m], the genes' tiles in two passes) and P = 7 at N = 3,000 (rows
    past the ones a block holds)."""
    import numpy as np
    out = []
    counts = [9, 33, 0, 1, 8, 9, 33, 0, 1, 8]
    for name, seed, N, P in (("p7", 61, 300, 7), ("p12", 62, 300, 12),
                             ("p7_over_r", 63, 3000, 7)):
        S = len(counts)
        X, mask, ncols, _pheno, _dense = ols_case_arrays(seed, S, N, P,
                                                         C=2)
        rng = np.random.default_rng(seed + 100)
        G = 40
        expr = rng.standard_normal((G, N)) + 1.0
        expr[G - 1] = 3.0
        pair_snarl, pair_gene = [], []
        for s, k in enumerate(counts):
            genes = sorted(rng.choice(G - 1, k, replace=False).tolist())
            if k and s >= 2 and s % 2 == 0:
                genes[-1] = G - 1
            pair_snarl += [s] * k
            pair_gene += genes
        out.append((name, X, mask, ncols, pair_snarl, pair_gene, expr,
                    (G - 1,)))
    return out


def compare_ols_grid(device, err):
    """ols and eqtl_ols on ols_grid_designs and eqtl_grid_designs against
    their plain versions on the CPU, as compare_ols and compare_eqtl hold
    them (the pseudo-inverse rows from pinv_rows).  Returns a
    description."""
    from stoat_tpu_torch.convert import to_eqtl_pairs
    t0 = time.perf_counter()
    notes = []
    for name, X, row, mask, ncols, noise in ols_grid_designs():
        Xt = upload_t(X, device)
        nc = upload_t(ncols, device)
        bad, _ = pinv_rows(Xt, nc)
        _, errs = compare_ols(Xt, upload_t(row, device),
                              None if mask is None else upload_t(mask, device),
                              nc, err, OLS_REL, f"grid {name}",
                              noise_rows=noise, pinv=bad,
                              pinv_bound=OLS_PINV_REL, plain_on_cpu=True)
        notes.append(f"{name} {X.shape} (pinv {len(bad)}): t1 "
                     f"{errs.get('t1', 0.0):.3g}")
    for name, X, mask, ncols, pair_snarl, pair_gene, expr, noise in \
            eqtl_grid_designs():
        d = {"X": upload_t(X, device), "used": upload_t(mask, device),
             "ncols": upload_t(ncols, device)}
        pairs = to_eqtl_pairs(pair_snarl, pair_gene, X.shape[0], device)
        _, errs, n_pinv = compare_eqtl(d, pairs, upload_t(expr, device), err,
                                       f"grid {name}", noise_genes=noise,
                                       plain_on_cpu=True)
        notes.append(f"eqtl {name} {X.shape}, {len(pair_snarl)} pairs "
                     f"({n_pinv} pinv): t1 {errs.get('t1', 0.0):.3g}")
    return (f"OLS grid in {time.perf_counter() - t0:.1f}s (bounds as above): "
            + "; ".join(notes))


def pinv_rows(X, ncols):
    """Snarls whose LDL^T has a real pivot below 1e-10 (the pseudo-inverse
    branch), and the smallest |pivot| / 1e-10 of the others."""
    import torch
    from stoat_tpu_torch.stats.linalg import ldlt_factor
    from stoat_tpu_torch.stats.linreg import LDLT_TOL
    P = X.shape[2]
    real = torch.arange(P, device=X.device)[None, :] < ncols[:, None]
    A = torch.einsum("bnp,bnq->bpq", X, X) \
        + torch.diag_embed(torch.where(real, 0.0, 1.0))
    _, D = ldlt_factor(A)
    small = torch.where(real, D.abs(), float("inf"))
    bad = (real & ((D.abs() < LDLT_TOL) | ~torch.isfinite(D))).any(dim=-1)
    nearest = small[~bad].min() / LDLT_TOL if bool((~bad).any()) \
        else float("inf")
    return bad.nonzero().squeeze(-1).tolist(), float(nearest)


def quant_edge_chunk(device):
    """A chunk of 40 snarls on 45 samples (H = 90: three words, the last
    one partial) whose paths hit Q1's rules: a merge of two equal columns
    among four, three equal columns (degenerate), two equal columns (no
    merge; the variant column is then constant, which takes Q2's
    pseudo-inverse), an invalid path, a path with no edges (every
    haplotype), a column with no carrier, and random snarls."""
    import numpy as np
    from stoat_tpu_torch.convert import DeviceChunk
    rng = np.random.default_rng(5)
    E, H, S, Pmax = 24, 90, 40, 4
    matrix = rng.random((E, H)) < 0.55
    matrix[23] = False                       # an edge nobody carries
    paths = []                               # (edge rows, valid) per path
    sidx = np.full((S, Pmax), -1, np.int32)

    def snarl(s, *cols):
        for j, col in enumerate(cols):
            sidx[s, j] = len(paths)
            paths.append(col)
    snarl(0, ([0], True), ([1], True), ([0], True), ([2], True))
    snarl(1, ([3], True), ([3], True), ([3], True))
    snarl(2, ([4], True), ([4], True))
    snarl(3, ([5], True), ([6], False), ([7], True))
    snarl(4, ([], True), ([8], True))
    snarl(5, ([9], True), ([23], True), ([10], True))
    for s in range(6, S):
        n = int(rng.integers(2, Pmax + 1))
        snarl(s, *[(list(rng.integers(0, 22, int(rng.integers(1, 3)))),
                    True) for _ in range(n)])
    chunk = DeviceChunk(*(upload_t(a, device) for a in pack_snarls(
        matrix, paths, sidx)))
    return chunk, H


def pack_snarls(matrix, paths, sidx):
    """(words as int32, path_idx, path_valid, snarl_path_idx) numpy arrays
    of a chunk: the bool [E, H] edge matrix, each path's (edge rows, valid)
    and the [S, Pmax] path index (-1 padding)."""
    import numpy as np
    from stoat_tpu_torch.pipeline import packed as pk
    coo_path = np.array([p for p, (rows, _) in enumerate(paths)
                         for _ in rows], np.int32)
    coo_row = np.array([r for rows, _ in paths for r in rows], np.int32)
    valid = np.array([v for _, v in paths], bool)
    words = pk.pack_matrix_words(matrix)
    idx = pk.pack_path_edge_idx(coo_path, coo_row, valid, matrix.shape[0])
    return words.view(np.int32), idx, valid, sidx


def quant_grid_chunks():
    """[(name, (words, path_idx, path_valid, snarl_path_idx), H)] numpy
    chunks at the edges of quant_design.cu's design, from seeds:

      pmax1      Pmax = 1 (kept < 2: every snarl filtered), an invalid and
                 an edgeless path, N = 37
      n37        N = 37 samples (H = 74: the last word holds 10 bits),
                 Pmax = 4: merged columns in the first, middle and last
                 positions, three of four merged, a degenerate snarl, an
                 all-invalid snarl, an edgeless path, random snarls
      two_tiles  Pmax = 64 at N = 2,100 (W = 132): the membership stage
                 holds 128 words, so each pass takes two word tiles;
                 columns equal on the first tile and not on the second,
                 columns equal on both
      pmax_max   Pmax = 1,966, the widest the parent design took (25
                 bytes a column in 48 KB): an 8-word stage over W = 19
                 (three word tiles), N = 300, 129 KB of shared memory
    """
    import numpy as np
    out = []

    def chunk(name, rng, N, E, Pmax, snarls, density=0.55, edit=None):
        matrix = rng.random((E, 2 * N)) < density
        if edit is not None:
            edit(matrix)
        paths = []
        sidx = np.full((len(snarls), Pmax), -1, np.int32)
        for s, cols in enumerate(snarls):
            for j, col in enumerate(cols):
                sidx[s, j] = len(paths)
                paths.append(col)
        out.append((name, pack_snarls(matrix, paths, sidx), 2 * N))

    def rand_cols(rng, n, lo, hi, k=3):
        return [(list(rng.integers(lo, hi, int(rng.integers(1, k)))), True)
                for _ in range(n)]

    rng = np.random.default_rng(21)
    chunk("pmax1", rng, 37, 8, 1,
          [[([0], True)], [([1, 2], True)], [([3], False)], [([], True)],
           [([4, 5], True)], [([6], True)]])
    rng = np.random.default_rng(22)
    a, b, c, d = ([1], True), ([2, 3], True), ([4], True), ([5], True)
    n37 = [[a, b, a, c], [b, a, c, a], [b, c, a, a], [a, a, a, b],
           [a, a, a], [([6], False)] * 4, [([], True), d, c], [b, d]]
    n37 += [rand_cols(rng, int(rng.integers(2, 5)), 6, 20) for _ in range(8)]
    chunk("n37", rng, 37, 20, 4, n37)
    rng = np.random.default_rng(23)

    def split_on_tile_two(matrix):
        # row 1 equals row 0 on the first 4,096 haplotypes (128 words)
        # only; row 2 equals row 0 everywhere
        matrix[1] = matrix[0]
        matrix[1, 4100] = not matrix[0, 4100]
        matrix[2] = matrix[0]
    p0, p1, p2 = ([0], True), ([1], True), ([2], True)
    wide = [[p0, p1, p2] + rand_cols(rng, 61, 3, 40),
            rand_cols(rng, 63, 3, 40) + [p1],
            [p1, p0, p2],
            [p0, p1],
            rand_cols(rng, int(rng.integers(2, 65)), 3, 40),
            rand_cols(rng, int(rng.integers(2, 65)), 3, 40)]
    wide[1][40] = wide[1][10]
    chunk("two_tiles", rng, 2100, 40, 64, wide, density=0.5,
          edit=split_on_tile_two)
    rng = np.random.default_rng(24)
    chunk("pmax_max", rng, 300, 64, 1966,
          [rand_cols(rng, 1966, 0, 64, k=4), rand_cols(rng, 5, 0, 64)],
          density=0.7)
    return out


def compare_quant_grid(device, err):
    """quant_design on quant_grid_chunks, in each of its four
    instantiations (all_rows, the table view) with C = 0 and 2, against
    the plain version on the card: X and norm bitwise, the rest exactly.
    Returns a description."""
    import numpy as np
    from stoat_tpu_torch.convert import DeviceChunk
    from stoat_tpu_torch.pipeline.quantitative import (quant_design,
                                                       quant_design_plain)
    rng = np.random.default_rng(25)
    notes = []
    for name, arrays, H in quant_grid_chunks():
        chunk = DeviceChunk(*(upload_t(a, device) for a in arrays))
        merged = 0
        for C in (0, 2):
            covar = upload_t(rng.standard_normal((H // 2, C)), device)
            for all_rows in (False, True):
                for tables in (False, True):
                    what = (f"grid {name}, C={C}, all_rows={all_rows}, "
                            f"tables={tables}")
                    got = quant_design(chunk, covar, *THRESHOLDS, H,
                                       all_rows=all_rows, tables=tables)
                    plain = quant_design_plain(chunk, covar, *THRESHOLDS, H,
                                               all_rows=all_rows,
                                               tables=tables)
                    e = design_equal(got, plain, what)
                    if tables:
                        e = max(e, table_view_equal(got, plain, what))
                    err["quant_design"] = max(err["quant_design"], e)
            kept = (to_np(got["allele_paths"]) > 0).sum(axis=1)
            merged = int(((to_np(got["ncols"]) - 1 - C) < kept - 1).sum())
        S, Pmax = arrays[3].shape
        notes.append(f"{name} (S {S}, Pmax {Pmax}, N {H // 2}, W "
                     f"{arrays[0].shape[1]}: {merged} snarls with a merge, "
                     f"{int(to_np(got['filtered']).sum())} filtered)")
    return "quant_design grid, 4 instantiations x C = 0, 2: " + \
        "; ".join(notes)


def upload_t(arr, device):
    import numpy as np
    import torch
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def quant_edge_cases(device, err):
    """Phase 3's quantitative edge cases; returns a short description."""
    import numpy as np
    import scipy.special
    import torch

    # Q1 -> Q2 -> Q3 on the rule-hitting chunk, with and without covariates
    chunk, H = quant_edge_chunk(device)
    N = H // 2
    rng = np.random.default_rng(6)
    pheno = upload_t(rng.standard_normal(N), device)
    notes = []
    for C in (0, 2):
        covar = upload_t(rng.standard_normal((N, C)), device)
        d = compare_quant_design(chunk, covar, H, err)
        deg = to_np(d["degenerate"])
        nc = to_np(d["ncols"])
        check(deg[1] and not deg[0] and not deg[2],
              f"quant_design: degenerate flags {deg[:6]}")
        check(nc[0] == 1 + 2 + C and nc[2] == 1 + 1 + C,
              f"quant_design: ncols {nc[:6]} (merge rule)")
        check(to_np(d["allele_paths"])[3, 1] == 0
              and to_np(d["allele_paths"])[4, 0] == H
              and to_np(d["allele_paths"])[5, 1] == 0,
              "quant_design: invalid / edgeless / empty path counts")
        used = d["used"]
        bad, _ = pinv_rows(d["X"], d["ncols"])
        check(2 in bad, f"ols: snarl 2 (constant variant column) did not "
              f"take the pseudo-inverse ({bad})")
        stats, _ = compare_ols(d["X"], pheno, used, d["ncols"], err, OLS_REL,
                               f"edge chunk, C={C}", pinv=bad,
                               pinv_bound=OLS_PINV_REL)
        out, _ = compare_student_t(*stats[:2], d["degenerate"], *stats[2:],
                                   err, f"edge chunk, C={C}")
        check(all(np.isnan(to_np(out[k])[1]) for k in out),
              "student_t: a degenerate snarl is not NA")
        notes.append(f"C={C}: pinv rows {bad}")

    # Q2: rank-deficient designs, PT = 7 and PT = 12, and a constant
    # phenotype on the full-rank ones
    ols_errs = {}
    for seed, P in ((1, 7), (2, 12)):
        X, row, mask, ncols = ols_cases(device, seed, 64, 300, P)
        bad, _ = pinv_rows(X, ncols)
        check(0 in bad and 1 in bad, f"ols: PT={P} designs 0 and 1 did "
              f"not take the pseudo-inverse ({bad})")
        _, errs = compare_ols(X, row, mask, ncols, err, OLS_REL, f"PT={P}",
                              pinv=bad, pinv_bound=OLS_PINV_REL)
        full = [r for r in range(X.shape[0]) if r not in bad]
        _, errs_c = compare_ols(X[full], torch.full_like(row, 3.0),
                                mask[full], ncols[full], err, OLS_REL,
                                f"PT={P}, constant phenotype",
                                noise_rows=range(len(full)))
        for name, e in (*errs.items(), *errs_c.items()):
            ols_errs[name] = max(ols_errs.get(name, 0.0), e)

    # Q3: the df x |t| grid, non-finite t, subnormal p, a degenerate row
    grid = [(df, t) for df in T_DFS for t in T_ABS]
    extra = [(10.0, float("nan")), (10.0, float("inf")),
             (10.0, -float("inf")), (2500.0, 43.5), (2500.0, 44.0),
             (1.0, 1e154), (5.0, 1e60), (7.0, -3.0)]
    df = np.array([g[0] for g in grid + extra])
    t1 = np.array([g[1] for g in grid + extra])
    deg = np.zeros(df.shape, bool)
    deg[-1] = True
    fill = np.linspace(-1.0, 1.0, df.size)
    out, t_worst = compare_student_t(
        *(upload_t(a, device) for a in (t1, df, deg, fill, fill, fill)),
        err, "grid")
    p = to_np(out["p"])
    n = len(grid)
    check((p[n:n + 3] == 1.0).all(), f"student_t: non-finite t gives "
          f"{p[n:n + 3]}, not 1")
    check(p[n + 3] == 0.0 and p[n + 4] == 0.0 and p[n + 5] == 0.0,
          f"student_t: subnormal p not flushed: {p[n + 3:n + 6]}")
    check(np.isnan(to_np(out["beta"])[-1]), "student_t: degenerate row")
    exact = 2.0 * scipy.special.stdtr(df[:n], -np.abs(t1[:n]))
    big = (exact > 1e-300) & (t1[:n] != 1e-8)
    scipy_rel = float(np.max(np.abs(p[:n][big] - exact[big]) / exact[big]))
    check(scipy_rel <= 1e-10, f"student_t: relative error {scipy_rel:.3g} "
          f"against scipy.special.stdtr")
    return (f"quantitative edge cases ok (merge, degenerate, invalid / "
            f"edgeless / empty paths, H=90; {'; '.join(notes)}; OLS "
            f"rank-deficient + PT=7/12 + tss=0, max rel err "
            + ", ".join(f"{k} {v:.3g}" for k, v in ols_errs.items())
            + f" (bounds {OLS_REL:g}, pseudo-inverse rows {OLS_PINV_REL:g})"
            f"; t tail grid + NaN/inf t + "
            f"subnormal p, max rel err {t_worst[0]:.3g} vs the card's "
            f"plain version (bound {T_REL:g}), {t_worst[1]:.3g} vs the "
            f"CPU's (bound {T_CPU_REL:g}), "
            f"vs scipy stdtr {scipy_rel:.3g})")


# ---------------------------------------------------------------- graph, logit

def compare_graph_stats(G0, G1, mask, err, expected_fisher=None):
    """K6 kernel vs plain: bitwise on the card, where the plain version is
    the parent's chain (its statistics on the card, run through the
    chi2_tail kernel, whose pieces K6 runs inside its launch: the same
    p-values bit for bit); against the CPU's plain version Fisher bitwise
    and the chi-squared p-values (chi2_tail's pieces on the card, the
    plain tail on the CPU) to a relative 1e-12 with equal strings."""
    from stoat_tpu_torch.writer import format_p
    from stoat_tpu_torch.graph.association import (graph_stats,
                                                   graph_stats_plain)
    got = [to_np(t) for t in graph_stats(G0, G1, mask)]
    plain = [to_np(t) for t in graph_stats_plain(G0, G1, mask)]
    cpu = [t.numpy() for t in graph_stats_plain(G0.cpu(), G1.cpu(),
                                                mask.cpu())]
    for name, g, p, c in zip(("chi2 2x2", "fisher", "chi2 2xN"), got, plain,
                             cpu):
        check(same_bits(g, p), f"graph_stats: {name} kernel != plain "
              f"bitwise (card)")
        if name == "fisher":
            check(same_bits(g, c), "graph_stats: fisher kernel != plain "
                  "bitwise (CPU)")
        else:
            check(rel_err(g, c) <= 1e-12 and [format_p(v) for v in g]
                  == [format_p(v) for v in c], f"graph_stats: {name} "
                  f"differs from the CPU's plain version")
        err["graph_stats"] = max(err["graph_stats"], max_abs_err(g, p))
    if expected_fisher is not None:
        strings = [format_p(v) for v in got[1]]
        check(strings == expected_fisher, f"graph_stats: fisher strings "
              f"{strings} != {expected_fisher}")
    return got


def graph_edge_cases(device, err):
    """K6 on the pinned Fisher tables and the overflowing scans as 2-column
    rows, then random rows with k = 2, 3 and 8, zero margins and zero
    columns; returns a short description."""
    import numpy as np
    import torch

    def rows(tables, k=2):
        t = np.asarray(tables, np.int32)
        G0 = np.zeros((len(t), k), np.int32)
        G1 = np.zeros((len(t), k), np.int32)
        G0[:, :2], G1[:, :2] = t[:, :2], t[:, 2:]
        mask = np.ones((len(t), k), bool)
        return [torch.from_numpy(a).to(device) for a in (G0, G1, mask)]
    compare_graph_stats(*rows([t for t, _ in FISHER_CASES]), err,
                        expected_fisher=[s for _, s in FISHER_CASES])
    compare_graph_stats(*rows(OVERFLOW_TABLES), err,
                        expected_fisher=["0"] * len(OVERFLOW_TABLES))
    rng = np.random.default_rng(8)
    # Pm = 40: rows too wide to stage, read where they lie
    for Pm in (2, 3, 8, 40):
        B = 4096
        k = rng.integers(2, Pm + 1, B)
        mask = np.arange(Pm)[None, :] < k[:, None]
        G0 = np.where(mask, rng.integers(0, 60, (B, Pm)), 0).astype(np.int32)
        G1 = np.where(mask, rng.integers(0, 60, (B, Pm)), 0).astype(np.int32)
        G0[:64] = 0                                  # a zero row margin
        G0[64:128, Pm - 1] = 0                       # a zero column
        G1[64:128, Pm - 1] = 0
        compare_graph_stats(*(torch.from_numpy(a).to(device)
                              for a in (G0, G1, mask)), err)
    return (f"{len(FISHER_CASES)} pinned + {len(OVERFLOW_TABLES)} overflow "
            f"Fisher rows, 4 x 4096 random rows with k = 2..2/3/8/40, zero "
            f"margins and zero columns")


def graph_counts(graph, device):
    """The main graph's K6 inputs, from the native prepare as ``graph``
    runs it: (G0, G1, mask) on ``device``, and k."""
    import numpy as np
    from stoat_tpu_torch.io.phenotype import parse_binary_pheno
    from stoat_tpu_torch.native import graph_assoc_native
    from stoat_tpu_torch.convert import to_graph_counts
    pheno, samples = parse_binary_pheno(graph["pheno"], [])
    got = graph_assoc_native(graph["gfa"], {"ref"}, samples,
                             pheno.astype(np.uint8), "chi2", 0)
    check(got is not None, "native graph prepare unavailable")
    _, kinds, offs, g0, g1, _ = got
    return to_graph_counts(kinds, offs, g0, g1, device)


def pack_designs(designs, ys, P, N):
    """Logistic designs [n_b, ncols_b] and responses [n_b], padded to
    (X [B, N, P], y [B, N], used [B, N], ncols [B]) numpy arrays."""
    import numpy as np
    B = len(designs)
    X = np.zeros((B, N, P))
    y = np.zeros((B, N))
    mask = np.zeros((B, N), bool)
    ncols = np.zeros(B, np.int32)
    for b, (Xb, yb) in enumerate(zip(designs, ys)):
        n, k = Xb.shape
        X[b, :n, :k] = Xb
        y[b, :n] = yb
        mask[b, :n] = True
        ncols[b] = k
    return X, y, mask, ncols


def logreg_edge_designs():
    """[(name, X, y)] of the logistic edge cases, from seeds:

      separated    a dosage equal to y (tests/test_stats_oracle.py:288);
                   the 1e-4 penalty bounds beta: converges in 13 steps
      oscillating  dosages of order 1e4, separated by the first one: the
                   steps never settle, 100 iterations, NA
      failing      a dosage of 1e160 overflows X^T W X: the first step is
                   not finite, NA (stats_test.cpp:107)
      singular     duplicate dosage columns and an all-zero one: only the
                   ridge keeps H invertible
      all_nan_p    X = [1, d, k d], integer d up to 1e6, each d once with
                   y = 0 and once with y = 1: the gradient is exactly 0 at
                   beta = 0 (converged after one step) and X^T W X exact in
                   any order, but so large that the ridge is lost and
                   LDL^T leaves a negative pivot: se is NaN for every
                   variant column, Holm gives each +inf, and the selection
                   falls on column 0 (p = +inf, the intercept's beta, se)
      holm_m3      three variant columns, one associated (Holm with m = 3)
    """
    import numpy as np
    out = []
    d = np.concatenate([np.zeros(20), np.ones(20)])
    out.append(("separated", np.column_stack([np.ones(40), d]), d.copy()))
    rng = np.random.default_rng(332)
    X = np.ones((64, 3))
    X[:, 1:] = rng.random((64, 2)) * 1e4
    out.append(("oscillating", X, (X[:, 1] > 5e3).astype(float)))
    rng = np.random.default_rng(5)
    X = np.column_stack([np.ones(30), rng.random(30)])
    X[3, 1] = 1e160
    out.append(("failing", X, (rng.random(30) < 0.5).astype(float)))
    rng = np.random.default_rng(6)
    d = rng.random(50)
    out.append(("singular", np.column_stack([np.ones(50), d, d,
                                             np.zeros(50)]),
                (rng.random(50) < 1 / (1 + np.exp(0.5 - 2 * d)))
                .astype(float)))
    rng = np.random.default_rng(0)
    n2 = int(rng.integers(4, 30))
    d = np.repeat(rng.integers(1, 10 ** 6, n2).astype(float), 2)
    k = float(rng.choice([3, 5, 7]))
    out.append(("all_nan_p", np.column_stack([np.ones(2 * n2), d, k * d]),
                np.tile([0.0, 1.0], n2)))
    rng = np.random.default_rng(7)
    dos = rng.random((200, 3))
    out.append(("holm_m3", np.column_stack([np.ones(200), dos]),
                (rng.random(200) < 1 / (1 + np.exp(1.0 - 3.0 * dos[:, 1])))
                .astype(float)))
    return out


def logreg_pt12_designs(seed=11, B=16):
    """B designs of PT = 12: eleven variant columns, padded and not."""
    import numpy as np
    rng = np.random.default_rng(seed)
    designs, ys = [], []
    for b in range(B):
        n = int(rng.integers(100, 300))
        k = 11 if b % 2 == 0 else int(rng.integers(1, 11))
        dos = rng.random((n, k))
        ys.append((rng.random(n) < 1 / (1 + np.exp(-1.2 * dos[:, 0] + 0.4)))
                  .astype(float))
        designs.append(np.column_stack([np.ones(n), dos]))
    return designs, ys


def logreg_grid_designs(seed=13):
    """[(name, (X, y, used, ncols))] numpy batches at the edges of
    logreg.cu's design, from seeds (the rows of each design a random
    prefix, so the mask cuts them):

      stream_p5  P = 5 at N = 3,000: past the 1,469 rows a block holds, so
                 the rest are read from device memory at every pass
      p7         P + 1 = 8: one 8 x 8 output tile, filled
      p8         P + 1 = 9 at N = 2,000: three output tiles, rows streamed
      p60        P = 60: the algebra (2 P^2 + 7 P doubles) in shared
                 memory beside 24 resident rows of 300
      p118       P = 118, the narrowest design whose algebra does not fit
                 in shared memory: it runs in the wrapper's scratch, beside
                 76 resident rows of 300; six real columns, the rest
                 padding (the plain version, a Python loop over P^3
                 entries, runs on the CPU)
    """
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for name, B, N, P, ks in (("stream_p5", 6, 3000, 5, (4, 1, 2)),
                              ("p7", 6, 400, 7, (6, 2, 4)),
                              ("p8", 6, 2000, 8, (7, 3, 5)),
                              ("p60", 4, 300, 60, (20, 3)),
                              ("p118", 2, 300, 118, (5,))):
        designs, ys = [], []
        for b in range(B):
            n = int(rng.integers(N * 5 // 6, N + 1))
            k = ks[b % len(ks)]
            dos = rng.random((n, k))
            logits = -0.4 + 1.3 * dos[:, 0] - 0.5 * dos[:, -1]
            ys.append((rng.random(n) < 1 / (1 + np.exp(-logits)))
                      .astype(float))
            designs.append(np.column_stack([np.ones(n), dos]))
        out.append((name, pack_designs(designs, ys, P, N)))
    return out


def logit_err(a, b, bound):
    """Max errors {p, beta, se} of logistic results ``a`` against ``b``
    (dicts of numpy arrays) in their strings' scale; checks that NaN and
    infinities agree."""
    errs = {}
    for name in ("p", "beta", "se"):
        e = stat_err(name, a[name], b[name], b["se"], p_floor=P_FLOOR)
        check(e <= bound, f"logreg: {name} error {e:.3g} > {bound:g}")
        errs[name] = e
    return errs


def compare_logreg(X, y, used, ncols, deg, err, what, plain_on_cpu=False):
    """K11 kernel vs plain on the card (or on the CPU): NA sets and
    infinities equal, p, beta, se within LOGREG_REL; returns (kernel
    results as numpy, errors, snarls whose step counts differ)."""
    import numpy as np
    from stoat_tpu_torch.stats.logreg import (logistic_regression,
                                              logistic_regression_plain)
    got = {k: to_np(v) for k, v in
           logistic_regression(X, y, used, ncols, deg).items()}
    args = [t.cpu() for t in (X, y, used, ncols, deg)] if plain_on_cpu \
        else (X, y, used, ncols, deg)
    plain = {k: to_np(v) for k, v in
             logistic_regression_plain(*args).items()}
    check(np.array_equal(np.isnan(got["p"]), np.isnan(plain["p"])),
          f"logreg ({what}): NA sets differ at snarls "
          f"{np.flatnonzero(np.isnan(got['p']) != np.isnan(plain['p']))}")
    errs = logit_err(got, plain, LOGREG_REL)
    for name in ("p", "beta", "se"):
        err["logreg"] = max(err["logreg"], max_abs_err(
            np.nan_to_num(got[name], posinf=0.0),
            np.nan_to_num(plain[name], posinf=0.0)))
    flips = np.flatnonzero(got["iters"] != plain["iters"]).tolist()
    return got, errs, flips


def logreg_edge_cases(device, err):
    """Phase 3's logistic edge cases; returns a short description."""
    import numpy as np
    import torch
    cases = logreg_edge_designs()
    X, y, used, ncols = pack_designs([c[1] for c in cases],
                                     [c[2] for c in cases], P=5, N=200)
    # the same designs again, flagged degenerate: NA whatever the fit
    X, y, used, ncols = (np.concatenate([a, a]) for a in (X, y, used,
                                                          ncols))
    deg = np.arange(X.shape[0]) >= len(cases)
    got, errs, flips = compare_logreg(
        *(upload_t(a, device) for a in (X, y, used, ncols, deg)), err,
        "edge designs")
    n = len(cases)
    iters = got["iters"][:n].tolist()
    p = got["p"][:n]
    check(np.isnan(got["p"][n:]).all() and np.isnan(got["beta"][n:]).all(),
          "logreg: a degenerate snarl is not NA")
    check(iters[0] < 100 and np.isfinite(p[0]), f"logreg: separated design "
          f"{p[0]} after {iters[0]} steps")
    check(np.isnan(p[1]) and iters[1] == 100, f"logreg: oscillating design "
          f"{p[1]} after {iters[1]} steps")
    check(np.isnan(p[2]) and iters[2] == 1, "logreg: a non-finite step is "
          "not NA")
    check(p[4] == np.inf and got["beta"][4] == 0.0, f"logreg: all-NaN-p "
          f"Holm case gives p {p[4]}, beta {got['beta'][4]}")
    designs, ys = logreg_pt12_designs()
    _, errs12, flips12 = compare_logreg(
        *(upload_t(a, device) for a in pack_designs(designs, ys, 12, 300)),
        upload_t(np.zeros(len(designs), bool), device), err, "PT = 12")
    grid = []
    for name, arrays in logreg_grid_designs():
        deg = np.zeros(arrays[0].shape[0], bool)
        got, errs_g, flips_g = compare_logreg(
            *(upload_t(a, device) for a in (*arrays, deg)), err,
            f"grid {name}", plain_on_cpu=name == "p118")
        check(np.isfinite(got["p"]).all(), f"logreg: grid {name} has NA "
              f"p {got['p']}")
        grid.append(f"{name} {tuple(arrays[0].shape)} max err "
                    + ", ".join(f"{k} {v:.3g}" for k, v in errs_g.items())
                    + f", steps {got['iters'].tolist()}, flips {flips_g}")
    return (f"logistic edge designs ({', '.join(c[0] for c in cases)}: "
            f"steps {iters}, p {p.tolist()}; the same flagged degenerate "
            f"all NA) max err "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + "; PT = 12 max err "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs12.items())
            + f"; step counts differing from the plain version: "
            f"{flips + flips12}; grid: " + "; ".join(grid))


# ---------------------------------------------------------------- permutations

def perm_host_rows(pheno_bin, pheno_q, covar, n_words, n_perms, seed=0):
    """The permutation test's rows as run_permutation_test builds them:
    {"masks": [1 + K, W] packed case masks, "phenos": [1 + K, N]
    Freedman-Lane phenotypes with covariates (``-q -c``), "phenos_q":
    [1 + K, N] label permutations (``-q``), "Z", "w" and "e": [1 + K, N]
    residual rows of the reduced logistic fit with covariates}, row 0 the
    observed phenotype."""
    import numpy as np
    from stoat_tpu_torch.pipeline import permutation as pm
    from stoat_tpu_torch.pipeline.packed import pack_hap_mask_words
    idx = pm.permutation_indices(len(pheno_bin), n_perms, seed)
    obs = pack_hap_mask_words(np.repeat(pheno_bin.astype(bool), 2), n_words)
    masks = pm.permutation_masks(pheno_bin, n_perms, seed, n_words, idx)
    phenos = pm.freedman_lane_phenos(pheno_q, covar, idx)
    phenos_q = pm.freedman_lane_phenos(pheno_q, None, idx)
    Z, w, e = pm.logistic_null_context(pheno_bin, covar)
    return {"masks": np.concatenate([obs[None, :], masks]),
            "phenos": np.concatenate([pheno_q[None, :], phenos]),
            "phenos_q": np.concatenate([pheno_q[None, :], phenos_q]),
            "Z": Z, "w": w, "e": np.concatenate([e[None, :], e[idx]])}


def compare_perm_binary(chunk, masks, err, cpu=True):
    """K1 alone and K15, kernel vs plain on the card (and on the CPU with
    ``cpu``): membership words and counts exact, statistic and df bitwise,
    flags exact; row 0's statistic also bitwise equal to K3's kernel on
    the same mask's counts."""
    import numpy as np
    from stoat_tpu_torch.pipeline import permutation as pm
    from stoat_tpu_torch.pipeline.binary import binary_tables
    from stoat_tpu_torch.pipeline.packed import membership_counts
    args = (chunk.words, chunk.path_idx, chunk.path_valid, chunk.tail)
    mem, g_all = pm.perm_membership(*args)
    for plain in (pm.perm_membership_plain(*args),
                  pm.perm_membership_plain(*(a.cpu() for a in args))):
        check(np.array_equal(to_np(mem), to_np(plain[0]))
              and np.array_equal(to_np(g_all), to_np(plain[1])),
              "perm_membership: kernel != plain")
    sargs = (mem, g_all, masks, chunk.snarl_path_idx, *THRESHOLDS)
    got = pm.perm_binary_stats(*sargs)
    plains = [("card", lambda: pm.perm_binary_stats_plain(*sargs))]
    if cpu:
        plains.append(("CPU", lambda: pm.perm_binary_stats_plain(
            *(a.cpu() for a in sargs[:4]), *THRESHOLDS)))
    for where, run_plain in plains:
        plain = run_plain()
        check(same_bits(to_np(got[0]), to_np(plain[0]))
              and same_bits(to_np(got[1]), to_np(plain[1]))
              and np.array_equal(to_np(got[2]), to_np(plain[2])),
              f"perm_binary: kernel != plain bitwise ({where})")
        err["perm_binary"] = max(err["perm_binary"],
                                 max_abs_err(to_np(got[0]), to_np(plain[0])))
    t = binary_tables(*membership_counts(*args, masks[0]),
                      chunk.snarl_path_idx, *THRESHOLDS)
    check(same_bits(to_np(got[0][0]), to_np(t["chi2_stat"])),
          "perm_binary: row 0 != K3's statistic bitwise")
    return mem, g_all, got


def compare_perm_ols(X, used, ncols, phenos, err, pinv, what):
    """K16a kernel vs plain on the card: t1 within OLS_REL (OLS_PINV_REL on
    the pseudo-inverse rows), df exact.  Returns (t1, df) and the largest
    error."""
    import numpy as np
    from stoat_tpu_torch.pipeline import permutation as pm
    t1, df = pm.perm_ols_stats(X, used, ncols, phenos)
    p1, pdf = pm.perm_ols_stats_plain(X, used, ncols, phenos)
    a, b = to_np(t1), to_np(p1)
    rows = np.zeros(X.shape[0], bool)
    rows[list(pinv)] = True
    worst = 0.0
    for sel, bound in ((~rows, OLS_REL), (rows, OLS_PINV_REL)):
        if sel.any():
            e = stat_err("t1", a[:, sel], b[:, sel])
            check(e <= bound, f"perm_ols ({what}): t1 error {e:.3g} > "
                  f"{bound:g}")
            worst = max(worst, e)
    check(np.array_equal(to_np(df), to_np(pdf)), f"perm_ols ({what}): df "
          f"differs")
    err["perm_ols"] = max(err["perm_ols"], max_abs_err(a[:, ~rows],
                                                       b[:, ~rows]))
    return t1, df, worst


def compare_score(X, used, ncols, bad, Z, w, e, err, what):
    """K16b/c kernel vs plain on the card: D bitwise, df and allbad exact;
    on the snarls not flagged, V^-1 within SCORE_REL of each snarl's
    largest entry and T within SCORE_REL of max(T, 1) (a chi-squared
    statistic's scale); the sanitised p-values' +inf sets equal.  Returns
    (D, Vinv, df, allbad, T) and the largest errors."""
    import numpy as np
    from stoat_tpu_torch.pipeline import permutation as pm
    got = pm.score_precompute(X, used, ncols, bad, Z, w)
    plain = pm.score_precompute_plain(X, used, ncols, bad, Z, w)
    check(same_bits(to_np(got[0]), to_np(plain[0])),
          f"score_precompute ({what}): D differs")
    check(np.array_equal(to_np(got[2]), to_np(plain[2]))
          and np.array_equal(to_np(got[3]), to_np(plain[3])),
          f"score_precompute ({what}): df or allbad differs")
    # V^-1 and T of a flagged snarl are never read (its p is +inf): an
    # ill-conditioned V inverts to finite garbage in both versions
    good = ~to_np(got[3])
    V, Vp = to_np(got[1])[good], to_np(plain[1])[good]
    scale = np.abs(Vp).max(axis=(1, 2), keepdims=True)
    ev = float(np.max(np.abs(V - Vp) / np.maximum(scale, 1e-300))) \
        if good.any() else 0.0
    check(ev <= SCORE_REL, f"score_precompute ({what}): Vinv error {ev:.3g}")
    err["score_precompute"] = max(err["score_precompute"],
                                  max_abs_err(V, Vp))
    T = pm.score_perm_stats(got[0], used, got[1], e)
    Tp = pm.score_perm_stats_plain(got[0], used, got[1], e)
    a, b = to_np(T)[:, good], to_np(Tp)[:, good]
    fin = np.isfinite(b)
    check(np.array_equal(np.isfinite(a), fin), f"score_perm ({what}): "
          f"non-finite T differ")
    et = float(np.max(np.abs(a[fin] - b[fin])
                      / np.maximum(np.abs(b[fin]), 1.0))) if fin.any() else 0
    check(et <= SCORE_REL, f"score_perm ({what}): T error {et:.3g}")
    err["score_perm"] = max(err["score_perm"], max_abs_err(a[fin], b[fin]))
    pk = to_np(pm.score_perm_pvalues(T, got[2], got[3]))
    pp = to_np(pm.score_perm_pvalues(Tp, plain[2], plain[3]))
    check(np.array_equal(np.isinf(pk), np.isinf(pp)),
          f"score p ({what}): +inf sets differ")
    return (*got, T), (ev, et)


# the permutation kernels' tile edges (perm_gemm_device.cuh): S not a
# multiple of the snarl group, ragged sample steps with N P odd, one row
# and a ragged K tile, designs of one and of two blocks of 8 columns
TILE_S = 17
TILE_N = (33, 37)
TILE_K = (1, 65)
TILE_P = (2, 5, 9, 12)
# and the wider designs of pass B's other paths (Pp = 24, 32; P > 32 reads
# beta from shared memory), (N, P) at K = 65
TILE_WIDE = ((150, 17), (150, 30), (150, 40), (150, 70))
# the wide tile (KT = 16, nt = 8): perm_ols from P = 121 (here N P odd,
# the 8-byte copies), score_perm from P = 186; (S, N, P) at K = 65
TILE_FALLBACK = {"perm_ols": (5, 301, 121), "score_perm": (5, 400, 190)}
NAN_SAMPLE = 3


def tile_case(seed, S, N, K, P, rank_deficient=True):
    """Inputs at a tile edge, numpy: S designs X [S, N, P] (an intercept, 1
    to P - 1 dosage fractions, rows of unused samples zero, sample
    NAN_SAMPLE used by no snarl; with ``rank_deficient`` snarl 0 has a
    repeated column, or a constant one at P = 2), used [S, N], ncols [S],
    phenotype and residual rows [K, N] (with K > 1 row K // 2 NaN at
    NAN_SAMPLE), the reduced design Z [N, 3] and weights w [N].  Returns
    (X, used, ncols, phenos, e, Z, w)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    used = rng.random((S, N)) < 0.8
    used[:, NAN_SAMPLE] = False
    ncols = rng.integers(2, P + 1, S).astype(np.int32)
    X = np.zeros((S, N, P))
    X[:, :, 0] = 1.0
    for s in range(S):
        X[s, :, 1:ncols[s]] = rng.random((N, ncols[s] - 1))
    if rank_deficient and P >= 3:
        ncols[0] = 3
        X[0, :, 2] = X[0, :, 1]
    elif rank_deficient:
        X[0, :, 1] = 0.5
    X[~used] = 0.0
    phenos = rng.standard_normal((K, N)) + 2.0
    e = rng.standard_normal((K, N)) * 0.5
    if K > 1:
        phenos[K // 2, NAN_SAMPLE] = np.nan
        e[K // 2, NAN_SAMPLE] = np.nan
    Z = np.column_stack([np.ones(N), rng.standard_normal((N, 2))])
    w = rng.random(N) * 0.25 + 0.01
    return X, used, ncols, phenos, e, Z, w


def perm_tile_fallback(device, err):
    """K16a and K16c kernel vs plain on the wide tile (TILE_FALLBACK; full
    rank): perm_ols t1 within OLS_REL against the plain version on the
    CPU (its LDL^T is a loop of small ops), df exact; score_perm T within
    SCORE_REL on a random symmetric V^-1; the NaN row NaN on every snarl.
    Returns a short description."""
    import numpy as np
    from stoat_tpu_torch.pipeline import permutation as pm
    K, nan_row = 65, 65 // 2
    S, N, P = TILE_FALLBACK["perm_ols"]
    X, used, ncols, phenos, _e, _Z, _w = tile_case(7, S, N, K, P, False)
    t1, df = pm.perm_ols_stats(*(upload_t(a, device)
                                 for a in (X, used, ncols, phenos)))
    p1, pdf = pm.perm_ols_stats_plain(*(upload_t(a, "cpu")
                                        for a in (X, used, ncols, phenos)))
    a, b = to_np(t1), to_np(p1)
    e_ols = stat_err("t1", a, b)
    check(e_ols <= OLS_REL, f"perm_ols (wide tile, P = {P}): t1 error "
          f"{e_ols:.3g} > {OLS_REL:g}")
    check(np.array_equal(to_np(df), to_np(pdf)),
          f"perm_ols (wide tile, P = {P}): df differs")
    check(np.isnan(a[nan_row]).all()
          and not np.isnan(np.delete(a, nan_row, 0)).any(),
          f"perm_ols (wide tile, P = {P}): the NaN row is not NaN alone")
    err["perm_ols"] = max(err["perm_ols"], max_abs_err(a, b))
    S, N, P = TILE_FALLBACK["score_perm"]
    D, used, _n, _p, e, _Z, _w = tile_case(8, S, N, K, P, False)
    rng = np.random.default_rng(9)
    M = rng.standard_normal((S, P, P)) / P
    Vinv = M @ M.transpose(0, 2, 1) + np.eye(P)
    args = [upload_t(x, device) for x in (D, used, Vinv, e)]
    T, Tp = to_np(pm.score_perm_stats(*args)), \
        to_np(pm.score_perm_stats_plain(*args))
    fin = np.isfinite(Tp)
    check(np.array_equal(np.isfinite(T), fin) and not fin[nan_row].any()
          and fin[np.arange(K) != nan_row].all(),
          f"score_perm (wide tile, P = {P}): non-finite T differ")
    e_sc = float(np.max(np.abs(T[fin] - Tp[fin])
                        / np.maximum(np.abs(Tp[fin]), 1.0)))
    check(e_sc <= SCORE_REL, f"score_perm (wide tile, P = {P}): T error "
          f"{e_sc:.3g}")
    err["score_perm"] = max(err["score_perm"], max_abs_err(T[fin], Tp[fin]))
    return (f"wide tile: perm_ols (S, N, P) {TILE_FALLBACK['perm_ols']} t1 "
            f"within {e_ols:.3g}, score_perm {TILE_FALLBACK['score_perm']} T "
            f"within {e_sc:.3g}")


def perm_tile_grid(device, err):
    """K16a and K16c kernel vs plain at the tile edges, every (N, K, P) of
    TILE_N x TILE_K x TILE_P and TILE_WIDE at S = TILE_S: t1 within OLS_REL
    (OLS_PINV_REL on the rank-deficient snarl), df exact, T within
    SCORE_REL; with K > 1 a NaN at sample NAN_SAMPLE, which no snarl uses,
    makes its row's t1 and T NaN on every snarl (0 x NaN, as in JAX) and
    its score-test p +inf; then the wide tile (perm_tile_fallback).
    Returns a short description."""
    import numpy as np
    import torch
    from stoat_tpu_torch.pipeline import permutation as pm
    worst_t1 = worst_T = 0.0
    cases = 0
    shapes = [(N, K, P) for N in TILE_N for K in TILE_K for P in TILE_P]
    for N, K, P in shapes + [(N, 65, P) for N, P in TILE_WIDE]:
        X, used, ncols, phenos, e, Z, w = (
            upload_t(a, device) for a in tile_case(
                1000 * N + 10 * K + P, TILE_S, N, K, P))
        pinv, _ = pinv_rows(X, ncols)
        nan_row = K // 2 if K > 1 else None
        what = f"tile edge S = {TILE_S}, N = {N}, K = {K}, P = {P}"
        t1, df, e_ols = compare_perm_ols(X, used, ncols, phenos, err, pinv,
                                         what)
        bad = torch.zeros(TILE_S, dtype=torch.bool, device=device)
        got, (_ev, et) = compare_score(X, used, ncols, bad, Z, w, e, err,
                                       what)
        if nan_row is not None:
            check(np.isnan(to_np(t1)[nan_row]).all()
                  and not np.isnan(np.delete(to_np(t1), nan_row,
                                             axis=0)).any(),
                  f"perm_ols ({what}): a NaN at an unused sample "
                  f"does not make row {nan_row}'s t1 NaN alone")
            T = to_np(got[4])
            ps = to_np(pm.score_perm_pvalues(got[4], got[2], got[3]))
            check(np.isnan(T[nan_row]).all()
                  and np.isinf(ps[nan_row]).all(),
                  f"score_perm ({what}): a NaN at an unused sample "
                  f"does not make row {nan_row}'s T NaN")
        worst_t1, worst_T = max(worst_t1, e_ols), max(worst_T, et)
        cases += 1
    return (f"tile edges: {cases} shapes (S = {TILE_S}; N {TILE_N}, K "
            f"{TILE_K}, P {TILE_P}; (N, P) {TILE_WIDE} at K = 65), perm_ols "
            f"t1 within {worst_t1:.3g}, "
            f"score_perm T within {worst_T:.3g}, a NaN at an unused sample "
            f"NaN on every snarl of its row, score p +inf; "
            f"{perm_tile_fallback(device, err)}")


# perm_binary's tile edges (csrc/perm_binary.cu): (name, Pmax, S,
# haplotypes H, K).  Row tiles of floor(64 / Pmax) snarls at Pmax = 1, 3
# and 4 (S not a multiple of them), one snarl over four 32-row units in
# two rounds at Pmax = 65, tiles of 32 masks at Pmax = 400 and of 8 at
# Pmax = 1,966;
# mask tiles of 128 with K = 1, 33 and 129; W = 1 word, ragged last words
# (H = 20, 90, 150) and full ones (H = 128, 256).  Every case has a snarl
# whose columns are all -1, invalid paths, and with K > 1 an all-zero
# mask (row 0) and an all-ones one (row 1, set past H too).
PB_GRID = (("pmax1_w1_k33", 1, 70, 20, 33), ("pmax3_k129", 3, 45, 150, 129),
           ("pmax4_k1", 4, 37, 90, 1), ("pmax65_k33", 65, 3, 128, 33),
           ("pmax400_k33", 400, 2, 256, 33), ("pmax1966_k9", 1966, 2, 64, 9))


def perm_binary_grid_cases(seed=31):
    """numpy inputs at perm_binary's tile edges, PB_GRID: (name, words
    uint32 [P, W] (path p's membership words, random past H as well), valid
    bool [P], tail uint32 [W], masks uint32 [K, W], sidx int32 [S, Pmax])
    per case; snarl 1 has only -1 columns, the other snarls 1 to Pmax
    distinct paths and -1 padding."""
    import numpy as np
    from stoat_tpu_torch.pipeline.packed import (pack_hap_mask_words,
                                                 tail_mask_words)
    rng = np.random.default_rng(seed)
    out = []
    for name, Pmax, S, H, K in PB_GRID:
        W = (H + 31) // 32
        P = S * Pmax + 3
        words = rng.integers(0, 2 ** 32, (P, W), dtype=np.uint64) \
            .astype(np.uint32)
        density = rng.random((P, 1)) * 0.8 + 0.1
        keep = rng.random((P, W * 32)) < density
        words &= np.packbits(keep, axis=1, bitorder="little").view("<u4")
        valid = rng.random(P) < 0.9
        sidx = np.full((S, Pmax), -1, np.int32)
        for s in range(S):
            n = int(rng.integers(1, Pmax + 1))
            sidx[s, :n] = rng.choice(P, n, replace=False)
        sidx[1] = -1
        masks = np.stack([pack_hap_mask_words(rng.random(H) < 0.45, W)
                          for _ in range(K)])
        if K > 1:
            masks[0] = 0
            masks[1] = 0xFFFFFFFF
        out.append((name, words, valid, tail_mask_words(H, W), masks, sidx))
    return out


def perm_binary_grid(device, err):
    """K15 (and K1 alone) kernel vs plain on perm_binary_grid_cases, as
    compare_perm_binary holds them: statistic and df bitwise and flags
    exact on the card and on the CPU, row 0's statistic bitwise equal to
    K3's.  Returns a short description."""
    import numpy as np
    from stoat_tpu_torch.convert import DeviceChunk
    for name, words, valid, tail, masks, sidx in perm_binary_grid_cases():
        idx = np.arange(words.shape[0], dtype=np.int32)[:, None]
        chunk = DeviceChunk(*(upload_t(a, device) for a in (
            words.view(np.int32), idx, valid, sidx, tail.view(np.int32))))
        compare_perm_binary(chunk, upload_t(masks.view(np.int32), device),
                            err)
    return (f"perm_binary grid: {len(PB_GRID)} cases (Pmax, S, H, K) "
            + ", ".join(f"{c[1:]}" for c in PB_GRID) + " bitwise")


# score_precompute's tile edges (csrc/score_test.cu): (name, PT, C1, N,
# S).  PT + C1 = 8 (one 8 x 8 tile of the Gram), 10 and 17 (two and three
# tile columns), 3; N not a multiple of 4 nor of the 8-row steps; 8 snarls
# a block, S not a multiple of it.  Snarl 0 has no used row, snarl 1
# ncols = 1, snarl 2 is flagged bad; "singular_g" repeats a column of Z.
SCORE_GRID = (("one_tile", 5, 3, 37, 9), ("two_tiles", 7, 3, 41, 9),
              ("three_tiles", 12, 5, 50, 6), ("narrow", 2, 1, 30, 5),
              ("singular_g", 5, 3, 36, 6))


def score_grid_cases(seed=41):
    """numpy inputs at score_precompute's tile edges, SCORE_GRID: (name, X
    [S, N, PT] (an intercept, 1 to PT - 1 dosage fractions, rows of unused
    samples zero), used [S, N], ncols [S], bad [S], Z [N, C1] (an
    intercept and standard normals), w [N], e [3, N] residual rows)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for name, PT, C1, N, S in SCORE_GRID:
        used = rng.random((S, N)) < 0.8
        used[0] = False
        ncols = rng.integers(2, PT + 1, S).astype(np.int32)
        ncols[1] = 1
        X = np.zeros((S, N, PT))
        X[:, :, 0] = 1.0
        for s in range(S):
            X[s, :, 1:ncols[s]] = rng.random((N, ncols[s] - 1))
        X[~used] = 0.0
        bad = np.zeros(S, bool)
        bad[2] = True
        Z = np.column_stack([np.ones(N), rng.standard_normal((N, C1 - 1))])
        if name == "singular_g":
            Z[:, 2] = Z[:, 1]
        w = rng.random(N) * 0.25 + 0.01
        e = rng.standard_normal((3, N)) * 0.5
        out.append((name, X, used, ncols, bad, Z, w, e))
    return out


def score_grid(device, err):
    """K16b (and K16c on its output) kernel vs plain on score_grid_cases,
    as compare_score holds them: D bitwise, df and allbad exact, V^-1 and T
    within SCORE_REL; the snarls with no used row, ncols = 1 or bad, and
    every snarl of "singular_g", flagged.  Returns a short description."""
    worst_v = worst_T = 0.0
    for name, *arrays in score_grid_cases():
        X, used, ncols, bad, Z, w, e = (upload_t(a, device) for a in arrays)
        got, (ev, et) = compare_score(X, used, ncols, bad, Z, w, e, err,
                                      f"score grid {name}")
        flags = to_np(got[3])
        check(flags[:3].all() and (flags.all() or name != "singular_g"),
              f"score_precompute (score grid {name}): a degenerate snarl "
              f"is not flagged")
        worst_v, worst_T = max(worst_v, ev), max(worst_T, et)
    return (f"score grid: {len(SCORE_GRID)} cases (PT, C1, N, S) "
            + ", ".join(f"{c[1:]}" for c in SCORE_GRID)
            + f", D bitwise, V^-1 within {worst_v:.3g}, T within "
            f"{worst_T:.3g}")


def perm_edge_cases(device, err):
    """Phase 3's permutation edge cases: rank-deficient designs (the
    pseudo-inverse) and a filtered snarl for K16a; an ill-conditioned
    Z^T W Z and non-finite T for K16b/c; 40 permutations (a ragged block of
    32) and W = 3 words for K15.  Returns a short description."""
    import numpy as np
    import torch
    from stoat_tpu_torch.convert import DeviceChunk
    from stoat_tpu_torch.pipeline import permutation as pm
    from stoat_tpu_torch.pipeline.packed import tail_mask_words
    rng = np.random.default_rng(21)
    X, y, mask, ncols = ols_cases(device, 3, 24, 300, 6)
    phenos = torch.from_numpy(rng.standard_normal((40, 300)) + 2.0) \
        .to(device)
    t1, df, e_ols = compare_perm_ols(X, mask, ncols, phenos, err, (0, 1),
                                     "edge designs")
    bad = torch.zeros(24, dtype=torch.bool, device=device)
    bad[5] = True
    p = to_np(pm.quant_perm_pvalues(t1, df, bad))
    check(np.isinf(p[:, 5]).all() and np.isfinite(p[:, 6]).all(),
          "perm p: a filtered snarl is not +inf")

    Z = np.column_stack([np.ones(300), rng.standard_normal((300, 2))])
    w = rng.random(300) * 0.25 + 0.01
    e = rng.standard_normal((40, 300)) * 0.5
    e[3, 7] = np.nan                         # T not finite for row 3
    Zd = Z.copy()
    Zd[:, 2] = Zd[:, 1]                      # Z^T W Z singular
    outs = []
    for Zc in (Z, Zd):
        got, (ev, et) = compare_score(
            X, mask, ncols, bad, *(upload_t(a, device) for a in (Zc, w, e)),
            err, "edge designs")
        outs.append((got, ev, et))
    T = to_np(outs[0][0][4])
    # used * e is 0 * NaN = NaN on the unused rows too, as in JAX: every
    # snarl's T of that row is NaN
    check(not np.isfinite(T[3]).any() and np.isfinite(T[2]).all(),
          "score_perm: a NaN residual does not make row 3's T NaN")
    p = to_np(pm.score_perm_pvalues(outs[0][0][4], outs[0][0][2],
                                    outs[0][0][3]))
    check(np.isinf(p[3]).all(), "score p: non-finite T not +inf")
    check(bool(to_np(outs[1][0][3]).all()), "score_precompute: a singular "
          "Z^T W Z is not flagged")
    for seed, H in ((0, 90), (1, 64)):
        words, idx, valid, tail, _ = membership_case(seed, 29, H, 31)
        chunk = DeviceChunk(*(upload_t(a, device) for a in (
            words.view(np.int32), idx, valid,
            rng.integers(-1, 31, (17, 5)).astype(np.int32),
            tail_mask_words(H, words.shape[1]).view(np.int32))))
        masks = np.stack([pm.permutation_masks(
            rng.random(H // 2) < 0.4, 1, s, words.shape[1])[0]
            for s in range(40)])
        compare_perm_binary(chunk, upload_t(masks.view(np.int32), device),
                            err)
    return (f"perm edge cases ok (rank-deficient designs 0, 1 within "
            f"{e_ols:.3g}; a filtered snarl +inf; a NaN residual makes its "
            f"row's T NaN on all {T.shape[1]} snarls, p +inf; singular "
            f"Z^T W Z flags all of them; V^-1 error "
            f"{max(o[1] for o in outs):.3g},"
            f" T error {max(o[2] for o in outs):.3g}; K15 on W = 3 and W = 2"
            f" words with 40 masks bitwise; {perm_binary_grid(device, err)}; "
            f"{score_grid(device, err)}; {perm_tile_grid(device, err)})")


def phase_perm_kernels(torch, device, chunks, quant, logit, err):
    """Phase 3 for the permutation kernels, on the first full-size chunk
    with PERM_K permutations; returns phase 5's inputs at the main path's
    K = 1 + PERM_FULL."""
    import numpy as np
    from stoat_tpu_torch.convert import to_perm_inputs
    chunk, qchunk, qpheno, qcovar, H, case = chunks[:6]
    pheno_bin = to_np(case) > 0.5
    covar = to_np(qcovar)
    W = int(chunk.words.shape[1])
    rows = perm_host_rows(pheno_bin, to_np(qpheno), covar, W, PERM_K)
    rows.pop("phenos_q")
    inp = to_perm_inputs(device, **rows)
    mem, g_all, _ = compare_perm_binary(chunk, inp.masks, err)

    q = quant
    pinv, _ = pinv_rows(q["X"], q["ncols"])
    t1, df, e_q = compare_perm_ols(q["X"], q["used"], q["ncols"],
                                   inp.phenos, err, pinv, "main chunk")
    one = stat_err("t1", to_np(t1[0]), to_np(q["stats"][0]))
    rows_ok = np.ones(q["X"].shape[0], bool)
    rows_ok[pinv] = False
    one_ok = stat_err("t1", to_np(t1[0])[rows_ok],
                      to_np(q["stats"][0])[rows_ok])
    check(one_ok <= OLS_REL and np.array_equal(to_np(df[0]),
                                               to_np(q["stats"][1])),
          f"perm_ols row 0 vs ols.cu: t1 error {one_ok:.3g}")

    lg = logit
    bad = lg["filtered"] | lg["deg"]
    _, (ev, et) = compare_score(lg["X"], lg["used"], lg["ncols"], bad,
                                inp.Z, inp.w, inp.e, err, "main chunk")
    edges = perm_edge_cases(device, err)
    torch.cuda.synchronize()
    say(f"phase 3 permutation kernels vs plain: first chunk, K = {PERM_K} "
        f"+ the observed row: perm_membership exact and perm_binary "
        f"statistic bitwise (card and CPU; row 0 = K3's bits); perm_ols t1 "
        f"within {e_q:.3g} (bound {OLS_REL:g}, {OLS_PINV_REL:g} on "
        f"{len(pinv)} pseudo-inverse rows), row 0 vs ols.cu {one_ok:.3g} "
        f"({one:.3g} with the pseudo-inverse rows); score_precompute D "
        f"bitwise, V^-1 within {ev:.3g}, score_perm T within {et:.3g} "
        f"(bound {SCORE_REL:g}); {edges}; max abs err "
        + ", ".join(f"{k}={err[k]:.3g}" for k in PERM_KERNELS))

    full = perm_host_rows(pheno_bin, to_np(qpheno), covar, W, PERM_FULL)
    phenos_q = upload_t(full.pop("phenos_q"), device)
    fin = to_perm_inputs(device, **full)
    D, Vinv, tails = compare_perm_full(torch, chunk, q, lg, bad, fin,
                                       phenos_q, err)
    return {"chunk": chunk, "mem": mem, "g_all": g_all, "masks": fin.masks,
            "X": q["X"], "used": q["used"], "ncols": q["ncols"],
            "phenos": fin.phenos, "bX": lg["X"], "bused": lg["used"],
            "bncols": lg["ncols"], "phenos_q": phenos_q, "bad": bad,
            "Z": fin.Z, "w": fin.w, "e": fin.e, "D": D, "Vinv": Vinv,
            "tails": tails}


def compare_perm_full(torch, chunk, q, lg, bad, fin, phenos_q, err):
    """Phase 3 at the main path's K = 1 + PERM_FULL rows, kernel vs plain on
    the card: K15 bitwise (every block of 32 masks); K16a at the ``-q -c``
    design (PT = 7, Freedman-Lane rows) and at the ``-q`` design (PT = 5,
    label permutations), t1 within OLS_REL (OLS_PINV_REL on the
    pseudo-inverse rows) and df exact; Q3's p-only route over the [K * S]
    statistics (linear_pvalues) against finish_linear_pvalues within T_REL;
    K16b/c within SCORE_REL; K5 on K15's [K, S] statistics and on the
    score test's (max(T, 0) on its df [S], read with its period) against
    chi2_sf_plain within CHI2_REL, the same strings.  Returns the score
    test's D and V^-1, and the two tails' [K, S] inputs: {"chi2_tail
    (binary)": (stat, df), "chi2_tail (score)": (T, df [1, S]),
    "student_t": (t1, df)}."""
    from stoat_tpu_torch.stats.linreg import (finish_linear_pvalues,
                                              linear_pvalues)
    from stoat_tpu_torch.stats.special import chi2_sf, chi2_sf_plain
    K = int(fin.masks.shape[0])
    _, _, (bstat, bdf, _) = compare_perm_binary(chunk, fin.masks, err,
                                                cpu=False)
    pinv7, _ = pinv_rows(q["X"], q["ncols"])
    t1, df, e7 = compare_perm_ols(q["X"], q["used"], q["ncols"], fin.phenos,
                                  err, pinv7, f"-q -c design, K = {K}")
    pinv5, _ = pinv_rows(lg["X"], lg["ncols"])
    _, _, e5 = compare_perm_ols(lg["X"], lg["used"], lg["ncols"], phenos_q,
                                err, pinv5, f"-q design, K = {K}")
    p, pp = to_np(linear_pvalues(t1, df)), to_np(finish_linear_pvalues(t1,
                                                                       df))
    ep = rel_err(p, pp)
    check(ep <= T_REL, f"linear_pvalues (K = {K}): relative error {ep:.3g} "
          f"> {T_REL:g} against finish_linear_pvalues")
    err["student_t"] = max(err["student_t"], max_abs_err(p, pp))
    got, (ev, et) = compare_score(lg["X"], lg["used"], lg["ncols"], bad,
                                  fin.Z, fin.w, fin.e, err, f"K = {K}")
    tails = {"chi2_tail (binary)": (bstat, bdf),
             "chi2_tail (score)": (torch.clamp(got[4], min=0.0),
                                   got[2][None, :]),
             "student_t": (t1, df)}
    k5 = []
    for what in ("chi2_tail (binary)", "chi2_tail (score)"):
        a, b = to_np(chi2_sf(*tails[what])).ravel(), \
            to_np(chi2_sf_plain(*tails[what])).ravel()
        r = hold_tail(a, b, f"{what}, K = {K}", CHI2_REL)
        err["chi2_tail"] = max(err["chi2_tail"], max_abs_err(a, b))
        k5.append(f"{what} max rel {r[0]:.3g}, {r[2]} differing")
    torch.cuda.synchronize()
    say(f"phase 3 permutation kernels vs plain at the main path's K = {K} "
        f"rows ({int(t1.shape[1])} snarls): perm_binary statistic bitwise; "
        f"perm_ols t1 within {e7:.3g} at PT = {int(q['X'].shape[2])} "
        f"({len(pinv7)} pseudo-inverse rows) and {e5:.3g} at PT = "
        f"{int(lg['X'].shape[2])} ({len(pinv5)}), df exact; linear_pvalues "
        f"over [{K} x {int(t1.shape[1])}] within {ep:.3g} (bound "
        f"{T_REL:g}); score_precompute V^-1 within {ev:.3g}, score_perm T "
        f"within {et:.3g} (bound {SCORE_REL:g}); chi2_tail over [{K} x "
        f"{int(t1.shape[1])}]: " + ", ".join(k5) + f" (bound {CHI2_REL:g}, "
        f"the same strings)")
    return got[0], got[1], tails


class PermCapture:
    """Records what run_permutation_test computes, by wrapping its
    accumulate_chunk (each chunk's [1 + K, S] p-values on the device) and
    timing the whole pass: per job of the pass (the binary and the
    quantitative table of a dual run, in that order) and chunk, the
    observed row and each permutation's minimum, and the full matrices of
    the first ``full`` chunks."""

    def __init__(self, full=1):
        self.full = full

    def job(self, j=0):
        """The chunk records of the pass's job ``j``."""
        return list(self.jobs.values())[j]

    @property
    def chunks(self):
        return self.job(0)

    def __enter__(self):
        from stoat_tpu_torch.pipeline import permutation as pm
        self.pm = pm
        self.real_acc = pm.accumulate_chunk
        self.real_run = pm.run_permutation_test
        self.jobs, self.walls = {}, []

        def acc(state, chrom, snarls, p):
            S = len(snarls)
            chunks = self.jobs.setdefault(id(state), [])
            rec = {"chrom": chrom, "snarls": [s.snarl_id_str for s in snarls],
                   "obs": to_np(p[0, :S]), "min": to_np(p[1:, :S].amin(1))
                   if S else None}
            if len(chunks) < self.full:
                rec["p"] = to_np(p[:, :S])
            chunks.append(rec)
            return self.real_acc(state, chrom, snarls, p)

        def run(*a, **k):
            import torch
            t0 = time.perf_counter()
            out = self.real_run(*a, **k)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.walls.append(time.perf_counter() - t0)
            return out
        pm.accumulate_chunk, pm.run_permutation_test = acc, run
        return self

    def __exit__(self, *exc):
        self.pm.accumulate_chunk = self.real_acc
        self.pm.run_permutation_test = self.real_run
        return False


def read_perm_tsv(path):
    """{(chrom, snarl): (P_ASY, P_EMP, P_FWER)} strings, in file order."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    check(lines[0] == "#CHR\tSTART_POS\tEND_POS\tSNARL\tP_ASY\tP_EMP\t"
          "P_FWER", f"permutation TSV header {lines[0]!r}")
    out = {}
    for line in lines[1:]:
        c = line.split("\t")
        check(len(c) == 7, f"malformed permutation row {line!r}")
        out[(c[0], c[3])] = tuple(c[4:])
    return out


def recount_perm(cap, got, n_perms, job=0):
    """The numpy recount of P_EMP (the fully captured chunks' snarls) and
    P_FWER (every snarl) of the pass's job ``job`` from the captured
    p-values; returns the snarls checked for each."""
    import numpy as np
    from stoat_tpu_torch.writer import format_p
    null_min = np.min(np.stack([c["min"] for c in cap.job(job)
                                if c["min"] is not None]), axis=0)
    n_emp = n_fwer = 0
    for c in cap.job(job):
        for i, sid in enumerate(c["snarls"]):
            obs = c["obs"][i]
            asy, emp, fwer = got[(c["chrom"], sid)]
            if not np.isfinite(obs):
                check((asy, emp, fwer) == ("NA",) * 3, f"{sid}: not NA")
                continue
            check(asy == format_p(obs), f"{sid}: P_ASY {asy} != {obs!r}")
            fw = int(np.sum(null_min <= obs))
            check(fwer == format_p((1 + fw) / (n_perms + 1)),
                  f"{sid}: P_FWER {fwer}, recount {fw}")
            n_fwer += 1
            if "p" in c:
                exc = int(np.sum(c["p"][1:, i] <= obs))
                check(emp == format_p((1 + exc) / (n_perms + 1)),
                      f"{sid}: P_EMP {emp}, recount {exc}")
                n_emp += 1
    return n_emp, n_fwer


def perm_same_but_ties(got_a, cap_a, got_b, cap_b, n_perms, job=0):
    """Two runs' permutation tables (CUDA and CPU) of the passes' job
    ``job`` agree: the same rows and NA cells; a P_ASY string may differ
    only at a rounding boundary, where the two p-values agree to TSV_REL;
    a P_EMP/P_FWER count may differ only inside the tie band of TIE_REL
    around run b's own p-values.  Returns the differing rows."""
    import numpy as np

    def cells(cap):
        out = {}
        for c in cap.job(job):
            for i, sid in enumerate(c["snarls"]):
                out[(c["chrom"], sid)] = (c["obs"][i], c["p"][1:, i])
        return out, np.min(np.stack([c["min"] for c in cap.job(job)
                                     if c["min"] is not None]), axis=0)
    check(list(got_a) == list(got_b), "permutation TSVs: rows differ")
    (cells_a, _), (cells_b, null_min) = cells(cap_a), cells(cap_b)
    diffs = []
    for key, a in got_a.items():
        b = got_b[key]
        if a == b:
            continue
        check(("NA" in a) == ("NA" in b), f"{key}: NA differs {a} / {b}")
        obs_a, _ = cells_a[key]
        obs, perm = cells_b[key]
        check(a[0] == b[0] or abs(obs_a - obs) <= TSV_REL * abs(obs),
              f"{key}: P_ASY {a[0]} / {b[0]} ({obs_a!r} / {obs!r})")
        for col, counts in ((1, perm), (2, null_min)):
            if a[col] == b[col]:
                continue
            n = round(float(a[col]) * (n_perms + 1)) - 1
            lo = int(np.sum(counts < obs - TIE_REL * obs))
            hi = int(np.sum(counts <= obs + TIE_REL * obs))
            check(lo <= n <= hi, f"{key}: {a} / {b}: count {n} outside "
                  f"the tie band [{lo}, {hi}]")
        diffs.append(f"{key[0]} {key[1]} {'/'.join(a)} vs {'/'.join(b)}")
    return diffs


def perm_cli_args(paths, out, device, mode, n_perms):
    pheno = {"b": ["-b", paths["binary"]], "b_c": ["-b", paths["binary"]],
             "q": ["-q", paths["quantitative"]],
             "q_c": ["-q", paths["quantitative"]],
             "bq": ["-b", paths["binary"], "-q", paths["quantitative"]]}[mode]
    covar = (["-c", paths["covariate"], "-C", ",".join(COVAR_NAMES)]
             if mode in ("q_c", "b_c") else [])
    return ["vcf", "-s", paths["snarl"], "-v", paths["vcf"], *pheno,
            *covar, "-o", out, "--device", device, "--permutations",
            str(n_perms), "--perm-seed", "0"]


# each mode's permutation tables, one per job of its pass
PERM_TABLES = {"b": ("binary_permutation_vcf.tsv",),
               "b_c": ("binary_permutation_vcf.tsv",),
               "q": ("quantitative_permutation_vcf.tsv",),
               "q_c": ("quantitative_permutation_vcf.tsv",),
               "bq": ("binary_permutation_vcf.tsv",
                      "quantitative_permutation_vcf.tsv")}
# each mode's kernels and their launches per chunk: the main table's, then
# the permutation pass's
PERM_LAUNCHES = {
    "b": {"binary_from_words": 1, "chi2_tail": 2, "perm_membership": 1,
          "perm_binary": 1},
    "q": {"quant_design": 2, "ols": 1, "student_t": 2, "perm_ols": 1},
    "q_c": {"quant_design": 2, "ols": 1, "student_t": 2, "perm_ols": 1},
    "b_c": {"quant_design": 2, "logreg": 1, "score_precompute": 1,
            "score_perm": 1, "chi2_tail": 1},
    # the dual table (K1 once), then both jobs of one pass
    "bq": {"perm_membership": 2, "binary_from_words": 1,
           "chi2_tail": 2, "quant_design": 2, "ols": 1,
           "student_t": 2, "perm_binary": 1, "perm_ols": 1},
}


def phase_perm_main(torch, paths, sub, work, n_chroms, mode):
    """``vcf ... --permutations PERM_FULL`` on the card at full size: every
    kernel of the mode launched on every chunk, the table's rows and a
    numpy recount of P_EMP (first chunk) and P_FWER (every snarl) from the
    captured p-values; then, unless ``sub`` is None, CUDA against CPU on
    the sub-cohort with PERM_SUB permutations.  Returns (launches, pass
    wall, the sub-cohort's CPU wall, line)."""
    from stoat_tpu_torch import cli, kernels
    n_chunks = n_chunks_of(paths, n_chroms)
    out = os.path.join(work, f"perm_cuda_{mode}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with PermCapture() as cap, PlainTailCounter() as lib:
        rc = cli.main(perm_cli_args(paths, out, "cuda", mode, PERM_FULL))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"--permutations {mode}: exit code {rc}")
    check(lib.calls == 0, f"--permutations {mode} called the plain "
          f"chi-squared tail {lib.calls} times")
    check_launches(launches, PERM_LAUNCHES[mode], n_chunks,
                   f"--permutations {mode}")
    tables = PERM_TABLES[mode]
    check(len(cap.jobs) == len(tables), f"--permutations {mode}: "
          f"{len(cap.jobs)} jobs in the pass")
    counts = []
    for j, table in enumerate(tables):
        got = read_perm_tsv(os.path.join(out, table))
        check(len(got) == paths["n_snarls"], f"--permutations {mode}: "
              f"{len(got)} rows in {table}")
        n_emp, n_fwer = recount_perm(cap, got, PERM_FULL, j)
        n_tested = sum(1 for v in got.values() if v[0] != "NA")
        counts.append(f"{table}: {len(got)} rows, {n_tested} tested, numpy "
                      f"recount equal for P_EMP of {n_emp} snarls (first "
                      f"chunk) and P_FWER of {n_fwer}")
    perm_wall = cap.walls[0]
    tests_s = len(tables) * PERM_FULL * paths["n_snarls"] / perm_wall
    line = (f"phase 4 permutations: {PERM_TITLES[mode]} --permutations "
            f"{PERM_FULL} on {paths['n_samples']} samples x "
            f"{paths['n_snarls']} snarls: CLI wall {wall:.2f}s, permutation "
            f"pass {perm_wall:.2f}s = {tests_s:.4g} permuted snarl-tests/s; "
            f"launches {launches} ({n_chunks} chunks); " + "; ".join(counts)
            + f"; max_memory_allocated {memory_note(peak, held)}")
    if sub is None:
        return launches, perm_wall, None, line

    # CUDA against CPU on the sub-cohort
    subs = {}
    for device in ("cuda", "cpu"):
        o = os.path.join(work, f"perm_sub_{device}_{mode}")
        with PermCapture(full=10 ** 6) as c:
            t1 = time.perf_counter()
            check(cli.main(perm_cli_args(sub, o, device, mode,
                                         PERM_SUB)) == 0,
                  f"sub-cohort --permutations {mode} on {device}")
            subs[device] = ([read_perm_tsv(os.path.join(o, t))
                             for t in tables], c, time.perf_counter() - t1)
    diffs = []
    for j in range(len(tables)):
        diffs += perm_same_but_ties(subs["cuda"][0][j], subs["cuda"][1],
                                    subs["cpu"][0][j], subs["cpu"][1],
                                    PERM_SUB, j)
    line += (f"; sub-cohort {sub['n_samples']} samples x "
             f"{sub['n_snarls']} snarls, K = {PERM_SUB}: cuda "
             f"{subs['cuda'][2]:.2f}s, cpu {subs['cpu'][2]:.2f}s, "
             f"{len(subs['cpu'][0][0])} rows per table, {len(diffs)} "
             f"differing (ties within {TIE_REL:g} or a P_ASY rounding "
             f"boundary){': ' + '; '.join(diffs[:5]) if diffs else ''}")
    return launches, perm_wall, subs["cpu"][2], line


PERM_TITLES = {"b": "vcf -b", "q": "vcf -q", "q_c": "vcf -q -c -C AGE,SEX",
               "b_c": "vcf -b -c -C AGE,SEX", "bq": "vcf -b -q"}


# ---------------------------------------------------------------- dual, eQTL, LMM

def gene_pairs(snarls, filtered, genes, window=1000000):
    """A chunk's (snarl, gene) pairs as the runner builds them: for each
    unfiltered snarl, in order, the genes of ``genes`` ([(name, start,
    end, expression)]) within the window (runner.found_gene_snarl)."""
    from stoat_tpu_torch.io.phenotype import QtlData
    from stoat_tpu_torch.pipeline.runner import found_gene_snarl
    qtl = [QtlData(g, e, lo, hi) for g, lo, hi, e in genes]
    pair_snarl, pair_gene = [], []
    for s, snarl in enumerate(snarls):
        if filtered[s]:
            continue
        for g in found_gene_snarl(qtl, snarl.start_pos, snarl.end_pos,
                                  window):
            pair_snarl.append(s)
            pair_gene.append(g)
    return pair_snarl, pair_gene


def compare_eqtl(d, pairs, expr, err, what, noise_genes=(),
                 plain_on_cpu=False):
    """K13 kernel vs plain on the card: t1, beta, se and r2 within OLS_REL
    (OLS_PINV_REL on the pairs of rank-deficient snarls), df exact; pairs
    of the ``noise_genes`` (a constant expression: tss = 0) have r2 not
    finite and beta, se below 1e-9 in both.  Returns the kernel's
    statistics and the largest errors."""
    import numpy as np
    from stoat_tpu_torch.pipeline import quantitative as tq
    args = (d["X"], d["used"], d["ncols"], *pairs, expr)
    got = tq.eqtl_ols_stats(*args)
    plain = tq.eqtl_ols_stats_plain(
        *(t.cpu() for t in args) if plain_on_cpu else args)
    ps = to_np(tq.pair_snarls(pairs[0], int(pairs[1].shape[0])))
    bad, _ = pinv_rows(d["X"], d["ncols"])
    pinv = np.flatnonzero(np.isin(ps, bad)).tolist()
    noise = np.flatnonzero(np.isin(to_np(pairs[1]), noise_genes)).tolist()
    errs = hold_ols_stats(got, plain, "eqtl_ols", err, OLS_REL, what, noise,
                          pinv, OLS_PINV_REL)
    return got, errs, len(pinv)


def eqtl_edge_cases(device, err):
    """K13 on the rule-hitting chunk of quant_edge_chunk with covariates:
    snarls with no pairs (every fourth), a rank-deficient design with
    pairs (snarl 2, the pseudo-inverse), 33 genes on one snarl (more than
    the kernel's 32 a pass) and a gene of constant expression (on
    full-rank designs: on a rank-deficient one its beta is not noise, but
    its rss and se are)."""
    import numpy as np
    chunk, H = quant_edge_chunk(device)
    N = H // 2
    rng = np.random.default_rng(9)
    covar = upload_t(rng.standard_normal((N, 2)), device)
    from stoat_tpu_torch.convert import to_eqtl_pairs
    from stoat_tpu_torch.pipeline.quantitative import quant_design
    d = quant_design(chunk, covar, *THRESHOLDS, H)
    G = 34
    expr = rng.standard_normal((G, N)) + 1.0
    expr[G - 1] = 3.0
    n_used = to_np(d["used"]).sum(axis=1)
    ncols = to_np(d["ncols"])
    bad, _ = pinv_rows(d["X"], d["ncols"])
    pair_snarl, pair_gene = [], []
    for s in range(int(d["X"].shape[0])):
        if s % 4 == 1 or n_used[s] <= ncols[s] + 1:
            continue
        genes = range(G - 1) if s in (2, 6) else \
            sorted(rng.choice(G - 1, 5, replace=False).tolist())
        if s % 4 == 0 and s not in bad:
            genes = [*genes, G - 1]
        for g in genes:
            pair_snarl.append(s)
            pair_gene.append(int(g))
    check(2 in pair_snarl, "eqtl edge case: snarl 2 has no pairs")
    pairs = to_eqtl_pairs(pair_snarl, pair_gene, int(d["X"].shape[0]),
                          device)
    _, errs, n_pinv = compare_eqtl(d, pairs, upload_t(expr, device), err,
                                   "edge chunk", noise_genes=(G - 1,))
    check(n_pinv >= G - 1, f"eqtl edge case: {n_pinv} pseudo-inverse pairs")
    return (f"eqtl_ols edge cases ok ({len(pair_snarl)} pairs, every fourth "
            f"snarl none, {n_pinv} on rank-deficient designs, {G} genes on "
            f"snarls 2 and 6, a constant expression; max err "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + ")")


def compare_lmm_chain(d, rot, y_rot, err, what):
    """The mixed model's chain (K14's rotation as one GEMM, Q2, Q3)
    against its plain version (torch.einsum "mn,snp->smp" as stoat_tpu
    writes it, linear_regression_stats_plain, student_t_pvalues_plain):
    the rotated designs within 1e-12 of each design's largest entry, the
    statistics as compare_ols holds them.  Returns a description and the
    largest errors."""
    import numpy as np
    import torch
    from stoat_tpu_torch.stats.linreg import linear_regression_stats_plain
    from stoat_tpu_torch.stats.lmm import lmm_regression_batch, lmm_rotate
    Xr = lmm_rotate(rot, d["X"])
    Xp = torch.einsum("mn,snp->smp", rot, d["X"])
    scale = Xp.abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-300)
    e_rot = float(((Xr - Xp).abs() / scale).max())
    check(e_rot <= 1e-12, f"lmm rotation ({what}): {e_rot:.3g} against "
          f"torch.einsum")
    del Xr
    S, N, _ = Xp.shape
    got = lmm_regression_batch(d["X"], rot, y_rot, d["ncols"])
    plain = linear_regression_stats_plain(
        Xp, y_rot[None, :].expand(S, N).contiguous(),
        torch.ones((S, N), dtype=torch.bool, device=Xp.device), d["ncols"])
    bad, _ = pinv_rows(Xp, d["ncols"])
    del Xp
    errs = hold_ols_stats(got, plain, "ols", err, OLS_REL, what, (), bad,
                          OLS_PINV_REL)
    _, t_worst = compare_student_t(*got[:2], d["degenerate"], *got[2:], err,
                                   what)
    return (f"rotation within {e_rot:.3g} of torch.einsum, ols max err "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" ({len(bad)} pseudo-inverse rows), student_t {t_worst[0]:.3g}"
              f" / {t_worst[1]:.3g} (card / CPU)"), errs


def phase_mode_kernels(torch, device, chunks, quant, err, genes, lmm_in):
    """Phase 3 for the dual, eQTL and mixed-model paths on the first chunk
    of ``vcf -q -c`` at full shapes: quant_design with all_rows bitwise
    (card and CPU), eqtl_ols on the chunk's real (snarl, gene) pairs and
    on edge cases, and the mixed model's chain.  Returns phase 5's
    inputs."""
    import numpy as np
    from stoat_tpu_torch.convert import to_eqtl_pairs
    chunk, qchunk, qpheno, qcovar, H, case, (chrom, packed) = chunks
    q = quant
    d_all = compare_quant_design(qchunk, qcovar, H, err, all_rows=True)
    X = d_all["X"]
    unused = ~d_all["used"]
    k3 = (d_all["ncols"] - 1 - qcovar.shape[1]).long()
    check(bool((X[..., 0] == 1.0).all()), "all_rows: an intercept is not 1")
    cov_ok = all(bool(torch.equal(
        X[s][:, 1 + int(k3[s]):1 + int(k3[s]) + qcovar.shape[1]], qcovar))
        for s in range(0, X.shape[0], 97))
    check(cov_ok, "all_rows: covariates not on every row")
    var = torch.arange(X.shape[2], device=device)[None, :] <= k3[:, None]
    var[:, 0] = False
    check(not bool((X * (unused[:, :, None] & var[:, None, :])).any()),
          "all_rows: a variant column is not 0 on an unused row")
    for key, ref in (("used", q["used"]), ("ncols", q["ncols"]),
                     ("filtered", q["filtered"]), ("degenerate", q["deg"])):
        check(torch.equal(d_all[key], ref), f"all_rows: {key} differs "
              f"from the OLS design's")

    pair_snarl, pair_gene = gene_pairs(packed.snarls, to_np(q["filtered"]),
                                       genes[chrom])
    pairs = to_eqtl_pairs(pair_snarl, pair_gene, int(q["X"].shape[0]),
                          device)
    expr = upload_t(np.stack([g[3] for g in genes[chrom]]), device)
    design = {"X": q["X"], "used": q["used"], "ncols": q["ncols"]}
    _, e_errs, n_pinv = compare_eqtl(design, pairs, expr, err, "main chunk")
    edges = eqtl_edge_cases(device, err)
    rot, y_rot = lmm_in
    chain, _ = compare_lmm_chain(d_all, rot, y_rot, err, "main chunk")
    torch.cuda.synchronize()
    n_with = len(set(pair_snarl))
    say(f"phase 3 dual/eQTL/mixed-model kernels vs plain: quant_design "
        f"all_rows on the main chunk (X {tuple(X.shape)}, "
        f"{int(to_np(unused).sum())} unused rows kept) bitwise on the card "
        f"and the CPU, intercepts and covariates on every row, variant "
        f"columns 0 on unused rows, used/ncols/flags those of the OLS "
        f"design; eqtl_ols on the chunk's {len(pair_snarl)} pairs "
        f"({n_with} snarls with pairs, {int(q['X'].shape[0]) - n_with} "
        f"without, {len(genes[chrom])} genes on {chrom}, {n_pinv} pairs on "
        f"rank-deficient designs) max err "
        + ", ".join(f"{k} {v:.3g}" for k, v in e_errs.items())
        + f" (bound {OLS_REL:g}, {OLS_PINV_REL:g} on pseudo-inverse pairs, "
        f"df exact); {edges}; mixed model on the all-rows chunk: {chain}; "
        f"max abs err eqtl_ols={err['eqtl_ols']:.3g}")
    return {"d_all": d_all, "pairs": pairs, "expr": expr, "rot": rot,
            "y_rot": y_rot, "n_pairs": len(pair_snarl),
            "n_with": n_with, "chunk": qchunk, "covar": qcovar, "H": H}


class EqtlCapture:
    """Records the eQTL pairs' statistics as the runner computes them, by
    wrapping its eqtl_regress_pairs: float64 arrays in row order."""

    def __enter__(self):
        from stoat_tpu_torch.pipeline import runner
        self.runner = runner
        self.real = runner.eqtl_regress_pairs
        self.parts = []

        def wrap(*a):
            res = self.real(*a)
            self.parts.append(res)
            return res
        runner.eqtl_regress_pairs = wrap
        return self

    def __exit__(self, *exc):
        self.runner.eqtl_regress_pairs = self.real
        return False

    def values(self):
        """{p, beta, se, r2}: each [rows] in row order."""
        import numpy as np
        return {k: np.concatenate([r[k] for r in self.parts]) if self.parts
                else np.zeros(0) for k in QUANT_STATS}


def read_eqtl_tsv(path):
    """The eQTL table's rows, split."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    check(lines[0].split("\t")[5] == "GENE", f"eQTL header {lines[0]!r}")
    rows = [line.split("\t") for line in lines[1:]]
    check(all(len(r) == 12 for r in rows), "malformed eQTL row")
    return rows


def compare_eqtl_tsvs(rows_a, vals_a, rows_b, vals_b):
    """Two eQTL tables (CUDA and CPU): the same rows, genes, ALLELE_PATHS
    and NA cells; a statistic string may differ only where the captured
    float64 values agree to TSV_REL.  Returns the differing cells."""
    check(len(rows_a) == len(rows_b), f"eQTL rows {len(rows_a)} / "
          f"{len(rows_b)}")
    names = ("p", "r2", "beta", "se")           # columns 6-9
    diffs = []
    for i, (a, b) in enumerate(zip(rows_a, rows_b)):
        check(a[:6] == b[:6] and a[10:] == b[10:], f"eQTL rows differ: "
              f"{a} / {b}")
        for col, name in enumerate(names, start=6):
            if a[col] == b[col]:
                continue
            check("NA" not in (a[col], b[col]), f"NA differs: {a} / {b}")
            va, vb = vals_a[name][i], vals_b[name][i]
            rel = stat_err(name, [va], [vb], [vals_b["se"][i]])
            check(rel <= TSV_REL, f"{a[3]} {a[5]} {name}: {a[col]} / "
                  f"{b[col]} ({va!r} / {vb!r})")
            diffs.append(f"{a[0]} {a[3]} {a[5]} {name} {a[col]}/{b[col]}")
    return diffs


def capped_chunk(paths):
    """The runner's chunk for every mode but binary (the design's 2 GB
    cap, pipeline/runner.py)."""
    return min(8192, max(int(2e9 // (paths["n_samples"] * 96)), 256))


def n_chunks_of(paths, n_chroms, chunk=8192):
    """Chunks of a run: make_fixture's split over chromosomes, in chunks
    of ``chunk`` snarls."""
    per_chrom = -(-paths["n_snarls"] // n_chroms)
    return sum(math.ceil(min(per_chrom, paths["n_snarls"] - c * per_chrom)
                         / chunk) for c in range(n_chroms)
               if paths["n_snarls"] - c * per_chrom > 0)


def check_launches(launches, kernels_per_chunk, n_chunks, what):
    for name, n in launches.items():
        want = kernels_per_chunk.get(name, 0) * n_chunks
        check(n == want, f"{what}: kernel {name} launched {n} times, "
              f"expected {want} ({n_chunks} chunks)")


def phase_dual(torch, paths, work, n_chroms, reference):
    """``vcf -b B -q Q`` on the card: each dual kernel once per chunk (K1
    once, shared), both tables equal the single ``-b`` and ``-q`` runs'
    byte for byte, the filter and ALLELE_PATHS of every snarl equal the
    numpy reference; then on the CPU, byte-identical binary table and the
    quantitative table as phase 4's regression rule states."""
    from stoat_tpu_torch import cli, kernels
    n_chunks = n_chunks_of(paths, n_chroms)
    outs, got, walls = {}, {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for device in ("cuda", "cpu"):
        outs[device] = os.path.join(work, f"out_{device}_dual")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with PlainTailCounter() as lib:
            rc, got[device] = run_captured(cli, dual_cli_args(
                paths, outs[device], device))
        torch.cuda.synchronize()
        walls[device] = time.perf_counter() - t0
        check(rc == 0, f"dual on {device}: exit code {rc}")
        check(device == "cpu" or lib.calls == 0, f"the dual on the card "
              f"called the plain chi-squared tail {lib.calls} times")
        if device == "cuda":
            launches = dict(kernels.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
    check_launches(launches, dict.fromkeys(DUAL_KERNELS, 1), n_chunks,
                   "vcf -b -q")
    bt, qt = "binary_table_vcf.tsv", "quantitative_table_vcf.tsv"
    for table, single in ((bt, "out_cuda"), (qt, "out_cuda_q")):
        with open(os.path.join(outs["cuda"], table), "rb") as fh:
            data = fh.read()
        with open(os.path.join(work, single, table), "rb") as fh:
            check(fh.read() == data, f"dual {table} differs from the "
                  f"single run's on the card")
    with open(os.path.join(outs["cuda"], bt), "rb") as a, \
            open(os.path.join(outs["cpu"], bt), "rb") as b:
        check(a.read() == b.read(), "dual binary tables: CUDA and CPU "
              "differ")
    n_rows, diffs = compare_quant_tsvs(
        os.path.join(outs["cuda"], qt), os.path.join(outs["cpu"], qt),
        got["cuda"], got["cpu"])
    table = reference[0]
    check(list(got["cuda"]) == list(table), "dual: snarl order differs "
          "from the reference")
    for key, (filtered, allele) in table.items():
        check(got["cuda"][key][:2] == (filtered, allele),
              f"dual {key}: filtered/allele_paths differ from the reference")
    say(f"phase 4 main path: vcf -b -q on {paths['n_samples']} samples x "
        f"{paths['n_snarls']} snarls: cuda wall {walls['cuda']:.2f}s, cpu "
        f"wall {walls['cpu']:.2f}s; launches {launches} ({n_chunks} chunks: "
        f"K1 once per chunk, its words read by binary_from_words and "
        f"quant_design); both tables byte-identical to the single vcf -b and "
        f"vcf -q runs on the card; binary table byte-identical to the CPU's, "
        f"quantitative {n_rows} rows, {len(diffs)} statistic strings differ "
        f"(within {TSV_REL:g}){': ' + '; '.join(diffs[:5]) if diffs else ''}"
        f"; filter and ALLELE_PATHS of all {len(table)} snarls equal the "
        f"numpy reference; max_memory_allocated {memory_note(peak, held)}")
    return launches, walls["cuda"]


def eqtl_cli_args(p, out, device):
    return ["vcf", "-s", p["snarl"], "-v", p["vcf"], "-e", p["qtl_smoke"],
            "-G", p["genes"], *covar_args(p), "-o", out, "--device", device]


def lmm_cli_args(p, out, device):
    return ["vcf", "-s", p["snarl"], "-v", p["vcf"], "-q", p["lmm_pheno"],
            "-k", p["kinship"], "--lmm", *covar_args(p), "-o", out,
            "--device", device]


def dual_cli_args(p, out, device):
    return ["vcf", "-s", p["snarl"], "-v", p["vcf"], "-b", p["binary"],
            "-q", p["quantitative"], "-o", out, "--device", device]


def phase_eqtl(torch, paths, sub, work, n_chroms, reference, genes):
    """``vcf -e E -G G -c C -C AGE,SEX`` on the card at full size: its
    kernels on every chunk, the rows exactly the unfiltered snarls' genes
    within the window (numpy), ALLELE_PATHS as the reference's, the
    sampled pairs' statistics within REF_REL of numpy OLS; the per-row
    format+write timed alone; then CUDA against CPU on the sub-cohort."""
    import io
    from stoat_tpu_torch import cli, kernels
    from stoat_tpu_torch import writer as W
    from stoat_tpu_torch.io.snarl_file import parse_snarl_path

    argv = eqtl_cli_args
    n_chunks = n_chunks_of(paths, n_chroms, capped_chunk(paths))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    out = os.path.join(work, "out_cuda_eqtl")
    t0 = time.perf_counter()
    with EqtlCapture() as cap:
        rc = cli.main(argv(paths, out, "cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"eQTL on cuda: exit code {rc}")
    check_launches(launches, dict.fromkeys(EQTL_KERNELS, 1), n_chunks,
                   "eQTL")
    rows = read_eqtl_tsv(os.path.join(out, "eqtl_table_vcf.tsv"))
    vals = cap.values()
    check(len(vals["p"]) == len(rows), f"eQTL: {len(vals['p'])} captured "
          f"pairs, {len(rows)} rows")
    table, _stats, eqtl_ref, _gls = reference
    snarls_chr = parse_snarl_path(paths["snarl"])
    want = []
    for chrom, snarls in snarls_chr.items():
        filtered = [table[(chrom, sn.snarl_id_str)][0] for sn in snarls]
        ps, pg = gene_pairs(snarls, filtered, genes.get(chrom, []))
        want += [(chrom, snarls[s].snarl_id_str, genes[chrom][g][0],
                  ",".join(map(str, table[(chrom, snarls[s].snarl_id_str)]
                               [1]))) for s, g in zip(ps, pg)]
    check([(r[0], r[3], r[5], r[10]) for r in rows] == want,
          "eQTL rows (chromosome, snarl, gene, ALLELE_PATHS) differ from "
          "the numpy pairing")
    index = {(r[0], r[3], r[5]): i for i, r in enumerate(rows)}
    worst = 0.0
    for key, ref in eqtl_ref.items():
        i = index[key]
        e = max(stat_err(name, [vals[name][i]], [ref[k]], [ref[2]])
                for k, name in enumerate(("p", "beta", "se", "r2")))
        check(e <= REF_REL, f"eQTL {key}: {[vals[n][i] for n in QUANT_STATS]}"
              f" vs reference {ref} (relative {e:.3g})")
        worst = max(worst, e)
    # the per-row format+write (runner._eqtl_chromosome's loop), alone
    snarl_of = {(c, sn.snarl_id_str): sn for c, sns in snarls_chr.items()
                for sn in sns}
    sink = io.StringIO()
    t1 = time.perf_counter()
    for i, r in enumerate(rows):
        sn = snarl_of[(r[0], r[3])]
        W.write_eqtl_row(sink, r[0], sn, sn.type_var_str, r[5],
                         W.format_p(vals["p"][i]), W.format_p(vals["r2"][i]),
                         W.format_p(vals["beta"][i]),
                         W.format_p(vals["se"][i]),
                         [int(a) for a in r[10].split(",")])
    write_s = time.perf_counter() - t1
    with open(os.path.join(out, "eqtl_table_vcf.tsv")) as fh:
        fh.readline()
        check(sink.getvalue() == fh.read(), "eQTL rows rewritten from the "
              "captured values differ from the table")

    subs = {}
    for device in ("cuda", "cpu"):
        o = os.path.join(work, f"sub_{device}_eqtl")
        t1 = time.perf_counter()
        with EqtlCapture() as c:
            check(cli.main(argv(sub, o, device)) == 0,
                  f"sub-cohort eQTL on {device}")
        subs[device] = (read_eqtl_tsv(os.path.join(o, "eqtl_table_vcf.tsv")),
                        c.values(), time.perf_counter() - t1)
    diffs = compare_eqtl_tsvs(subs["cuda"][0], subs["cuda"][1],
                              subs["cpu"][0], subs["cpu"][1])
    n_genes = sum(len(g) for g in genes.values())
    say(f"phase 4 main path: vcf -e -G -c -C AGE,SEX on "
        f"{paths['n_samples']} samples x {paths['n_snarls']} snarls and "
        f"{n_genes} genes (one per {GENE_STEP // 1000} kb, 1 Mb window): "
        f"cuda wall {wall:.2f}s, of which the per-row format+write of the "
        f"{len(rows)} rows takes {write_s:.2f}s (timed alone); launches "
        f"{launches} ({n_chunks} chunks); rows, genes and ALLELE_PATHS "
        f"equal the numpy pairing; {len(eqtl_ref)} sampled pairs within "
        f"{worst:.3g} of numpy OLS (bound {REF_REL:g}); sub-cohort "
        f"{sub['n_snarls']} snarls: cuda {subs['cuda'][2]:.2f}s, cpu "
        f"{subs['cpu'][2]:.2f}s, {len(subs['cpu'][0])} rows, {len(diffs)} "
        f"statistic strings differ (within {TSV_REL:g})"
        f"{': ' + '; '.join(diffs[:5]) if diffs else ''}; "
        f"max_memory_allocated {memory_note(peak, held)}")
    return launches, wall, write_s, len(rows)


def phase_lmm(torch, paths, sub, work, n_chroms, reference, lmm_note):
    """``vcf -q Y -k K --lmm -c C -C AGE,SEX`` on the card at full size:
    quant_design (with all_rows on every call), ols and student_t on every
    chunk, filter and ALLELE_PATHS of every snarl as the reference's, the
    sampled snarls within REF_REL of the numpy GLS; then CUDA against CPU
    on the sub-cohort (the same samples, kinship and phenotype)."""
    from stoat_tpu_torch import cli, kernels
    from stoat_tpu_torch.pipeline import quantitative as tq

    argv = lmm_cli_args
    n_chunks = n_chunks_of(paths, n_chroms, capped_chunk(paths))
    flags = []
    real = tq.quant_design

    def spy(*a, all_rows=False, **k):
        flags.append(all_rows)
        return real(*a, all_rows=all_rows, **k)
    table, _stats, _eqtl, gls = reference
    tq.quant_design = spy
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc, got = run_captured(cli, argv(paths, os.path.join(
            work, "out_cuda_lmm"), "cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    finally:
        tq.quant_design = real
    check(rc == 0, f"LMM on cuda: exit code {rc}")
    check_launches(launches, dict.fromkeys(LMM_KERNELS, 1), n_chunks,
                   "LMM")
    check(flags == [True] * n_chunks, f"LMM: quant_design all_rows {flags}")
    check(list(got) == list(table), "LMM: snarl order differs")
    for key, (filtered, allele) in table.items():
        check(got[key][:2] == (filtered, allele),
              f"LMM {key}: filtered/allele_paths differ from the reference")
    worst = 0.0
    for key, ref in gls.items():
        e = max(stat_err(name, [got[key][2][QUANT_STATS.index(name)]],
                         [ref[k]], [ref[2]])
                for k, name in enumerate(("p", "beta", "se", "r2")))
        check(e <= REF_REL, f"LMM {key}: {got[key][2]} vs reference {ref} "
              f"(relative {e:.3g})")
        worst = max(worst, e)
    subs, walls = {}, {}
    for device in ("cuda", "cpu"):
        o = os.path.join(work, f"sub_{device}_lmm")
        t1 = time.perf_counter()
        rc, subs[device] = run_captured(cli, argv(sub, o, device))
        walls[device] = time.perf_counter() - t1
        check(rc == 0, f"sub-cohort LMM on {device}")
    n_rows, diffs = compare_quant_tsvs(
        os.path.join(work, "sub_cuda_lmm", "lmm_table_vcf.tsv"),
        os.path.join(work, "sub_cpu_lmm", "lmm_table_vcf.tsv"),
        subs["cuda"], subs["cpu"])
    say(f"phase 4 main path: vcf -q -k --lmm -c -C AGE,SEX on "
        f"{paths['n_samples']} samples x {paths['n_snarls']} snarls "
        f"({lmm_note}): cuda wall {wall:.2f}s; launches {launches} "
        f"({n_chunks} chunks, quant_design with all_rows on each); filter "
        f"and ALLELE_PATHS of all {len(table)} snarls equal the reference; "
        f"{len(gls)} sampled snarls within {worst:.3g} of the numpy GLS "
        f"(bound {REF_REL:g}); sub-cohort {sub['n_snarls']} snarls: cuda "
        f"{walls['cuda']:.2f}s, cpu {walls['cpu']:.2f}s, {n_rows} rows, "
        f"{len(diffs)} statistic strings differ (within {TSV_REL:g})"
        f"{': ' + '; '.join(diffs[:5]) if diffs else ''}; "
        f"max_memory_allocated {memory_note(peak, held)}")
    return launches, wall


# ---------------------------------------------------------------- -T, case 3

# each -T path: its phenotype flags, its tables with their statistic
# columns (None: the binary table, byte for byte) and its kernels
TABLE_PATHS = {
    "q": (lambda p: ["-q", p["quantitative"]],
          (("quantitative_table_vcf.tsv", ("p", "r2", "beta", "se")),),
          QUANT_KERNELS),
    "q_c": (lambda p: ["-q", p["quantitative"], *covar_args(p)],
            (("quantitative_table_vcf.tsv", ("p", "r2", "beta", "se")),),
            QUANT_KERNELS),
    "b_c": (lambda p: ["-b", p["binary"], *covar_args(p)],
            (("binary_table_vcf.tsv", ("p", "beta", "se")),), BC_KERNELS),
    "lmm": (lambda p: ["-q", p["lmm_pheno"], "-k", p["kinship"], "--lmm",
                       *covar_args(p)],
            (("lmm_table_vcf.tsv", ("p", "r2", "beta", "se")),),
            LMM_KERNELS),
    "bq": (lambda p: ["-b", p["binary"], "-q", p["quantitative"]],
           (("binary_table_vcf.tsv", None),
            ("quantitative_table_vcf.tsv", ("p", "r2", "beta", "se"))),
           None),
}
TABLE_TITLES = {"q": "-q", "q_c": "-q -c", "b_c": "-b -c", "lmm": "--lmm",
                "bq": "-b -q"}


def covar_args(p):
    return ["-c", p["covariate"], "-C", ",".join(COVAR_NAMES)]


def table_cli_args(p, out, device, mode, threshold):
    return ["vcf", "-s", p["snarl"], "-v", p["vcf"],
            *TABLE_PATHS[mode][0](p), "-T", threshold, "-o", out,
            "--device", device]


def significant_rows(tsv, threshold):
    """SNARL of each row of a regression TSV whose P string passes the
    threshold (formatting.is_pvalue_significant), in file order."""
    from stoat_tpu_torch.formatting import is_pvalue_significant
    with open(tsv) as fh:
        rows = [line.rstrip("\n").split("\t") for line in fh][1:]
    return [r[3] for r in rows if is_pvalue_significant(float(threshold),
                                                        r[5])]


def regression_files(out):
    d = os.path.join(out, "regression")
    files = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as fh:
            files[name] = fh.read()
    return files


def phase_tables(torch, paths, sub, work, n_chroms):
    """-T on the card.  At full size, ``-q -c`` and ``-b -c`` with
    T_FULL: the table instantiation of quant_design on every chunk (the
    wrapper's ``tables`` flag), one file in regression/ per row whose P
    passes, named by its snarl, each a sample x path table of the used
    samples.  Then on the sub-cohort with T_SUB in five modes, CUDA
    against CPU: the main TSVs (binary byte for byte, regressions under
    phase 4's string rule) and regression/ byte for byte, a file present
    in one only where its P string differs at the threshold.  Returns
    (launches, description lines)."""
    from stoat_tpu_torch import cli, kernels
    from stoat_tpu_torch.pipeline import quantitative as tq
    n_chunks = n_chunks_of(paths, n_chroms, capped_chunk(paths))
    launches, lines = {}, []
    real = tq.quant_design
    for mode in ("q_c", "b_c"):
        flags = []

        def spy(*a, tables=False, **k):
            flags.append(tables)
            return real(*a, tables=tables, **k)
        out = os.path.join(work, f"tables_cuda_{mode}")
        tq.quant_design = spy
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(table_cli_args(paths, out, "cuda", mode, T_FULL))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            tq.quant_design = real
        check(rc == 0, f"-T {T_FULL} {mode}: exit code {rc}")
        got = dict(kernels.LAUNCHES)
        check_launches(got, dict.fromkeys(TABLE_PATHS[mode][2], 1),
                       n_chunks, f"-T {T_FULL} {mode}")
        check(flags == [True] * n_chunks, f"-T {mode}: quant_design tables "
              f"{flags}")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        table = TABLE_PATHS[mode][1][0][0]
        sig = significant_rows(os.path.join(out, table), T_FULL)
        files = regression_files(out)
        check(len(files) == len(sig) and set(files) == {f"{snarl}.tsv"
                                                        for snarl in sig},
              f"-T {mode}: {len(files)} tables for {len(sig)} rows with P "
              f"< {T_FULL}")
        widths = set()
        for data in files.values():
            rows = data.decode().splitlines()
            check(rows[0].startswith("sample_name\t") and len(rows) > 1,
                  f"-T {mode}: a table without rows")
            widths |= {len(r.split("\t")) for r in rows[1:]}
        lines.append(f"{TABLE_TITLES[mode]} -T {T_FULL} cuda wall "
                     f"{wall:.2f}s, quant_design's table view on {n_chunks} "
                     f"of {n_chunks} chunks, {len(files)} tables = rows with "
                     f"P < {T_FULL} (columns per table row "
                     f"{sorted(widths)})")

    for mode, (_, tables, _) in TABLE_PATHS.items():
        outs, got, walls = {}, {}, {}
        for device in ("cuda", "cpu"):
            outs[device] = os.path.join(work, f"tables_sub_{device}_{mode}")
            t0 = time.perf_counter()
            rc, got[device] = run_captured(cli, table_cli_args(
                sub, outs[device], device, mode, T_SUB))
            walls[device] = time.perf_counter() - t0
            check(rc == 0, f"sub-cohort -T {mode} on {device}: exit code "
                  f"{rc}")
        diffs = []
        for table, names in tables:
            a, b = (os.path.join(outs[d], table) for d in ("cuda", "cpu"))
            if names is None:
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    check(fa.read() == fb.read(), f"sub-cohort -T {mode}: "
                          f"{table} differs")
                continue
            diffs += compare_quant_tsvs(
                a, b, got["cuda"], got["cpu"], names,
                P_FLOOR if mode == "b_c" else 0.0)[1]
        files = {d: regression_files(outs[d]) for d in ("cuda", "cpu")}
        for name in set(files["cuda"]) & set(files["cpu"]):
            check(files["cuda"][name] == files["cpu"][name],
                  f"sub-cohort -T {mode}: regression/{name} differs")
        alone = set(files["cuda"]) ^ set(files["cpu"])
        p_moved = {f"{k[1]}.tsv" for k in got["cuda"] for d in diffs
                   if d.startswith(f"{k[0]} {k[1]} p ")}
        check(alone <= p_moved, f"sub-cohort -T {mode}: tables "
              f"{sorted(alone)} in one output only")
        lines.append(f"{TABLE_TITLES[mode]} -T {T_SUB} on the sub-cohort: "
                     f"cuda {walls['cuda']:.2f}s, cpu {walls['cpu']:.2f}s, "
                     f"{len(files['cuda'])} tables byte-identical, "
                     f"{len(diffs)} statistic strings differ (within "
                     f"{TSV_REL:g}){': ' + '; '.join(diffs[:3]) if diffs else ''}")
    return launches, lines


# ------------------------------------------- the command line's remnants

SIM_SNARLS = 8192
SIM_SEED = 7
GAF_REF_ROWS = 1000
BH_SIGNIFICANT = 1e-5
STEP = re.compile(r"([<>])(\d+)")


def write_cohort_gfa(paths, out_dir, seed=0):
    """A GFA for ``vcf -g`` on a ``make_fixture`` cohort, from a seed: a
    node for every node id of the snarl file's paths (the star node 0
    excluded), each of a seeded length of 1 to 32 bases (most of a
    pangenome's nodes are that short), and a reference path a chromosome
    through the first path of each snarl, with its links.  Returns
    {"gfa", "lengths" (node id -> length), "nodes"}."""
    import numpy as np
    rng = np.random.default_rng(seed)
    nodes, walks = set(), {}
    with open(paths["snarl"]) as fh:
        fh.readline()
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            steps = [[int(n) for _, n in STEP.findall(p)]
                     for p in cols[5].split(",")]
            for ids in steps:
                nodes.update(ids)
            first = [n for n in steps[0] if n]
            walk = walks.setdefault(cols[0], [])
            walk += first[1:] if walk and walk[-1] == first[0] else first
    nodes.discard(0)
    ids = sorted(nodes)
    lengths = rng.integers(1, 33, len(ids)).tolist()
    bases = "ACGT" * 9
    os.makedirs(out_dir, exist_ok=True)
    gfa = os.path.join(out_dir, "cohort.gfa")
    with open(gfa, "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        fh.write("".join(f"S\t{n}\t{bases[n % 4:n % 4 + k]}\n"
                         for n, k in zip(ids, lengths)))
        for chrom, walk in walks.items():
            fh.write("".join(f"L\t{u}\t+\t{v}\t+\t0M\n"
                             for u, v in zip(walk, walk[1:])))
            fh.write(f"P\t{chrom}\t" + ",".join(f"{n}+" for n in walk)
                     + "\t*\n")
    return {"gfa": gfa, "lengths": dict(zip(ids, lengths)),
            "nodes": len(ids)}


def gaf_proportions(g0, g1, p):
    """The 0-60 pair of one path, skewed by -log(p): the reference's
    calcul_proportion_signi (gaf_creator.cpp:5-43), written out here."""
    total = g0 + g1
    if total == 0:
        return 0.0, 0.0
    a = g1 / total * 60.0
    b = 60.0 - a
    shift = -math.log(max(p, 1e-20))
    a, b = (a + shift, b - shift) if a > b else (a - shift, b + shift)
    a, b = min(max(a, 0.0), 60.0), min(max(b, 0.0), 60.0)
    if a + b not in (60.0, 0.0):
        scale = 60.0 / (a + b)
        a, b = a * scale, b * scale
    return a, b


def gaf_reference(tsv, snarl_file, lengths, gaf0, gaf1,
                  n_rows=GAF_REF_ROWS, seed=0):
    """The GAF lines of ``n_rows`` random rows of a binary TSV, recomputed
    from the row's P_FISHER, P_CHI2 and GROUP_PATHS, the snarl file's
    paths (split at the star node 0) and the node lengths, against both
    files' lines of those snarls.  Returns the lines compared."""
    import numpy as np
    paths = {}
    with open(snarl_file) as fh:
        fh.readline()
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            paths[(cols[0], cols[4])] = cols[5].split(",")
    with open(tsv) as fh:
        rows = [line.rstrip("\n").split("\t") for line in fh][1:]
    by_snarl = []
    for gaf, tag in ((gaf0, "_G0_"), (gaf1, "_G1_")):
        lines = {}
        with open(gaf) as fh:
            for line in fh:
                name = line[:line.index("\t")]
                lines.setdefault(name[:name.index(tag)], []).append(
                    line.rstrip("\n"))
        by_snarl.append(lines)

    def p_of(s):
        return 1.0 if s in ("NA", "") else float(s)
    pick = np.random.default_rng(seed).choice(
        len(rows), min(n_rows, len(rows)), replace=False)
    compared = 0
    for i in sorted(pick.tolist()):
        chrom, snarl, pf_s, pc_s, groups = (rows[i][0], rows[i][3],
                                            rows[i][5], rows[i][6],
                                            rows[i][7])
        pf, pc = p_of(pf_s), p_of(pc_s)
        pairs = [tuple(int(v) for v in t.split(":", 1))
                 for t in groups.split(",") if ":" in t]
        want = ([], [])
        for (g0, g1), path in zip(pairs, paths[(chrom, snarl)]):
            props = gaf_proportions(g0, g1, pf)
            parts = [[]]
            for orient, nid in STEP.findall(path):
                if nid == "0":
                    parts.append([])
                else:
                    parts[-1].append((orient, nid))
            for part in parts:
                if not part:
                    continue
                sub = "".join(o + n for o, n in part)
                length = sum(lengths.get(int(n), 0) for _, n in part)
                for g, (count, prop) in enumerate(((g0, props[0]),
                                                   (g1, props[1]))):
                    want[g].append(f"{snarl}_G{g}_{count}_F{pf:.6f}_C"
                                   f"{pc:.6f}\t{sub}\t{length}\t{prop:g}")
        for g in (0, 1):
            got = by_snarl[g].get(snarl, [])
            check(got == want[g], f"GAF _{g} of {chrom} {snarl}: "
                  f"{got[:2]} / recomputed {want[g][:2]}")
            compared += len(got)
    return compared


def phase_gaf(torch, paths, work, n_chroms, cohort):
    """``vcf -b -p <cohort GFA> -g`` on the card, then on the CPU: the
    binary table byte for byte phase 4's ``vcf -b`` table, the two GAF
    files byte for byte across the devices, K1-K4 and K5 once a chunk, the
    plain chi-squared tail never, and the GAF lines of GAF_REF_ROWS rows
    recomputed here.  Returns (launches, TSV, line)."""
    from stoat_tpu_torch import cli, kernels
    n_chunks = n_chunks_of(paths, n_chroms)
    real = cli._write_gaf
    walls, gaf_s, out = {}, {}, {}

    def timed(*a, **k):
        t = time.perf_counter()
        real(*a, **k)
        gaf_s[device] = time.perf_counter() - t
    cli._write_gaf = timed
    try:
        for device in ("cuda", "cpu"):
            out[device] = os.path.join(work, f"out_gaf_{device}")
            argv = cli_args(paths, out[device], device) + [
                "-p", cohort["gfa"], "-g"]
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with PlainTailCounter() as lib:
                rc = cli.main(argv)
                if device == "cuda":
                    torch.cuda.synchronize()
            walls[device] = time.perf_counter() - t0
            check(rc == 0, f"vcf -g on {device}: exit code {rc}")
            if device == "cuda":
                launches = dict(kernels.LAUNCHES)
                check_launches(launches, dict.fromkeys(BINARY_KERNELS, 1),
                               n_chunks, "vcf -g")
                check(lib.calls == 0, f"vcf -g called the plain "
                      f"chi-squared tail {lib.calls} times")
    finally:
        cli._write_gaf = real

    def read(*p):
        with open(os.path.join(*p), "rb") as fh:
            return fh.read()
    table = read(work, "out_cuda", "binary_table_vcf.tsv")
    for device in out:
        check(read(out[device], "binary_table_vcf.tsv") == table,
              f"vcf -g on {device}: the binary table differs from phase "
              f"4's vcf -b table")
    sizes = []
    for name in ("binary_table_vcf_0.gaf", "binary_table_vcf_1.gaf"):
        data = read(out["cuda"], name)
        check(data == read(out["cpu"], name), f"{name} differs between "
              f"cuda and cpu")
        n_lines = data.count(b"\n")
        check(n_lines > paths["n_snarls"], f"{name}: {n_lines} lines")
        sizes.append((n_lines, len(data)))
    t0 = time.perf_counter()
    compared = gaf_reference(
        os.path.join(out["cuda"], "binary_table_vcf.tsv"), paths["snarl"],
        cohort["lengths"],
        *(os.path.join(out["cuda"], f"binary_table_vcf_{g}.gaf")
          for g in (0, 1)))
    ref_s = time.perf_counter() - t0
    line = (f"phase 4 vcf -g: vcf -s -v -b -p <cohort GFA> -g on "
            f"{paths['n_samples']} samples x {paths['n_snarls']} snarls, "
            f"GFA of {cohort['nodes']} nodes "
            f"({os.path.getsize(cohort['gfa']) / 1e6:.1f} MB, lengths 1-32 "
            f"from seed 0): cuda wall {walls['cuda']:.2f}s "
            f"(graph load and GAF {gaf_s['cuda']:.2f}s), cpu wall "
            f"{walls['cpu']:.2f}s (graph load and GAF {gaf_s['cpu']:.2f}s);"
            f" binary table byte-identical to phase 4's vcf -b table on "
            f"both devices; binary_table_vcf_0.gaf and _1.gaf "
            f"({sizes[0][0]} and {sizes[1][0]} lines, {sizes[0][1] / 1e6:.1f}"
            f" and {sizes[1][1] / 1e6:.1f} MB) byte-identical cuda and cpu; "
            f"{compared} lines of {GAF_REF_ROWS} random rows equal to their "
            f"recomputation from GROUP_PATHS, P_FISHER and the node lengths "
            f"({ref_s:.1f}s); launches "
            f"{ {k: n for k, n in launches.items() if n} } ({n_chunks} "
            f"chunks; the plain chi-squared tail called 0 times)")
    return launches, os.path.join(out["cuda"], "binary_table_vcf.tsv"), line


def bh_reference(p):
    """Benjamini-Hochberg written out: sort, p * n / rank, the running
    minimum from the largest rank down, clamped at 1, in input order."""
    import numpy as np
    p = np.asarray(p, dtype=np.float64)
    n = p.size
    order = np.argsort(p, kind="stable")
    adj = p[order] * n / np.arange(1, n + 1, dtype=np.float64)
    adj = np.minimum(np.minimum.accumulate(adj[::-1])[::-1], 1.0)
    out = np.empty(n)
    out[order] = adj
    return out


def phase_bhcorrect(work, tsv, what):
    """``BHcorrect -t T -p 7 -a 8`` (P_CHI2 into the GROUP_PATHS column,
    as tests/test_cli_extras.py runs it) on a copy of a binary table: the
    adjusted column is set_precision of bh_reference on the p strings,
    every other cell is unchanged, and top_variant.tsv holds exactly the
    rows below BH_SIGNIFICANT.  Returns a line."""
    from stoat_tpu_torch import cli
    from stoat_tpu_torch.formatting import set_precision
    d = os.path.join(work, f"bh_{what}")
    os.makedirs(d, exist_ok=True)
    copy = os.path.join(d, "binary_table_vcf.tsv")
    shutil.copyfile(tsv, copy)
    with open(copy) as fh:
        before = fh.read().splitlines()
    rows = [line.split("\t") for line in before[1:]]
    adj = bh_reference([1.0 if r[6] in ("NA", "") else float(r[6])
                        for r in rows])
    t0 = time.perf_counter()
    rc = cli.main(["BHcorrect", "-t", copy, "-p", "7", "-a", "8", "-o", d])
    wall = time.perf_counter() - t0
    check(rc == 0, f"BHcorrect exit code {rc}")
    with open(copy) as fh:
        after = fh.read().splitlines()
    check(after[0] == before[0] and len(after) == len(before),
          f"BHcorrect: {len(after)} lines, {len(before)} before")
    want = []
    for r, a in zip(rows, adj.tolist()):
        r = list(r)
        r[7] = set_precision(a)
        want.append("\t".join(r))
    bad = [(g, w) for g, w in zip(after[1:], want) if g != w]
    check(not bad, f"BHcorrect: {len(bad)} rows differ from the numpy "
          f"BH, first {bad[0]}" if bad else "")
    with open(os.path.join(d, "top_variant.tsv")) as fh:
        top = fh.read().splitlines()
    sig = [w for w, a in zip(want, adj.tolist()) if a < BH_SIGNIFICANT]
    check(top == [before[0]] + sig, f"top_variant.tsv: {len(top) - 1} "
          f"rows, {len(sig)} below {BH_SIGNIFICANT:g}")
    return (f"BHcorrect -p 7 -a 8 on {what} ({len(rows)} rows): {wall:.2f}s"
            f", every adjusted string equal to set_precision of the numpy "
            f"BH (smallest {adj.min():.4g}), other cells unchanged, "
            f"top_variant.tsv = the {len(sig)} rows below "
            f"{BH_SIGNIFICANT:g}")


def phase_simulate(torch, work):
    """``simulate -n N_SAMPLES -s SIM_SNARLS --seed 7``, then ``vcf -b`` and
    ``vcf -q`` on its data on the card and on the CPU (the binary table
    byte for byte, the quantitative one by compare_quant_tsvs; each path's
    kernels once a chunk) and ``truth`` on each table, equal across the
    devices.  Returns (launches, binary TSV, line)."""
    import contextlib
    import io
    from stoat_tpu_torch import cli, kernels
    sim = os.path.join(work, "sim")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["simulate", "-n", str(N_SAMPLES), "-s",
                       str(SIM_SNARLS), "--seed", str(SIM_SEED), "-o", sim])
    sim_s = time.perf_counter() - t0
    check(rc == 0, f"simulate exit code {rc}")
    files = dict(line.split("\t") for line in buf.getvalue().splitlines())
    check(sorted(files) == ["binary", "covariate", "quantitative", "snarl",
                            "truth", "vcf"], f"simulate wrote {files}")
    launches, walls, truth, tables = {}, {}, {}, {}
    for flag, kernels_of, table in (
            ("-b", BINARY_KERNELS, "binary_table_vcf.tsv"),
            ("-q", QUANT_KERNELS, "quantitative_table_vcf.tsv")):
        pheno = files["binary" if flag == "-b" else "quantitative"]
        got = {}
        for device in ("cuda", "cpu"):
            out = os.path.join(work, f"sim_{flag[1]}_{device}")
            kernels.reset_launch_counts()
            t1 = time.perf_counter()
            rc, got[device] = run_captured(cli, [
                "vcf", "-s", files["snarl"], "-v", files["vcf"], flag, pheno,
                "-o", out, "--device", device])
            if device == "cuda":
                torch.cuda.synchronize()
                for name, n in kernels.LAUNCHES.items():
                    launches[name] = launches.get(name, 0) + n
                check_launches(kernels.LAUNCHES,
                               dict.fromkeys(kernels_of, 1), 1,
                               f"simulated vcf {flag}")
            walls[(flag, device)] = time.perf_counter() - t1
            check(rc == 0, f"simulated vcf {flag} on {device}: exit {rc}")
            tables[(flag, device)] = os.path.join(out, table)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["truth", "-r", tables[(flag, device)], "-f",
                               files["truth"]])
            check(rc == 0, f"truth exit code {rc}")
            truth[(flag, device)] = buf.getvalue().strip()
            check(truth[(flag, device)].count("\n") == 0,
                  f"truth printed {truth[(flag, device)]!r}")
        check(truth[(flag, "cuda")] == truth[(flag, "cpu")],
              f"truth of simulated vcf {flag}: cuda "
              f"{truth[(flag, 'cuda')]} / cpu {truth[(flag, 'cpu')]}")
        if flag == "-b":
            with open(tables[(flag, "cuda")], "rb") as fa, \
                    open(tables[(flag, "cpu")], "rb") as fb:
                check(fa.read() == fb.read(), "simulated vcf -b: cuda and "
                      "cpu tables differ")
            n_rows, diffs = None, []
        else:
            n_rows, diffs = compare_quant_tsvs(
                tables[(flag, "cuda")], tables[(flag, "cpu")], got["cuda"],
                got["cpu"])
    line = (f"phase 4 simulate: simulate -n {N_SAMPLES} -s {SIM_SNARLS} "
            f"--seed {SIM_SEED} in {sim_s:.1f}s "
            f"({os.path.getsize(files['vcf']) / 1e6:.0f} MB VCF, one chunk); "
            f"vcf -b cuda wall {walls[('-b', 'cuda')]:.2f}s, cpu "
            f"{walls[('-b', 'cpu')]:.2f}s, tables byte-identical; vcf -q "
            f"cuda {walls[('-q', 'cuda')]:.2f}s, cpu "
            f"{walls[('-q', 'cpu')]:.2f}s, {n_rows} rows equal in rows, "
            f"PATH_LENGTHS/ALLELE_PATHS/DEPTH and NA cells, {len(diffs)} "
            f"statistic strings differ (float64 values within rel "
            f"{TSV_REL:g}){': ' + '; '.join(diffs[:5]) if diffs else ''}; "
            f"truth equal across the devices: -b {truth[('-b', 'cuda')]}, "
            f"-q {truth[('-q', 'cuda')]}; launches "
            f"{ {k: n for k, n in launches.items() if n} }")
    return launches, tables[("-b", "cuda")], line


def plot_note():
    """``plot`` is not run here: it is host work (matplotlib, no torch)
    and the card's machine may lack matplotlib."""
    import importlib.util
    found = importlib.util.find_spec("matplotlib") is not None
    return (f"phase 4 plot: not run on the card: plot is host work "
            f"(matplotlib PNGs, no torch, no kernel) and is held to "
            f"stoat_tpu's file names by the CPU tests; matplotlib "
            f"importable here: {found}")


def phase_case3(graph, work):
    """The decomposition alone (``vcf -p G -d G -r CHR``): the snarl file
    and its companion, no kernel launched, no device asked for."""
    from stoat_tpu_torch import cli, kernels
    out = os.path.join(work, "case3")
    chr_file = os.path.join(work, "case3_chr.txt")
    with open(chr_file, "w") as fh:
        fh.write("ref\n")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(["vcf", "-p", graph["gfa"], "-d", graph["gfa"], "-r",
                   chr_file, "-o", out])
    wall = time.perf_counter() - t0
    check(rc == 0, f"case 3: exit code {rc}")
    check(sorted(os.listdir(out)) == ["snarl_analyse.tsv",
                                      "snarl_not_analyse.tsv"],
          f"case 3 wrote {sorted(os.listdir(out))}")
    with open(os.path.join(out, "snarl_analyse.tsv")) as fh:
        n_rows = sum(1 for _ in fh) - 1
    check(n_rows >= graph["n_snarls"], f"case 3: {n_rows} snarls for a "
          f"graph of {graph['n_snarls']}")
    check(not any(kernels.LAUNCHES.values()), f"case 3 launched "
          f"{kernels.LAUNCHES}")
    return (f"phase 4 case 3: vcf -p -d -r on {graph['n_snarls']} snarls "
            f"({2 * graph['n_samples']} haplotype paths): {n_rows} snarls "
            f"in snarl_analyse.tsv in {wall:.2f}s, no kernel launched")


# ---------------------------------------------------------------- the mesh

MESH_SHARDS = 4
BT, QT = "binary_table_vcf.tsv", "quantitative_table_vcf.tsv"
LT, ET = "lmm_table_vcf.tsv", "eqtl_table_vcf.tsv"
BPT, QPT = "binary_permutation_vcf.tsv", "quantitative_permutation_vcf.tsv"


def mesh_runs(paths):
    """The mesh phase's full-size runs: title -> (CLI argv of (out,
    device), phase 4's one-device output directory under ``work``, the
    tables compared, kernels a shard a chunk, kernels a chunk (unsharded:
    eQTL's design), kernels a shard a permutation block, the chunk, -T's
    regression/ compared)."""
    def ones(names):
        return dict.fromkeys(names, 1)
    capped = capped_chunk(paths)
    return {
        "vcf -b": (partial(cli_args, paths), "out_cuda", (BT,),
                   ones(BINARY_KERNELS), {}, {}, 8192, False),
        "vcf -q": (partial(regression_cli_args, paths, mode="q"),
                   "out_cuda_q", (QT,), ones(QUANT_KERNELS), {}, {}, capped,
                   False),
        "vcf -q -c -C AGE,SEX": (
            partial(regression_cli_args, paths, mode="q_c"), "out_cuda_q_c",
            (QT,), ones(QUANT_KERNELS), {}, {}, capped, False),
        "vcf -b -c -C AGE,SEX": (
            partial(regression_cli_args, paths, mode="b_c"), "out_cuda_b_c",
            (BT,), ones(BC_KERNELS), {}, {}, capped, False),
        "vcf -b -q": (partial(dual_cli_args, paths), "out_cuda_dual",
                      (BT, QT), ones(DUAL_KERNELS), {}, {}, 8192, False),
        "vcf -q -k --lmm -c -C AGE,SEX": (
            partial(lmm_cli_args, paths), "out_cuda_lmm", (LT,),
            ones(LMM_KERNELS), {}, {}, capped, False),
        "vcf -e -G -c -C AGE,SEX": (
            partial(eqtl_cli_args, paths), "out_cuda_eqtl", (ET,),
            ones(("eqtl_ols", "student_t")), ones(("quant_design",)), {},
            capped, False),
        f"vcf -q -c -C AGE,SEX -T {T_FULL}": (
            lambda o, d: table_cli_args(paths, o, d, "q_c", T_FULL),
            "tables_cuda_q_c", (QT,), ones(QUANT_KERNELS), {}, {}, capped,
            True),
        f"vcf -b --permutations {PERM_FULL}": (
            lambda o, d: perm_cli_args(paths, o, d, "b", PERM_FULL),
            "perm_cuda_b", (BT, BPT), ones(BINARY_KERNELS), {},
            ones(("chi2_tail", "perm_membership", "perm_binary")), 8192,
            False),
        f"vcf -q --permutations {PERM_FULL}": (
            lambda o, d: perm_cli_args(paths, o, d, "q", PERM_FULL),
            "perm_cuda_q", (QT, QPT), ones(QUANT_KERNELS), {},
            ones(("quant_design", "perm_ols", "student_t")), capped, False),
        f"vcf -b -c -C AGE,SEX --permutations {PERM_FULL}": (
            lambda o, d: perm_cli_args(paths, o, d, "b_c", PERM_FULL),
            "perm_cuda_b_c", (BT, BPT), ones(BC_KERNELS), {},
            ones(("quant_design", "score_precompute", "score_perm",
                  "chi2_tail")), capped, False),
    }


def mesh_sub_runs(sub):
    """The sub-cohort's runs on a mesh of the card and of the CPU: title ->
    (CLI argv of (out, device), phase 4's one-device output directory of
    the same device, tables, -T's regression/ compared, the binary table
    compared across the two meshes byte for byte)."""
    def perm(mode):
        return lambda o, d: perm_cli_args(sub, o, d, mode, PERM_SUB)
    return {
        f"vcf -b --permutations {PERM_SUB}": (
            perm("b"), "perm_sub_{}_b", (BT, BPT), False, True),
        f"vcf -q --permutations {PERM_SUB}": (
            perm("q"), "perm_sub_{}_q", (QT, QPT), False, False),
        f"vcf -q -c --permutations {PERM_SUB}": (
            perm("q_c"), "perm_sub_{}_q_c", (QT, QPT), False, False),
        f"vcf -b -c --permutations {PERM_SUB}": (
            perm("b_c"), "perm_sub_{}_b_c", (BT, BPT), False, False),
        f"vcf -b -q --permutations {PERM_SUB}": (
            perm("bq"), "perm_sub_{}_bq", (BT, QT, BPT, QPT), False, True),
        "vcf --lmm": (partial(lmm_cli_args, sub), "sub_{}_lmm", (LT,), False,
                      False),
        "vcf -e -G": (partial(eqtl_cli_args, sub), "sub_{}_eqtl", (ET,),
                      False, False),
        f"vcf -q -c -T {T_SUB}": (
            lambda o, d: table_cli_args(sub, o, d, "q_c", T_SUB),
            "tables_sub_{}_q_c", (QT,), True, False),
    }


class OneCard:
    """While entered, the CLI's bare ``--device cuda`` runs on one card
    even where several are visible (where the runner's rule would shard
    over them): phases 4 and 5 are one-device runs; phase 6 hands in its
    meshes.  With one card visible it changes nothing."""

    def __enter__(self):
        from stoat_tpu_torch.parallel import mesh
        from stoat_tpu_torch.pipeline import runner
        self.mods = (mesh, runner)
        self.real = mesh.resolve_mesh

        def one_card(device, mesh=None):
            return mesh
        mesh.resolve_mesh = runner.resolve_mesh = one_card
        return self

    def __exit__(self, *exc):
        mesh, runner = self.mods
        mesh.resolve_mesh = runner.resolve_mesh = self.real
        return False


class OnMesh:
    """While entered, the CLI runs its GWAS and its permutation pass on
    ``mesh``: pipeline/runner.py run_vcf_analysis and
    pipeline/permutation.py run_permutation_test, the entry points it
    calls, get ``mesh=mesh``.  ``replicated`` lists the
    parallel/sharded.py Replicated of each run, whose ``uploads`` count
    the copies of the replicated inputs; ``words_bytes`` is the largest
    chromosome's words."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.replicated = []
        self.words_bytes = 0

    def __enter__(self):
        from stoat_tpu_torch.parallel import sharded
        from stoat_tpu_torch.pipeline import permutation, runner
        self.mods = (runner, permutation, sharded)
        self.real = (runner.run_vcf_analysis,
                     permutation.run_permutation_test, sharded.Replicated)
        runner.run_vcf_analysis = partial(self.real[0], mesh=self.mesh)
        permutation.run_permutation_test = partial(self.real[1],
                                                   mesh=self.mesh)
        on = self

        class Seen(self.real[2]):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                on.replicated.append(self)

            def get(self, name, source, make):
                got = super().get(name, source, make)
                if name == "words":
                    on.words_bytes = max(on.words_bytes, got[0].numel()
                                         * got[0].element_size())
                return got
        runner.Replicated = Seen
        sharded.Replicated = Seen
        return self

    def __exit__(self, *exc):
        runner, permutation, sharded = self.mods
        runner.run_vcf_analysis, permutation.run_permutation_test = \
            self.real[:2]
        runner.Replicated = sharded.Replicated = self.real[2]
        return False


def same_files(a, b, what):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        check(fa.read() == fb.read(), f"{what}: {a} differs from {b}")


def same_regression(a, b, what):
    files = regression_files(a)
    check(files and files == regression_files(b), f"{what}: regression/ "
          f"differs ({len(files)} tables)")
    return len(files)


def mesh_chunk(torch, paths, mesh, device):
    """One vcf -b chunk on one device and split over ``mesh``: the
    runner's chunk calls (binary_analyze_chromosome; binary_analyze_sharded)
    bitwise equal, their ms by events (host waits for the results inside),
    device ms of every kernel and copy and of the two kernels alone
    (torch.profiler), and the bound: the sum of binary_from_words' and
    chi2_tail's bounds over the shards' inputs (one shard: the chunk)."""
    import numpy as np
    from stoat_tpu_torch.convert import (chunk_words, pheno_masks, upload,
                                         upload_words)
    from stoat_tpu_torch.io.phenotype import parse_binary_pheno
    from stoat_tpu_torch.io.snarl_file import parse_snarl_path
    from stoat_tpu_torch.io.vcf import VcfReader
    from stoat_tpu_torch.parallel import (binary_analyze_sharded,
                                          shard_packed_chromosome)
    from stoat_tpu_torch.parallel.sharded import Replicated
    from stoat_tpu_torch.pipeline.binary import (binary_analyze_chromosome,
                                                 binary_tables)
    from stoat_tpu_torch.pipeline.packed import (membership_counts,
                                                 tail_mask_words)
    from stoat_tpu_torch.pipeline.runner import iter_chromosome_matrices
    from stoat_tpu_torch.tables import pack_chromosome_chunks

    reader = VcfReader(paths["vcf"])
    samples = reader.samples
    reader.close()
    pheno, _ = parse_binary_pheno(paths["binary"], samples)
    snarls_chr = parse_snarl_path(paths["snarl"])
    gen = iter_chromosome_matrices(paths["vcf"], 2 * len(samples),
                                   snarls_chr)
    chrom, matrix = next(gen)
    packed = pack_chromosome_chunks(snarls_chr[chrom], matrix, 8192)[0]
    gen.close()
    H = packed.n_haplotypes
    host_words = chunk_words(packed)
    W = int(host_words.shape[1])
    words = upload_words(host_words, device)
    masks = pheno_masks(pheno, H, W, device)
    sharded = shard_packed_chromosome(packed.snarls, matrix, len(mesh))
    rep = Replicated(mesh)
    S = packed.n_snarls

    def single():
        return binary_analyze_chromosome(packed, pheno, *THRESHOLDS, device,
                                         words=words, pheno=masks)["p_chi2"]

    def meshed():
        return binary_analyze_sharded(sharded, pheno, mesh, *THRESHOLDS,
                                      replicated=rep)["p_chi2"]
    check(same_bits(single()[:S], meshed()), "one vcf -b chunk: the mesh's "
          "p_chi2 differs from one device's")
    two = re.compile(r"(?<![A-Za-z0-9_])(binary_from_words|chi2_tail|"
                     r"chi2_tail_warp)_kernel\b")
    out = {}
    for what, fn in (("one device", single), ("mesh", meshed)):
        records = profile_records(torch, [fn], f"mesh phase: {what}")
        out[what] = (cuda_ms(fn, 20), per_call_ms(records),
                     per_call_ms(records, pattern=two))

    def bound(tables):
        total = 0.0
        for pidx, valid, sidx in tables:
            pidx, valid, sidx = (upload(np.ascontiguousarray(a), device)
                                 for a in (pidx, valid, sidx))
            tail = upload(tail_mask_words(H, W).view(np.int32), device)
            t = binary_tables(*membership_counts(words, pidx, valid, tail,
                                                 masks[0]),
                              sidx, *THRESHOLDS)
            total += bound_of("binary_from_words", {
                "words": words, "path_idx": pidx, "path_valid": valid,
                "sidx": sidx, "abcd": tuple(t[k] for k in "abcd"),
                "k": t["k"]})[0]
            total += bound_of("chi2_tail", {"stat": t["chi2_stat"],
                                            "df": t["chi2_df"]})[0]
        return total
    out["bound one device"] = bound([(packed.path_edge_idx(),
                                      packed.path_valid,
                                      packed.snarl_path_idx)])
    out["bound mesh"] = bound(zip(sharded.path_idx, sharded.path_valid,
                                  sharded.snarl_path_idx))
    return chrom, S, out


def phase_mesh(torch, device, paths, sub, work, n_chroms):
    """The snarl mesh (parallel/) on the card: the full-size runs of
    ``mesh_runs`` through the CLI with run_vcf_analysis and
    run_permutation_test on a mesh of MESH_SHARDS shards on the first card
    (and, with several visible, on every card), each output byte-identical
    to phase 4's one-device run, every kernel launched shards x chunks
    times (permutation blocks: shards x blocks), the replicated words
    uploaded once a chromosome; ``vcf -b`` again on one device beside its
    mesh run (walls, peak memory); the sub-cohort's runs on a mesh of the
    card and of the CPU, each equal to the same device's one-device run;
    one chunk's time.  Returns (launches over the full-size mesh runs,
    lines, the distinct cards the meshes ran on)."""
    from stoat_tpu_torch import cli, kernels
    from stoat_tpu_torch.parallel import make_snarl_mesh

    meshes = [make_snarl_mesh([device] * MESH_SHARDS)]
    if torch.cuda.device_count() > 1:
        meshes.append(make_snarl_mesh())
    launches, lines = {}, []

    # vcf -b on one device again, beside its mesh run
    out = os.path.join(work, "mesh_single_b")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    check(cli.main(cli_args(paths, out, "cuda")) == 0, "vcf -b: exit code")
    torch.cuda.synchronize()
    single_wall = time.perf_counter() - t0
    single_peak = torch.cuda.max_memory_allocated() - held
    same_files(os.path.join(out, BT), os.path.join(work, "out_cuda", BT),
               "vcf -b again")

    for mesh in meshes:
        shards = len(mesh)
        names = ",".join(str(d) for d in mesh.devices)
        walls = []
        for title, (argv, single_dir, tables, per_shard, per_chunk,
                    per_block, chunk, regression) in mesh_runs(paths).items():
            n_chunks = n_chunks_of(paths, n_chroms, chunk)
            n_blocks = n_chunks_of(paths, n_chroms, 8192 * shards)
            out = os.path.join(work, f"mesh{shards}_{len(lines)}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with OnMesh(mesh) as on, PlainTailCounter() as lib:
                rc = cli.main(argv(out, "cuda"))
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = dict(kernels.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() - held
            check(rc == 0, f"mesh {title}: exit code {rc}")
            check(lib.calls == 0, f"mesh {title}: the plain chi-squared tail "
                  f"called {lib.calls} times")
            for name, n in got.items():
                want = (per_shard.get(name, 0) * shards * n_chunks
                        + per_chunk.get(name, 0) * n_chunks
                        + per_block.get(name, 0) * shards * n_blocks)
                check(n == want, f"mesh {title}: kernel {name} launched {n} "
                      f"times, expected {want} ({shards} shards, {n_chunks} "
                      f"chunks, {n_blocks} permutation blocks)")
                launches[name] = launches.get(name, 0) + n
            # eQTL's design runs unsharded, on the mesh's first device
            words = [r.uploads.get("words", 0) for r in on.replicated]
            check(per_chunk or words and all(
                n == n_chroms * len(mesh.distinct) for n in words),
                  f"mesh {title}: the words uploaded {words} times a run, "
                  f"expected once a chromosome a device")
            for table in tables:
                same_files(os.path.join(out, table),
                           os.path.join(work, single_dir, table),
                           f"mesh {title}")
            n_tables = (same_regression(out, os.path.join(work, single_dir),
                                        f"mesh {title}") if regression
                        else None)
            walls.append(f"{title} {wall:.2f}s"
                         + (f" ({n_tables} -T tables)" if n_tables else ""))
            if title == "vcf -b":
                line = (f"phase 6 mesh of {shards} shards ({names}): vcf -b "
                        f"LAUNCHES binary_from_words "
                        f"{got['binary_from_words']}, chi2_tail "
                        f"{got['chi2_tail']} = {shards} shards x "
                        f"{n_chunks} chunks; cuda wall {wall:.2f}s against "
                        f"{single_wall:.2f}s on one device; "
                        f"max_memory_allocated {peak / 1e6:.1f} MB against "
                        f"{single_peak / 1e6:.1f} MB, the words "
                        f"({on.words_bytes / 1e6:.1f} MB a chromosome) held "
                        f"once a device ({words[0]} uploads, {n_chroms} "
                        f"chromosomes)")
                # the words held once: a second copy of a chromosome's
                # words (one left from the chromosome before, or one a
                # shard) adds a whole words' bytes
                check(peak < single_peak + on.words_bytes // 2,
                      f"mesh vcf -b: peak {peak} bytes against {single_peak} "
                      f"on one device, more than half a chromosome's words "
                      f"({on.words_bytes} bytes) over it")
                lines.append(line)
            shutil.rmtree(out, ignore_errors=True)
        lines.append(f"phase 6 mesh of {shards} shards ({names}): every "
                     f"output byte-identical to phase 4's one-device run, "
                     f"every kernel launched shards x chunks (permutation "
                     f"blocks of {8192 * shards} snarls: shards x blocks), "
                     f"the plain chi-squared tail never; cuda walls: "
                     + ", ".join(walls))

    # the sub-cohort on a mesh of the card and of the CPU
    parts = []
    for title, (argv, single_dir, tables, regression, across) in \
            mesh_sub_runs(sub).items():
        outs = {}
        for dev in ("cuda", "cpu"):
            mesh = make_snarl_mesh([dev if dev == "cpu" else device]
                                   * MESH_SHARDS)
            outs[dev] = os.path.join(work, f"mesh_sub_{dev}_{len(parts)}")
            t0 = time.perf_counter()
            with OnMesh(mesh):
                rc = cli.main(argv(outs[dev], dev))
            check(rc == 0, f"sub-cohort mesh {title} on {dev}: exit code")
            for table in tables:
                same_files(os.path.join(outs[dev], table),
                           os.path.join(work, single_dir.format(dev), table),
                           f"sub-cohort mesh {title} on {dev}")
            if regression:
                same_regression(outs[dev],
                                os.path.join(work, single_dir.format(dev)),
                                f"sub-cohort mesh {title} on {dev}")
            outs[dev] = (outs[dev], time.perf_counter() - t0)
        if across:
            same_files(os.path.join(outs["cuda"][0], BT),
                       os.path.join(outs["cpu"][0], BT),
                       f"sub-cohort mesh {title}: cuda against cpu")
        parts.append(f"{title} cuda {outs['cuda'][1]:.2f}s, cpu "
                     f"{outs['cpu'][1]:.2f}s")
    lines.append(f"phase 6 mesh on the sub-cohort ({sub['n_samples']} x "
                 f"{sub['n_snarls']} snarls, {MESH_SHARDS} shards on the "
                 f"card and on the CPU): each output byte-identical to the "
                 f"same device's one-device run of phase 4, so the CPU mesh "
                 f"holds to the card's mesh as phase 4's CPU runs to the "
                 f"card's (binary tables byte for byte: checked directly); "
                 + "; ".join(parts))

    chrom, S, t = mesh_chunk(torch, paths, meshes[0], device)

    def ms(v):
        return "not measured" if v is None else f"{v:.4f} ms"
    a, b = t["one device"], t["mesh"]
    lines.append(
        f"phase 6 mesh: one vcf -b chunk ({chrom}, {S} snarls), the "
        f"runner's chunk call with its uploads and host copies, p_chi2 "
        f"bitwise equal: one device {a[0]:.4f} ms by events, device "
        f"{ms(a[1])} (binary_from_words + chi2_tail {ms(a[2])}), bound "
        f"{t['bound one device']:.4f} ms; {MESH_SHARDS} shards on {device}: "
        f"{b[0]:.4f} ms by events, device {ms(b[1])} (kernels {ms(b[2])}), "
        f"bound {t['bound mesh']:.4f} ms (the sum of the shards' "
        f"binary_from_words and chi2_tail bounds)")
    cards = {d for mesh in meshes for d in mesh.devices}
    return launches, lines, cards


# ---------------------------------------------------------------- bounds

def cf_iteration_counts(t1, df):
    """Continued-fraction iterations of the Student-t tail of each |t1| on
    df (the loop of stats/special.py _betainc_continued_fraction, in numpy:
    the data-dependent work of student_t.cu), and whether each element
    takes the mirrored fraction (b, a, 1 - x): (counts, mirrored).  Only
    the elements still running are iterated."""
    import numpy as np
    t1 = np.abs(np.asarray(t1, np.float64)).ravel()
    df = np.asarray(df, np.float64).ravel()
    fin = np.isfinite(t1)
    a0, b0 = df * 0.5, np.full_like(df, 0.5)
    with np.errstate(all="ignore"):
        x0 = df / (df + t1 * t1)
    rapid = x0 < (a0 + 1.0) / (a0 + b0 + 2.0)
    half = np.finfo(np.float64).eps / 2
    iters = np.zeros(t1.shape, np.int64)
    idx = np.nonzero(fin)[0]
    a = np.where(rapid, a0, b0)[idx]
    b = np.where(rapid, b0, a0)[idx]
    x = np.where(rapid, x0, 1.0 - x0)[idx]
    c = np.full_like(x, half)
    d = np.zeros_like(x)
    with np.errstate(all="ignore"):
        for n in range(1, 600):
            if not idx.size:
                break
            if n == 1:
                num = np.ones_like(x)
            else:
                m = float((n - 1) // 2)
                if n % 2 == 0:
                    num = (-(a + b) * x / (a + 1.0) if m == 0 else
                           -(a + m) * (a + b + m) * x
                           / ((a + 2 * m) * (a + 2 * m + 1.0)))
                else:
                    num = m * (b - m) * x / ((a + 2 * m - 1.0) * (a + 2 * m))
            c = 1.0 + num / c
            c = np.where(np.abs(c) < half, half, c)
            d = 1.0 + num * d
            d = 1.0 / np.where(np.abs(d) < half, half, d)
            iters[idx] += 1
            go = np.abs(c * d - 1.0) >= half
            idx, a, b, x, c, d = (v[go] for v in (idx, a, b, x, c, d))
    return iters, ~rapid & fin


def cf_iterations(t1, df):
    """The sum of :func:`cf_iteration_counts`: K10's data-dependent work."""
    return int(cf_iteration_counts(t1, df)[0].sum())


def fisher_steps(a, b, c, d):
    """Steps of Fisher's scan per 2x2 table (fisher_device.cuh, the plain
    version's three walks transcribed): one ratio and one multiply into
    the relative probability each, phases 1 and 2 (the right tail) and 3
    (the left).  A table with a zero margin takes none.  This is the
    data-dependent work of K4 and K6 (int64 [N])."""
    import numpy as np
    m11, m12, m21, m22 = (np.asarray(v, np.float64).copy() for v in
                          (a, b, c, d))
    na = ((m11 + m12) == 0) | ((m21 + m22) == 0) | ((m11 + m21) == 0) \
        | ((m12 + m22) == 0) | np.isnan(m11 + m12 + m21 + m22)
    m12, m21 = np.minimum(m12, m21), np.maximum(m12, m21)
    m11, m22 = np.minimum(m11, m22), np.maximum(m11, m22)
    swap = (m11 * m22) > (m12 * m21)
    m11, m12 = np.where(swap, m12, m11), np.where(swap, m11, m12)
    m21, m22 = np.where(swap, m22, m21), np.where(swap, m21, m22)
    bias, dbl_max = 1.0339757656912846e-25, np.finfo(np.float64).max
    tprob0 = (1.0 - 9.094947017729282e-13) * bias
    steps = np.zeros(m11.shape, np.int64)
    with np.errstate(all="ignore"):
        # phases 1 and 2: the right tail
        c11, c12, c21, c22 = m11.copy(), m12.copy(), m21.copy(), m22.copy()
        prob = np.full(m11.shape, tprob0)
        cprob = np.zeros(m11.shape)
        tprob = np.full(m11.shape, tprob0)
        phase2 = np.zeros(m11.shape, bool)
        overflowed = np.zeros(m11.shape, bool)
        run = ~na & (c12 > 0.5)
        while run.any():
            c11 = np.where(run, c11 + 1.0, c11)
            c22 = np.where(run, c22 + 1.0, c22)
            pn = prob * ((c12 * c21) / (c11 * c22))
            c12 = np.where(run, c12 - 1.0, c12)
            c21 = np.where(run, c21 - 1.0, c21)
            steps += run
            one, two = run & ~phase2, run & phase2
            ovf = ~np.isfinite(pn) | (pn > dbl_max)
            und = pn < bias
            nxt = tprob + pn
            stalled = nxt <= tprob
            tprob = np.where((one & und) | two, nxt, tprob)
            cprob = np.where(one & ~(und | ovf), cprob + pn, cprob)
            prob = np.where(run, pn, prob)
            overflowed |= one & ovf
            # phase 2 only after a fall below the bias, and never when
            # phase 1 ended with cprob == 0 (the p-value is 1)
            phase2 = phase2 | (one & und & ~ovf & (cprob != 0.0))
            run = run & ~(one & (ovf | (und & (cprob == 0.0)))) \
                & ~(two & stalled) & (c12 > 0.5)
        early = na | overflowed | (cprob == 0.0)
        # phase 3: the left tail, a do-while
        c11, c12, c21, c22 = m11.copy(), m12.copy(), m21.copy(), m22.copy()
        prob = np.full(m11.shape, tprob0)
        run = ~early & (m11 > 0.0)
        while run.any():
            c12 = np.where(run, c12 + 1.0, c12)
            c21 = np.where(run, c21 + 1.0, c21)
            pn = prob * ((c11 * c22) / (c12 * c21))
            c11 = np.where(run, c11 - 1.0, c11)
            c22 = np.where(run, c22 - 1.0, c22)
            steps += run
            nxt = tprob + pn
            stalled = nxt <= tprob
            tprob = np.where(run, nxt, tprob)
            prob = np.where(run, pn, prob)
            run = run & ~stalled & (c11 > 0.5)
    return steps


def kernel_work(name, x):
    """(bytes, operations, kind) of one call of kernel ``name`` on phase 5's
    inputs ``x``: each input read once, each output written once, and the
    operations these inputs need (float64 flops or int32 ops)."""
    import numpy as np
    f8, i4 = 8, 4
    if name in ("membership_counts", "perm_membership"):
        w, idx, valid = x["words"], x["path_idx"], x["path_valid"]
        rows = np.unique(to_np(idx)).size
        W = w.shape[1]
        P, K = idx.shape
        out = 2 * P * f8 if name == "membership_counts" else P * (W + 1) * i4
        ops = P * K * W + (2 if name == "membership_counts" else 1) * P * W
        return rows * W * i4 + P * K * i4 + P + 2 * W * i4 + out, \
            2 * ops, "int32"
    # Fisher's scan: 12 float64 operations a step (the counters' four adds,
    # two products, the ratio, the multiply into prob, the add, the tests)
    # over the steps these tables take (fisher_steps)
    if name == "binary_tables":
        S, Pmax = x["sidx"].shape
        paths = np.unique(to_np(x["sidx"])).size
        return (2 * paths * f8 + S * Pmax * i4
                + S * Pmax * (1 + 2 * f8) + S * (2 + i4 + 6 * f8)), \
            40 * S * Pmax, "float64"
    if name == "fisher":
        S = x["abcd"][0].shape[0]
        return 5 * S * f8, 12 * int(fisher_steps(*map(
            to_np, x["abcd"])).sum()), "float64"
    if name == "binary_stats":
        # K3's inputs, the fused outputs (three float64 and three flag
        # rows, g0, g1 and keep), and the scan on the k == 2 tables only
        S, Pmax = x["sidx"].shape
        paths = np.unique(to_np(x["sidx"])).size
        two = to_np(x["k"]) == 2
        abcd = [to_np(v)[two] for v in x["abcd"]]
        return (2 * paths * f8 + S * Pmax * i4
                + S * Pmax * (1 + 2 * f8) + S * (3 + 3 * f8)), \
            40 * S * Pmax + 12 * int(fisher_steps(*abcd).sum()), "float64"
    if name == "binary_from_words":
        # K1+K2's distinct rows of the valid paths (each input read once),
        # the rows, flags, masks and snarl_path_idx, binary_stats'
        # outputs; K1+K2's ANDs and popcounts counted with the table's and
        # the scan's operations at the float64 peak, the card's fastest of
        # their rates (the bytes bound the call either way)
        w, idx, valid = x["words"], to_np(x["path_idx"]), \
            to_np(x["path_valid"])
        W = w.shape[1]
        P, K = idx.shape
        rows = np.unique(idx[valid]).size
        S, Pmax = x["sidx"].shape
        two = to_np(x["k"]) == 2
        abcd = [to_np(v)[two] for v in x["abcd"]]
        return (rows * W * i4 + P * K * i4 + P + 2 * W * i4
                + S * Pmax * i4 + S * Pmax * (1 + 2 * f8)
                + S * (3 + 3 * f8)), \
            2 * (int(valid.sum()) * K * W + 2 * int(valid.sum()) * W) \
            + 40 * S * Pmax + 12 * int(fisher_steps(*abcd).sum()), "float64"
    if name == "graph_stats":
        # the counts and mask read, p22, pf and pn written; the scan on
        # every row, the statistics and both tails' igammac on the
        # elements their masks leave
        from stoat_tpu_torch.stats.chi2 import chi2_2x2_stat, chi2_2xn_stat
        G0, G1 = to_np(x["G0"]), to_np(x["G1"])
        B, Pm = G0.shape
        cols = [x["G0"][:, 0], x["G0"][:, 1], x["G1"][:, 0], x["G1"][:, 1]]
        stat, inv, zexp = (to_np(v) for v in chi2_2x2_stat(*cols))
        statn, dfn, invn = (to_np(v) for v in chi2_2xn_stat(
            x["G0"], x["G1"], x["mask"]))
        live, live_n = ~(inv | zexp), ~invn
        return (B * Pm * (2 * i4 + 1) + 3 * B * f8), \
            12 * int(fisher_steps(G0[:, 0], G0[:, 1], G1[:, 0],
                                  G1[:, 1]).sum()) + 40 * B * Pm \
            + igammac_operations(stat[live], np.ones(int(live.sum()))) \
            + igammac_operations(statn[live_n], dfn[live_n]), "float64"
    if name == "quant_design":
        # with the table view, norm [S, N, Pmax] and kept [S, Pmax] too
        S, N, PT = x["X_out"].shape
        w, idx = x["words"], x["path_idx"]
        rows = np.unique(to_np(idx)).size
        Pmax = x["sidx"].shape[1]
        tables = S * Pmax * (N * f8 + 1) if x.get("tables") else 0
        return (rows * w.shape[1] * i4 + idx.numel() * i4
                + x["sidx"].numel() * i4 + x["covar"].numel() * f8
                + S * N * PT * f8 + S * N + S * (3 + Pmax) * i4 + tables
                ), 4 * S * N * Pmax, "float64"
    if name == "ols":
        # X, the mask (none for the mixed model's designs) and the phenotype
        # row, or y_rows rows of y
        S, N, P = x["X"].shape
        mask = S * N if x.get("mask", True) else 0
        return (S * N * P * f8 + mask + x.get("y_rows", 1) * N * f8
                + S * i4 + 5 * S * f8), \
            S * N * (P * (P + 1) + 2 * P + 2 * P + 6), "float64"
    if name == "student_t":
        # t1 and df read and p written; with the NA masking the degenerate
        # flags, beta, se and r2 read and written too
        S = x["t1"].numel()
        nbytes = 10 * S * f8 + S if x.get("masks", True) else 3 * S * f8
        return nbytes, \
            20 * cf_iterations(to_np(x["t1"]), to_np(x["df"])) + 60 * S, \
            "float64"
    if name == "logreg":
        S, N, P = x["X"].shape
        steps = float(np.asarray(x["iters"]).sum())
        return S * N * (P * f8 + f8 + 1) + S * (i4 + 1) + 3 * S * f8, \
            steps * N * (P * (P + 1) + 4 * P + 30), "float64"
    if name == "perm_binary":
        # the case counts as a 0/1 product at the int8 tensor-core rate
        # (the binary AND + POPC rate the kernel runs at is not published):
        # a multiply and an add per (real path, mask, haplotype bit)
        P, W = x["mem"].shape
        K = x["masks"].shape[0]
        S, Pmax = x["sidx"].shape
        real = int((to_np(x["sidx"]) >= 0).sum())
        return (P * W * i4 + P * i4 + K * W * i4 + S * Pmax * i4
                + K * S * (2 * f8 + 1)), 2 * K * real * 32 * W, "int8"
    if name == "perm_ols":
        S, N, P = x["X"].shape
        K = x["phenos"].shape[0]
        return (S * N * (P * f8 + 1) + S * i4 + K * N * f8
                + 2 * K * S * f8), \
            S * N * P * (P + 1) + K * S * N * (4 * P + 3), "float64"
    if name == "score_precompute":
        S, N, PT = x["X"].shape
        C1 = x["Z"].shape[1]
        return (2 * S * N * PT * f8 + S * N + S * (i4 + 1) + N * (C1 + 1)
                * f8 + S * PT * PT * f8 + S * (f8 + 1)), \
            3 * S * N * (PT * (PT + 1) // 2 + PT * C1
                         + C1 * (C1 + 1) // 2), "float64"
    if name == "score_perm":
        S, N, PT = x["D"].shape
        K = x["e"].shape[0]
        return (S * N * (PT * f8 + 1) + S * PT * PT * f8 + K * N * f8
                + K * S * f8), K * S * (2 * N * PT + 2 * PT * PT + 2 * PT), \
            "float64"
    if name == "eqtl_ols":
        # pass 1 only on the snarls with pairs; per pair X^T y and the sum
        # of y (2 N (P + 1)), then the residual and total sums of squares
        # (N (2 P + 5))
        S, N, P = x["X"].shape
        B, G, S1 = x["n_pairs"], x["expr"].shape[0], x["n_with"]
        return (S * N * (P * f8 + 1) + S * i4 + (S + 1) * i4 + B * i4
                + G * N * f8 + 5 * B * f8), \
            S1 * N * P * (P + 1) + B * N * (4 * P + 7), "float64"
    if name == "chi2_tail":
        # stat and df (the score test's [S] once) read, the two masks read
        # where given, p written
        stat, df = to_np(x["stat"]), to_np(x["df"])
        masks = 2 * stat.size if x.get("masks", True) else 0
        return stat.size * 2 * f8 + df.size * f8 + masks, \
            igammac_operations(stat, np.broadcast_to(df, stat.shape)), \
            "float64"
    if name == "lmm_gemm":
        # rot [N, N] @ X laid out [N, S * PT]: read both, write the product
        S, N, PT = x["X"].shape
        return N * N * f8 + 2 * S * N * PT * f8, 2 * N * N * S * PT, \
            "float64"
    raise KeyError(name)


# igammac's operations (chi2_tail_device.cuh, JAX's igammac): per iteration
# of the power series (an add, two divisions, a multiply, an add and the
# test) and of the continued fraction (three adds and five multiplies and
# subtracts for p_k, q_k, two divisions, the select and the rescale test),
# and per element for the prefactor (a log, an exp and XLA's lgamma, its
# eight Lanczos quotients and two logarithms, counted at 20 an elementary
# function) and the masks
IGAM_SERIES_OPS = 6
CF_OPS = 16
ELEMENT_OPS = 150


def igammac_counts(stat, df):
    """Per element of chi2_tail's igammac (JAX's, chi2_tail_device.cuh):
    (branch, iterations), branch 0 for an element that runs no loop (a
    mask, an underflowing prefactor), 1 for the power series, 2 for the
    continued fraction, and the iterations of its loop, run in numpy until
    it stops as the kernel's does (the data-dependent work; only the
    elements still running are iterated)."""
    import numpy as np
    from scipy.special import gammaln
    eps = np.finfo(np.float64).eps
    a = (np.asarray(df, np.float64) * 0.5).ravel()
    x = (np.asarray(stat, np.float64) * 0.5).ravel()
    with np.errstate(all="ignore"):
        domain = (x < 0) | (a < 0) | ((a == 0) & (x == 0)) | np.isnan(a) \
            | np.isnan(x)
        ax = a * np.log(x) - x - gammaln(a)
        live = ~(domain | (ax < -np.log(np.finfo(np.float64).max))
                 | (x == np.inf) | (a == 0))
        series = live & ((x < 1) | (x < a))
        branch = np.where(series, 1, np.where(live, 2, 0))
        iters = np.zeros(a.shape, np.int64)
        idx = np.nonzero(series)[0]
        xx, r = x[idx], a[idx].copy()
        c, ans = np.ones_like(r), np.ones_like(r)
        while idx.size:
            iters[idx] += 1
            r = r + 1.0
            c = c * (xx / r)
            ans = ans + c
            go = c / ans > eps
            idx, xx, r, c, ans = (v[go] for v in (idx, xx, r, c, ans))
        idx = np.nonzero(branch == 2)[0]
        xx = x[idx]
        y = 1.0 - a[idx]
        z = xx + y + 1.0
        pkm2, qkm2 = np.ones_like(xx), xx.copy()
        pkm1, qkm1 = xx + 1.0, z * xx
        ans = pkm1 / qkm1
        for k in range(1, 2001):
            if not idx.size:
                break
            iters[idx] += 1
            y, z = y + 1.0, z + 2.0
            yc = y * k
            pk = pkm1 * z - pkm2 * yc
            qk = qkm1 * z - qkm2 * yc
            rr = pk / qk
            t = np.where(qk != 0, np.abs((ans - rr) / rr), 1.0)
            ans = np.where(qk != 0, rr, ans)
            scale = np.where(np.abs(pk) > 1.0 / eps, eps, 1.0)
            pkm2, qkm2 = pkm1 * scale, qkm1 * scale
            pkm1, qkm1 = pk * scale, qk * scale
            go = t > eps
            idx, xx, y, z, pkm1, qkm1, pkm2, qkm2, ans = (
                v[go] for v in (idx, xx, y, z, pkm1, qkm1, pkm2, qkm2, ans))
    return branch, iters


def igammac_operations(stat, df):
    """Floating-point operations of chi2_tail's igammac on these inputs:
    each element's prefactor and masks, and the iterations of its loop
    (:func:`igammac_counts`)."""
    import numpy as np
    branch, iters = igammac_counts(stat, df)
    return float(ELEMENT_OPS * branch.size
                 + IGAM_SERIES_OPS * iters[branch == 1].sum()
                 + CF_OPS * iters[branch == 2].sum())


def bound_of(name, x):
    """(bound_ms, bound_by): the larger of bytes over the card's memory
    rate and operations over its peak rate for their type."""
    nbytes, ops, kind = kernel_work(name, x)
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAKS[kind]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# torch.profiler on the card's machine loses device records: at full size
# a lone window of 5 quant_design calls keeps 3 or 4 of their records, of
# 5 GEMMs with their 10 copies 13 or 14 (the first records of the window;
# a reading that takes such a window as whole is low by 1/5 to 2/5), and
# once a window kept none.  Each window opens with LEAD_SPINS launches of
# torch.cuda._sleep's spin_kernel, left out of every sum; a time a call
# is each kernel's mean record times its launches a call (per_call_ms); a
# window in which a kernel asked for has no record is run again, up to
# PROFILE_TRIES times; PROFILE_LOG keeps each window that was not whole.
PROFILE_REPS = 5
PROFILE_TRIES = 4
LEAD_SPINS = 4
SPIN = re.compile(r"(?<![A-Za-z0-9_])spin_kernel\b")
PROFILE_LOG = []


def profile_window(torch, fns, reps=PROFILE_REPS, lead=LEAD_SPINS):
    """One torch.profiler window: ``lead`` spins, then ``reps`` calls of
    each of ``fns``: ({kernel name: (device records, device us)} but the
    spins, spin records kept)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            torch.cuda._sleep(1000)
        for fn in fns:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    if not len(averages):
        return {}, 0
    key = ("self_device_time_total"
           if hasattr(averages[0], "self_device_time_total")
           else "self_cuda_time_total")
    records, spins = {}, 0
    for e in averages:
        if e.device_type != DeviceType.CUDA:
            continue
        if SPIN.search(e.key):
            spins += e.count
            continue
        n, us = records.get(e.key, (0, 0.0))
        records[e.key] = (n + e.count, us + getattr(e, key))
    return records, spins


def profile_records(torch, fns, what, reps=PROFILE_REPS, patterns=()):
    """The records of a window over ``fns`` (after one untimed call of
    each) in which every one of ``patterns`` (or, with none, any kernel)
    has a record, or of the last of PROFILE_TRIES windows."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        records, spins = profile_window(torch, fns, reps)
        whole = spins == LEAD_SPINS and all(
            n % reps == 0 for n, _ in records.values())
        found = all(any(p.search(k) for k in records) for p in patterns) \
            if patterns else bool(records)
        if not whole or not found:
            PROFILE_LOG.append((what, attempt, spins, {
                k: n for k, (n, _) in records.items()}))
        if found:
            break
    return records


def per_call_ms(records, reps=PROFILE_REPS, pattern=None):
    """Device ms a call from a window's records (those whose name
    ``pattern`` matches): each kernel's mean record times its launches a
    call, ceil(records / reps) (the sum over ``reps`` on whole calls);
    None where no record matches."""
    us = sum(t / n * -(-n // reps) for name, (n, t) in records.items()
             if n and (pattern is None or pattern.search(name)))
    return us / 1e3 if us else None


def device_total_ms(torch, fn, reps=PROFILE_REPS, what="a call"):
    """Device time per call of ``fn`` under torch.profiler, summed over
    every kernel and copy it launches (library kernels have no name of
    ours)."""
    return per_call_ms(profile_records(torch, [fn], what, reps), reps)


def cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phases

def phase_card(torch):
    from stoat_tpu_torch.kernels import build
    smi = nvidia_smi_line()
    say(smi)
    t0 = time.perf_counter()
    build.build_all(SOURCES)                # one nvcc per source, together
    summaries = []
    for name in SOURCES:
        build.load(name)
        info = build.BUILD_LOG[name]
        regs = re.findall(r"Used (\d+) registers", info.ptxas)
        spills = re.findall(r"(\d+) bytes spill stores", info.ptxas)
        summaries.append(f"{name} {info.seconds:.1f}s regs={','.join(regs)}"
                         f" spill_stores={','.join(spills) or '0'}")
    build_s = time.perf_counter() - t0
    say(f"phase 1 card: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda} | nvcc build "
        f"{build_s:.1f}s: " + "; ".join(summaries))
    return smi


def phase_native():
    """Builds (g++ at once, one each) and loads the VCF core, the graph
    core and the single-core baseline under their host-keyed names."""
    from concurrent.futures import ThreadPoolExecutor
    from stoat_tpu_torch import native
    from stoat_tpu_torch.native import baseline
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:   # three g++ at once
        jobs = [pool.submit(native.get_lib), pool.submit(native.get_graph_lib),
                pool.submit(baseline.get_baseline_lib)]
        try:
            lib, glib, blib = (f.result() for f in jobs)
        except native.NativeBuildError as e:
            raise SmokeFailure(f"the baseline core did not build: {e}")
    for got, src, libs, what in (
            (lib, native._SRC, native._CORE_LIBS, "native core"),
            (glib, native._GRAPH_SRC, (), "native graph core"),
            (blib, baseline.BASELINE_SRC, baseline.BASELINE_LIBS,
             "baseline core")):
        check(got is not None, f"{what} failed to build or load")
        path = native.library_path(src, libs)
        check(os.path.samefile(got._name, path)
              and os.path.dirname(path) == native.BUILD_DIR,
              f"{what} loaded from {got._name}, expected {path}")
    say(f"phase 2 native cores: {os.path.basename(lib._name)}, "
        f"{os.path.basename(glib._name)} and the single-core baseline "
        f"{os.path.basename(blib._name)} in {native.BUILD_DIR} built and "
        f"loaded in {time.perf_counter() - t0:.1f}s")


def main_path_chunks(paths, device):
    """The first chunk of the first chromosome, as the main paths build it,
    on the card: the binary DeviceChunk, the quantitative one (the same
    words, no masks), the quantitative phenotype [N] and the AGE and SEX
    covariates [N, 2], H, the binary phenotype as ``vcf -b -c`` feeds
    it to the logistic model (float64 [N]), and (chromosome, host chunk)
    of that chunk.  (The chunk cap of ``-q`` and ``-b -c``, 2e9 // (N * 96) =
    8,319 at N = 2,504, leaves the chunk at 8,192.)"""
    from stoat_tpu_torch.io.phenotype import (parse_binary_pheno,
                                              parse_covariates,
                                              parse_quantitative_pheno)
    from stoat_tpu_torch.io.snarl_file import parse_snarl_path
    from stoat_tpu_torch.io.vcf import VcfReader
    from stoat_tpu_torch.tables import pack_chromosome_chunks
    from stoat_tpu_torch.convert import (to_binary_pheno, to_device_chunk,
                                         to_quant_inputs)
    from stoat_tpu_torch.pipeline.runner import iter_chromosome_matrices

    reader = VcfReader(paths["vcf"])
    samples = reader.samples
    reader.close()
    covar = parse_covariates(paths["covariate"], COVAR_NAMES, samples)
    pheno_q = parse_quantitative_pheno(paths["quantitative"], samples)
    pheno, _ = parse_binary_pheno(paths["binary"], samples)
    snarls_chr = parse_snarl_path(paths["snarl"])
    gen = iter_chromosome_matrices(paths["vcf"], 2 * len(samples),
                                   snarls_chr)
    chrom, matrix = next(gen)
    packed = pack_chromosome_chunks(snarls_chr[chrom], matrix, 8192)[0]
    chunk = to_device_chunk(packed, pheno, device)
    qchunk = to_device_chunk(packed, None, device, words=chunk.words)
    qpheno, qcovar = to_quant_inputs(pheno_q, covar, len(samples), device)
    gen.close()
    return (chunk, qchunk, qpheno, qcovar, packed.n_haplotypes,
            to_binary_pheno(pheno, device), (chrom, packed))


def phase_kernels(torch, device, chunks, err, graph):
    chunk, qchunk, qpheno, qcovar, H, case = chunks[:6]
    args = (chunk.words, chunk.path_idx, chunk.path_valid, chunk.tail,
            chunk.g1_words)
    g0p, g1p = compare_membership(args, err)
    tables = compare_tables(g0p, g1p, chunk.snarl_path_idx, (3, 5, 0.05),
                            err)
    abcd = (tables["a"], tables["b"], tables["c"], tables["d"])
    compare_fisher(abcd, err)
    compare_binary_stats(g0p, g1p, chunk.snarl_path_idx, (3, 5, 0.05), err,
                         "main chunk")
    variants = from_words_variants(chunk)
    for what, fargs, fsidx in variants:
        compare_binary_from_words(fargs, fsidx, (3, 5, 0.05), err, what)
    shapes = (f"words {tuple(chunk.words.shape)}, path_idx "
              f"{tuple(chunk.path_idx.shape)}, snarl_path_idx "
              f"{tuple(chunk.snarl_path_idx.shape)}")
    edges = edge_cases(device, err)
    tails = compare_chi2_tail(torch, device, tables, err)
    torch.cuda.synchronize()
    say(f"phase 3 kernels vs plain: main-path shapes ({shapes}) ok; "
        f"binary_from_words on "
        + ", ".join(what for what, _, _ in variants)
        + f"; {edges}; tolerances: counts/flags/keep exact, Fisher bitwise, "
        f"chi2 stat rel 1e-12 (binary_tables), binary_stats and "
        f"binary_from_words bitwise in every output; max abs err "
        + ", ".join(f"{k}={err[k]:.3g}" for k in (
            "membership_counts", "binary_tables", "fisher", "binary_stats",
            "binary_from_words")))
    say(f"phase 3 chi2_tail vs its plain version (JAX's igammac) on the "
        f"card: {tails}; bounds: relative {CHI2_REL:g} where p > 1e-300 and "
        f"equal strings, zeros, NaNs and DBL_MAX on every grid; against "
        f"the CPU's plain version the special values equal, the rest "
        f"reported")

    # Q1 -> Q2 -> Q3 on the first chunk of `vcf -q -c`
    import numpy as np
    from stoat_tpu_torch.pipeline.quantitative import quant_design
    d = compare_quant_design(qchunk, qcovar, H, err)
    used = d["used"]
    y = qpheno[None, :] * used   # the plain version's, for its time
    bad, nearest = pinv_rows(d["X"], d["ncols"])
    filtered = to_np(d["filtered"])
    bad_kept = [r for r in bad if not filtered[r]]
    stats, ols_errs = compare_ols(d["X"], qpheno, used, d["ncols"], err,
                                  OLS_REL, "main chunk", pinv=bad,
                                  pinv_bound=OLS_PINV_REL)
    _, t_worst = compare_student_t(*stats[:2], d["degenerate"], *stats[2:],
                                   err, "main chunk")
    qedges = quant_edge_cases(device, err)
    qgrid = compare_quant_grid(device, err)
    ogrid = compare_ols_grid(device, err)
    no_covar = torch.zeros((qcovar.shape[0], 0), dtype=torch.float64,
                           device=device)
    views = "; ".join(compare_table_view(qchunk, c, H, err, what, all_rows)
                      for c, what, all_rows in (
                          (qcovar, "-q -c design", False),
                          (no_covar, "-b -c design", False),
                          (qcovar, "all-rows design", True)))
    torch.cuda.synchronize()
    say(f"phase 3 quantitative kernels vs plain: main chunk (X "
        f"{tuple(d['X'].shape)}, {int(to_np(d['filtered']).sum())} "
        f"filtered, {int(to_np(d['degenerate']).sum())} degenerate) ok: "
        f"quant_design exact, X bitwise (card and CPU); ols max rel err "
        + ", ".join(f"{k} {v:.3g}" for k, v in ols_errs.items())
        + f" (bound {OLS_REL:g}, {OLS_PINV_REL:g} on {len(bad)} "
        f"pseudo-inverse rows, of which unfiltered {bad_kept}; smallest "
        f"pivot of the others {nearest:.3g} x 1e-10); student_t max rel err "
        f"{t_worst[0]:.3g} vs the card's plain version (bound {T_REL:g}), "
        f"{t_worst[1]:.3g} vs the CPU's (bound {T_CPU_REL:g}); {qedges}; "
        f"table view (-T) on the main chunk: {views}; {qgrid}; {ogrid}; "
        f"max abs err "
        + ", ".join(f"{k}={err[k]:.3g}" for k in QUANT_KERNELS))
    quant = {"chunk": qchunk, "covar": qcovar, "H": H, "X": d["X"], "y": y,
             "row": qpheno, "used": used, "ncols": d["ncols"],
             "deg": d["degenerate"], "filtered": d["filtered"],
             "stats": stats}
    del d

    # K6 on the main graph's partition counts, then its edge rows
    G0, G1, mask, k = graph_counts(graph, device)
    compare_graph_stats(G0, G1, mask, err)
    gedges = graph_edge_cases(device, err)
    torch.cuda.synchronize()
    say(f"phase 3 graph kernel vs plain: main graph ({G0.shape[0]} tested "
        f"snarls of {graph['n_snarls']}, Pmax {G0.shape[1]}, k = "
        f"{sorted(set(k.tolist()))}) ok; {gedges}; tolerances: bitwise "
        f"against the plain version on the card (its statistics through "
        f"the chi2_tail kernel: the parent's chain), Fisher bitwise and "
        f"chi2 rel 1e-12 with equal strings against the CPU's; max abs err "
        f"graph_stats={err['graph_stats']:.3g}")

    # K11 on the first chunk of `vcf -b -c` (its design has no covariates)
    d = quant_design(qchunk, no_covar, *THRESHOLDS, H)
    bused = d["used"]
    by = case[None, :] * bused
    got, lerrs, flips = compare_logreg(d["X"], by, bused, d["ncols"],
                                       d["degenerate"], err, "main chunk")
    ledges = logreg_edge_cases(device, err)
    torch.cuda.synchronize()
    say(f"phase 3 logistic kernel vs plain: main chunk (X "
        f"{tuple(d['X'].shape)}, {int(np.isnan(got['p']).sum())} NA of "
        f"{got['p'].size}, Newton steps per snarl: mean "
        f"{float(got['iters'].mean()):.3f}, largest "
        f"{int(got['iters'].max())}, "
        f"step counts differing from the plain version at snarls {flips}) "
        f"max err " + ", ".join(f"{k} {v:.3g}" for k, v in lerrs.items())
        + f" (bound {LOGREG_REL:g}, p below {P_FLOOR:g} in units of "
        f"{P_FLOOR:g}); {ledges}; max abs err logreg={err['logreg']:.3g}")
    logit = {"X": d["X"], "y": by, "used": bused, "ncols": d["ncols"],
             "deg": d["degenerate"], "filtered": d["filtered"],
             "iters": got["iters"], "graph": (G0, G1, mask)}
    return g0p, g1p, tables, quant, logit


def cli_args(paths, out, device):
    return ["vcf", "-s", paths["snarl"], "-v", paths["vcf"], "-b",
            paths["binary"], "-o", out, "--device", device]


def quant_cli_args(paths, out, device, with_covar):
    covar = (["-c", paths["covariate"], "-C", ",".join(COVAR_NAMES)]
             if with_covar else [])
    return ["vcf", "-s", paths["snarl"], "-v", paths["vcf"], "-q",
            paths["quantitative"], *covar, "-o", out, "--device", device]


def phase_main(torch, paths, work, n_chroms, gen_s):
    from stoat_tpu_torch import cli, kernels
    from stoat_tpu_torch.pipeline import runner
    ingest0 = dict(runner.INGEST_COUNTS)
    out_cuda = os.path.join(work, "out_cuda")
    out_cpu = os.path.join(work, "out_cpu")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with PlainTailCounter() as lib:
        rc = cli.main(cli_args(paths, out_cuda, "cuda"))
        torch.cuda.synchronize()
    wall_cuda = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"CUDA CLI exit code {rc}")
    n_chunks = n_chunks_of(paths, n_chroms)
    check_launches(launches, dict.fromkeys(BINARY_KERNELS, 1), n_chunks,
                   "the binary path")
    check(lib.calls == 0, f"the binary path called the plain chi-squared "
          f"tail {lib.calls} times")
    native_runs = runner.INGEST_COUNTS["native"] - ingest0["native"]
    python_runs = runner.INGEST_COUNTS["python"] - ingest0["python"]
    check(native_runs == n_chroms and python_runs == 0,
          f"ingest: native {native_runs}, python fallback {python_runs}")

    t1 = time.perf_counter()
    rc = cli.main(cli_args(paths, out_cpu, "cpu"))
    wall_cpu = time.perf_counter() - t1
    check(rc == 0, f"CPU CLI exit code {rc}")
    tsv_cuda = os.path.join(out_cuda, "binary_table_vcf.tsv")
    tsv_cpu = os.path.join(out_cpu, "binary_table_vcf.tsv")
    with open(tsv_cuda, "rb") as fh:
        data = fh.read()
    with open(tsv_cpu, "rb") as fh:
        check(fh.read() == data, "CUDA and CPU TSVs differ")
    rows = data.decode().splitlines()
    check(rows[0].startswith("#CHR\t"), "TSV has no header")
    got = []
    for line in rows[1:]:
        cols = line.split("\t")
        check(len(cols) == 9, f"malformed row {line!r}")
        for p in cols[5:7]:
            check(p == "NA" or 0.0 <= float(p) <= 1.0, f"bad p {p!r}")
        got.append((cols[0], cols[3], cols[7]))
    t2 = time.perf_counter()
    want, filtered = reference_rows(paths)
    ref_s = time.perf_counter() - t2
    check(len(want) + len(filtered) == paths["n_snarls"],
          f"reference saw {len(want) + len(filtered)} snarls")
    check(len(got) == len(want), f"TSV has {len(got)} rows, the numpy "
          f"reference {len(want)}")
    bad = [(g, w) for g, w in zip(got, want) if g != w]
    check(not bad, f"{len(bad)} rows differ from the numpy reference, "
          f"first {bad[0]}" if bad else "")
    say(f"phase 4 main path: vcf -b on {paths['n_samples']} samples x "
        f"{paths['n_snarls']} snarls ({n_chroms} chromosomes, "
        f"{os.path.getsize(paths['vcf']) / 1e6:.0f} MB VCF, generated in "
        f"{gen_s:.1f}s): cuda wall "
        f"{wall_cuda:.2f}s, cpu wall {wall_cpu:.2f}s, {len(got)} rows "
        f"byte-identical; snarl, chromosome and GROUP_PATHS of every row "
        f"equal to the numpy reference ({ref_s:.1f}s), which filters "
        f"{len(filtered)}: " + "; ".join(
            f"{c} {s} ({why})" for c, s, why in filtered[:5])
        + f"; launches {launches} ({n_chunks} chunks; "
        f"the plain chi-squared tail called 0 times); native ingest of "
        f"{native_runs} chromosomes, python fallback 0; "
        f"max_memory_allocated {memory_note(peak, held)}")
    return launches


QUANT_STATS = ("p", "beta", "se", "r2")
# each regression path of phase 4: its table, its kernels, its CLI
# arguments beyond -s/-v/-o, and its statistics in TSV column order
REGRESSION_PATHS = {
    "q": ("quantitative_table_vcf.tsv", QUANT_KERNELS, "-q", False,
          ("p", "r2", "beta", "se")),
    "q_c": ("quantitative_table_vcf.tsv", QUANT_KERNELS, "-q", True,
            ("p", "r2", "beta", "se")),
    "b_c": ("binary_table_vcf.tsv", BC_KERNELS, "-b", True,
            ("p", "beta", "se")),
}


def regression_cli_args(p, out, device, mode):
    """``vcf`` with the phenotype and covariates of regression path
    ``mode`` (REGRESSION_PATHS)."""
    _, _, flag, with_covar, _ = REGRESSION_PATHS[mode]
    pheno = p["binary"] if flag == "-b" else p["quantitative"]
    return ["vcf", "-s", p["snarl"], "-v", p["vcf"], flag, pheno,
            *(covar_args(p) if with_covar else []), "-o", out, "--device",
            device]


def run_captured(cli, args):
    """Run the CLI; return its exit code and each snarl's results as the
    writer received them, at full precision: {(chrom, snarl): (filtered,
    allele_paths, (p, beta, se, r2))}, r2 NaN where the path has none."""
    import numpy as np
    from stoat_tpu_torch import writer as W
    real = W.write_quant_rows_batch
    got = {}

    def capture(fh, chrom, snarls, res, has_r2=True):
        filtered = np.array(res["filtered"])
        allele = np.array(res["allele_paths"])
        stats = np.stack([np.array(res[k]) if k in res
                          else np.full(len(filtered), np.nan)
                          for k in QUANT_STATS], axis=1)
        for s, snarl in enumerate(snarls):
            got[(chrom, snarl.snarl_id_str)] = (
                bool(filtered[s]), tuple(allele[s, :snarl.n_paths].tolist()),
                tuple(stats[s].tolist()))
        return real(fh, chrom, snarls, res, has_r2)

    W.write_quant_rows_batch = capture
    try:
        rc = cli.main(args)
    finally:
        W.write_quant_rows_batch = real
    return rc, got


def compare_quant_tsvs(tsv_cuda, tsv_cpu, got_cuda, got_cpu,
                       names=("p", "r2", "beta", "se"), p_floor=0.0):
    """The CUDA and CPU TSVs of one regression run (statistic columns
    ``names`` from column 5 on): the same rows and the same PATH_LENGTHS,
    ALLELE_PATHS and DEPTH columns and NA cells; a statistic string may
    differ only where the two float64 values agree to TSV_REL.  Returns
    (rows, differing cells)."""
    with open(tsv_cuda) as fh:
        a = fh.read().splitlines()
    with open(tsv_cpu) as fh:
        b = fh.read().splitlines()
    check(a[0] == b[0] and a[0].startswith("#CHR\t"), "TSV headers")
    check(len(a) == len(b), f"CUDA TSV has {len(a)} lines, CPU {len(b)}")
    width = 7 + len(names)
    fixed = (0, 1, 2, 3, 4, width - 2, width - 1)
    diffs = []
    for la, lb in zip(a[1:], b[1:]):
        ca, cb = la.split("\t"), lb.split("\t")
        check(len(ca) == width and len(cb) == width,
              f"malformed row {la!r}")
        check([ca[i] for i in fixed] == [cb[i] for i in fixed],
              f"rows differ: {la!r} / {lb!r}")
        key = (ca[0], ca[3])
        for col, name in enumerate(names, start=5):
            if ca[col] == cb[col]:
                continue
            check("NA" not in (ca[col], cb[col]), f"NA differs: {la!r} / "
                  f"{lb!r}")
            k = QUANT_STATS.index(name)
            va, vb = got_cuda[key][2][k], got_cpu[key][2][k]
            rel = stat_err(name, [va], [vb], [got_cpu[key][2][2]],
                           p_floor=p_floor)
            check(rel <= TSV_REL, f"{key} {name}: {ca[col]} / {cb[col]} "
                  f"({va!r} / {vb!r}, relative {rel:.3g})")
            diffs.append(f"{key[0]} {key[1]} {name} {ca[col]}/{cb[col]} "
                         f"({va!r}/{vb!r}, rel {rel:.2g})")
    return len(a) - 1, diffs


def phase_main_regression(torch, paths, work, n_chroms, mode, reference):
    """One regression path on the card, then on the CPU: ``vcf -q`` (mode
    "q"), ``vcf -q -c -C AGE,SEX`` ("q_c") or ``vcf -b -c -C AGE,SEX``
    ("b_c", logistic): its kernels on every chunk, the TSVs against each
    other, and the results against the numpy reference."""
    from stoat_tpu_torch import cli, kernels
    table, stats = reference[:2]
    table_name, path_kernels, flag, with_covar, names = \
        REGRESSION_PATHS[mode]
    logistic = mode == "b_c"
    p_floor = P_FLOOR if logistic else 0.0
    out_cuda = os.path.join(work, f"out_cuda_{mode}")
    out_cpu = os.path.join(work, f"out_cpu_{mode}")
    n_chunks = n_chunks_of(paths, n_chroms, capped_chunk(paths))
    argv = partial(regression_cli_args, mode=mode)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc, got_cuda = run_captured(cli, argv(paths, out_cuda, "cuda"))
    torch.cuda.synchronize()
    wall_cuda = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"CUDA CLI exit code {rc}")
    check_launches(launches, dict.fromkeys(path_kernels, 1), n_chunks,
                   f"the {mode} path")
    t1 = time.perf_counter()
    rc, got_cpu = run_captured(cli, argv(paths, out_cpu, "cpu"))
    wall_cpu = time.perf_counter() - t1
    check(rc == 0, f"CPU CLI exit code {rc}")
    n_rows, diffs = compare_quant_tsvs(
        os.path.join(out_cuda, table_name),
        os.path.join(out_cpu, table_name), got_cuda, got_cpu, names,
        p_floor)

    # every snarl's filter and ALLELE_PATHS against the numpy reference,
    # the TSV's rows are exactly the unfiltered snarls, and the statistics
    # of the sampled snarls at REF_REL
    check(list(got_cuda) == list(table), "snarl order differs from the "
          "reference")
    for key, (filtered, allele) in table.items():
        check(got_cuda[key][:2] == (filtered, allele),
              f"{key}: filtered/allele_paths {got_cuda[key][:2]} != "
              f"reference {(filtered, allele)}")
    n_filtered = sum(f for f, _ in table.values())
    check(n_rows == len(table) - n_filtered, f"{n_rows} rows, reference "
          f"{len(table) - n_filtered}")
    worst, n_na = 0.0, 0
    ref_index = {"q": 0, "q_c": 1, "b_c": 2}[mode]
    ref_names = ("p", "beta", "se") if logistic else QUANT_STATS
    for key, ref in stats.items():
        ref = ref[ref_index]
        e = max(stat_err(name, [got_cuda[key][2][QUANT_STATS.index(name)]],
                         [ref[k]], [ref[2]], p_floor=p_floor)
                for k, name in enumerate(ref_names))
        n_na += all(math.isnan(v) for v in ref)
        check(e <= REF_REL, f"{key}: {got_cuda[key][2]} vs reference {ref} "
              f"(relative {e:.3g})")
        worst = max(worst, e)
    what = {"q": "vcf -q", "q_c": "vcf -q -c -C AGE,SEX",
            "b_c": "vcf -b -c -C AGE,SEX"}[mode]
    say(f"phase 4 main path: {what} on {paths['n_samples']} samples x "
        f"{paths['n_snarls']} snarls: cuda wall {wall_cuda:.2f}s, cpu wall "
        f"{wall_cpu:.2f}s; launches {launches} ({n_chunks} chunks); "
        f"{n_rows} rows, CUDA and CPU TSVs equal in rows, "
        f"PATH_LENGTHS/ALLELE_PATHS/DEPTH and NA cells, {len(diffs)} "
        f"statistic strings differ (float64 values within rel "
        f"{TSV_REL:g}){': ' + '; '.join(diffs[:10]) if diffs else ''};"
        f" filter and ALLELE_PATHS of all {len(table)} snarls equal the "
        f"numpy reference ({n_filtered} filtered); {', '.join(names)} of "
        f"{len(stats)} sampled snarls ({n_na} NA) within {worst:.3g} of "
        f"the numpy references (bound {REF_REL:g}); max_memory_allocated "
        f"{memory_note(peak, held)}")
    return launches, wall_cuda


def graph_reference_rows(tsv, n_sample=GRAPH_REF_ROWS, seed=0):
    """P_FISHER and P_CHI2 of ``n_sample`` random tested rows of a graph
    TSV against chi2_p and fisher_p (scipy) on their GROUP_PATHS
    counts, formatted as the writer formats them.  Returns (rows checked,
    rows whose string flipped at a rounding boundary)."""
    import numpy as np
    from stoat_tpu_torch.writer import format_p
    with open(tsv) as fh:
        rows = [line.rstrip("\n").split("\t") for line in fh][1:]
    tested = [r for r in rows if r[7] != "NA"]
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(tested), min(n_sample, len(tested)), replace=False)
    flips = []
    for i in sorted(pick.tolist()):
        r = tested[i]
        pairs = [tuple(int(v) for v in g.split(":")) for g in r[7].split(",")]
        g0 = [a for a, _ in pairs]
        g1 = [b for _, b in pairs]
        want = [format_p(fisher_p(g0[0], g0[1], g1[0], g1[1]))
                if len(pairs) == 2 else "NA", format_p(chi2_p(g0, g1))]
        for got_s, want_s, what in zip(r[5:7], want, ("fisher", "chi2")):
            if got_s == want_s:
                continue
            check("NA" not in (got_s, want_s), f"{r[3]} {what}: {got_s} / "
                  f"reference {want_s}")
            rel = abs(float(got_s) - float(want_s)) / float(want_s)
            check(rel <= GRAPH_REF_REL, f"{r[3]} {what}: {got_s} / "
                  f"reference {want_s}")
            flips.append(f"{r[3]} {what} {got_s}/{want_s}")
    return len(pick), flips


def phase_graph(torch, graph, twin, work):
    """``graph`` on the main graph: -T chi2 -O tsv on the card (K6
    launched, the native path taken) and on the CPU, byte for byte; 2,000
    rows against scipy; -T exact and -O fasta on both devices, byte for
    byte; then the Python twin on the small graph against the native path,
    on the card."""
    from stoat_tpu_torch import cli, kernels
    from stoat_tpu_torch.graph import association as assoc

    def run(g, out, device, method="chi2", fmt="tsv", python=False):
        os.environ["STOAT_GRAPH_PYTHON"] = "1" if python else "0"
        paths0 = dict(assoc.GRAPH_PATHS)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with PlainTailCounter() as lib:
                rc = cli.main(["graph", "-p", g["gfa"], "-d", g["gfa"], "-b",
                               g["pheno"], "-T", method, "-O", fmt, "-r",
                               "ref", "-V", "0", "-o", out, "--device",
                               device])
        finally:
            os.environ.pop("STOAT_GRAPH_PYTHON", None)
        torch.cuda.synchronize()
        check(device == "cpu" or lib.calls == 0, f"graph {method} {fmt} on "
              f"the card called the plain chi-squared tail {lib.calls} times")
        wall = time.perf_counter() - t0
        check(rc == 0, f"graph {method} {fmt} on {device}: exit code {rc}")
        path = "python" if python else "native"
        check(assoc.GRAPH_PATHS[path] == paths0[path] + 1
              and sum(assoc.GRAPH_PATHS.values()) == sum(paths0.values())
              + 1, f"graph {method} {fmt} on {device}: paths "
              f"{assoc.GRAPH_PATHS}, before {paths0}")
        name = "binary_table_graph.tsv" if fmt == "tsv" \
            else "binary_output.fasta"
        with open(os.path.join(out, name), "rb") as fh:
            data = fh.read()
        return wall, dict(kernels.LAUNCHES), data

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    wall_cuda, launches, tsv = run(graph, os.path.join(work, "g_cuda"),
                                   "cuda")
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        check(n == (1 if name in GRAPH_KERNELS else 0), f"kernel {name}: "
              f"{n} launches on the graph path, expected "
              f"{1 if name in GRAPH_KERNELS else 0}")
    wall_cpu, _, tsv_cpu = run(graph, os.path.join(work, "g_cpu"), "cpu")
    check(tsv == tsv_cpu, "graph: CUDA and CPU TSVs differ")
    lines = tsv.decode().splitlines()
    check(lines[0].startswith("#CHR\t") and len(lines) > graph["n_snarls"],
          f"graph TSV has {len(lines)} lines")
    depth2 = sum(1 for line in lines[1:] if line.endswith("\t2"))
    kinds = {}
    for line in lines[1:]:
        k = line.split("\t")[7].count(",") + 1
        kinds[k] = kinds.get(k, 0) + 1
    t0 = time.perf_counter()
    n_ref, flips = graph_reference_rows(os.path.join(work, "g_cuda",
                                                     "binary_table_graph.tsv"))
    ref_s = time.perf_counter() - t0
    others = []
    for method, fmt in (("exact", "tsv"), ("chi2", "fasta")):
        w_cuda, _, a = run(graph, os.path.join(work, f"g_cuda_{method}_{fmt}"),
                           "cuda", method, fmt)
        w_cpu, _, b = run(graph, os.path.join(work, f"g_cpu_{method}_{fmt}"),
                          "cpu", method, fmt)
        check(a == b, f"graph -T {method} -O {fmt}: CUDA and CPU outputs "
              f"differ")
        n_lines = a.count(b"\n")
        check(n_lines > 10, f"graph -T {method} -O {fmt}: {n_lines} lines")
        others.append(f"-T {method} -O {fmt} {n_lines} lines, cuda "
                      f"{w_cuda:.2f}s / cpu {w_cpu:.2f}s, identical")
    w_native, _, native = run(twin, os.path.join(work, "t_native"), "cuda")
    w_twin, twin_launches, python = run(twin, os.path.join(work, "t_python"),
                                        "cuda", python=True)
    check(native == python, "graph: the Python twin's TSV differs from the "
          "native path's")
    check(twin_launches["graph_stats"] == 1
          and twin_launches["chi2_tail"] == 0, f"graph twin: launches "
          f"{twin_launches}")
    say(f"phase 4 main path: graph -T chi2 on {graph['n_snarls']} snarls x "
        f"{2 * graph['n_samples']} haplotype paths: cuda wall "
        f"{wall_cuda:.2f}s, cpu wall {wall_cpu:.2f}s, {len(lines) - 1} rows "
        f"byte-identical ({depth2} nested at depth 2; partitions per row "
        f"{dict(sorted(kinds.items()))}); launches {launches} (graph_stats "
        f"once, its two tails inside it: chi2_tail never, the plain "
        f"chi-squared tail called 0 times), "
        f"native path; "
        f"{n_ref} sampled rows' P_FISHER/P_CHI2 equal scipy's strings "
        f"({ref_s:.1f}s), {len(flips)} at a rounding boundary"
        f"{': ' + '; '.join(flips[:5]) if flips else ''}; "
        + "; ".join(others)
        + f"; Python twin on {twin['n_snarls']} snarls ({w_twin:.2f}s, "
        f"graph_stats launched) byte-identical to the native path "
        f"({w_native:.2f}s); max_memory_allocated {memory_note(peak, held)}")
    return launches, wall_cuda


# the device kernels of an entry point beside <name>_kernel (perm_ols runs
# two; tools/kernel_ab.py times sources with either)
DEVICE_KERNELS = {"perm_ols": ("perm_ols", "perm_ols_inverse",
                               "perm_ols_main"),
                  "chi2_tail": ("chi2_tail", "chi2_tail_warp"),
                  "student_t": ("student_t", "student_t_batch")}


def kernel_pattern(name):
    """The device kernels of entry point ``name``, by their whole names
    ("ols_kernel" must not match perm_ols_kernel; a template instance
    "quant_design_kernel<true, false>" matches quant_design)."""
    names = "|".join(DEVICE_KERNELS.get(name, (name,)))
    return re.compile(rf"(?<![A-Za-z0-9_])({names})_kernel\b")


def device_ms(torch, calls):
    """Device time per call of each named kernel under torch.profiler
    (every device kernel of its entry point): {name: ms}, None where the
    trace shows no device time."""
    patterns = {name: kernel_pattern(name) for name in calls}
    records = profile_records(torch, list(calls.values()), ", ".join(calls),
                              patterns=tuple(patterns.values()))
    return {name: per_call_ms(records, pattern=p)
            for name, p in patterns.items()}


def profile_window_note(torch, what, fn, name=None, windows=10):
    """``windows`` single windows of PROFILE_REPS calls of ``fn`` with no
    lead (a reading without spins) and as many with LEAD_SPINS spins ahead,
    none run again: the records of ``name``'s kernels (or of every kernel)
    in each, and the spins kept."""
    pattern = kernel_pattern(name) if name else None
    fn()
    torch.cuda.synchronize()
    parts = []
    for lead in (0, LEAD_SPINS):
        kept, spins = [], []
        for _ in range(windows):
            records, n_spins = profile_window(torch, [fn], lead=lead)
            kept.append(sum(n for k, (n, _) in records.items()
                            if pattern is None or pattern.search(k)))
            spins.append(n_spins)
        parts.append(f"lead {lead}: records {'/'.join(map(str, kept))}"
                     + (f", spins kept {'/'.join(map(str, spins))}"
                        if lead else ""))
    return f"{what} ({windows} windows of {PROFILE_REPS} calls): " + \
        "; ".join(parts)


def phase_times(torch, chunk, g0p, g1p, tables, quant, logit, perm, modes,
                smi):
    """Each kernel's ms per call and its plain version's on the card (CUDA
    events), its device ms (torch.profiler) and its bound, at the main
    paths' shapes: the first chunk of each path, K = 1 + PERM_FULL rows
    for the permutation kernels, the first chunk's (snarl, gene) pairs for
    eqtl_ols.  Then the mixed model's pieces: quant_design with all_rows,
    the rotation (one GEMM, against torch.einsum as stoat_tpu writes it)
    and the whole chain against its plain version."""
    from stoat_tpu_torch.pipeline import permutation as pm
    from stoat_tpu_torch.pipeline import quantitative as tq
    from stoat_tpu_torch.stats.lmm import lmm_regression_batch, lmm_rotate
    from stoat_tpu_torch.pipeline.binary import (
        binary_stats, binary_stats_from_words, binary_stats_from_words_plain,
        binary_stats_plain, binary_tables, binary_tables_plain)
    from stoat_tpu_torch.pipeline.packed import (membership_counts,
                                                 membership_counts_plain)
    from stoat_tpu_torch.pipeline.quantitative import (quant_design,
                                                       quant_design_plain)
    from stoat_tpu_torch.stats.chi2 import (finish_chi2_pvalues,
                                            finish_chi2_pvalues_plain)
    from stoat_tpu_torch.stats.fisher import (fisher_exact_2x2,
                                              fisher_exact_2x2_plain)
    from stoat_tpu_torch.graph.association import (graph_stats,
                                                   graph_stats_plain)
    from stoat_tpu_torch.stats.linreg import (linear_regression_row_stats,
                                              linear_regression_stats_plain,
                                              student_t_pvalues,
                                              student_t_pvalues_plain)
    from stoat_tpu_torch.stats.logreg import (logistic_regression,
                                              logistic_regression_plain)
    args = (chunk.words, chunk.path_idx, chunk.path_valid, chunk.tail,
            chunk.g1_words)
    sidx = chunk.snarl_path_idx
    thr = (3, 5, 0.05)
    abcd = (tables["a"], tables["b"], tables["c"], tables["d"])
    q = quant
    design = (q["chunk"], q["covar"], *THRESHOLDS, q["H"])
    ols = (q["X"], q["row"], q["used"], q["ncols"])
    ols_plain = (q["X"], q["y"], q["used"], q["ncols"])
    tail = (*q["stats"][:2], q["deg"], *q["stats"][2:])
    counts = logit["graph"]
    fit = (logit["X"], logit["y"], logit["used"], logit["ncols"],
           logit["deg"])
    m = perm
    member = args[:4]
    pbin = (m["mem"], m["g_all"], m["masks"], sidx, *THRESHOLDS)
    pols = (m["X"], m["used"], m["ncols"], m["phenos"])
    spre = (m["bX"], m["bused"], m["bncols"], m["bad"], m["Z"], m["w"])
    sperm = (m["D"], m["bused"], m["Vinv"], m["e"])
    md = modes
    eq = (q["X"], q["used"], q["ncols"], *md["pairs"], md["expr"])
    k5 = tuple(tables[k] for k in ("chi2_stat", "chi2_df", "chi2_invalid",
                                   "chi2_zexp"))
    calls = {
        "membership_counts": lambda: membership_counts(*args),
        "binary_tables": lambda: binary_tables(g0p, g1p, sidx, *thr),
        "fisher": lambda: fisher_exact_2x2(*abcd),
        "binary_stats": lambda: binary_stats(g0p, g1p, sidx, *thr),
        "binary_from_words": lambda: binary_stats_from_words(*args, sidx,
                                                             *thr),
        "quant_design": lambda: quant_design(*design),
        "ols": lambda: linear_regression_row_stats(*ols),
        "student_t": lambda: student_t_pvalues(*tail),
        "graph_stats": lambda: graph_stats(*counts),
        "logreg": lambda: logistic_regression(*fit),
        "perm_membership": lambda: pm.perm_membership(*member),
        "perm_binary": lambda: pm.perm_binary_stats(*pbin),
        "perm_ols": lambda: pm.perm_ols_stats(*pols),
        "score_precompute": lambda: pm.score_precompute(*spre),
        "score_perm": lambda: pm.score_perm_stats(*sperm),
        "eqtl_ols": lambda: tq.eqtl_ols_stats(*eq),
        "chi2_tail": lambda: finish_chi2_pvalues(*k5),
    }
    times = {
        "membership_counts": (
            cuda_ms(calls["membership_counts"], 50),
            cuda_ms(lambda: membership_counts_plain(*args), 10)),
        "binary_tables": (
            cuda_ms(calls["binary_tables"], 50),
            cuda_ms(lambda: binary_tables_plain(g0p, g1p, sidx, *thr), 10)),
        "fisher": (
            cuda_ms(calls["fisher"], 20),
            cuda_ms(lambda: fisher_exact_2x2_plain(*abcd), 3, warmup=1)),
        "binary_stats": (
            cuda_ms(calls["binary_stats"], 50),
            cuda_ms(lambda: binary_stats_plain(g0p, g1p, sidx, *thr), 3,
                    warmup=1)),
        "binary_from_words": (
            cuda_ms(calls["binary_from_words"], 50),
            cuda_ms(lambda: binary_stats_from_words_plain(*args, sidx, *thr),
                    3, warmup=1)),
        "quant_design": (
            cuda_ms(calls["quant_design"], 10),
            cuda_ms(lambda: quant_design_plain(*design), 3, warmup=1)),
        "ols": (
            cuda_ms(calls["ols"], 10),
            cuda_ms(lambda: linear_regression_stats_plain(*ols_plain), 3,
                    warmup=1)),
        "student_t": (
            cuda_ms(calls["student_t"], 20),
            cuda_ms(lambda: student_t_pvalues_plain(*tail), 3, warmup=1)),
        "graph_stats": (
            cuda_ms(calls["graph_stats"], 20),
            cuda_ms(lambda: graph_stats_plain(*counts), 3, warmup=1)),
        "logreg": (
            cuda_ms(calls["logreg"], 5),
            cuda_ms(lambda: logistic_regression_plain(*fit), 3, warmup=1)),
        "perm_membership": (
            cuda_ms(calls["perm_membership"], 50),
            cuda_ms(lambda: pm.perm_membership_plain(*member), 10)),
        # the plain permutation versions loop over the rows in Python:
        # one call each, after the kernels' warm-up
        "perm_binary": (
            cuda_ms(calls["perm_binary"], 5),
            cuda_ms(lambda: pm.perm_binary_stats_plain(*pbin), 1, warmup=0)),
        "perm_ols": (
            cuda_ms(calls["perm_ols"], 3, warmup=1),
            cuda_ms(lambda: pm.perm_ols_stats_plain(*pols), 1, warmup=0)),
        "score_precompute": (
            cuda_ms(calls["score_precompute"], 10),
            cuda_ms(lambda: pm.score_precompute_plain(*spre), 3, warmup=1)),
        "score_perm": (
            cuda_ms(calls["score_perm"], 3, warmup=1),
            cuda_ms(lambda: pm.score_perm_stats_plain(*sperm), 1, warmup=0)),
        "eqtl_ols": (
            cuda_ms(calls["eqtl_ols"], 10),
            cuda_ms(lambda: tq.eqtl_ols_stats_plain(*eq), 1, warmup=0)),
        "chi2_tail": (
            cuda_ms(calls["chi2_tail"], 50),
            cuda_ms(lambda: finish_chi2_pvalues_plain(*k5), 20)),
    }
    # the one PyTorch call that computes K5's function: the upper
    # incomplete gamma of the same inputs (halved outside the timing)
    halves = (k5[1] * 0.5, k5[0] * 0.5)
    library = {"chi2_tail": cuda_ms(
        lambda: torch.special.gammaincc(*halves), 50)}
    # the permutation kernels' GEMM core alone, one torch.matmul each (the
    # port never calls them): X^T Y for K16a, D^T e for K16c
    library["perm_ols"] = cuda_ms(
        lambda: m["X"].transpose(1, 2) @ m["phenos"].T, 3, warmup=1)
    library["score_perm"] = cuda_ms(
        lambda: m["D"].transpose(1, 2) @ m["e"].T, 3, warmup=1)
    # the OLS kernels' GEMM core alone: X^T X of the chunk's design (the
    # same X for both)
    library["ols"] = library["eqtl_ols"] = cuda_ms(
        lambda: torch.einsum("snp,snq->spq", q["X"], q["X"]), 10)
    # K15's count product alone: torch._int_mm of the chunk's membership
    # bits [P, 32 W] and the masks' bits [32 W, K] as 0/1 int8 (K padded to
    # a multiple of 8, as the op asks)
    shifts = torch.arange(32, dtype=torch.int32, device=m["mem"].device)

    def bits(words):
        return ((words.unsqueeze(-1) >> shifts) & 1).to(torch.int8) \
            .reshape(words.shape[0], -1)
    a8, b8 = bits(m["mem"]), bits(m["masks"])
    kp = (b8.shape[0] + 7) // 8 * 8
    b8 = torch.nn.functional.pad(b8, (0, 0, 0, kp - b8.shape[0])).t() \
        .contiguous()
    library["perm_binary"] = cuda_ms(lambda: torch._int_mm(a8, b8), 10)
    del a8, b8
    # K16b's Gram alone: torch.bmm of ([D | Z] w used)^T and [D | Z]
    S_b, N_b, _ = m["D"].shape
    dz = torch.cat([m["D"], m["Z"].expand(S_b, N_b, m["Z"].shape[1])], 2)
    dzw = (dz * (m["w"][None, :] * m["bused"])[:, :, None]).transpose(
        1, 2).contiguous()
    library["score_precompute"] = cuda_ms(lambda: torch.bmm(dzw, dz), 10)
    del dz, dzw
    dev = device_ms(torch, calls)
    # the call binary_from_words replaced on the main path: the two
    # launches on their own, membership_counts, then binary_stats on its
    # counts (device ms: both kernels)
    chain = "binary_from_words (parent: membership_counts, binary_stats)"

    def parent_chain():
        return binary_stats(*membership_counts(*args), sidx, *thr)
    times[chain] = (cuda_ms(parent_chain, 50), times["binary_from_words"][1])
    dev[chain] = device_total_ms(torch, parent_chain, what=chain)
    # perm_ols at the `-q` design (PT = 5) too; the row above is `-q -c`'s
    pols5 = (m["bX"], m["bused"], m["bncols"], m["phenos_q"])
    q5 = "perm_ols (PT = 5)"
    times[q5] = (
        cuda_ms(lambda: pm.perm_ols_stats(*pols5), 3, warmup=1),
        cuda_ms(lambda: pm.perm_ols_stats_plain(*pols5), 1, warmup=0))
    dev[q5] = device_ms(torch, {"perm_ols": lambda: pm.perm_ols_stats(
        *pols5)})["perm_ols"]
    library[q5] = cuda_ms(lambda: m["bX"].transpose(1, 2) @ m["phenos_q"].T,
                          3, warmup=1)
    work = {
        "membership_counts": {"words": chunk.words,
                              "path_idx": chunk.path_idx,
                              "path_valid": chunk.path_valid},
        "binary_tables": {"sidx": sidx},
        "fisher": {"abcd": abcd},
        "binary_stats": {"sidx": sidx, "abcd": abcd, "k": tables["k"]},
        "binary_from_words": {"words": chunk.words,
                              "path_idx": chunk.path_idx,
                              "path_valid": chunk.path_valid, "sidx": sidx,
                              "abcd": abcd, "k": tables["k"]},
        "quant_design": {"X_out": q["X"], "words": q["chunk"].words,
                         "path_idx": q["chunk"].path_idx,
                         "sidx": q["chunk"].snarl_path_idx,
                         "covar": q["covar"]},
        "ols": {"X": q["X"]},
        "ols (y [S, N])": {"X": q["X"], "y_rows": q["X"].shape[0]},
        "student_t": {"t1": q["stats"][0], "df": q["stats"][1]},
        "graph_stats": {"G0": counts[0], "G1": counts[1],
                        "mask": counts[2]},
        "logreg": {"X": logit["X"], "iters": logit["iters"]},
        "perm_membership": {"words": chunk.words,
                            "path_idx": chunk.path_idx,
                            "path_valid": chunk.path_valid},
        "perm_binary": {"mem": m["mem"], "masks": m["masks"], "sidx": sidx},
        "perm_ols": {"X": m["X"], "phenos": m["phenos"]},
        "score_precompute": {"X": m["bX"], "Z": m["Z"]},
        "score_perm": {"D": m["D"], "e": m["e"]},
        "eqtl_ols": {"X": q["X"], "expr": md["expr"],
                     "n_pairs": md["n_pairs"], "n_with": md["n_with"]},
        "chi2_tail": {"stat": k5[0], "df": k5[1]},
    }
    bounds = {name: bound_of(name, work[name]) for name in calls}
    bounds[chain] = bounds["binary_from_words"]
    # the parent design of K15: a population count per (mask, real path,
    # word), at 16 an SM a clock
    popc_ms = 1e3 * int(m["masks"].shape[0]) * int(
        (to_np(sidx) >= 0).sum()) * int(m["mem"].shape[1]) / POPC_OPS
    # K9's bound as the parent's call needed it: a [S, N] y read besides
    ols_y_bound = bound_of("ols", work.pop("ols (y [S, N])"))[0]
    bounds[q5] = bound_of("perm_ols", {"X": m["bX"], "phenos": pols5[3]})

    # the two tails at the permutation pass's [K, S] shape (K = 1 +
    # PERM_FULL rows): K5 on K15's statistics and on the score test's (its
    # df [S] read with its period), K10 on K16a's (linear_pvalues, p alone)
    from stoat_tpu_torch.stats.linreg import (finish_linear_pvalues,
                                              linear_pvalues)
    from stoat_tpu_torch.stats.special import chi2_sf, chi2_sf_plain
    for what, (a, b) in m["tails"].items():
        name = "student_t" if what == "student_t" else "chi2_tail"
        label = f"{what} [K, S]"
        if name == "student_t":
            def fn(a=a, b=b):
                return linear_pvalues(a, b)

            def plain(a=a, b=b):
                return finish_linear_pvalues(a, b)
            library[label] = None
            shape_work = {"t1": a, "df": b, "masks": False}
        else:
            def fn(a=a, b=b):
                return chi2_sf(a, b)

            def plain(a=a, b=b):
                return chi2_sf_plain(a, b)
            halves = (b.expand_as(a) * 0.5, a * 0.5)
            library[label] = cuda_ms(
                lambda h=halves: torch.special.gammaincc(*h), 5)
            del halves
            shape_work = {"stat": a, "df": b, "masks": False}
        times[label] = (cuda_ms(fn, 5), cuda_ms(plain, 1, warmup=0))
        dev[label] = device_ms(torch, {name: fn})[name]
        bounds[label] = bound_of(name, shape_work)

    # K12, the dual's chunk (`vcf -b -q`, no covariate) as the main path
    # runs it: K1 once, the binary table on its words (one row a path),
    # K5, the design on the same words, OLS and the t tail; its plain
    # column is the plain versions' chain, its device ms every kernel of
    # the call, its bound the sum of its kernels' at these shapes
    from stoat_tpu_torch.convert import DeviceChunk
    from stoat_tpu_torch.stats.chi2 import finish_chi2_pvalues_plain
    no_covar = torch.zeros((q["covar"].shape[0], 0), dtype=torch.float64,
                           device=q["covar"].device)
    k12 = ("K12 dual chunk (perm_membership, binary_from_words, chi2_tail, "
           "quant_design, ols, student_t)")

    def dual():
        return tq.dual_chunk_tables(chunk, q["row"], no_covar, *THRESHOLDS,
                                    q["H"])

    def dual_plain():
        mem, _ = pm.perm_membership_plain(*member)
        rows = torch.arange(mem.shape[0], dtype=torch.int32,
                            device=mem.device)[:, None]
        t = binary_stats_from_words_plain(mem, rows, *args[2:], sidx,
                                          *THRESHOLDS)
        finish_chi2_pvalues_plain(t["chi2_stat"], t["chi2_df"],
                                  t["chi2_invalid"], t["chi2_zexp"])
        d = quant_design_plain(DeviceChunk(mem, rows, args[2], sidx),
                               no_covar, *THRESHOLDS, q["H"])
        st = linear_regression_stats_plain(d["X"], q["row"][None, :]
                                           * d["used"], d["used"], d["ncols"])
        return student_t_pvalues_plain(*st[:2], d["degenerate"], *st[2:])
    times[k12] = (cuda_ms(dual, 10), cuda_ms(dual_plain, 2, warmup=1))
    dev[k12] = device_total_ms(torch, dual, what=k12)
    mem, _ = pm.perm_membership(*member)
    rows = torch.arange(mem.shape[0], dtype=torch.int32,
                        device=mem.device)[:, None]
    d_dual = quant_design(DeviceChunk(mem, rows, args[2], sidx), no_covar,
                          *THRESHOLDS, q["H"])
    st_dual = linear_regression_row_stats(d_dual["X"], q["row"],
                                          d_dual["used"], d_dual["ncols"])
    parts = [
        ("perm_membership", work["perm_membership"]),
        ("binary_from_words", dict(work["binary_from_words"], words=mem,
                                   path_idx=rows)),
        ("chi2_tail", work["chi2_tail"]),
        ("quant_design", {"X_out": d_dual["X"], "words": mem,
                          "path_idx": rows, "sidx": sidx,
                          "covar": no_covar}),
        ("ols", {"X": d_dual["X"]}),
        ("student_t", {"t1": st_dual[0], "df": st_dual[1]})]
    part_bounds = [bound_of(name, w) for name, w in parts]
    bounds[k12] = (sum(b for b, _ in part_bounds),
                   "+".join(sorted({by for _, by in part_bounds})))
    del mem, rows, d_dual, st_dual

    # Q1's table view (-T) on the same chunk
    qt = "quant_design (tables)"
    times[qt] = (
        cuda_ms(lambda: quant_design(*design, tables=True), 10),
        cuda_ms(lambda: quant_design_plain(*design, tables=True), 3,
                warmup=1))
    dev[qt] = device_ms(torch, {"quant_design": lambda: quant_design(
        *design, tables=True)})["quant_design"]
    bounds[qt] = bound_of("quant_design", dict(work["quant_design"],
                                               tables=True))
    # the write rate the card reaches for X's bytes: X.zero_() on a tensor
    # of its shape (quant_design's yardstick; the port never calls it)
    zeros = torch.empty_like(q["X"])
    zero_ms = cuda_ms(zeros.zero_, 10)
    zero_gbs = zeros.numel() * 8 / zero_ms / 1e6
    del zeros

    # the mixed model: Q1 with all_rows, K14's rotation, the whole chain
    d_all = md["d_all"]
    allrows = (md["chunk"], md["covar"], *THRESHOLDS, md["H"], True)
    rot, y_rot = md["rot"], md["y_rot"]
    qa = "quant_design (all_rows)"
    times[qa] = (cuda_ms(lambda: quant_design(*allrows), 10),
                 cuda_ms(lambda: quant_design_plain(*allrows), 3, warmup=1))
    dev[qa] = device_ms(torch, {"quant_design": lambda: quant_design(
        *allrows)})["quant_design"]
    bounds[qa] = bound_of("quant_design", dict(
        work["quant_design"], X_out=d_all["X"]))
    gemm = "lmm rotation (GEMM)"
    times[gemm] = (
        cuda_ms(lambda: lmm_rotate(rot, d_all["X"]), 5),
        cuda_ms(lambda: torch.einsum("mn,snp->smp", rot, d_all["X"]), 3,
                warmup=1))
    dev[gemm] = device_total_ms(
        torch, lambda: lmm_rotate(rot, d_all["X"]), what=gemm)
    bounds[gemm] = bound_of("lmm_gemm", {"X": d_all["X"]})
    # the three windows that a reading without spins put near or below
    # their bounds, in single windows with and without the spins
    say("phase 5 profiler windows, none run again (records of the "
        "kernels; the GEMM's: its GEMM and its two copies a call, 15 a "
        "window): "
        + "; ".join((
            profile_window_note(torch, qt, lambda: quant_design(
                *design, tables=True), "quant_design"),
            profile_window_note(torch, qa, lambda: quant_design(*allrows),
                                "quant_design"),
            profile_window_note(torch, gemm,
                                lambda: lmm_rotate(rot, d_all["X"])))))

    def chain():
        st = lmm_regression_batch(d_all["X"], rot, y_rot, d_all["ncols"])
        return student_t_pvalues(*st[:2], d_all["degenerate"], *st[2:])

    def chain_plain():
        X = torch.einsum("mn,snp->smp", rot, d_all["X"])
        S, N, _ = X.shape
        st = linear_regression_stats_plain(
            X, y_rot[None, :].expand(S, N).contiguous(),
            torch.ones((S, N), dtype=torch.bool, device=X.device),
            d_all["ncols"])
        return student_t_pvalues_plain(*st[:2], d_all["degenerate"],
                                       *st[2:])
    lc = "lmm chain (rotation, ols, student_t)"
    times[lc] = (cuda_ms(chain, 5), cuda_ms(chain_plain, 2, warmup=1))
    dev[lc] = device_total_ms(torch, chain, what=lc)
    b_ols = bound_of("ols", {"X": d_all["X"], "mask": False})[0]
    b_t = bound_of("student_t", {"t1": q["stats"][0],
                                 "df": q["stats"][1]})[0]
    bounds[lc] = (bounds[gemm][0] + b_ols + b_t, "operations"
                  if bounds[gemm][1] == "operations" else "bytes")
    say(f"phase 5 profiler windows not whole ({len(PROFILE_LOG)}; a "
        f"window holds {LEAD_SPINS} spins and {PROFILE_REPS} calls; run "
        f"again where a kernel asked for has no record): " + ("; ".join(
            f"{what} try {k}, spins {spins}: " + (", ".join(
                f"{name[:48]} {n}" for name, n in recs.items())
                or "no record")
            for what, k, spins, recs in PROFILE_LOG) or "none"))
    say(f"phase 5 times on {smi} (ms per chunk call, kernel / plain; "
        f"device ms per call from torch.profiler; bound ms and what sets "
        f"it): " + "; ".join(
            f"{k} {a:.4f} / {b:.4f} (device "
            f"{'not measured' if dev[k] is None else f'{dev[k]:.4f}'}, bound "
            f"{bounds[k][0]:.4f} {bounds[k][1]})"
            for k, (a, b) in times.items())
        + f"; library (one PyTorch call of the same function): chi2_tail "
        f"{library['chi2_tail']:.4f} (torch.special.gammaincc, a yardstick: "
        f"another algorithm), at [K, S] "
        f"{library['chi2_tail (binary) [K, S]']:.4f} (binary) and "
        f"{library['chi2_tail (score) [K, S]']:.4f} (score); student_t none "
        f"(torch has no incomplete beta); GEMM core "
        f"only (one torch.matmul, X^T Y or D^T e): perm_ols "
        f"{library['perm_ols']:.4f}, {q5} {library[q5]:.4f}, score_perm "
        f"{library['score_perm']:.4f}; ols and eqtl_ols: X^T X alone "
        f"(torch.einsum snp,snq->spq) {library['ols']:.4f}; perm_binary: "
        f"the count product alone (torch._int_mm, 0/1 int8) "
        f"{library['perm_binary']:.4f}, bound by the int8 tensor cores' "
        f"operations {bounds['perm_binary'][0]:.4f}, the parent design's "
        f"popcount ceiling (16 an SM a clock) {popc_ms:.4f}; "
        f"score_precompute: the weighted Gram of [D | Z] alone (torch.bmm) "
        f"{library['score_precompute']:.4f}; ols bound with "
        f"an [S, N] y read besides X (the parent's call) {ols_y_bound:.4f}; "
        f"X.zero_() on quant_design's X "
        f"{tuple(q['X'].shape)} float64 {zero_ms:.4f} ms ({zero_gbs:.1f} "
        f"GB/s), beside quant_design's bound "
        f"{bounds['quant_design'][0]:.4f}; chi2_tail "
        f"on the first vcf -b chunk's statistics and masks, and at [K, S] "
        f"on the first chunk's permutation statistics; permutation "
        f"kernels at K = {PERM_FULL + 1} rows; eqtl_ols on "
        f"{md['n_pairs']} pairs of {md['n_with']} snarls; the mixed model's "
        f"rows on the all-rows design (the GEMM's plain column is "
        f"torch.einsum, the chain's the plain versions after it; device ms "
        f"of both is every kernel in their profiler window); "
        f"binary_from_words and the two launches it replaced on the first "
        f"vcf -b chunk (the parent chain's device ms is both kernels'); "
        f"graph_stats with both tails inside its launch on the main "
        f"graph's counts")
    return times, dev, bounds, library


PROFILE_TITLES = {"b": "vcf -b", "q_c": "vcf -q -c -C AGE,SEX",
                  "b_c": "vcf -b -c -C AGE,SEX"}


def profile_main_path(torch, device, paths, work, out_dir, mode):
    """--profile DIR: where the time of one main path goes (mode "b" for
    `vcf -b`, "q_c" for `vcf -q -c -C AGE,SEX`, "b_c" for `vcf -b -c -C
    AGE,SEX`).  The stages run once serially (the runner overlaps ingest,
    dispatch and writing on three threads), then torch.profiler traces one
    whole CUDA CLI run (trace_cli)."""
    from stoat_tpu_torch import writer as W
    from stoat_tpu_torch.io.phenotype import (parse_binary_pheno,
                                              parse_covariates,
                                              parse_quantitative_pheno)
    from stoat_tpu_torch.io.snarl_file import parse_snarl_path
    from stoat_tpu_torch.io.vcf import VcfReader
    from stoat_tpu_torch.tables import pack_chromosome_chunks
    from stoat_tpu_torch.convert import (chunk_words, pheno_masks,
                                         to_binary_pheno, to_device_chunk,
                                         to_quant_inputs, upload_words)
    from stoat_tpu_torch.pipeline.binary import binary_tables_packed
    from stoat_tpu_torch.pipeline.fetch import fetch_async
    from stoat_tpu_torch.pipeline.quantitative import quant_design
    from stoat_tpu_torch.pipeline.runner import iter_chromosome_matrices
    from stoat_tpu_torch.stats.linreg import (linear_regression_row_stats,
                                              student_t_pvalues)
    from stoat_tpu_torch.stats.logreg import logistic_regression

    binary = mode == "b"
    logistic = mode == "b_c"
    stage = dict.fromkeys(("parse inputs", "native ingest", "host pack",
                           "upload", "kernels", "fetch", "format+write"),
                          0.0)

    def timed(name, fn, sync=False):
        t = time.perf_counter()
        out = fn()
        if sync:
            torch.cuda.synchronize()
        stage[name] += time.perf_counter() - t
        return out

    def parse():
        reader = VcfReader(paths["vcf"])
        samples = reader.samples
        reader.close()
        if binary or logistic:
            covar = (parse_covariates(paths["covariate"], COVAR_NAMES,
                                      samples) if logistic else None)
            pheno, samples = parse_binary_pheno(paths["binary"], samples)
        else:
            covar = parse_covariates(paths["covariate"], COVAR_NAMES,
                                     samples)
            pheno = parse_quantitative_pheno(paths["quantitative"], samples)
        return pheno, covar, samples, parse_snarl_path(paths["snarl"])
    pheno, covar, samples, snarls_chr = timed("parse inputs", parse)

    def analyze(c, consts):
        if binary:
            return binary_tables_packed(c, *THRESHOLDS)
        d = quant_design(c, consts[1], *THRESHOLDS, 2 * len(samples))
        used = d["used"]
        if logistic:
            out = logistic_regression(d.pop("X"), consts[0][None, :] * used,
                                      used, d["ncols"], d["degenerate"])
            del out["iters"]
            return {"filtered": d["filtered"],
                    "allele_paths": d["allele_paths"], **out}
        stats = linear_regression_row_stats(d.pop("X"), consts[0], used,
                                            d["ncols"])
        return {"filtered": d["filtered"],
                "allele_paths": d["allele_paths"],
                **student_t_pvalues(*stats[:2], d["degenerate"],
                                    *stats[2:])}

    write = (W.write_binary_rows_batch if binary
             else partial(W.write_quant_rows_batch, has_r2=not logistic))
    gen = iter_chromosome_matrices(paths["vcf"], 2 * len(samples),
                                   snarls_chr)
    consts = None
    with open(os.path.join(work, "profile_rows.tsv"), "w") as sink:
        while True:
            got = timed("native ingest", lambda: next(gen, None))
            if got is None:
                break
            chrom, matrix = got
            packs = timed("host pack", lambda: pack_chromosome_chunks(
                snarls_chr[chrom], matrix, 8192))

            def up():
                words = upload_words(chunk_words(packs[0]), device)
                if consts:
                    c = consts
                elif binary:
                    c = pheno_masks(pheno, packs[0].n_haplotypes,
                                    int(words.shape[1]), device)
                elif logistic:
                    c = (to_binary_pheno(pheno, device),
                         torch.zeros((len(samples), 0), dtype=torch.float64,
                                     device=device))
                else:
                    c = to_quant_inputs(pheno, covar, len(samples), device)
                return c, [to_device_chunk(p, pheno if binary else None,
                                           device, words=words,
                                           pheno=c if binary else None)
                           for p in packs]
            consts, chunks = timed("upload", up, sync=True)
            outs = timed("kernels", lambda: [analyze(c, consts)
                                             for c in chunks], sync=True)

            def fetch():
                res = [fetch_async(o) for o in outs]
                for r in res:
                    r.wait()
                return res
            res = timed("fetch", fetch)
            timed("format+write", lambda: [
                write(sink, chrom, p.snarls, r) for p, r in zip(packs, res)])

    out = os.path.join(work, f"out_profile_{mode}")
    if binary or logistic:
        args = cli_args(paths, out, device.type)
        if logistic:
            args += ["-c", paths["covariate"], "-C", ",".join(COVAR_NAMES)]
    else:
        args = quant_cli_args(paths, out, device.type, True)
    return trace_cli(torch, args, out_dir, mode,
                     f"{PROFILE_TITLES[mode]}: {paths['n_samples']} samples x "
                     f"{paths['n_snarls']} snarls", stage)


MODE_TITLES = {"bq": "vcf -b -q", "e": "vcf -e -G -c -C AGE,SEX",
               "lmm": "vcf -q -k --lmm -c -C AGE,SEX"}


def profile_mode(torch, device, paths, work, out_dir, mode):
    """--profile DIR: where the time of the dual run (mode "bq"), eQTL
    ("e") or the mixed model ("lmm") goes.  The stages run once serially
    (parse inputs, the null model's REML fit, native ingest, host pack,
    upload, kernels, fetch, the eQTL pairing, format+write), then
    torch.profiler traces one whole CUDA CLI run (trace_cli)."""
    import numpy as np
    from stoat_tpu_torch import writer as W
    from stoat_tpu_torch.convert import (chunk_words, pheno_masks,
                                         to_eqtl_expr, to_eqtl_pairs,
                                         to_lmm_inputs, to_quant_inputs,
                                         upload_words)
    from stoat_tpu_torch.io.phenotype import (parse_binary_pheno,
                                              parse_covariates,
                                              parse_kinship_matrix,
                                              parse_qtl_gene_file,
                                              parse_quantitative_pheno)
    from stoat_tpu_torch.io.snarl_file import parse_snarl_path
    from stoat_tpu_torch.io.vcf import VcfReader
    from stoat_tpu_torch.pipeline import quantitative as tq
    from stoat_tpu_torch.pipeline.runner import (found_gene_snarl,
                                                 iter_chromosome_matrices)
    from stoat_tpu_torch.stats.lmm import fit_null_reml
    from stoat_tpu_torch.tables import pack_chromosome_chunks
    stage = dict.fromkeys(("parse inputs", "null model", "native ingest",
                           "host pack", "upload", "kernels", "fetch",
                           "pairs", "format+write"), 0.0)

    def timed(name, fn, sync=False):
        t = time.perf_counter()
        out = fn()
        if sync:
            torch.cuda.synchronize()
        stage[name] += time.perf_counter() - t
        return out

    def parse():
        reader = VcfReader(paths["vcf"])
        samples = reader.samples
        reader.close()
        covar = (None if mode == "bq" else
                 parse_covariates(paths["covariate"], COVAR_NAMES, samples))
        if mode == "bq":
            pheno, samples = parse_binary_pheno(paths["binary"], samples)
            extra = parse_quantitative_pheno(paths["quantitative"], samples)
        elif mode == "e":
            pheno = parse_qtl_gene_file(paths["qtl_smoke"], paths["genes"],
                                        samples)
            extra = None
        else:
            pheno = parse_quantitative_pheno(paths["lmm_pheno"], samples)
            extra = parse_kinship_matrix(paths["kinship"])
        return pheno, extra, covar, samples, parse_snarl_path(paths["snarl"])
    pheno, extra, covar, samples, snarls_chr = timed("parse inputs", parse)
    N = len(samples)
    if mode == "lmm":
        def null():
            index = {s: i for i, s in enumerate(extra.ids)}
            order = [index[s] for s in samples]
            return fit_null_reml(pheno, extra.matrix[np.ix_(order, order)],
                                 covar)
        ctx = timed("null model", null)
    gen = iter_chromosome_matrices(paths["vcf"], 2 * N, snarls_chr)
    th = THRESHOLDS
    sink = open(os.path.join(work, "profile_rows.tsv"), "w")
    consts = None
    while True:
        got = timed("native ingest", lambda: next(gen, None))
        if got is None:
            break
        chrom, matrix = got
        chunk = 8192 if mode == "bq" else min(8192, int(2e9 // (N * 96)))
        packs = timed("host pack", lambda: pack_chromosome_chunks(
            snarls_chr[chrom], matrix, chunk))

        def up():
            words = upload_words(chunk_words(packs[0]), device)
            if consts is not None:
                return words, consts
            if mode == "bq":
                return words, (pheno_masks(pheno, 2 * N, int(words.shape[1]),
                                           device),
                               to_quant_inputs(extra, None, N, device))
            if mode == "e":
                return words, to_quant_inputs(np.zeros(N), covar, N,
                                              device)[1]
            return words, to_lmm_inputs(ctx, covar, N, device)
        words, consts = timed("upload", up, sync=True)
        for packed in packs:
            if mode == "bq":
                res = timed("kernels", lambda: tq.dual_analyze_chromosome(
                    packed, consts[0], *consts[1], *th, device, words=words),
                    sync=True)
                timed("fetch", res.wait)
                timed("format+write", lambda: (
                    W.write_binary_rows_batch(sink, chrom, packed.snarls,
                                              res),
                    W.write_quant_rows_batch(sink, chrom, packed.snarls,
                                             tq.PrefixView(res))))
            elif mode == "lmm":
                res = timed("kernels", lambda: tq.lmm_analyze_chromosome(
                    packed, *consts, *th, device, words=words), sync=True)
                timed("fetch", res.wait)
                timed("format+write", lambda: W.write_quant_rows_batch(
                    sink, chrom, packed.snarls, res))
            else:
                genes = pheno.get(chrom, [])
                d = timed("kernels", lambda: tq.eqtl_design_for_chromosome(
                    packed, consts, *th, device, words=words), sync=True)
                flags = timed("fetch", lambda: d["filtered"].cpu().numpy())

                def pairs():
                    ps, pg = [], []
                    for i, sn in enumerate(packed.snarls):
                        if not flags[i]:
                            for g in found_gene_snarl(genes, sn.start_pos,
                                                      sn.end_pos, 1000000):
                                ps.append(i)
                                pg.append(g)
                    return ps, pg
                ps, pg = timed("pairs", pairs)
                res = timed("kernels", lambda: tq.eqtl_regress_pairs(
                    d, *to_eqtl_pairs(ps, pg, int(d["X"].shape[0]), device),
                    to_eqtl_expr(genes, device)), sync=True)
                timed("fetch", res.wait)
                allele = d["allele_paths"].cpu().numpy()

                def rows():
                    p, r2, b, se = (res[k] for k in ("p", "r2", "beta",
                                                     "se"))
                    for i, (si, g) in enumerate(zip(ps, pg)):
                        sn = packed.snarls[si]
                        W.write_eqtl_row(
                            sink, chrom, sn, sn.type_var_str,
                            genes[g].gene_name, W.format_p(p[i]),
                            W.format_p(r2[i]), W.format_p(b[i]),
                            W.format_p(se[i]), allele[si][:sn.n_paths])
                timed("format+write", rows)
    sink.close()
    args = {"bq": ["-b", paths["binary"], "-q", paths["quantitative"]],
            "e": ["-e", paths["qtl_smoke"], "-G", paths["genes"], "-c",
                  paths["covariate"], "-C", ",".join(COVAR_NAMES)],
            "lmm": ["-q", paths["lmm_pheno"], "-k", paths["kinship"], "--lmm",
                    "-c", paths["covariate"], "-C",
                    ",".join(COVAR_NAMES)]}[mode]
    return trace_cli(torch, ["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                             *args, "-o", os.path.join(work,
                                                       f"out_profile_{mode}"),
                             "--device", device.type], out_dir, mode,
                     f"{MODE_TITLES[mode]}: {paths['n_samples']} samples x "
                     f"{paths['n_snarls']} snarls", stage)


def trace_cli(torch, args, out_dir, mode, title, stage):
    """torch.profiler over one whole CUDA CLI run of ``args``; writes the
    serial ``stage`` times, the run's wall and device busy time and the
    profiler's table to DIR/profile_<mode>.txt and returns a one-line
    summary."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from stoat_tpu_torch import cli
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc = cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(rc == 0, f"profiled CLI exit code {rc}")
    averages = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(averages[0], "self_device_time_total")
           else "self_cuda_time_total")
    # device-side rows only (kernels and copies): a CPU op's row repeats
    # the device time of what it launched
    device_us = sum(getattr(e, key) for e in averages
                    if e.device_type == DeviceType.CUDA)
    busy = device_us / 1e6 / wall
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{mode}.txt"), "w") as fh:
        fh.write(f"{nvidia_smi_line()}\n{title}\n\nserial stages (s):\n")
        for name, sec in stage.items():
            fh.write(f"  {name:16s} {sec:.4f}\n")
        fh.write(f"\nprofiled CUDA CLI run: wall {wall:.4f} s, device "
                 f"busy {device_us / 1e6:.4f} s ({100 * busy:.2f}%)\n\n")
        fh.write(averages.table(sort_by=key, row_limit=30))
    return (f"profile {mode}: serial stages " + ", ".join(
        f"{k} {v:.3f}s" for k, v in stage.items())
        + f"; traced CUDA CLI wall {wall:.3f}s, device busy "
        f"{device_us / 1e6:.4f}s = {100 * busy:.2f}% (idle "
        f"{100 - 100 * busy:.2f}%)")


def profile_graph(torch, device, graph, work, out_dir):
    """--profile DIR: where the time of ``graph -T chi2`` goes.  The stages
    run once serially (parse the phenotype, the native prepare, the
    counts' upload, K6 and its tails, the host copy, the native splice and
    write), then torch.profiler traces one whole CUDA CLI run."""
    import numpy as np
    from stoat_tpu_torch import writer as W
    from stoat_tpu_torch.io.phenotype import parse_binary_pheno
    from stoat_tpu_torch.native import (graph_assoc_native,
                                        graph_format_rows_native)
    from stoat_tpu_torch.convert import to_graph_counts
    from stoat_tpu_torch.graph.association import graph_stats
    from stoat_tpu_torch.pipeline.fetch import fetch_async
    stage = dict.fromkeys(("parse inputs", "native prepare", "upload",
                           "kernels", "fetch", "format+write"), 0.0)

    def timed(name, fn, sync=False):
        t = time.perf_counter()
        out = fn()
        if sync:
            torch.cuda.synchronize()
        stage[name] += time.perf_counter() - t
        return out
    pheno, samples = timed("parse inputs", lambda: parse_binary_pheno(
        graph["pheno"], []))
    blob, kinds, offs, g0, g1, _ = timed("native prepare", lambda:
                                         graph_assoc_native(
        graph["gfa"], {"ref"}, samples, pheno.astype(np.uint8), "chi2", 0))
    G0, G1, mask, k = timed("upload", lambda: to_graph_counts(
        kinds, offs, g0, g1, device), sync=True)
    outs = timed("kernels", lambda: graph_stats(G0, G1, mask), sync=True)
    res = timed("fetch", lambda: fetch_async(dict(zip(("p22", "pf", "pn"),
                                                      outs))))
    timed("fetch", res.wait)

    def write():
        text = graph_format_rows_native(blob, kinds, res["p22"], res["pf"],
                                        res["pn"], (k == 2).astype(np.uint8))
        with open(os.path.join(work, "profile_graph.tsv"), "w") as fh:
            W.write_binary_header(fh)
            fh.write(text.decode())
    timed("format+write", write)
    args = ["graph", "-p", graph["gfa"], "-d", graph["gfa"], "-b",
            graph["pheno"], "-r", "ref", "-V", "0", "-o",
            os.path.join(work, "out_profile_graph"), "--device", device.type]
    return trace_cli(torch, args, out_dir, "graph",
                     f"graph -T chi2: {graph['n_snarls']} snarls x "
                     f"{2 * graph['n_samples']} haplotype paths", stage)


def lmm_null_model(paths):
    """The mixed model's null fit as the CLI makes it (the kinship parsed
    and ordered to the VCF's samples, REML with the covariates), timed;
    returns the context and a note of its times, delta and h2."""
    import numpy as np
    from stoat_tpu_torch.io.phenotype import (parse_covariates,
                                              parse_kinship_matrix,
                                              parse_quantitative_pheno)
    from stoat_tpu_torch.stats.lmm import fit_null_reml
    samples = list(paths["samples"])
    t0 = time.perf_counter()
    kin = parse_kinship_matrix(paths["kinship"])
    t1 = time.perf_counter()
    index = {s: i for i, s in enumerate(kin.ids)}
    order = [index[s] for s in samples]
    ctx = fit_null_reml(
        parse_quantitative_pheno(paths["lmm_pheno"], samples),
        kin.matrix[np.ix_(order, order)],
        parse_covariates(paths["covariate"], COVAR_NAMES, samples))
    t2 = time.perf_counter()
    return ctx, (f"kinship {kin.matrix.shape[0]} x {kin.matrix.shape[1]} "
                 f"(rank {KIN_RANK}) parsed in {t1 - t0:.2f}s, REML null fit "
                 f"{t2 - t1:.2f}s: delta {ctx.delta:.4g}, h2 "
                 f"{ctx.heritability:.4f}")


def run(args):
    try:
        import torch
    except ImportError:
        sys.stderr.write("chip_smoke: torch is not importable\n")
        return 1
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device is available\n")
        return 1
    for path in (HERE, os.path.join(HERE, "tests")):
        if path not in sys.path:
            sys.path.insert(0, path)
    try:
        import stoat_tpu_torch  # noqa: F401
        from fixtures import make_fixture
    except ImportError as e:
        sys.stderr.write(f"chip_smoke: run it from a checkout of the "
                         f"repository ({e})\n")
        return 1
    logging.basicConfig(level=logging.ERROR)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    t_start = time.perf_counter()
    smi = phase_card(torch)
    with OneCard():
        launches, err, times, dev, bounds, library, cards = smoke(
            torch, device, args, smi, make_fixture)
    # library_ms: one PyTorch call computes K5's function
    # (torch.special.gammaincc); for perm_ols and score_perm it is their
    # GEMM core alone (one torch.matmul), for ols and eqtl_ols X^T X alone
    # (torch.einsum), for perm_binary the count product alone
    # (torch._int_mm), for score_precompute the weighted Gram alone
    # (torch.bmm); none computes any of the others
    kernels_json = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library.get(name), "device_ms": dev[name]}
        for name, (src, rep) in KERNELS.items()]
    # the tails' second launch shape, the permutation pass's [K, S]: the
    # same keys under "shapes" (launches are counted by kernel, not shape)
    for entry in kernels_json:
        entry["shapes"] = [
            {"shape": label, "ms": times[label][0],
             "plain_ms": times[label][1], "device_ms": dev[label],
             "bound_ms": bounds[label][0], "bound_by": bounds[label][1],
             "library_ms": library[label]}
            for label in times if label.startswith(entry["name"] + " ")
            and label.endswith("[K, S]")]
    # the cards the run used: phases 1-5, the kernels line and the mesh of
    # MESH_SHARDS shards on cuda:0; phase 6's mesh of every card, where
    # several are visible, on the others
    used = sorted({device} | cards, key=str)
    count = torch.cuda.device_count()
    check(len(used) == count, f"{count} cards visible, the run used "
          f"{len(used)}: {', '.join(map(str, used))}")
    others = [str(d) for d in used if d != device]
    say(f"chip_smoke total {time.perf_counter() - t_start:.1f}s on "
        f"{len(used)} card(s): phases 1-5, the kernels line and the mesh of "
        f"{MESH_SHARDS} shards on {device}" + (
            f"; phase 6's mesh of every card also on {', '.join(others)}"
            if others else ""))
    say(smi)
    say(json.dumps({"kernels": kernels_json}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": len(used)}}))
    return 0


def smoke(torch, device, args, smi, make_fixture):
    """Phases 2 to 5 on ``device``; returns (launches over the main paths'
    runs, max abs errors, times, device ms, bounds, library ms) per
    kernel."""
    phase_native()
    base = os.path.join(HERE, "build", "stoat_tpu_torch")
    os.makedirs(base, exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke-", dir=base)
    try:
        t0 = time.perf_counter()
        paths = make_fixture(os.path.join(work, "data"),
                             n_samples=N_SAMPLES, n_snarls=args.snarls,
                             seed=0, n_chroms=N_CHROMS)
        paths["n_samples"], paths["n_snarls"] = N_SAMPLES, args.snarls
        genes = write_genes(paths)
        write_kinship(paths)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        graph = write_graph(os.path.join(work, "graph"), args.graph_snarls)
        twin = write_graph(os.path.join(work, "twin"), TWIN_SNARLS, seed=1)
        say(f"graphs generated in {time.perf_counter() - t0:.1f}s: "
            f"{graph['n_snarls']} snarls x {2 * graph['n_samples']} "
            f"haplotype paths ({os.path.getsize(graph['gfa']) / 1e6:.0f} MB "
            f"GFA), and {twin['n_snarls']} for the Python twin")
        chunks = main_path_chunks(paths, device)
        lmm_ctx, lmm_note = lmm_null_model(paths)
        say(f"mixed model inputs: {lmm_note}")
        err = {name: 0.0 for name in KERNELS}
        g0p, g1p, tables, quant, logit = phase_kernels(torch, device, chunks,
                                                       err, graph)
        perm = phase_perm_kernels(torch, device, chunks, quant, logit, err)
        from stoat_tpu_torch.convert import to_lmm_inputs
        modes = phase_mode_kernels(
            torch, device, chunks, quant, err, genes,
            to_lmm_inputs(lmm_ctx, None, N_SAMPLES, device)[:2])
        launches = phase_main(torch, paths, work, N_CHROMS, gen_s)
        t0 = time.perf_counter()
        from stoat_tpu_torch.io.phenotype import (parse_binary_pheno,
                                                  parse_covariates,
                                                  parse_quantitative_pheno)
        samples = list(paths["samples"])
        covar = parse_covariates(paths["covariate"], COVAR_NAMES, samples)
        reference = quant_reference(
            paths, parse_quantitative_pheno(paths["quantitative"], samples),
            covar, parse_binary_pheno(paths["binary"], samples)[0],
            genes=genes, lmm=(lmm_ctx.rot, lmm_ctx.y_rot))
        say(f"phase 4 numpy regression reference: {len(reference[0])} "
            f"snarls, {len(reference[1])} sampled ({len(reference[2])} eQTL "
            f"pairs, {len(reference[3])} mixed-model tests), in "
            f"{time.perf_counter() - t0:.1f}s")
        for mode in ("q", "q_c", "b_c"):
            r_launches, _ = phase_main_regression(torch, paths, work,
                                                  N_CHROMS, mode, reference)
            for name in REGRESSION_PATHS[mode][1]:
                launches[name] = launches.get(name, 0) + r_launches[name]
        g_launches, _ = phase_graph(torch, graph, twin, work)
        for name in GRAPH_KERNELS:
            launches[name] = launches.get(name, 0) + g_launches[name]
        t0 = time.perf_counter()
        sub = make_fixture(os.path.join(work, "sub"), n_samples=N_SAMPLES,
                           n_snarls=SUB_SNARLS, seed=1, n_chroms=N_CHROMS)
        sub["n_samples"], sub["n_snarls"] = N_SAMPLES, SUB_SNARLS
        write_genes(sub, seed=1)
        # the same samples: the full cohort's kinship and phenotype
        sub["kinship"], sub["lmm_pheno"] = paths["kinship"], \
            paths["lmm_pheno"]
        say(f"phase 4 permutations: sub-cohort of {N_SAMPLES} samples x "
            f"{SUB_SNARLS} snarls generated in "
            f"{time.perf_counter() - t0:.1f}s for the CUDA-against-CPU "
            f"comparison at K = {PERM_SUB}; full size at K = {PERM_FULL}")
        perm_walls, cpu_walls = {}, {}
        for mode in ("b", "q", "q_c", "b_c", "bq"):
            p_launches, perm_walls[mode], cpu_walls[mode], line = \
                phase_perm_main(torch, paths, sub, work, N_CHROMS, mode)
            say(line)
            for name, n in p_launches.items():
                launches[name] = launches.get(name, 0) + n
        # the two quantitative passes again, in the same order: is a wall
        # the mode's own or the first run's?
        again = {}
        for mode in ("q", "q_c"):
            _, again[mode], _, line = phase_perm_main(
                torch, paths, None, work, N_CHROMS, mode)
            say(f"{line} (second run)")
        for name, n in phase_dual(torch, paths, work, N_CHROMS,
                                  reference)[0].items():
            launches[name] = launches.get(name, 0) + n
        for name, n in phase_eqtl(torch, paths, sub, work, N_CHROMS,
                                  reference, genes)[0].items():
            launches[name] = launches.get(name, 0) + n
        for name, n in phase_lmm(torch, paths, sub, work, N_CHROMS,
                                 reference, lmm_note)[0].items():
            launches[name] = launches.get(name, 0) + n
        t_launches, t_lines = phase_tables(torch, paths, sub, work, N_CHROMS)
        say("phase 4 -T regression tables: " + "; ".join(t_lines))
        for name, n in t_launches.items():
            launches[name] = launches.get(name, 0) + n
        t0 = time.perf_counter()
        cohort = write_cohort_gfa(paths, os.path.join(work, "cohort"))
        gfa_s = time.perf_counter() - t0
        gaf_launches, gaf_tsv, line = phase_gaf(torch, paths, work,
                                                N_CHROMS, cohort)
        say(f"{line}; the GFA written in {gfa_s:.1f}s")
        sim_launches, sim_tsv, line = phase_simulate(torch, work)
        say(line)
        for name, n in (*gaf_launches.items(), *sim_launches.items()):
            launches[name] = launches.get(name, 0) + n
        say("phase 4 " + "; ".join(
            phase_bhcorrect(work, tsv, what) for tsv, what in (
                (gaf_tsv, "the cohort's vcf -g table"),
                (sim_tsv, "the simulated vcf -b table"))))
        say(plot_note())
        say(phase_case3(twin, work))
        say(phase_baseline(paths, sub, graph, twin, work, smi))
        times, dev, bounds, library = phase_times(
            torch, chunks[0], g0p, g1p, tables, quant, logit, perm, modes,
            smi)
        say("phase 5 permutation pass walls (s, K = "
            f"{PERM_FULL}, {paths['n_snarls']} snarls): " + ", ".join(
                f"{PERM_TITLES[m]} {w:.3f} "
                f"({len(PERM_TABLES[m]) * PERM_FULL * paths['n_snarls'] / w:.4g}"
                f" permuted snarl-tests/s)" for m, w in perm_walls.items())
            + "; second runs: " + ", ".join(
                f"{PERM_TITLES[m]} {w:.3f}" for m, w in again.items()))
        mesh_launches, mesh_lines, cards = phase_mesh(torch, device, paths,
                                                      sub, work, N_CHROMS)
        for line in mesh_lines:
            say(line)
        for name, n in mesh_launches.items():
            launches[name] = launches.get(name, 0) + n
        if args.profile:
            for mode in ("b", "q_c", "b_c"):
                say(profile_main_path(torch, device, paths, work,
                                      args.profile, mode))
            say(profile_graph(torch, device, graph, work, args.profile))
            for mode in ("bq", "e", "lmm"):
                say(profile_mode(torch, device, paths, work, args.profile,
                                 mode))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches, err, times, dev, bounds, library, cards


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--snarls", type=int, default=65536,
                    help="snarls in the generated cohort (fewer for a "
                         "quick run)")
    ap.add_argument("--graph-snarls", type=int, default=GRAPH_SNARLS,
                    help="snarls in the generated graph (fewer for a quick "
                         "run)")
    ap.add_argument("--profile", metavar="DIR",
                    help="also write a stage breakdown and a torch.profiler "
                         "table of each main path to DIR/profile_<path>.txt")
    args = ap.parse_args()
    try:
        return run(args)
    except SmokeFailure as e:
        sys.stderr.write(f"chip_smoke: FAILED: {e}\n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
