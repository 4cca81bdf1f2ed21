#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (stoat_tpu_torch) on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
g++:

    python3 chip_smoke.py

It builds the port's six CUDA kernels (one nvcc per source, all at once)
and the native VCF core from the sources in the checkout, then runs five
phases, each printing one line and each fatal on failure:

  1. card: nvidia-smi name and power limit, torch and CUDA versions, the
     kernels' nvcc build with ptxas register and spill counts;
  2. native core: built into build/stoat_tpu_torch/native and loaded;
  3. kernels against their plain PyTorch versions, on the card, at the
     main path's shapes (the first chunk of ``vcf -b`` and of ``vcf -q
     -c``) and on edge cases (tolerances printed);
  4. main paths: the port's CLI, ``vcf -b``, ``vcf -q`` and ``vcf -q -c
     -C AGE,SEX`` with ``--device cuda``, on a generated cohort of 2,504
     samples (the 1000 Genomes phase-3 size) and 65,536 snarls on 2
     chromosomes; each path's kernels must have launched on every chunk;
     then the same runs with ``--device cpu`` (the binary TSVs byte for
     byte, the quantitative ones as phase 4 states), and numpy references
     built from the VCF text;
  5. each kernel's time and its plain version's, on the card, at the main
     path's shapes (CUDA events, after a warm-up, and profiler device
     time).

The last two lines of standard output are a JSON object of the kernels and
the contract line {"ok": true, "device": {...}}.  Without a CUDA device,
or outside a checkout of the repository, it exits non-zero and prints no
result.  The generated data lives under build/stoat_tpu_torch/ and is
removed at the end.  It imports nothing of JAX: only the JAX package's
host modules that the port reuses (parsers, packing, native core) and
tests/reference_impl.py (numpy and scipy).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the 1000 Genomes phase-3 cohort size, and two chromosomes so that the
# runner's per-chromosome pipelining runs
N_SAMPLES = 2504
N_CHROMS = 2

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
    "fisher": ("stoat_tpu_torch/csrc/fisher.cu",
               "stoat_tpu/stats/fisher.py:165"),
    "quant_design": ("stoat_tpu_torch/csrc/quant_design.cu",
                     "stoat_tpu/pipeline/quantitative.py:122"),
    "ols": ("stoat_tpu_torch/csrc/ols.cu", "stoat_tpu/stats/linreg.py:141"),
    "student_t": ("stoat_tpu_torch/csrc/student_t.cu",
                  "stoat_tpu/stats/linreg.py:206"),
}
BINARY_KERNELS = ("membership_counts", "binary_tables", "fisher")
QUANT_KERNELS = ("quant_design", "ols", "student_t")
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


# ---------------------------------------------------------------- reference

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


def quant_reference(paths, pheno, covar, n_sample=512, seed=0,
                    thresholds=THRESHOLDS):
    """What ``vcf -q`` must compute for a ``make_fixture`` cohort, from the
    VCF text, the phenotype and the covariates alone, in numpy.

    Returns ``(table, stats)``: ``table`` maps (chrom, snarl) to
    (filtered, allele_paths) for every snarl, in file order; ``stats``
    maps (chrom, snarl) of up to ``n_sample`` random unfiltered snarls to
    ((p, beta, se, r2) without covariates, the same with them), from
    tests/reference_impl.py (NaN for a degenerate snarl, whose merged
    columns all drop).  A haplotype carries path i exactly when its
    allele is i (reference_rows)."""
    import numpy as np
    from reference_impl import (combine_identical_columns,
                                filtration_quantitative, ols_reference)
    N = pheno.shape[0]
    sample_of = np.arange(2 * N) // 2
    records = []
    with open(paths["vcf"], "rb") as fh:
        for line in fh:
            if not line.startswith(b"#"):
                records.append(line)
    rng = np.random.default_rng(seed)
    chosen = set(rng.choice(len(records), min(len(records), n_sample + 64),
                            replace=False).tolist())
    table, stats = {}, {}
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
        if merged.shape[1] == 0:
            stats[key] = ((np.nan,) * 4, (np.nan,) * 4)
            continue
        stats[key] = (ols_reference(merged, pheno[used], None),
                      ols_reference(merged, pheno[used], covar[used]))
    return table, stats


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
    from stoat_tpu.writer import format_p
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


def membership_case(seed, E, H, P, max_k=5):
    import numpy as np
    from stoat_tpu_torch.pipeline import packed as pk
    rng = np.random.default_rng(seed)
    matrix = rng.random((E, H)) < 0.6
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
    from stoat_tpu.writer import format_p
    from stoat_tpu_torch.stats.special import chi2_sf

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

    # K4: pinned strings, overflow tables, a random batch
    def cols(tables):
        t = torch.tensor(tables, dtype=torch.float64, device=device)
        return tuple(t[:, i].contiguous() for i in range(4))
    compare_fisher(cols([t for t, _ in FISHER_CASES]), err,
                   expected=[s for _, s in FISHER_CASES])
    compare_fisher(cols(OVERFLOW_TABLES), err,
                   expected=["0"] * len(OVERFLOW_TABLES))
    rng = np.random.default_rng(1)
    for hi in (60, 400, 5000):
        tables = rng.integers(0, hi, (4096, 4)).astype(float)
        tables[:64, 0] = 0
        tables[64:96, :2] = 0
        compare_fisher(cols(tables.tolist()), err)

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
        compare_tables(torch.from_numpy(g0).to(device),
                       torch.from_numpy(g1).to(device),
                       torch.from_numpy(sidx).to(device), thr, err)

    # K5: torch.special.gammaincc on the card vs the CPU
    grid = [(s, d) for s in TAIL_STATS for d in TAIL_DFS]
    st = torch.tensor([s for s, _ in grid], dtype=torch.float64)
    df = torch.tensor([float(d) for _, d in grid], dtype=torch.float64)
    on_card = to_np(chi2_sf(st.to(device), df.to(device)))
    on_cpu = chi2_sf(st, df).numpy()
    check([format_p(v) for v in on_card] == [format_p(v) for v in on_cpu],
          "chi2_sf: format_p differs between the card and the CPU")
    big = on_cpu > 1e-300
    tail_rel = float(np.max(np.abs(on_card[big] - on_cpu[big])
                            / on_cpu[big]))
    check(tail_rel <= 1e-12, f"chi2_sf: relative error {tail_rel}")
    return (f"edge cases ok (zero-edge/invalid paths, H=7/31/32/101/5008,"
            f" {len(FISHER_CASES)} pinned + {len(OVERFLOW_TABLES)} "
            f"overflow + 12288 random Fisher tables, zero-margin 2x2/2xN, "
            f"chi2_sf grid max rel err {tail_rel:.3g})")


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


def stat_err(name, a, b, se=None):
    """Max error of OLS statistic ``name`` of ``a`` against ``b`` in the
    scale its printed string carries (see the bounds above); inf unless
    NaN and infinities agree."""
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


def compare_quant_design(chunk, covar, n_haplotypes, err):
    """Q1 kernel vs its plain version on the card and on the CPU."""
    from stoat_tpu_torch.convert import DeviceChunk
    from stoat_tpu_torch.pipeline.quantitative import (quant_design,
                                                       quant_design_plain)
    got = quant_design(chunk, covar, *THRESHOLDS, n_haplotypes)
    e = design_equal(got, quant_design_plain(chunk, covar, *THRESHOLDS,
                                             n_haplotypes), "card")
    host = DeviceChunk(chunk.words.cpu(), chunk.path_idx.cpu(),
                       chunk.path_valid.cpu(), chunk.snarl_path_idx.cpu())
    e = max(e, design_equal(got, quant_design_plain(
        host, covar.cpu(), *THRESHOLDS, n_haplotypes), "CPU"))
    err["quant_design"] = max(err["quant_design"], e)
    return got


OLS_NAMES = ("t1", "df_res", "beta1", "se1", "r2")


def compare_ols(X, y, mask, ncols, err, bound, what, noise_rows=(),
                pinv=(), pinv_bound=None):
    """Q2 kernel vs plain on the card: each output's max error (stat_err),
    held to ``bound``, and to ``pinv_bound`` on the ``pinv`` rows (those
    that take the pseudo-inverse).  ``noise_rows`` have a constant
    phenotype (tss = 0): there r2 must not be finite in either, and beta1
    and se1 are rounding noise (below 1e-9) whose ratio t1 no summation
    order reproduces."""
    import numpy as np
    from stoat_tpu_torch.stats.linreg import (linear_regression_stats,
                                              linear_regression_stats_plain)
    got = linear_regression_stats(X, y, mask, ncols)
    plain = linear_regression_stats_plain(X, y, mask, ncols)
    groups = np.zeros(X.shape[0], np.int8)     # 0 normal, 1 pinv, 2 noise
    groups[list(pinv)] = 1
    groups[list(noise_rows)] = 2
    se_plain = to_np(plain[3])
    errs = {}
    for name, g, p in zip(OLS_NAMES, got, plain):
        a, b = to_np(g), to_np(p)
        for group, limit in ((0, bound), (1, pinv_bound)):
            rows = groups == group
            if not rows.any():
                continue
            e = stat_err(name, a[rows], b[rows], se_plain[rows])
            check(e <= limit, f"ols ({what}{', pinv rows' if group else ''}"
                  f"): {name} error {e:.3g} > {limit:g}")
            errs[name] = max(errs.get(name, 0.0), e)
        keep = groups != 2
        err["ols"] = max(err["ols"], max_abs_err(a[keep], b[keep]))
        for r in noise_rows:
            if name == "r2":
                check(not np.isfinite(a[r]) and not np.isfinite(b[r]),
                      f"ols ({what}): r2 of a constant phenotype is finite")
            if name in ("beta1", "se1"):
                check(abs(a[r]) < 1e-9 and abs(b[r]) < 1e-9,
                      f"ols ({what}): {name} of a constant phenotype")
    return got, errs


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
    """B OLS designs [1 | dosage fractions | covariates], padded to
    [B, N, P] with their own used rows: snarl 0 has two equal dosage
    columns and snarl 1 a covariate collinear with a dosage (both take the
    pseudo-inverse), snarl 2 a constant phenotype (tss = 0)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    X = np.zeros((B, N, P))
    y = np.zeros((B, N))
    mask = rng.random((B, N)) < 0.8
    ncols = np.zeros(B, np.int32)
    pheno = rng.standard_normal(N) * 2.0 + 5.0
    covar = rng.standard_normal((N, C))
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
        ncols[b] = Xb.shape[1]
        X[b, :, :ncols[b]] = Xb
        y[b] = 3.0 if b == 2 else pheno
    X[~mask] = 0.0
    y[~mask] = 0.0
    return tuple(torch.from_numpy(a).to(device) for a in (X, y, mask, ncols))


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
    from stoat_tpu_torch.pipeline import packed as pk
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
    coo_path = np.array([p for p, (rows, _) in enumerate(paths)
                         for _ in rows], np.int32)
    coo_row = np.array([r for rows, _ in paths for r in rows], np.int32)
    valid = np.array([v for _, v in paths])
    words = pk.pack_matrix_words(matrix)
    idx = pk.pack_path_edge_idx(coo_path, coo_row, valid, E)
    chunk = DeviceChunk(
        *(upload_t(a, device) for a in (words.view(np.int32), idx, valid,
                                        sidx)))
    return chunk, H


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
        y = pheno[None, :] * used
        bad, _ = pinv_rows(d["X"], d["ncols"])
        check(2 in bad, f"ols: snarl 2 (constant variant column) did not "
              f"take the pseudo-inverse ({bad})")
        stats, _ = compare_ols(d["X"], y, used, d["ncols"], err, OLS_REL,
                               f"edge chunk, C={C}", pinv=bad,
                               pinv_bound=OLS_PINV_REL)
        out, _ = compare_student_t(*stats[:2], d["degenerate"], *stats[2:],
                                   err, f"edge chunk, C={C}")
        check(all(np.isnan(to_np(out[k])[1]) for k in out),
              "student_t: a degenerate snarl is not NA")
        notes.append(f"C={C}: pinv rows {bad}")

    # Q2: rank-deficient designs, PT = 7 and PT = 12, constant phenotype
    ols_errs = {}
    for seed, P in ((1, 7), (2, 12)):
        X, y, mask, ncols = ols_cases(device, seed, 64, 300, P)
        bad, _ = pinv_rows(X, ncols)
        check(0 in bad and 1 in bad, f"ols: PT={P} designs 0 and 1 did "
              f"not take the pseudo-inverse ({bad})")
        _, errs = compare_ols(X, y, mask, ncols, err, OLS_REL, f"PT={P}",
                              noise_rows=(2,), pinv=bad,
                              pinv_bound=OLS_PINV_REL)
        for name, e in errs.items():
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
    build.build_all(list(KERNELS))          # one nvcc per source, together
    summaries = []
    for name in KERNELS:
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
    import stoat_tpu.native as native
    lib_dir = os.path.join(HERE, "build", "stoat_tpu_torch", "native")
    os.makedirs(lib_dir, exist_ok=True)
    lib_path = os.path.join(lib_dir, "libstoat_core.so")
    # a library built here, never one copied in from another machine
    native._LIB = lib_path
    t0 = time.perf_counter()
    lib = native.get_lib()
    check(lib is not None, "native core failed to build or load")
    check(os.path.samefile(lib._name, lib_path),
          f"native core loaded from {lib._name}")
    say(f"phase 2 native core: {lib_path} loaded in "
        f"{time.perf_counter() - t0:.1f}s")


def main_path_chunks(paths, device):
    """The first chunk of the first chromosome, as the main paths build it,
    on the card: the binary DeviceChunk, the quantitative one (the same
    words, no masks), the quantitative phenotype [N] and the AGE and SEX
    covariates [N, 2], and H.  (The quantitative chunk cap,
    2e9 // (N * 96) = 8,319 at N = 2,504, leaves the chunk at 8,192.)"""
    from stoat_tpu.io.phenotype import (parse_binary_pheno, parse_covariates,
                                        parse_quantitative_pheno)
    from stoat_tpu.io.snarl_file import parse_snarl_path
    from stoat_tpu.io.vcf import VcfReader
    from stoat_tpu.tables import pack_chromosome_chunks
    from stoat_tpu_torch.convert import to_device_chunk, to_quant_inputs
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
    return chunk, qchunk, qpheno, qcovar, packed.n_haplotypes


def phase_kernels(torch, device, chunks, err):
    chunk, qchunk, qpheno, qcovar, H = chunks
    args = (chunk.words, chunk.path_idx, chunk.path_valid, chunk.tail,
            chunk.g1_words)
    g0p, g1p = compare_membership(args, err)
    tables = compare_tables(g0p, g1p, chunk.snarl_path_idx, (3, 5, 0.05),
                            err)
    abcd = (tables["a"], tables["b"], tables["c"], tables["d"])
    compare_fisher(abcd, err)
    shapes = (f"words {tuple(chunk.words.shape)}, path_idx "
              f"{tuple(chunk.path_idx.shape)}, snarl_path_idx "
              f"{tuple(chunk.snarl_path_idx.shape)}")
    edges = edge_cases(device, err)
    torch.cuda.synchronize()
    say(f"phase 3 kernels vs plain: main-path shapes ({shapes}) ok; "
        f"{edges}; tolerances: counts/flags/keep exact, Fisher bitwise, "
        f"chi2 stat rel 1e-12, chi2_sf rel 1e-12 for p > 1e-300; max abs "
        f"err " + ", ".join(f"{k}={err[k]:.3g}" for k in BINARY_KERNELS))

    # Q1 -> Q2 -> Q3 on the first chunk of `vcf -q -c`
    d = compare_quant_design(qchunk, qcovar, H, err)
    used = d["used"]
    y = qpheno[None, :] * used
    bad, nearest = pinv_rows(d["X"], d["ncols"])
    filtered = to_np(d["filtered"])
    bad_kept = [r for r in bad if not filtered[r]]
    stats, ols_errs = compare_ols(d["X"], y, used, d["ncols"], err, OLS_REL,
                                  "main chunk", pinv=bad,
                                  pinv_bound=OLS_PINV_REL)
    _, t_worst = compare_student_t(*stats[:2], d["degenerate"], *stats[2:],
                                   err, "main chunk")
    qedges = quant_edge_cases(device, err)
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
        f"max abs err "
        + ", ".join(f"{k}={err[k]:.3g}" for k in QUANT_KERNELS))
    quant = {"chunk": qchunk, "covar": qcovar, "H": H, "X": d["X"], "y": y,
             "used": used, "ncols": d["ncols"], "deg": d["degenerate"],
             "stats": stats}
    return g0p, g1p, tables, quant


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
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(cli_args(paths, out_cuda, "cuda"))
    torch.cuda.synchronize()
    wall_cuda = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"CUDA CLI exit code {rc}")
    for name, n in launches.items():
        check((n > 0) == (name in BINARY_KERNELS),
              f"kernel {name}: {n} launches on the binary path")
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
        + f"; launches {launches}; native ingest of "
        f"{native_runs} chromosomes, python fallback 0; "
        f"max_memory_allocated {peak / 2**20:.1f} MiB")
    return launches


QUANT_STATS = ("p", "beta", "se", "r2")


def run_captured(cli, args):
    """Run the CLI; return its exit code and each snarl's results as the
    writer received them, at full precision: {(chrom, snarl): (filtered,
    allele_paths, (p, beta, se, r2))}."""
    import numpy as np
    from stoat_tpu import writer as W
    real = W.write_quant_rows_batch
    got = {}

    def capture(fh, chrom, snarls, res, has_r2=True):
        filtered = np.array(res["filtered"])
        allele = np.array(res["allele_paths"])
        stats = np.stack([np.array(res[k]) for k in QUANT_STATS], axis=1)
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


def compare_quant_tsvs(tsv_cuda, tsv_cpu, got_cuda, got_cpu):
    """The CUDA and CPU TSVs of one `vcf -q` run: the same rows and the
    same PATH_LENGTHS, ALLELE_PATHS and DEPTH columns and NA cells; a
    statistic string may differ only where the two float64 values agree
    to TSV_REL.  Returns (rows, differing cells)."""
    with open(tsv_cuda) as fh:
        a = fh.read().splitlines()
    with open(tsv_cpu) as fh:
        b = fh.read().splitlines()
    check(a[0] == b[0] and a[0].startswith("#CHR\t"), "TSV headers")
    check(len(a) == len(b), f"CUDA TSV has {len(a)} lines, CPU {len(b)}")
    diffs = []
    for la, lb in zip(a[1:], b[1:]):
        ca, cb = la.split("\t"), lb.split("\t")
        check(len(ca) == 11 and len(cb) == 11, f"malformed row {la!r}")
        check([ca[i] for i in (0, 1, 2, 3, 4, 9, 10)]
              == [cb[i] for i in (0, 1, 2, 3, 4, 9, 10)],
              f"rows differ: {la!r} / {lb!r}")
        key = (ca[0], ca[3])
        for col, name in zip((5, 6, 7, 8), ("p", "r2", "beta", "se")):
            if ca[col] == cb[col]:
                continue
            check("NA" not in (ca[col], cb[col]), f"NA differs: {la!r} / "
                  f"{lb!r}")
            k = QUANT_STATS.index(name)
            va, vb = got_cuda[key][2][k], got_cpu[key][2][k]
            rel = stat_err(name, [va], [vb], [got_cpu[key][2][2]])
            check(rel <= TSV_REL, f"{key} {name}: {ca[col]} / {cb[col]} "
                  f"({va!r} / {vb!r}, relative {rel:.3g})")
            diffs.append(f"{key[0]} {key[1]} {name} {ca[col]}/{cb[col]} "
                         f"({va!r}/{vb!r}, rel {rel:.2g})")
    return len(a) - 1, diffs


def phase_main_quant(torch, paths, work, n_chroms, with_covar, reference):
    """`vcf -q` (or `vcf -q -c -C AGE,SEX`) on the card, then on the CPU:
    Q1-Q3 on every chunk, the TSVs against each other, and the results
    against the numpy reference."""
    import math
    from stoat_tpu_torch import cli, kernels
    table, stats = reference
    tag = "q_c" if with_covar else "q"
    out_cuda = os.path.join(work, f"out_cuda_{tag}")
    out_cpu = os.path.join(work, f"out_cpu_{tag}")
    # the runner's chunk cap, and make_fixture's split over chromosomes
    chunk = min(8192, max(int(2e9 // (paths["n_samples"] * 96)), 256))
    per_chrom = -(-paths["n_snarls"] // n_chroms)
    sizes = [min(per_chrom, paths["n_snarls"] - c * per_chrom)
             for c in range(n_chroms)]
    n_chunks = sum(math.ceil(n / chunk) for n in sizes if n > 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc, got_cuda = run_captured(cli, quant_cli_args(paths, out_cuda, "cuda",
                                                    with_covar))
    torch.cuda.synchronize()
    wall_cuda = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"CUDA CLI exit code {rc}")
    for name, n in launches.items():
        want = n_chunks if name in QUANT_KERNELS else 0
        check(n == want, f"kernel {name}: {n} launches on the -q path, "
              f"expected {want} ({n_chunks} chunks)")
    t1 = time.perf_counter()
    rc, got_cpu = run_captured(cli, quant_cli_args(paths, out_cpu, "cpu",
                                                   with_covar))
    wall_cpu = time.perf_counter() - t1
    check(rc == 0, f"CPU CLI exit code {rc}")
    table_name = "quantitative_table_vcf.tsv"
    n_rows, diffs = compare_quant_tsvs(os.path.join(out_cuda, table_name),
                                       os.path.join(out_cpu, table_name),
                                       got_cuda, got_cpu)

    # every snarl's filter and ALLELE_PATHS against the numpy reference,
    # the TSV's rows are exactly the unfiltered snarls, and p, beta, se,
    # r2 of the sampled snarls at REF_REL
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
    for key, ref in stats.items():
        ref = ref[1] if with_covar else ref[0]
        e = max(stat_err(name, [got_cuda[key][2][k]], [ref[k]], [ref[2]])
                for k, name in enumerate(QUANT_STATS))
        n_na += all(math.isnan(v) for v in ref)
        check(e <= REF_REL, f"{key}: {got_cuda[key][2]} vs reference {ref} "
              f"(relative {e:.3g})")
        worst = max(worst, e)
    say(f"phase 4 main path: vcf -q{' -c -C AGE,SEX' if with_covar else ''}"
        f" on {paths['n_samples']} samples x {paths['n_snarls']} snarls: "
        f"cuda wall {wall_cuda:.2f}s, cpu wall {wall_cpu:.2f}s; launches "
        f"{launches} ({n_chunks} chunks); {n_rows} rows, CUDA and CPU TSVs "
        f"equal in rows, PATH_LENGTHS/ALLELE_PATHS/DEPTH and NA cells, "
        f"{len(diffs)} statistic strings differ (float64 values within "
        f"rel {TSV_REL:g}){': ' + '; '.join(diffs[:10]) if diffs else ''};"
        f" filter and ALLELE_PATHS of all {len(table)} snarls equal the "
        f"numpy reference ({n_filtered} filtered); p, beta, se, r2 of "
        f"{len(stats)} sampled snarls ({n_na} NA) within "
        f"{worst:.3g} of tests/reference_impl.py (bound {REF_REL:g}); "
        f"max_memory_allocated {peak / 2**20:.1f} MiB")
    return launches, wall_cuda


def device_ms(torch, calls):
    """Device time per call of each named kernel under torch.profiler:
    {name: ms}, None where the trace shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(averages[0], "self_device_time_total")
           else "self_cuda_time_total")
    out = {}
    for name in calls:
        us = sum(getattr(e, key) for e in averages
                 if e.device_type == DeviceType.CUDA
                 and f"{name}_kernel" in e.key)
        out[name] = us / 1e3 / reps if us else None
    return out


def phase_times(torch, chunk, g0p, g1p, tables, quant, smi):
    from stoat_tpu_torch.pipeline.binary import (binary_tables,
                                                 binary_tables_plain)
    from stoat_tpu_torch.pipeline.packed import (membership_counts,
                                                 membership_counts_plain)
    from stoat_tpu_torch.pipeline.quantitative import (quant_design,
                                                       quant_design_plain)
    from stoat_tpu_torch.stats.chi2 import finish_chi2_pvalues
    from stoat_tpu_torch.stats.fisher import (fisher_exact_2x2,
                                              fisher_exact_2x2_plain)
    from stoat_tpu_torch.stats.linreg import (linear_regression_stats,
                                              linear_regression_stats_plain,
                                              student_t_pvalues,
                                              student_t_pvalues_plain)
    args = (chunk.words, chunk.path_idx, chunk.path_valid, chunk.tail,
            chunk.g1_words)
    sidx = chunk.snarl_path_idx
    thr = (3, 5, 0.05)
    abcd = (tables["a"], tables["b"], tables["c"], tables["d"])
    q = quant
    design = (q["chunk"], q["covar"], *THRESHOLDS, q["H"])
    ols = (q["X"], q["y"], q["used"], q["ncols"])
    tail = (*q["stats"][:2], q["deg"], *q["stats"][2:])
    calls = {
        "membership_counts": lambda: membership_counts(*args),
        "binary_tables": lambda: binary_tables(g0p, g1p, sidx, *thr),
        "fisher": lambda: fisher_exact_2x2(*abcd),
        "quant_design": lambda: quant_design(*design),
        "ols": lambda: linear_regression_stats(*ols),
        "student_t": lambda: student_t_pvalues(*tail),
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
        "quant_design": (
            cuda_ms(calls["quant_design"], 10),
            cuda_ms(lambda: quant_design_plain(*design), 3, warmup=1)),
        "ols": (
            cuda_ms(calls["ols"], 10),
            cuda_ms(lambda: linear_regression_stats_plain(*ols), 3,
                    warmup=1)),
        "student_t": (
            cuda_ms(calls["student_t"], 20),
            cuda_ms(lambda: student_t_pvalues_plain(*tail), 3, warmup=1)),
    }
    tail_ms = cuda_ms(lambda: finish_chi2_pvalues(
        tables["chi2_stat"], tables["chi2_df"], tables["chi2_invalid"],
        tables["chi2_zexp"]), 20)
    dev = device_ms(torch, calls)
    say(f"phase 5 times on {smi} (ms per chunk call, kernel / plain; "
        f"device ms per call from torch.profiler): " + "; ".join(
            f"{k} {a:.4f} / {b:.4f} (device "
            f"{'not measured' if dev[k] is None else f'{dev[k]:.4f}'})"
            for k, (a, b) in times.items())
        + f"; chi2 tail (torch.special, K5) {tail_ms:.4f}")
    return times, dev


def profile_main_path(torch, device, paths, work, out_dir, mode):
    """--profile DIR: where the time of one main path goes (mode "b" for
    `vcf -b`, "q_c" for `vcf -q -c -C AGE,SEX`).  The stages run once
    serially (the runner overlaps ingest, dispatch and writing on three
    threads), then torch.profiler traces one whole CUDA CLI run.  Writes
    DIR/profile_<mode>.txt and returns a one-line summary."""
    from torch.profiler import ProfilerActivity, profile
    from stoat_tpu import writer as W
    from stoat_tpu.io.phenotype import (parse_binary_pheno, parse_covariates,
                                        parse_quantitative_pheno)
    from stoat_tpu.io.snarl_file import parse_snarl_path
    from stoat_tpu.io.vcf import VcfReader
    from stoat_tpu.tables import pack_chromosome_chunks
    from stoat_tpu_torch import cli
    from stoat_tpu_torch.convert import (chunk_words, pheno_masks,
                                         to_device_chunk, to_quant_inputs,
                                         upload_words)
    from stoat_tpu_torch.pipeline.binary import binary_tables_packed
    from stoat_tpu_torch.pipeline.fetch import fetch_async
    from stoat_tpu_torch.pipeline.quantitative import quant_design
    from stoat_tpu_torch.pipeline.runner import iter_chromosome_matrices
    from stoat_tpu_torch.stats.linreg import (linear_regression_stats,
                                              student_t_pvalues)

    binary = mode == "b"
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
        if binary:
            pheno, samples = parse_binary_pheno(paths["binary"], samples)
            covar = None
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
        stats = linear_regression_stats(d.pop("X"), consts[0][None, :] *
                                        used, used, d["ncols"])
        return {"filtered": d["filtered"],
                "allele_paths": d["allele_paths"],
                **student_t_pvalues(*stats[:2], d["degenerate"],
                                    *stats[2:])}

    write = W.write_binary_rows_batch if binary else W.write_quant_rows_batch
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
                c = consts or (
                    pheno_masks(pheno, packs[0].n_haplotypes,
                                int(words.shape[1]), device) if binary
                    else to_quant_inputs(pheno, covar, len(samples), device))
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
    args = (cli_args(paths, out, device.type) if binary
            else quant_cli_args(paths, out, device.type, True))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc = cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(rc == 0, f"profiled CLI exit code {rc}")
    from torch.autograd import DeviceType
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
        fh.write(f"{nvidia_smi_line()}\n"
                 f"{'vcf -b' if binary else 'vcf -q -c -C AGE,SEX'}: "
                 f"{paths['n_samples']} samples x {paths['n_snarls']} "
                 f"snarls\n\nserial stages (s):\n")
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


def run(args):
    # the run uses one card, the first visible one, and so reports one
    os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
        "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
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
        gen_s = time.perf_counter() - t0
        chunks = main_path_chunks(paths, device)
        err = {name: 0.0 for name in KERNELS}
        g0p, g1p, tables, quant = phase_kernels(torch, device, chunks, err)
        launches = phase_main(torch, paths, work, N_CHROMS, gen_s)
        t0 = time.perf_counter()
        from stoat_tpu.io.phenotype import (parse_covariates,
                                            parse_quantitative_pheno)
        samples = list(paths["samples"])
        reference = quant_reference(
            paths, parse_quantitative_pheno(paths["quantitative"], samples),
            parse_covariates(paths["covariate"], COVAR_NAMES, samples))
        say(f"phase 4 numpy quantitative reference: {len(reference[0])} "
            f"snarls, {len(reference[1])} sampled, in "
            f"{time.perf_counter() - t0:.1f}s")
        for with_covar in (False, True):
            q_launches, _ = phase_main_quant(torch, paths, work, N_CHROMS,
                                             with_covar, reference)
            for name in QUANT_KERNELS:
                launches[name] = launches.get(name, 0) + q_launches[name]
        times, dev = phase_times(torch, chunks[0], g0p, g1p, tables, quant,
                                 smi)
        if args.profile:
            for mode in ("b", "q_c"):
                say(profile_main_path(torch, device, paths, work,
                                      args.profile, mode))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kernels_json = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "device_ms": dev[name]}
        for name, (src, rep) in KERNELS.items()]
    count = torch.cuda.device_count()
    check(count == 1, f"{count} devices visible, the run used 1")
    say(f"chip_smoke total {time.perf_counter() - t_start:.1f}s")
    say(smi)
    say(json.dumps({"kernels": kernels_json}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": count}}))
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--snarls", type=int, default=65536,
                    help="snarls in the generated cohort (fewer for a "
                         "quick run)")
    ap.add_argument("--profile", metavar="DIR",
                    help="also write a stage breakdown and a torch.profiler "
                         "table of the main path to DIR/profile.txt")
    args = ap.parse_args()
    try:
        return run(args)
    except SmokeFailure as e:
        sys.stderr.write(f"chip_smoke: FAILED: {e}\n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
