#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (stoat_tpu_torch) on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
g++:

    python3 chip_smoke.py

It builds the port's eight CUDA kernels (one nvcc per source, all at
once) and the native VCF and graph cores from the sources in the
checkout, then runs five phases, each printing lines and each fatal on
failure:

  1. card: nvidia-smi name and power limit, torch and CUDA versions, the
     kernels' nvcc build with ptxas register and spill counts;
  2. native cores: built into build/stoat_tpu_torch/native and loaded;
  3. kernels against their plain PyTorch versions, on the card, at the
     main paths' shapes (the first chunk of ``vcf -b``, of ``vcf -q -c``
     and of ``vcf -b -c``, and the main graph's partition counts) and on
     edge cases (tolerances printed);
  4. main paths: the port's CLI with ``--device cuda``: ``vcf -b``, ``vcf
     -q``, ``vcf -q -c -C AGE,SEX`` and ``vcf -b -c -C AGE,SEX`` on a
     generated cohort of 2,504 samples (the 1000 Genomes phase-3 size)
     and 65,536 snarls on 2 chromosomes, each path's kernels launched on
     every chunk; ``graph`` on a generated graph of 100,000 snarls walked
     by 90 haplotype paths (the HPRC release-1 count), through the native
     path; then the same runs with ``--device cpu`` (the binary and graph
     outputs byte for byte, the regression TSVs as phase 4 states), numpy
     and scipy references built from the inputs' text, and graph mode's
     Python twin against its native path;
  5. each kernel's time and its plain version's, on the card, at the main
     paths' shapes (CUDA events, after a warm-up, and profiler device
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
    "graph_stats": ("stoat_tpu_torch/csrc/graph_stats.cu",
                    "stoat_tpu/graph/association.py:496"),
    "logreg": ("stoat_tpu_torch/csrc/logreg.cu",
               "stoat_tpu/stats/logreg.py:44"),
}
BINARY_KERNELS = ("membership_counts", "binary_tables", "fisher")
QUANT_KERNELS = ("quant_design", "ols", "student_t")
BC_KERNELS = ("quant_design", "logreg")
GRAPH_KERNELS = ("graph_stats",)
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
# tests/reference_impl.py (scipy); a 4-digit string may flip at a rounding
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


def memory_note(peak, held):
    """A run's peak device memory, and how much of it earlier phases'
    tensors (kept for phase 5) already held when the run started."""
    return (f"{peak / 2**20:.1f} MiB ({(peak - held) / 2**20:.1f} MiB above "
            f"the {held / 2**20:.1f} MiB held before the run)")


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


def quant_reference(paths, pheno, covar, case, n_sample=512, seed=0,
                    thresholds=THRESHOLDS):
    """What ``vcf -q`` and ``vcf -b -c`` must compute for a
    ``make_fixture`` cohort, from the VCF text, the phenotypes and the
    covariates alone, in numpy.

    Returns ``(table, stats)``: ``table`` maps (chrom, snarl) to
    (filtered, allele_paths) for every snarl, in file order (the two
    modes filter alike); ``stats`` maps (chrom, snarl) of up to
    ``n_sample`` random unfiltered snarls to ((p, beta, se, r2) of OLS
    without covariates, the same with them, (p, beta, se) of the logistic
    model of the bool phenotype ``case``), from tests/reference_impl.py
    (NaN for a degenerate snarl, whose merged columns all drop, and for a
    logistic fit that never converges).  A haplotype carries path i
    exactly when its allele is i (reference_rows)."""
    import numpy as np
    from reference_impl import (combine_identical_columns,
                                filtration_quantitative, irls_reference,
                                ols_reference)
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
            stats[key] = ((np.nan,) * 4, (np.nan,) * 4, (np.nan,) * 3)
            continue
        logit = irls_reference(merged, case[used].astype(float))
        stats[key] = (ols_reference(merged, pheno[used], None),
                      ols_reference(merged, pheno[used], covar[used]),
                      (np.nan,) * 3 if logit is None else logit)
    return table, stats


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
    Returns {"gfa",
    "pheno", "n_snarls", "n_samples"}."""
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
    ref_steps = []
    for k in range(n_snarls):
        m1, m2 = node("C"), node("GG")
        alleles = [[m1]]
        if k % 11 == 4:                       # m2 -> (n1 | n2) -> m3
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
    base = np.asarray(offs[:-1], np.int64)
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
            "n_samples": n_samples}


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


# ---------------------------------------------------------------- graph, logit

def compare_graph_stats(G0, G1, mask, err, expected_fisher=None):
    """K6 kernel vs plain: bitwise on the card (the tails are the same
    torch ops on bitwise statistics); against the CPU's plain version
    Fisher bitwise and the chi-squared p-values (torch.special.gammaincc on
    the card and on the CPU) to a relative 1e-12 with equal strings."""
    from stoat_tpu.writer import format_p
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
    for Pm in (2, 3, 8):
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
            f"Fisher rows, 3 x 4096 random rows with k = 2..2/3/8, zero "
            f"margins and zero columns")


def graph_counts(graph, device):
    """The main graph's K6 inputs, from the native prepare as ``graph``
    runs it: (G0, G1, mask) on ``device``, and k."""
    import numpy as np
    from stoat_tpu.io.phenotype import parse_binary_pheno
    from stoat_tpu.native import graph_assoc_native
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


def compare_logreg(X, y, used, ncols, deg, err, what):
    """K11 kernel vs plain on the card: NA sets and infinities equal, p,
    beta, se within LOGREG_REL; returns (kernel results as numpy, errors,
    snarls whose step counts differ)."""
    import numpy as np
    from stoat_tpu_torch.stats.logreg import (logistic_regression,
                                              logistic_regression_plain)
    got = {k: to_np(v) for k, v in
           logistic_regression(X, y, used, ncols, deg).items()}
    plain = {k: to_np(v) for k, v in
             logistic_regression_plain(X, y, used, ncols, deg).items()}
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
    return (f"logistic edge designs ({', '.join(c[0] for c in cases)}: "
            f"steps {iters}, p {p.tolist()}; the same flagged degenerate "
            f"all NA) max err "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + "; PT = 12 max err "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs12.items())
            + f"; step counts differing from the plain version: "
            f"{flips + flips12}")


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
    from concurrent.futures import ThreadPoolExecutor
    import stoat_tpu.native as native
    lib_dir = os.path.join(HERE, "build", "stoat_tpu_torch", "native")
    os.makedirs(lib_dir, exist_ok=True)
    lib_path = os.path.join(lib_dir, "libstoat_core.so")
    graph_path = os.path.join(lib_dir, "libstoat_graph.so")
    # libraries built here, never ones copied in from another machine
    native._LIB = lib_path
    native._GRAPH_LIB = graph_path
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:   # two g++ at once
        lib, glib = (f.result() for f in [pool.submit(native.get_lib),
                                          pool.submit(native.get_graph_lib)])
    for got, path, what in ((lib, lib_path, "native core"),
                            (glib, graph_path, "native graph core")):
        check(got is not None, f"{what} failed to build or load")
        check(os.path.samefile(got._name, path),
              f"{what} loaded from {got._name}")
    say(f"phase 2 native cores: {lib_path} and {graph_path} loaded in "
        f"{time.perf_counter() - t0:.1f}s")


def main_path_chunks(paths, device):
    """The first chunk of the first chromosome, as the main paths build it,
    on the card: the binary DeviceChunk, the quantitative one (the same
    words, no masks), the quantitative phenotype [N] and the AGE and SEX
    covariates [N, 2], H, and the binary phenotype as ``vcf -b -c`` feeds
    it to the logistic model (float64 [N]).  (The chunk cap of ``-q`` and
    ``-b -c``, 2e9 // (N * 96) = 8,319 at N = 2,504, leaves the chunk at
    8,192.)"""
    from stoat_tpu.io.phenotype import (parse_binary_pheno, parse_covariates,
                                        parse_quantitative_pheno)
    from stoat_tpu.io.snarl_file import parse_snarl_path
    from stoat_tpu.io.vcf import VcfReader
    from stoat_tpu.tables import pack_chromosome_chunks
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
            to_binary_pheno(pheno, device))


def phase_kernels(torch, device, chunks, err, graph):
    chunk, qchunk, qpheno, qcovar, H, case = chunks
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
    import numpy as np
    from stoat_tpu_torch.pipeline.quantitative import quant_design
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
    del d

    # K6 on the main graph's partition counts, then its edge rows
    G0, G1, mask, k = graph_counts(graph, device)
    compare_graph_stats(G0, G1, mask, err)
    gedges = graph_edge_cases(device, err)
    torch.cuda.synchronize()
    say(f"phase 3 graph kernel vs plain: main graph ({G0.shape[0]} tested "
        f"snarls of {graph['n_snarls']}, Pmax {G0.shape[1]}, k = "
        f"{sorted(set(k.tolist()))}) ok; {gedges}; tolerances: bitwise "
        f"against the plain version on the card, Fisher bitwise and chi2 "
        f"rel 1e-12 with equal strings against the CPU's; max abs err "
        f"graph_stats={err['graph_stats']:.3g}")

    # K11 on the first chunk of `vcf -b -c` (its design has no covariates)
    no_covar = torch.zeros((qcovar.shape[0], 0), dtype=torch.float64,
                           device=device)
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
             "deg": d["degenerate"], "graph": (G0, G1, mask)}
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


def run_captured(cli, args):
    """Run the CLI; return its exit code and each snarl's results as the
    writer received them, at full precision: {(chrom, snarl): (filtered,
    allele_paths, (p, beta, se, r2))}, r2 NaN where the path has none."""
    import numpy as np
    from stoat_tpu import writer as W
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
    import math
    from stoat_tpu_torch import cli, kernels
    table, stats = reference
    table_name, path_kernels, flag, with_covar, names = \
        REGRESSION_PATHS[mode]
    logistic = mode == "b_c"
    p_floor = P_FLOOR if logistic else 0.0
    out_cuda = os.path.join(work, f"out_cuda_{mode}")
    out_cpu = os.path.join(work, f"out_cpu_{mode}")
    # the runner's chunk cap, and make_fixture's split over chromosomes
    chunk = min(8192, max(int(2e9 // (paths["n_samples"] * 96)), 256))
    per_chrom = -(-paths["n_snarls"] // n_chroms)
    sizes = [min(per_chrom, paths["n_snarls"] - c * per_chrom)
             for c in range(n_chroms)]
    n_chunks = sum(math.ceil(n / chunk) for n in sizes if n > 0)

    def argv(p, out, device):
        covar = (["-c", p["covariate"], "-C", ",".join(COVAR_NAMES)]
                 if with_covar else [])
        pheno = p["binary"] if flag == "-b" else p["quantitative"]
        return ["vcf", "-s", p["snarl"], "-v", p["vcf"], flag, pheno, *covar,
                "-o", out, "--device", device]
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
    for name, n in launches.items():
        want = n_chunks if name in path_kernels else 0
        check(n == want, f"kernel {name}: {n} launches on the {mode} path, "
              f"expected {want} ({n_chunks} chunks)")
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
        f"tests/reference_impl.py (bound {REF_REL:g}); max_memory_allocated "
        f"{memory_note(peak, held)}")
    return launches, wall_cuda


def graph_reference_rows(tsv, n_sample=GRAPH_REF_ROWS, seed=0):
    """P_FISHER and P_CHI2 of ``n_sample`` random tested rows of a graph
    TSV against tests/reference_impl.py (scipy) on their GROUP_PATHS
    counts, formatted as the writer formats them.  Returns (rows checked,
    rows whose string flipped at a rounding boundary)."""
    import numpy as np
    from reference_impl import chi2_p, fisher_p
    from stoat_tpu.writer import format_p
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
            rc = cli.main(["graph", "-p", g["gfa"], "-d", g["gfa"], "-b",
                           g["pheno"], "-T", method, "-O", fmt, "-r", "ref",
                           "-V", "0", "-o", out, "--device", device])
        finally:
            os.environ.pop("STOAT_GRAPH_PYTHON", None)
        torch.cuda.synchronize()
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
        check((n > 0) == (name in GRAPH_KERNELS), f"kernel {name}: {n} "
              f"launches on the graph path")
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
    check(twin_launches["graph_stats"] == 1, f"graph twin: launches "
          f"{twin_launches}")
    say(f"phase 4 main path: graph -T chi2 on {graph['n_snarls']} snarls x "
        f"{2 * graph['n_samples']} haplotype paths: cuda wall "
        f"{wall_cuda:.2f}s, cpu wall {wall_cpu:.2f}s, {len(lines) - 1} rows "
        f"byte-identical ({depth2} nested at depth 2; partitions per row "
        f"{dict(sorted(kinds.items()))}); launches {launches}, native path; "
        f"{n_ref} sampled rows' P_FISHER/P_CHI2 equal scipy's strings "
        f"({ref_s:.1f}s), {len(flips)} at a rounding boundary"
        f"{': ' + '; '.join(flips[:5]) if flips else ''}; "
        + "; ".join(others)
        + f"; Python twin on {twin['n_snarls']} snarls ({w_twin:.2f}s, "
        f"graph_stats launched) byte-identical to the native path "
        f"({w_native:.2f}s); max_memory_allocated {memory_note(peak, held)}")
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


def phase_times(torch, chunk, g0p, g1p, tables, quant, logit, smi):
    from stoat_tpu_torch.pipeline.binary import (binary_tables,
                                                 binary_tables_plain)
    from stoat_tpu_torch.pipeline.packed import (membership_counts,
                                                 membership_counts_plain)
    from stoat_tpu_torch.pipeline.quantitative import (quant_design,
                                                       quant_design_plain)
    from stoat_tpu_torch.stats.chi2 import finish_chi2_pvalues
    from stoat_tpu_torch.stats.fisher import (fisher_exact_2x2,
                                              fisher_exact_2x2_plain)
    from stoat_tpu_torch.graph.association import (graph_stats,
                                                   graph_stats_plain)
    from stoat_tpu_torch.stats.linreg import (linear_regression_stats,
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
    ols = (q["X"], q["y"], q["used"], q["ncols"])
    tail = (*q["stats"][:2], q["deg"], *q["stats"][2:])
    counts = logit["graph"]
    fit = (logit["X"], logit["y"], logit["used"], logit["ncols"],
           logit["deg"])
    calls = {
        "membership_counts": lambda: membership_counts(*args),
        "binary_tables": lambda: binary_tables(g0p, g1p, sidx, *thr),
        "fisher": lambda: fisher_exact_2x2(*abcd),
        "quant_design": lambda: quant_design(*design),
        "ols": lambda: linear_regression_stats(*ols),
        "student_t": lambda: student_t_pvalues(*tail),
        "graph_stats": lambda: graph_stats(*counts),
        "logreg": lambda: logistic_regression(*fit),
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
        "graph_stats": (
            cuda_ms(calls["graph_stats"], 20),
            cuda_ms(lambda: graph_stats_plain(*counts), 3, warmup=1)),
        "logreg": (
            cuda_ms(calls["logreg"], 5),
            cuda_ms(lambda: logistic_regression_plain(*fit), 3, warmup=1)),
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


PROFILE_TITLES = {"b": "vcf -b", "q_c": "vcf -q -c -C AGE,SEX",
                  "b_c": "vcf -b -c -C AGE,SEX"}


def profile_main_path(torch, device, paths, work, out_dir, mode):
    """--profile DIR: where the time of one main path goes (mode "b" for
    `vcf -b`, "q_c" for `vcf -q -c -C AGE,SEX`, "b_c" for `vcf -b -c -C
    AGE,SEX`).  The stages run once serially (the runner overlaps ingest,
    dispatch and writing on three threads), then torch.profiler traces one
    whole CUDA CLI run (trace_cli)."""
    from stoat_tpu import writer as W
    from stoat_tpu.io.phenotype import (parse_binary_pheno, parse_covariates,
                                        parse_quantitative_pheno)
    from stoat_tpu.io.snarl_file import parse_snarl_path
    from stoat_tpu.io.vcf import VcfReader
    from stoat_tpu.tables import pack_chromosome_chunks
    from stoat_tpu_torch.convert import (chunk_words, pheno_masks,
                                         to_binary_pheno, to_device_chunk,
                                         to_quant_inputs, upload_words)
    from stoat_tpu_torch.pipeline.binary import binary_tables_packed
    from stoat_tpu_torch.pipeline.fetch import fetch_async
    from stoat_tpu_torch.pipeline.quantitative import quant_design
    from stoat_tpu_torch.pipeline.runner import iter_chromosome_matrices
    from stoat_tpu_torch.stats.linreg import (linear_regression_stats,
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
        stats = linear_regression_stats(d.pop("X"), consts[0][None, :] *
                                        used, used, d["ncols"])
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
    from stoat_tpu import writer as W
    from stoat_tpu.io.phenotype import parse_binary_pheno
    from stoat_tpu.native import graph_assoc_native, graph_format_rows_native
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
        t0 = time.perf_counter()
        graph = write_graph(os.path.join(work, "graph"), args.graph_snarls)
        twin = write_graph(os.path.join(work, "twin"), TWIN_SNARLS, seed=1)
        say(f"graphs generated in {time.perf_counter() - t0:.1f}s: "
            f"{graph['n_snarls']} snarls x {2 * graph['n_samples']} "
            f"haplotype paths ({os.path.getsize(graph['gfa']) / 1e6:.0f} MB "
            f"GFA), and {twin['n_snarls']} for the Python twin")
        chunks = main_path_chunks(paths, device)
        err = {name: 0.0 for name in KERNELS}
        g0p, g1p, tables, quant, logit = phase_kernels(torch, device, chunks,
                                                       err, graph)
        launches = phase_main(torch, paths, work, N_CHROMS, gen_s)
        t0 = time.perf_counter()
        from stoat_tpu.io.phenotype import (parse_binary_pheno,
                                            parse_covariates,
                                            parse_quantitative_pheno)
        samples = list(paths["samples"])
        reference = quant_reference(
            paths, parse_quantitative_pheno(paths["quantitative"], samples),
            parse_covariates(paths["covariate"], COVAR_NAMES, samples),
            parse_binary_pheno(paths["binary"], samples)[0])
        say(f"phase 4 numpy regression reference: {len(reference[0])} "
            f"snarls, {len(reference[1])} sampled, in "
            f"{time.perf_counter() - t0:.1f}s")
        for mode in ("q", "q_c", "b_c"):
            r_launches, _ = phase_main_regression(torch, paths, work,
                                                  N_CHROMS, mode, reference)
            for name in REGRESSION_PATHS[mode][1]:
                launches[name] = launches.get(name, 0) + r_launches[name]
        g_launches, _ = phase_graph(torch, graph, twin, work)
        launches["graph_stats"] = g_launches["graph_stats"]
        times, dev = phase_times(torch, chunks[0], g0p, g1p, tables, quant,
                                 logit, smi)
        if args.profile:
            for mode in ("b", "q_c", "b_c"):
                say(profile_main_path(torch, device, paths, work,
                                      args.profile, mode))
            say(profile_graph(torch, device, graph, work, args.profile))
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
