#!/usr/bin/env python3
"""Time a CUDA kernel of the checkout against another version of its source,
on one card, in one process.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/kernel_ab.py --baseline DIR [--candidate DIR ...]
                               [--kernel binary_from_words|binary_stats|
                                         binary_tables|chi2_tail|
                                         chi2_tail_perm|chi2_tail_score|
                                         eqtl_ols|fisher|
                                         graph_stats|logreg|
                                         membership_counts|ols|
                                         perm_binary|perm_ols|
                                         quant_design|score_precompute|
                                         score_perm|student_t|
                                         student_t_perm]
                               [--snarls 16384] [--rounds 4]
                               [--order as-is,branch,work]

Each DIR holds one version's kernel sources (its ``<source>.cu`` and the
``.cuh`` headers that it includes; score_precompute and score_perm are
in ``score_test.cu``; binary_stats is ``binary_stats.cu`` where the
version has it, else the pair it replaced, ``binary_tables.cu`` and
``fisher.cu``; binary_from_words builds ``membership_counts.cu`` and
``binary_stats.cu``),
for example the ``csrc/`` of an earlier commit unpacked with ``git
archive``; the candidate defaults to the checkout's
``stoat_tpu_torch/csrc``.  Both versions are built with the
port's nvcc flags (``stoat_tpu_torch/kernels/build.py``) and their ptxas
registers and spills printed, and the tensor-core instructions in each
library's SASS (``cuobjdump -sass``): the lines with DMMA (float64),
IMMA (integer) and BMMA (binary), in the whole library and in the timed
kernel's own functions.  Both then run
through the port's own wrapper on the same inputs, the first chunk of
``vcf -q -c -C AGE,SEX`` on chip_smoke.py's cohort (2,504 samples;
``--snarls`` over 2 chromosomes, 8,192 per chunk; binary_tables,
fisher and binary_stats on the first ``vcf -b`` chunk's path counts
(membership_counts' plain version on the card), as chip_smoke.py phase 5
feeds them: binary_tables and fisher through their wrappers, fisher on
the chunk's (a, b, c, d) with the steps of its scan per table printed
(chip_smoke.fisher_steps), binary_stats as ``binary_from_path_counts``
calls it, with the chi-squared tail: for a version with
``binary_stats.cu`` its one launch, for an earlier one binary_tables,
fisher and the torch.where that masked Fisher (its device ms is every
kernel in the window); membership_counts on the same chunk's words;
binary_from_words as a ``vcf -b`` chunk runs from the words to the
p-values (its device ms every kernel in the window): the fused launch
where the version's ``binary_stats.cu`` declares
``binary_from_words_launch``, else membership_counts and binary_stats
on its counts, then the chi-squared tail; graph_stats on chip_smoke.py's
main graph (100,000 snarls x 90 haplotype paths), its launch alone and
with its tails (a version whose launch declares ``p22`` has them inside;
an earlier one runs the chi-squared tail twice after it, device ms every
kernel in the window); perm_ols with the
observed phenotype and the main path's 1,000 Freedman-Lane permutations
(chip_smoke.PERM_FULL); score_perm on the first ``vcf -b -c`` chunk's D
and V^-1 with the observed residual and 1,000 permuted ones;
score_precompute on the same chunk's design with the reduced logistic
fit's Z and w; perm_binary on the first ``vcf -b`` chunk's membership
with the observed case mask and 1,000 permuted ones; quant_design's
OLS design, ``all_rows`` off and no table view; logreg on the first ``vcf
-b -c`` chunk's design and case indicator, chip_smoke.py phase 5's
``fit``; eqtl_ols on the same design with chip_smoke.write_genes' gene
set and the chunk's (snarl, gene) pairs, phase 5's ``eq``: with
``--snarls 65536`` phase 5's 85,159 pairs; the two tails at both of
their launch shapes: chi2_tail on the first ``vcf -b`` chunk's
statistics and masks, chi2_tail_perm on perm_binary's [1 + PERM_FULL, S]
statistics and df, chi2_tail_score on the score test's max(T, 0) with its
df [S] (a version whose launch declares ``df_period`` reads it with that
period, an earlier one gets it made [K, S] in the call, as its wrapper
did), student_t on the first ``vcf -q -c`` chunk's OLS statistics with
their NA masking (and the wrapper's host costs), student_t_perm on
perm_ols's [K, S] t1 and df; the inputs come from the plain versions on
the card; ``--order`` also runs the tails on their elements reordered on
the host, grouped by branch or by branch and iterations, to show how
much of a tail's time its lanes spend idle).  quant_design and ols launch
each version with the argument list its source declares: ols the
phenotype row and the mask where the launch declares ``pheno``, else
the [S, N] y = pheno * used that the earlier callers built.  They run in
the order A B B A for
``--rounds`` rounds (A is the candidate).  With ``--candidate`` given
more than once, the candidates A1, A2, ... and B run in that order and
back in each round, and each candidate is compared with B.  It prints
each version's ms per call (CUDA events, the median
of its rounds), its device ms per call (torch.profiler), whether the two
versions' outputs are equal bit for bit and, where they are not, the
largest relative difference of the first output (t1, T, perm_binary's
statistic: |A - B| / max(|B|, 1); logreg's p in units of max(|B|, 1e-5);
chip_smoke.stat_err; inf unless NaN and infinities agree;
score_precompute's V^-1 relative to each snarl's largest entry, on the
snarls that neither version flags) and, for logreg, the snarls whose
Newton step counts differ,
then the card's name and power limit.  It exits non-zero when there is no
card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def first_chunks(cs, device, snarls, work):
    """chip_smoke.main_path_chunks of the cohort at ``snarls`` snarls, and
    the cohort's paths."""
    from fixtures import make_fixture
    paths = make_fixture(os.path.join(work, "data"), n_samples=cs.N_SAMPLES,
                         n_snarls=snarls, seed=0, n_chroms=cs.N_CHROMS)
    return cs.main_path_chunks(paths, device), paths


def quant_chunk(cs, device, snarls, work, genes=False):
    """The first ``vcf -q -c`` chunk's design, phenotype and covariates;
    with ``genes``, also the eQTL mode's (snarl, gene) pairs of that chunk
    (CSR by snarl) and its chromosome's [G, N] expression, from
    chip_smoke.write_genes."""
    from stoat_tpu_torch.pipeline.quantitative import quant_design
    (chunk, qchunk, qpheno, qcovar, H, case, (chrom, packed)), paths = \
        first_chunks(cs, device, snarls, work)
    d = quant_design(qchunk, qcovar, *cs.THRESHOLDS, H)
    if not genes:
        return d, chunk, qpheno, qcovar, case
    import numpy as np
    from stoat_tpu_torch.convert import to_eqtl_pairs
    gene_set = cs.write_genes(paths)[chrom]
    pair_snarl, pair_gene = cs.gene_pairs(packed.snarls,
                                          cs.to_np(d["filtered"]), gene_set)
    pairs = to_eqtl_pairs(pair_snarl, pair_gene, int(d["X"].shape[0]),
                          device)
    expr = cs.upload_t(np.stack([g[3] for g in gene_set]), device)
    return d, pairs, expr


def declares(versions, source, word):
    """tag -> whether that version's ``source``.cu holds ``word`` (a
    parameter its launch function declares)."""
    out = {}
    for tag, src in versions.items():
        with open(os.path.join(src, f"{source}.cu")) as fh:
            out[tag] = word in fh.read()
    return out


def binary_chunk(cs, device, snarls, work):
    """The first ``vcf -b`` chunk's path counts (membership_counts' plain
    version on the card: the kernel's bits) and snarl_path_idx."""
    from stoat_tpu_torch.pipeline.packed import membership_counts_plain
    (chunk, *_), _p = first_chunks(cs, device, snarls, work)
    g0p, g1p = membership_counts_plain(chunk.words, chunk.path_idx,
                                       chunk.path_valid, chunk.tail,
                                       chunk.g1_words)
    return g0p, g1p, chunk.snarl_path_idx


def binary_tables_inputs(cs, device, snarls, work):
    """binary_tables (K3) through its wrapper on the first ``vcf -b``
    chunk, and (S, Pmax)."""
    from stoat_tpu_torch.pipeline.binary import TABLE_KEYS, binary_tables
    g0p, g1p, sidx = binary_chunk(cs, device, snarls, work)

    def call():
        t = binary_tables(g0p, g1p, sidx, *cs.THRESHOLDS)
        return [t[k] for k in ("chi2_stat",) + TABLE_KEYS]
    return call, tuple(sidx.shape)


def fisher_inputs(cs, device, snarls, work):
    """fisher_exact_2x2 (K4) through its wrapper on the first ``vcf -b``
    chunk's (a, b, c, d), and S; prints the steps of the scan per table
    (chip_smoke.fisher_steps), over all S and over the k == 2 tables,
    which the main path scans."""
    from stoat_tpu_torch.pipeline.binary import binary_tables_plain
    from stoat_tpu_torch.stats.fisher import fisher_exact_2x2
    g0p, g1p, sidx = binary_chunk(cs, device, snarls, work)
    t = binary_tables_plain(g0p, g1p, sidx, *cs.THRESHOLDS)
    abcd = tuple(t[k].contiguous() for k in "abcd")
    steps = cs.fisher_steps(*map(cs.to_np, abcd))
    two = cs.to_np(t["k"]) == 2
    cs.say(f"fisher steps per table on the first vcf -b chunk: all "
           f"{steps.size} tables mean {steps.mean():.2f} max {steps.max()}; "
           f"the {int(two.sum())} k == 2 tables mean "
           f"{steps[two].mean():.2f} max {steps[two].max()}")
    return (lambda: [fisher_exact_2x2(*abcd)]), (len(abcd[0]),)


def binary_stats_inputs(cs, device, snarls, work, versions):
    """``binary_from_path_counts`` on the first ``vcf -b`` chunk as each
    version's main path ran it: the one binary_stats launch where the
    version has binary_stats.cu, else binary_tables, fisher and a
    torch.where; then the chi-squared tail (the checkout's K5).  Returns
    the call and (S, Pmax)."""
    import torch
    from stoat_tpu_torch.pipeline.binary import (binary_from_path_counts,
                                                 binary_tables)
    from stoat_tpu_torch.stats.chi2 import finish_chi2_pvalues
    from stoat_tpu_torch.stats.fisher import fisher_exact_2x2
    g0p, g1p, sidx = binary_chunk(cs, device, snarls, work)
    fused = {tag: os.path.exists(os.path.join(src, "binary_stats.cu"))
             for tag, src in versions.items()}
    keys = ("p_fisher", "p_chi2", "filtered", "keep", "g0", "g1")

    def call():
        if fused[STATE["tag"]]:
            out = binary_from_path_counts(g0p, g1p, sidx, *cs.THRESHOLDS)
        else:
            t = binary_tables(g0p, g1p, sidx, *cs.THRESHOLDS)
            p = fisher_exact_2x2(t["a"], t["b"], t["c"], t["d"])
            out = dict(t, p_fisher=torch.where(t["k"] == 2, p, float("nan")),
                       p_chi2=finish_chi2_pvalues(
                           t["chi2_stat"], t["chi2_df"], t["chi2_invalid"],
                           t["chi2_zexp"]))
        return [out[k] for k in keys]
    return call, tuple(sidx.shape)


def membership_counts_inputs(cs, device, snarls, work):
    """membership_counts (K1+K2) through its wrapper on the first ``vcf
    -b`` chunk's words, rows, masks, and the chunk's (P, K, W)."""
    from stoat_tpu_torch.pipeline.packed import membership_counts
    (chunk, *_), _p = first_chunks(cs, device, snarls, work)
    args = (chunk.words, chunk.path_idx, chunk.path_valid, chunk.tail,
            chunk.g1_words)
    P, K = chunk.path_idx.shape
    gather_bytes(cs, chunk)
    return (lambda: list(membership_counts(*args))), \
        (int(P), int(K), int(chunk.words.shape[1]))


def gather_bytes(cs, chunk):
    """Print the chunk's gathered words (valid paths x K x W x 4 bytes)
    and its distinct rows' words, and each over the card's memory rate."""
    import numpy as np
    idx = cs.to_np(chunk.path_idx)
    valid = cs.to_np(chunk.path_valid)
    W = int(chunk.words.shape[1])
    gathered = int(valid.sum()) * idx.shape[1] * W * 4
    distinct = np.unique(idx).size * W * 4
    cs.say(f"first vcf -b chunk: {int(valid.sum())} valid paths of "
           f"{idx.shape[0]}, K = {idx.shape[1]}, W = {W}: gathered words "
           f"{gathered} bytes ({1e3 * gathered / cs.HBM_BYTES_S:.4f} ms at "
           f"{cs.HBM_BYTES_S:.3g} B/s), distinct rows' words {distinct} "
           f"bytes ({1e3 * distinct / cs.HBM_BYTES_S:.4f} ms)")


def binary_from_words_inputs(cs, device, snarls, work, versions):
    """A ``vcf -b`` chunk's call from the words to the p-values on the
    first chunk, as each version's main path ran it: the fused
    binary_from_words launch where the version's binary_stats.cu declares
    it (``binary_tables_packed``), else membership_counts and then
    ``binary_from_path_counts`` (binary_stats on the counts); then the
    chi-squared tail (the checkout's K5).  Returns the call and (S,
    Pmax)."""
    from stoat_tpu_torch.pipeline import binary
    from stoat_tpu_torch.pipeline.packed import membership_counts
    (chunk, *_), _p = first_chunks(cs, device, snarls, work)
    gather_bytes(cs, chunk)
    fused = declares(versions, "binary_stats", "binary_from_words_launch")
    keys = ("p_fisher", "p_chi2", "filtered", "keep", "g0", "g1")

    def call():
        if fused[STATE["tag"]]:
            out = binary.binary_tables_packed(chunk, *cs.THRESHOLDS)
        else:
            g0p, g1p = membership_counts(chunk.words, chunk.path_idx,
                                         chunk.path_valid, chunk.tail,
                                         chunk.g1_words)
            out = binary.binary_from_path_counts(
                g0p, g1p, chunk.snarl_path_idx, *cs.THRESHOLDS)
        return [out[k] for k in keys]
    return call, tuple(chunk.snarl_path_idx.shape)


def graph_stats_inputs(cs, device, snarls, work, versions):
    """K6 on chip_smoke.py's main graph (GRAPH_SNARLS snarls x 90
    haplotype paths, the native prepare's partition counts), launched as
    each version's wrapper launches it: "alone", the graph_stats launch by
    itself (a version whose launch declares ``p22`` writes the three
    p-values; an earlier one the statistics and Fisher's p, its tails
    left to K5), and "with its tails", the wrapper's whole call (an
    earlier version's launch, then finish_chi2_pvalues on the 2x2 and on
    the 2xN statistics).  Returns {label: call} and (B, Pmax)."""
    import torch
    from stoat_tpu_torch.kernels import I64, VOIDP, launch
    from stoat_tpu_torch.stats.chi2 import finish_chi2_pvalues
    graph = cs.write_graph(os.path.join(work, "graph"), cs.GRAPH_SNARLS)
    G0, G1, mask, _k = cs.graph_counts(graph, device)
    B, Pm = G0.shape
    fused = declares(versions, "graph_stats", "void* p22")
    # the counts stay referenced by the calls: a launch reads them by
    # pointer, and freed memory would be handed to the tails' allocations
    counts = (G0, G1, mask)
    ps = torch.empty((3, B), dtype=torch.float64, device=device)
    f64 = [torch.empty(B, dtype=torch.float64, device=device)
           for _ in range(4)]
    u8 = [torch.empty(B, dtype=torch.bool, device=device) for _ in range(3)]
    stat, pf, statn, dfn = f64
    invalid, zexp, invalidn = u8

    def k6():
        ins = [t.data_ptr() for t in counts]
        if fused[STATE["tag"]]:
            launch("graph_stats", [VOIDP] * 6 + [I64] * 2,
                   [*ins, *(ps[i].data_ptr() for i in range(3)), B, Pm],
                   device)
            return [ps[0], ps[1], ps[2]]
        launch("graph_stats", [VOIDP] * 10 + [I64] * 2,
               [*ins, *(t.data_ptr() for t in (stat, invalid, zexp, pf,
                                               statn, dfn, invalidn)),
                B, Pm], device)
        return None

    def alone():
        out = k6()
        return [out[1] if out is not None else pf]

    def with_tails():
        out = k6()
        if out is not None:
            return out
        return [finish_chi2_pvalues(stat, torch.ones_like(stat), invalid,
                                    zexp), pf,
                finish_chi2_pvalues(statn, dfn, invalidn,
                                    torch.zeros_like(invalidn))]
    return {"alone": alone, "with its tails": with_tails}, (int(B), int(Pm))


def version_sources(kernel, src_dir):
    """The sources that ``kernel``'s call builds from the version in
    ``src_dir``: binary_stats from the pair it replaced where the version
    has no binary_stats.cu."""
    if kernel == "binary_stats" and not os.path.exists(
            os.path.join(src_dir, "binary_stats.cu")):
        return ("binary_tables", "fisher")
    if kernel == "binary_from_words":
        return ("membership_counts", "binary_stats")
    return (SOURCES.get(kernel, kernel),)


def ols_inputs(cs, device, snarls, work, versions):
    """A zero-argument call of the ols kernel on the first ``vcf -q -c``
    chunk, as each version's caller feeds it: a version whose launch
    declares ``pheno`` gets the phenotype row [N] and the used-row mask,
    an earlier one the [S, N] y = pheno * used.  Returns
    the call and the design's shape."""
    import torch
    from stoat_tpu_torch.kernels import I64, VOIDP, launch
    d, _, qpheno, _, _ = quant_chunk(cs, device, snarls, work)
    X, used, ncols = d["X"], d["used"], d["ncols"]
    S, N, P = X.shape
    row = declares(versions, "ols", "const void* pheno")
    y = qpheno[None, :] * used
    # the parent's scratch (4 P^2 + 4 P + 4 doubles a snarl) covers both
    scratch = torch.empty((S, 4 * P * P + 4 * P + 4), dtype=torch.float64,
                          device=device)
    out = [torch.empty(S, dtype=torch.float64, device=device)
           for _ in range(5)]

    def call():
        by_row = row[STATE["tag"]]
        launch("ols", [VOIDP] * 10 + [I64] * 3,
               [X.data_ptr(), (qpheno if by_row else y).data_ptr(),
                used.data_ptr(), ncols.data_ptr(), scratch.data_ptr(),
                *(t.data_ptr() for t in out), S, N, P], device)
        return out
    return call, tuple(X.shape)


def eqtl_ols_inputs(cs, device, snarls, work):
    """A zero-argument call of the eqtl_ols kernel on the first eQTL chunk
    (the ``vcf -q -c`` chunk's design with chip_smoke.py's gene set: phase
    5's inputs), and (S, N, P, pairs).  The versions since the kernel came
    take the same arguments; the scratch is the first one's size, which
    covers them all."""
    import torch
    from stoat_tpu_torch.kernels import I64, VOIDP, launch
    d, (pair_off, pair_gene), expr = quant_chunk(cs, device, snarls, work,
                                                 genes=True)
    X, used, ncols = d["X"], d["used"], d["ncols"]
    S, N, P = X.shape
    B = int(pair_gene.shape[0])
    scratch = torch.empty((S, 4 * P * P + 4 * P + 4), dtype=torch.float64,
                          device=device)
    out = [torch.empty(B, dtype=torch.float64, device=device)
           for _ in range(5)]

    def call():
        launch("eqtl_ols", [VOIDP] * 12 + [I64] * 3,
               [X.data_ptr(), used.data_ptr(), ncols.data_ptr(),
                pair_off.data_ptr(), pair_gene.data_ptr(), expr.data_ptr(),
                scratch.data_ptr(), *(t.data_ptr() for t in out), S, N, P],
               device)
        return out
    return call, (S, N, P, B)


def perm_ols_inputs(cs, device, snarls, work):
    """A zero-argument call of perm_ols_stats on the first ``vcf -q -c``
    chunk with 1 + PERM_FULL phenotype rows, and the design's shape."""
    from stoat_tpu_torch.pipeline.permutation import perm_ols_stats
    d, chunk, qpheno, qcovar, case = quant_chunk(cs, device, snarls, work)
    rows = cs.perm_host_rows(cs.to_np(case) > 0.5, cs.to_np(qpheno),
                             cs.to_np(qcovar), int(chunk.words.shape[1]),
                             cs.PERM_FULL)
    args = (d["X"], d["used"], d["ncols"], cs.upload_t(rows["phenos"],
                                                       device))
    return (lambda: perm_ols_stats(*args)), tuple(d["X"].shape)


def score_perm_inputs(cs, device, snarls, work):
    """A zero-argument call of score_perm_stats on the first ``vcf -b -c``
    chunk (its design has no covariates; D and V^-1 from the plain
    score_precompute) with 1 + PERM_FULL residual rows, and D's shape."""
    import torch
    from stoat_tpu_torch.pipeline import permutation as pm
    from stoat_tpu_torch.pipeline.quantitative import quant_design
    _d, chunk, qpheno, qcovar, case = quant_chunk(cs, device, snarls, work)
    no_covar = torch.zeros((qcovar.shape[0], 0), dtype=torch.float64,
                           device=device)
    d = quant_design(chunk, no_covar, *cs.THRESHOLDS, 2 * qcovar.shape[0])
    rows = cs.perm_host_rows(cs.to_np(case) > 0.5, cs.to_np(qpheno),
                             cs.to_np(qcovar), int(chunk.words.shape[1]),
                             cs.PERM_FULL)
    Z, w, e = (cs.upload_t(rows[k], device) for k in ("Z", "w", "e"))
    D, Vinv, _df, _bad = pm.score_precompute_plain(
        d["X"], d["used"], d["ncols"], d["filtered"] | d["degenerate"], Z, w)
    args = (D, d["used"], Vinv, e)
    return (lambda: [pm.score_perm_stats(*args)]), tuple(D.shape)


def score_precompute_inputs(cs, device, snarls, work):
    """A zero-argument call of score_precompute on the first ``vcf -b -c``
    chunk (its design has no covariates: PT = 5, from the plain
    quant_design, whose X is the kernel's bit for bit) with the reduced
    logistic fit's Z [N, 3] and w, as phase 5 times it; the call returns
    (V^-1, D, df, allbad): V^-1 first.  And X's shape."""
    import torch
    from stoat_tpu_torch.pipeline import permutation as pm
    from stoat_tpu_torch.pipeline.quantitative import quant_design_plain
    (chunk, _q, qpheno, qcovar, _H, case, _c), _p = first_chunks(
        cs, device, snarls, work)
    no_covar = torch.zeros((qcovar.shape[0], 0), dtype=torch.float64,
                           device=device)
    d = quant_design_plain(chunk, no_covar, *cs.THRESHOLDS,
                           2 * qcovar.shape[0])
    Z, w, _e = pm.logistic_null_context(cs.to_np(case) > 0.5,
                                        cs.to_np(qcovar))
    args = (d["X"], d["used"], d["ncols"], d["filtered"] | d["degenerate"],
            cs.upload_t(Z, device), cs.upload_t(w, device))

    def call():
        D, Vinv, df, allbad = pm.score_precompute(*args)
        return [Vinv, D, df, allbad]
    return call, tuple(d["X"].shape)


def perm_binary_inputs(cs, device, snarls, work):
    """A zero-argument call of perm_binary_stats on the first ``vcf -b``
    chunk's membership (perm_membership's plain version on the card: the
    kernel's words bit for bit) with the observed case mask and PERM_FULL
    permuted ones, and (K, S, Pmax, W)."""
    from stoat_tpu_torch.convert import to_perm_inputs
    from stoat_tpu_torch.pipeline import permutation as pm
    (chunk, _q, qpheno, qcovar, _H, case, _c), _p = first_chunks(
        cs, device, snarls, work)
    W = int(chunk.words.shape[1])
    rows = cs.perm_host_rows(cs.to_np(case) > 0.5, cs.to_np(qpheno),
                             cs.to_np(qcovar), W, cs.PERM_FULL)
    masks = to_perm_inputs(device, masks=rows["masks"]).masks
    mem, g_all = pm.perm_membership_plain(chunk.words, chunk.path_idx,
                                          chunk.path_valid, chunk.tail)
    args = (mem, g_all, masks, chunk.snarl_path_idx, *cs.THRESHOLDS)
    S, Pmax = chunk.snarl_path_idx.shape
    return (lambda: list(pm.perm_binary_stats(*args))), \
        (int(masks.shape[0]), int(S), int(Pmax), W)


def logreg_inputs(cs, device, snarls, work):
    """A zero-argument call of logistic_regression on the first ``vcf -b
    -c`` chunk (its design has no covariates, y the case indicator times
    the used rows), and X's shape."""
    import torch
    from stoat_tpu_torch.pipeline.quantitative import quant_design
    from stoat_tpu_torch.stats.logreg import LOGREG_KEYS, logistic_regression
    _d, chunk, _qpheno, qcovar, case = quant_chunk(cs, device, snarls, work)
    no_covar = torch.zeros((qcovar.shape[0], 0), dtype=torch.float64,
                           device=device)
    d = quant_design(chunk, no_covar, *cs.THRESHOLDS, 2 * qcovar.shape[0])
    args = (d["X"], case[None, :] * d["used"], d["used"], d["ncols"],
            d["degenerate"])

    def call():
        out = logistic_regression(*args)
        return [out[k] for k in LOGREG_KEYS]
    return call, tuple(d["X"].shape)


def quant_design_inputs(cs, device, snarls, work, versions):
    """A zero-argument call of the quant_design kernel on the first ``vcf
    -q -c`` chunk (the OLS design: all_rows off, no table view), and X's
    shape.  The call passes ``all_rows`` only to a version whose source
    declares it, and the table view's two (null) output pointers only to
    one that declares kTables (``versions``: tag -> source directory),
    read from the tag that ``use`` last set (STATE)."""
    import torch
    from stoat_tpu_torch.kernels import F64, I64, VOIDP, launch
    from stoat_tpu_torch.pipeline.quantitative import DESIGN_KEYS
    d, chunk, _qpheno, qcovar, _case = quant_chunk(cs, device, snarls, work)
    with_flag = declares(versions, "quant_design", "all_rows")
    with_tables = declares(versions, "quant_design", "kTables")
    W = int(chunk.words.shape[1])
    K = int(chunk.path_idx.shape[1])
    S, Pmax = chunk.snarl_path_idx.shape
    N, C = qcovar.shape
    H = 2 * N
    out = {key: torch.empty_like(d[key]) for key in DESIGN_KEYS}

    def call():
        tag = STATE["tag"]
        ints = [S, Pmax, K, W, N, C, H] + ([0] if with_flag[tag] else [])
        tables = [None, None] if with_tables[tag] else []
        launch("quant_design",
               [VOIDP] * (11 + len(tables)) + [I64] * len(ints) + [F64] * 3,
               [chunk.words.data_ptr(), chunk.path_idx.data_ptr(),
                chunk.path_valid.data_ptr(), chunk.snarl_path_idx.data_ptr(),
                qcovar.data_ptr(), *(out[k].data_ptr() for k in DESIGN_KEYS),
                *tables, *ints, *map(float, cs.THRESHOLDS)], device)
        return [out[k] for k in DESIGN_KEYS]
    return call, tuple(d["X"].shape)


def tail_order(cs, kind, args, order):
    """The permutation of a tail's elements that ``--order`` asks for:
    None as they come; "branch": each element's branch first (chi2_tail:
    no loop, the power series, the continued fraction; student_t: the
    direct, then the mirrored fraction), in their order within it;
    "work": by branch, then by the iterations of its loop."""
    import numpy as np
    if order == "as-is":
        return None
    if kind == "chi2_tail":
        branch, iters = cs.igammac_counts(cs.to_np(args[0]).ravel(),
                                          cs.to_np(args[1]).ravel())
    else:
        iters, branch = cs.cf_iteration_counts(cs.to_np(args[0]).ravel(),
                                               cs.to_np(args[1]).ravel())
    keys = (branch,) if order == "branch" else (iters, branch)
    return np.lexsort(keys)


def reorder(perm, tensors):
    """``tensors`` flattened and gathered by ``perm`` (None: unchanged)."""
    import torch
    if perm is None:
        return tensors
    idx = torch.from_numpy(perm).to(tensors[0].device)
    return [t.reshape(-1)[idx].contiguous() for t in tensors]


def per_order(build, orders):
    """{order: build(order)} for each of ``orders``."""
    return {o: build(o) for o in orders}


def chi2_tail_call(cs, device, versions, stat, df, masks, order):
    """A zero-argument launch of each version's chi2_tail on ``stat`` and
    ``df`` (with the two masks, or None), as its source declares it: a
    version whose launch takes ``df_period`` reads a df shorter than stat
    (the score test's [S]) with that period; an earlier one gets the df
    broadcast to stat's shape and made contiguous, as its wrapper did, in
    the call."""
    import torch
    from stoat_tpu_torch.kernels import I64, VOIDP, launch
    periodic = declares(versions, "chi2_tail", "df_period")
    stat = stat.contiguous()
    if masks is None:
        masks = (None, None)
    tensors = reorder(tail_order(cs, "chi2_tail", (stat, df.expand_as(
        stat)), order), [stat, df.expand_as(stat).contiguous(),
                         *(m for m in masks if m is not None)])
    if order != "as-is":
        stat, df = tensors[:2]
        masks = tuple(tensors[2:]) if masks[0] is not None else masks
    n = stat.numel()
    p = torch.empty(stat.shape, dtype=torch.float64, device=device)

    def call():
        # the pointers taken here, so that the call holds the masks
        ptrs = [None if m is None else m.data_ptr() for m in masks]
        if periodic[STATE["tag"]]:
            d = df.contiguous()
            launch("chi2_tail", [VOIDP] * 5 + [I64] * 2,
                   [stat.data_ptr(), d.data_ptr(), *ptrs, p.data_ptr(), n,
                    d.numel()], device)
        else:
            d = df.expand_as(stat).contiguous()
            launch("chi2_tail", [VOIDP] * 5 + [I64],
                   [stat.data_ptr(), d.data_ptr(), *ptrs, p.data_ptr(), n],
                   device)
        return [p]
    return call


def binary_chunk_tables(cs, device, snarls, work):
    """The first ``vcf -b`` chunk's K3 outputs (plain versions on the card:
    the kernels' bits) and the chunk."""
    from stoat_tpu_torch.pipeline.binary import binary_tables_plain
    from stoat_tpu_torch.pipeline.packed import membership_counts_plain
    (chunk, *_rest), _p = first_chunks(cs, device, snarls, work)
    g0, g1 = membership_counts_plain(chunk.words, chunk.path_idx,
                                     chunk.path_valid, chunk.tail,
                                     chunk.g1_words)
    return binary_tables_plain(g0, g1, chunk.snarl_path_idx,
                               *cs.THRESHOLDS), chunk


def chi2_tail_inputs(cs, device, snarls, work, versions, order):
    """chi2_tail on the first ``vcf -b`` chunk's statistics, df and masks
    ([S], finish_chi2_pvalues' call), and their shape."""
    t, _ = binary_chunk_tables(cs, device, snarls, work)
    calls = per_order(lambda o: chi2_tail_call(
        cs, device, versions, t["chi2_stat"], t["chi2_df"],
        (t["chi2_invalid"], t["chi2_zexp"]), o), order)
    return calls, tuple(t["chi2_stat"].shape)


def chi2_tail_perm_inputs(cs, device, snarls, work, versions, order):
    """chi2_tail on the [K, S] statistics and df of perm_binary on the
    first ``vcf -b`` chunk with the observed case mask and PERM_FULL
    permuted ones (binary_perm_pvalues' call), and their shape."""
    from stoat_tpu_torch.convert import to_perm_inputs
    from stoat_tpu_torch.pipeline import permutation as pm
    (chunk, _q, qpheno, qcovar, _H, case, _c), _p = first_chunks(
        cs, device, snarls, work)
    rows = cs.perm_host_rows(cs.to_np(case) > 0.5, cs.to_np(qpheno),
                             cs.to_np(qcovar), int(chunk.words.shape[1]),
                             cs.PERM_FULL)
    masks = to_perm_inputs(device, masks=rows["masks"]).masks
    mem, g_all = pm.perm_membership_plain(chunk.words, chunk.path_idx,
                                          chunk.path_valid, chunk.tail)
    stat, df, _bad = pm.perm_binary_stats_plain(
        mem, g_all, masks, chunk.snarl_path_idx, *cs.THRESHOLDS)
    return per_order(lambda o: chi2_tail_call(cs, device, versions, stat,
                                              df, None, o), order), \
        tuple(stat.shape)


def chi2_tail_score_inputs(cs, device, snarls, work, versions, order):
    """chi2_tail on the score test's [K, S] statistics max(T, 0) of the
    first ``vcf -b -c`` chunk with the observed residual and PERM_FULL
    permuted ones, on its df [S] (score_perm_pvalues' call), and their
    shape."""
    import torch
    from stoat_tpu_torch.pipeline import permutation as pm
    from stoat_tpu_torch.pipeline.quantitative import quant_design_plain
    (chunk, _q, qpheno, qcovar, _H, case, _c), _p = first_chunks(
        cs, device, snarls, work)
    no_covar = torch.zeros((qcovar.shape[0], 0), dtype=torch.float64,
                           device=device)
    d = quant_design_plain(chunk, no_covar, *cs.THRESHOLDS,
                           2 * qcovar.shape[0])
    rows = cs.perm_host_rows(cs.to_np(case) > 0.5, cs.to_np(qpheno),
                             cs.to_np(qcovar), int(chunk.words.shape[1]),
                             cs.PERM_FULL)
    Z, w, e = (cs.upload_t(rows[k], device) for k in ("Z", "w", "e"))
    D, Vinv, df, _bad = pm.score_precompute_plain(
        d["X"], d["used"], d["ncols"], d["filtered"] | d["degenerate"], Z, w)
    T = torch.clamp(pm.score_perm_stats_plain(D, d["used"], Vinv, e),
                    min=0.0)
    return per_order(lambda o: chi2_tail_call(cs, device, versions, T,
                                              df[None, :], None, o),
                     order), tuple(T.shape)


def quant_chunk_stats(cs, device, snarls, work):
    """The first ``vcf -q -c`` chunk's design (plain quant_design on the
    card: the kernel's X bit for bit) and its OLS statistics (plain),
    (t1, df, beta, se, r2), and the chunk."""
    from stoat_tpu_torch.pipeline.quantitative import quant_design_plain
    from stoat_tpu_torch.stats.linreg import linear_regression_stats_plain
    (chunk, qchunk, qpheno, qcovar, H, case, _c), _p = first_chunks(
        cs, device, snarls, work)
    d = quant_design_plain(qchunk, qcovar, *cs.THRESHOLDS, H)
    stats = linear_regression_stats_plain(d["X"], qpheno[None, :] * d["used"],
                                          d["used"], d["ncols"])
    return d, [t.contiguous() for t in stats], (chunk, qpheno, qcovar, case)


def student_t_call(cs, device, t1, df, rest, order):
    """A zero-argument launch of student_t on ``t1`` and ``df`` (with the
    degenerate mask and beta, se, r2 to mask, or None: p alone)."""
    import torch
    from stoat_tpu_torch.kernels import I64, VOIDP, launch
    tensors = reorder(tail_order(cs, "student_t", (t1, df), order),
                      [t.contiguous() for t in (t1, df, *(rest or ()))])
    t1, df = tensors[:2]
    rest = tensors[2:] if rest else None
    n = t1.numel()
    outs = [torch.empty(n, dtype=torch.float64, device=device)
            for _ in range(4 if rest else 1)]
    outp = [t.data_ptr() for t in outs] + [None] * (4 - len(outs))

    def call():
        # the pointers taken here, so that the call holds its inputs
        ins = [t.data_ptr() for t in rest] if rest else [None] * 4
        launch("student_t", [VOIDP] * 10 + [I64],
               [t1.data_ptr(), df.data_ptr(), *ins, *outp, n], device)
        return outs
    return call


def student_t_inputs(cs, device, snarls, work, versions, order):
    """student_t on the first ``vcf -q -c`` chunk's statistics with their
    NA masking ([S], student_t_pvalues' call), and their shape."""
    d, st, _ = quant_chunk_stats(cs, device, snarls, work)
    rest = (d["degenerate"], *st[2:5])
    return per_order(lambda o: student_t_call(cs, device, st[0], st[1], rest,
                                              o), order), \
        tuple(st[0].shape)


def student_t_perm_inputs(cs, device, snarls, work, versions, order):
    """student_t on perm_ols's [K, S] statistics of the first ``vcf -q
    -c`` chunk with the observed phenotype and PERM_FULL Freedman-Lane
    permutations (quant_perm_pvalues' linear_pvalues call), and their
    shape."""
    from stoat_tpu_torch.pipeline import permutation as pm
    d, _st, (chunk, qpheno, qcovar, case) = quant_chunk_stats(
        cs, device, snarls, work)
    rows = cs.perm_host_rows(cs.to_np(case) > 0.5, cs.to_np(qpheno),
                             cs.to_np(qcovar), int(chunk.words.shape[1]),
                             cs.PERM_FULL)
    t1, df = pm.perm_ols_stats_plain(d["X"], d["used"], d["ncols"],
                                     cs.upload_t(rows["phenos"], device))
    return per_order(lambda o: student_t_call(cs, device, t1, df, None, o),
                     order), tuple(t1.shape)


def host_costs(cs, device, snarls, work):
    """The host's part of a student_t [S] call: ms per call of the
    wrapper (student_t_pvalues: checks, four allocations, the launch),
    of the bare launch into outputs allocated once, and of that launch on
    no element (S = 0: the launch's own cost)."""
    import torch
    from stoat_tpu_torch.kernels import I64, VOIDP, launch
    from stoat_tpu_torch.stats.linreg import student_t_pvalues
    d, st, _ = quant_chunk_stats(cs, device, snarls, work)
    args = (st[0], st[1], d["degenerate"], *st[2:5])
    S = int(st[0].shape[0])
    outs = [torch.empty(S, dtype=torch.float64, device=device)
            for _ in range(4)]
    ptrs = [t.data_ptr() for t in args] + [t.data_ptr() for t in outs]

    def bare(n):
        return lambda: launch("student_t", [VOIDP] * 10 + [I64],
                              [*ptrs, n], device)
    return {"wrapper": cs.cuda_ms(lambda: student_t_pvalues(*args), 50),
            "bare launch": cs.cuda_ms(bare(S), 50),
            "launch of S = 0": cs.cuda_ms(bare(0), 50)}


CALLS = {"binary_stats": binary_stats_inputs,
         "binary_from_words": binary_from_words_inputs,
         "membership_counts": membership_counts_inputs,
         "graph_stats": graph_stats_inputs,
         "binary_tables": binary_tables_inputs, "fisher": fisher_inputs,
         "eqtl_ols": eqtl_ols_inputs, "logreg": logreg_inputs,
         "ols": ols_inputs, "perm_binary": perm_binary_inputs,
         "perm_ols": perm_ols_inputs, "quant_design": quant_design_inputs,
         "score_precompute": score_precompute_inputs,
         "score_perm": score_perm_inputs, "chi2_tail": chi2_tail_inputs,
         "chi2_tail_perm": chi2_tail_perm_inputs,
         "chi2_tail_score": chi2_tail_score_inputs,
         "student_t": student_t_inputs,
         "student_t_perm": student_t_perm_inputs}
# the calls that launch each version with the arguments its source declares
BY_SOURCE = ("ols", "quant_design", "chi2_tail", "chi2_tail_perm",
             "chi2_tail_score", "binary_stats", "binary_from_words",
             "graph_stats")
# the calls whose device ms is every kernel in their profiler window (by
# kernel, or by the label of one of a kernel's calls)
DEVICE_TOTAL = ("binary_stats", "binary_from_words",
                "graph_stats (with its tails)")
# the tails' calls, which take ``--order``
TAILS = ("chi2_tail", "chi2_tail_perm", "chi2_tail_score", "student_t",
         "student_t_perm")
# the first output's statistic and p floor in chip_smoke.stat_err
FIRST = {"logreg": ("p", 1e-5)}
# the source (and library) of each kernel
SOURCES = {"score_perm": "score_test", "score_precompute": "score_test",
           "chi2_tail_perm": "chi2_tail", "chi2_tail_score": "chi2_tail",
           "student_t_perm": "student_t"}
# the version whose library is loaded (kernel_ab's use)
STATE = {"tag": "A"}


def build_version(build, name, src_dir, tag):
    """One version's library, built afresh, and its ptxas report."""
    src = os.path.join(os.path.abspath(src_dir), f"{name}.cu")
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"lib{name}-{tag}.so"
    res = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                          str(out), src], capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    return ctypes.CDLL(str(out)), (res.stdout + res.stderr).strip(), \
        str(out)


TENSOR_OPS = ("DMMA", "IMMA", "BMMA")


def sass_counts(lib_path, kernel):
    """The tensor-core instructions of the library's SASS: for DMMA (float64),
    IMMA (integer) and BMMA (binary), "<lines in the library> (<lines in
    the functions of ``kernel``>)", the kernel's functions being those named
    ``<kernel>_kernel`` or ``<kernel>_<part>_kernel``."""
    from stoat_tpu_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        return f"cuobjdump failed: {res.stderr.strip()[:200]}"
    own = re.compile(rf"(?:^|[^A-Za-z_])\d*{re.escape(kernel)}"
                     rf"(?:_[a-z]+)?_kernel")
    total = {op: 0 for op in TENSOR_OPS}
    mine = dict(total)
    in_kernel = False
    for line in res.stdout.splitlines():
        if "Function : " in line:
            in_kernel = bool(own.search(line.split("Function : ", 1)[1]))
            continue
        for op in TENSOR_OPS:
            if op in line:
                total[op] += 1
                mine[op] += in_kernel
    return "; ".join(f"{op} lines in the SASS: {total[op]} ({mine[op]} in "
                     f"{kernel})" for op in TENSOR_OPS)


def first_err(cs, kernel, outs_a, outs_b):
    """The largest relative difference of the first outputs of A and B, in
    the scale of the kernel's check (see the docstring)."""
    import numpy as np
    a, b = outs_a[0], outs_b[0]
    if kernel == "score_precompute":
        # V^-1 [S, PT, PT] of the snarls neither version flags (allbad, the
        # fourth output: an ill-conditioned V inverts to garbage that no
        # statistic reads)
        good = ~(outs_a[3] | outs_b[3])
        scale = np.maximum(np.abs(b[good]).max(axis=(1, 2), keepdims=True),
                           1e-300)
        return float(np.max(np.abs(a[good] - b[good]) / scale)) \
            if good.any() else 0.0
    if kernel in TAILS:
        return cs.stat_err("p", a, b)
    stat, floor = FIRST.get(kernel, ("t1", 0.0))
    return cs.stat_err(stat, a, b, p_floor=floor)


def differing(cs, i, a, b):
    """Output ``i``: how many elements of A differ from B's in any bit,
    the largest relative difference and the first three (index, A, B)."""
    import numpy as np
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    if a.shape != b.shape:
        return f"output {i}: shapes {a.shape} and {b.shape}"
    bad = np.flatnonzero(~((a.view(np.uint64) == b.view(np.uint64))
                           | (np.isnan(a) & np.isnan(b))))
    return (f"output {i}: {bad.size} elements differ, largest relative "
            f"difference {cs.rel_err(a, b):.3g}, first "
            + ", ".join(f"[{j}] {a[j]!r} / {b[j]!r}" for j in bad[:3]))


def kernel_name(mangled):
    """``<name>_kernel`` (with an instantiation's integer template
    argument) out of a mangled name: the identifier whose length prefix
    covers it."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):
            ident = mangled[m.end():m.end() + int(m.group()[i:])]
            if re.fullmatch(r"[a-z][a-z_0-9]*_kernel", ident):
                arg = re.match(r"ILi(\d+)E", mangled[m.end() + len(ident):])
                return ident + (f"<{arg.group(1)}>" if arg else "")
    return mangled


def registers(ptxas):
    """Each kernel's registers and spill stores from ptxas -v, by the
    kernel's name (an instantiation's template arguments after it)."""
    out, name = [], "?"
    for line in ptxas.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill:
            out.append(f"{name}: spill stores {spill.group(1)}")
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out.append(f"{name}: {regs.group(1)} registers")
    return "; ".join(out)


def time_versions(cs, torch, label, kernel, name, call, shape, tags,
                  sources, use, ptxas, sass, rounds):
    """Each version's outputs, ms per call (A B B A, ``rounds`` rounds) and
    device ms on ``call``, printed under ``label``, and each candidate's
    outputs against B's."""
    outs, ms, dev = {}, {tag: [] for tag in tags}, {}
    for tag in tags:
        use(tag)
        outs[tag] = [cs.to_np(t) for t in call()]
    for _ in range(rounds):
        for tag in tags + tags[::-1]:
            use(tag)
            ms[tag].append(cs.cuda_ms(call, 10))
    for tag in tags:
        use(tag)
        if kernel in DEVICE_TOTAL or label in DEVICE_TOTAL:
            dev[tag] = cs.device_total_ms(torch, call)
        else:
            dev[tag] = cs.device_ms(torch, {name: call})[name]
    use(tags[0])
    for tag in tags:
        cs.say(f"{label} {tag} ({sources[tag]}): {registers(ptxas[tag])}; "
               f"{sass[tag]}; "
               f"{statistics.median(ms[tag]):.4f} ms per call (median of "
               f"{len(ms[tag])} timings of 10 calls: "
               + ", ".join(f"{t:.4f}" for t in ms[tag])
               + f"); device {dev[tag]} ms per call")
    for tag in tags[:-1]:
        same = all(cs.same_bits(a, b) for a, b in zip(outs[tag], outs["B"]))
        first = first_err(cs, kernel, outs[tag], outs["B"])
        flips = ""
        if kernel == "logreg":
            diff = (outs[tag][3] != outs["B"][3]).nonzero()[0].tolist()
            flips = f"; snarls whose Newton step counts differ: {diff}"
        if not same:
            flips += "; " + "; ".join(
                differing(cs, i, a, b)
                for i, (a, b) in enumerate(zip(outs[tag], outs["B"]))
                if not cs.same_bits(a, b))
        cs.say(f"{label} on {shape}: outputs of {tag} and B bitwise equal: "
               f"{same}; largest relative difference of the first output: "
               f"{first:.3g}" + flips)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="directory of the other version's kernel sources")
    ap.add_argument("--candidate", action="append",
                    help="directory of a version to test (default: the "
                         "checkout's stoat_tpu_torch/csrc); repeat it to "
                         "time several versions in turn")
    ap.add_argument("--kernel", default="ols", choices=sorted(CALLS))
    ap.add_argument("--snarls", type=int, default=16384)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--order", default="as-is",
                    help="the tails: their elements as they come (as-is), "
                         "grouped by branch (branch), or by branch and "
                         "iterations (work); several, comma-separated, are "
                         "timed in turn")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("kernel_ab: no CUDA device is available\n")
        return 1
    for path in (HERE, os.path.join(HERE, "tests")):
        if path not in sys.path:
            sys.path.insert(0, path)
    import chip_smoke as cs
    from stoat_tpu_torch.kernels import build

    kernel = args.kernel
    name = SOURCES.get(kernel, kernel)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    libs, ptxas, sass = {}, {}, {}
    candidates = args.candidate or [str(build.CSRC_DIR)]
    sources = {("A" if len(candidates) == 1 else f"A{i + 1}"): str(c)
               for i, c in enumerate(candidates)}
    sources["B"] = args.baseline
    tags = list(sources)
    # every version's sources built at once, one nvcc each
    from concurrent.futures import ThreadPoolExecutor
    jobs = [(tag, src) for tag, src_dir in sources.items()
            for src in version_sources(kernel, src_dir)]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda job: build_version(build, job[1], sources[job[0]],
                                      job[0]), jobs)))
    for tag, src_dir in sources.items():
        libs[tag], reports, sasses = {}, [], []
        for src in version_sources(kernel, src_dir):
            libs[tag][src], report, path = built[(tag, src)]
            reports.append(report)
            sasses.append(sass_counts(path, src))
        ptxas[tag], sass[tag] = "\n".join(reports), "; ".join(sasses)

    def use(tag):
        STATE["tag"] = tag
        with build._LOCK:
            build._LIBS.update(libs[tag])

    work = tempfile.mkdtemp(prefix="ab-", dir=build.BUILD_DIR)
    extra = {"versions": sources} if kernel in BY_SOURCE else {}
    if kernel in TAILS:
        extra = {"versions": sources, "order": args.order.split(",")}
    host = None
    try:
        call, shape = CALLS[kernel](cs, device, args.snarls, work, **extra)
        if kernel == "student_t":
            use(tags[0])
            host = host_costs(cs, device, args.snarls, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    calls = call if isinstance(call, dict) else {None: call}
    for order, call in calls.items():
        label = kernel if order is None else f"{kernel} ({order})"
        time_versions(cs, torch, label, kernel, name, call, shape, tags,
                      sources, use, ptxas, sass, args.rounds)
    if host is not None:
        cs.say(f"{kernel} host costs of {tags[0]} (ms per call): " + ", ".join(
            f"{k} {v:.4f}" for k, v in host.items()))
    cs.say(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
