"""Synthetic GWAS dataset simulation with ground-truth labels.

The port's copy of stoat_tpu/simulate.py (``simulate`` and ``truth``):
the same draws from ``np.random.default_rng(seed)`` in the same order,
so the files come out byte for byte the same.  Fills the role of the
reference's simulation pipeline (tests/simu/Snakefile_simulation +
simulate_test_dataset.py) without the
vg toolchain: generates a snarl decomposition file, a VCF with ``AT``
allele traversals, binary/quantitative phenotypes, covariates, and a truth
allele-frequency table in the reference's ``pg.snarls.freq.tsv`` schema
(``start_node  next_node  group  freq``) for precision/recall scoring.

A chosen fraction of snarls carry a real association: their allele
frequencies differ between case and control groups (binary) and the first
allele's dosage shifts the quantitative phenotype.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

__all__ = ["generate_dataset", "verify_truth"]


def generate_dataset(outdir: str, n_samples: int = 200, n_snarls: int = 100,
                     seed: int = 7, chrom: str = "ref",
                     effect_fraction: float = 0.2,
                     effect_shift: float = 0.35,
                     quant_effect: float = 1.5) -> Dict[str, str]:
    """Write a full simulated dataset; returns the file paths."""
    rng = np.random.default_rng(seed)
    os.makedirs(outdir, exist_ok=True)

    samples = [f"samp{i}" for i in range(n_samples)]
    is_case = rng.random(n_samples) < 0.5

    snarl_rows: List[str] = []
    vcf_rows: List[str] = []
    truth_rows: List[str] = []
    quant = rng.standard_normal(n_samples) * 1.0

    node = 1
    pos = 100
    for k in range(n_snarls):
        n_alleles = int(rng.integers(2, 5))
        start = node
        end = node + n_alleles + 1
        mids = list(range(node + 1, node + 1 + n_alleles))
        paths = [f">{start}>{mid}>{end}" for mid in mids]
        types = ["1"] * n_alleles
        snarl_id = f"{start}_{end}"
        snarl_rows.append("\t".join([
            chrom, str(pos), str(pos + 10), str(1000 + k), snarl_id,
            ",".join(paths), ",".join(types), "1", "1"]))

        has_effect = rng.random() < effect_fraction
        base = rng.dirichlet(np.ones(n_alleles) * 3.0)
        if has_effect:
            shift = np.zeros(n_alleles)
            shift[0] = effect_shift
            shift[1] = -effect_shift * base[1] / max(1 - base[0], 1e-9)
            case_freq = np.clip(base + shift, 0.02, None)
            case_freq /= case_freq.sum()
        else:
            case_freq = base
        control_freq = base

        # vectorized diploid draws: inverse-CDF sample per haplotype
        cum_case = np.cumsum(case_freq)
        cum_ctrl = np.cumsum(control_freq)
        u = rng.random((n_samples, 2))
        a_case = np.searchsorted(cum_case, u, side="right")
        a_ctrl = np.searchsorted(cum_ctrl, u, side="right")
        alleles = np.where(is_case[:, None], a_case, a_ctrl)
        alleles = np.minimum(alleles, n_alleles - 1)
        gts = [f"{a1}/{a2}" for a1, a2 in alleles]
        dosage0 = (alleles == 0).sum(axis=1).astype(float)
        hap_counts = {}
        for group in (0, 1):
            sel = alleles[is_case == bool(group)].ravel()
            hap_counts[group] = np.bincount(sel, minlength=n_alleles)

        if has_effect:
            quant += quant_effect * (dosage0 - dosage0.mean())

        # the reference's freq file pairs each (start, next)'s group-0
        # and group-1 rows ADJACENT (its verify script reads pairwise):
        # allele outer, group inner
        totals = {g: hap_counts[g].sum() for g in (0, 1)}
        for a, mid in enumerate(mids):
            for group in (0, 1):
                total = totals[group]
                freq = hap_counts[group][a] / total if total else 0.0
                truth_rows.append(
                    f"{start}\t{mid}\t{group}\t{freq:.4f}")

        alts = ",".join(["T"] * max(n_alleles - 1, 1))
        vcf_rows.append("\t".join([
            chrom, str(pos), snarl_id, "A", alts, "99", "PASS",
            f"AT={','.join(paths)};LV=0", "GT"] + gts))
        node = end
        pos += 120

    files = {}
    files["snarl"] = os.path.join(outdir, "snarl_analyse.tsv")
    with open(files["snarl"], "w") as fh:
        fh.write("CHR\tSTART_POS\tEND_POS\tSNARL_HANDLEGRAPH\tSNARL\tPATHS\t"
                 "TYPE\tREF\tDEPTH\n")
        fh.write("\n".join(snarl_rows) + "\n")

    files["vcf"] = os.path.join(outdir, "simulated.vcf")
    with open(files["vcf"], "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write(f"##contig=<ID={chrom}>\n")
        fh.write('##INFO=<ID=AT,Number=R,Type=String,Description="Allele '
                 'Traversal">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(samples) + "\n")
        fh.write("\n".join(vcf_rows) + "\n")

    files["binary"] = os.path.join(outdir, "binary.phenotype.tsv")
    with open(files["binary"], "w") as fh:
        fh.write("FID\tIID\tPHENO\n")
        for s, c in zip(samples, is_case):
            fh.write(f"{s}\t{s}\t{2 if c else 1}\n")

    files["quantitative"] = os.path.join(outdir, "quant.phenotype.tsv")
    with open(files["quantitative"], "w") as fh:
        fh.write("FID\tIID\tPHENO\n")
        for s, q in zip(samples, quant):
            fh.write(f"{s}\t{s}\t{q:.6f}\n")

    covar = rng.standard_normal((n_samples, 2))
    files["covariate"] = os.path.join(outdir, "covariate.tsv")
    with open(files["covariate"], "w") as fh:
        fh.write("FID\tIID\tPC1\tPC2\n")
        for i, s in enumerate(samples):
            fh.write(f"{s}\t{s}\t{covar[i, 0]:.6f}\t{covar[i, 1]:.6f}\n")

    files["truth"] = os.path.join(outdir, "snarls.freq.tsv")
    with open(files["truth"], "w") as fh:
        fh.write("start_node\tnext_node\tgroup\tfreq\n")
        fh.write("\n".join(truth_rows) + "\n")

    return files


def verify_truth(results_tsv: str, truth_tsv: str,
                 p_threshold: float = 0.05,
                 freq_threshold: float = 0.2) -> Dict[str, float]:
    """Precision/recall of significant calls vs the truth frequencies
    (tests/scripts/verify_truth.py semantics: a snarl is truly associated
    when any allele's group-frequency difference exceeds the threshold)."""
    # truth: {start_node: max |freq_g0 - freq_g1| over alleles}
    freqs: Dict[tuple, Dict[int, float]] = {}
    with open(truth_tsv) as fh:
        fh.readline()
        for line in fh:
            start, nxt, group, freq = line.split("\t")
            freqs.setdefault((start, nxt), {})[int(group)] = float(freq)
    max_diff: Dict[str, float] = {}
    for (start, _nxt), groups in freqs.items():
        diff = abs(groups.get(0, 0.0) - groups.get(1, 0.0))
        max_diff[start] = max(max_diff.get(start, 0.0), diff)

    tp = fp = fn = tn = 0
    seen_starts = set()
    with open(results_tsv) as fh:
        header = fh.readline().rstrip("\n").lstrip("#").split("\t")
        p_idx = header.index("P") if "P" in header else header.index(
            "P_CHI2")
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            snarl_start = cols[3].split("_")[0]
            seen_starts.add(snarl_start)
            truth_assoc = max_diff.get(snarl_start, 0.0) > freq_threshold
            p_str = cols[p_idx]
            called = p_str not in ("NA", "") and float(p_str) < p_threshold
            if called and truth_assoc:
                tp += 1
            elif called:
                fp += 1
            elif truth_assoc:
                fn += 1
            else:
                tn += 1
    # truth-associated snarls with NO results row (filtered before any
    # test) are false negatives of the END-TO-END pipeline — skipping
    # them inflated recall
    for start, diff in max_diff.items():
        if diff > freq_threshold and start not in seen_starts:
            fn += 1
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {"tp": tp, "fp": fp, "fn": fn, "tn": tn,
            "precision": precision, "recall": recall, "f1": f1}
