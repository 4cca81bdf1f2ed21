"""A cis-eQTL cohort from a seed: VCF, snarl file, expression, gene
positions and covariates, in GTEx v8's shapes.

The VCF and the snarl file are ``vcf_cohort.py``'s (its ``make``, at the
configuration's sample count): the same shapes, the same fixed multisets
of allele counts and frequency bins, so that every seed does the same
amount of work.  Beside them, drawn from a second stream of the seed:

- genes: along each chromosome, one gene a TSS, every ``tss_spacing``
  bases from an offset in [0, tss_spacing) drawn a chromosome, as many a
  chromosome whatever the seed (the chromosome's length over the
  spacing); a gene's start and end are its TSS, so that stoat's overlap
  test of a snarl's window [start - w, end + w] with a gene is GTEx's
  "TSS within w"; written as ``gene_name chr start end``;
- expression: N(0, 1) per gene and sample, printed with six decimals
  (GTEx's input to its mapper after the inverse-normal transform), one
  row a gene in the genes' order, the samples in the VCF's order;
- covariates: one column a name of ``covariate_names``, N(0, 1) printed
  with six decimals, those in ``binary_covariates`` 0 or 1 with
  probability 1/2 each.

``vcf_cohort.make``'s trait files are removed and its two-column
covariate file is replaced by this one.  ``make`` returns a
:class:`GtexCohort`: the files' paths (``vcf``, ``snarl``, ``expression``,
``genes``, ``covariate``) and the arrays they were written from, as the
files print them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from gwasbench.inputs import vcf_cohort
from gwasbench.inputs.vcf_cohort import Cohort, _printed, _settle

__all__ = ["GtexCohort", "make"]


@dataclass
class GtexCohort(Cohort):
    """The cohort of ``vcf_cohort`` with genes and their expression;
    ``covariates`` holds every covariate column, as printed."""

    gene_names: List[str] = None
    gene_chrom: np.ndarray = None     # [G] index into chroms
    tss: np.ndarray = None            # [G] start = end of each gene
    expression: np.ndarray = None     # float64 [G, N], as printed


def gene_count(config: Dict) -> int:
    """TSS a chromosome: the chromosome's length over the spacing."""
    S = int(config["n_snarls"])
    per_chrom = -(-S // max(int(config["n_chroms"]), 1))
    length = 100 + (per_chrom - 1) * 120 + 10
    return length // int(config["tss_spacing"])


def make(config: Dict, seed: int, out_dir: str) -> GtexCohort:
    """Write the cohort of ``config`` drawn from ``seed`` into
    ``out_dir``."""
    base = vcf_cohort.make(config, seed, out_dir)
    for key in ("binary", "quantitative"):
        os.remove(base.paths[key])
    rng = np.random.default_rng([seed, 1])
    N = base.n_samples
    spacing = int(config["tss_spacing"])
    per_chrom = gene_count(config)

    names, chrom_of, tss = [], [], []
    for c, chrom in enumerate(base.chroms):
        offset = int(rng.integers(0, spacing))
        for i in range(per_chrom):
            names.append(f"GENE{c}_{i}")
            chrom_of.append(c)
            tss.append(offset + i * spacing)
    G = len(names)
    expr_str, expr = _printed(rng.standard_normal((G, N)))

    covar_names = list(config["covariate_names"])
    binary = set(config.get("binary_covariates", ()))
    C = len(covar_names)
    cov_str = np.empty((N, C), dtype=object)
    covar = np.empty((N, C), np.float64)
    for j, name in enumerate(covar_names):
        if name in binary:
            v = rng.integers(0, 2, N)
            cov_str[:, j] = v.astype(str)
            covar[:, j] = v
        else:
            cov_str[:, j], covar[:, j] = _printed(rng.standard_normal(N))

    paths = {"vcf": base.paths["vcf"], "snarl": base.paths["snarl"],
             "expression": os.path.join(out_dir, "expression.tsv"),
             "genes": os.path.join(out_dir, "genes.tsv"),
             "covariate": base.paths["covariate"]}
    with open(paths["genes"], "w") as fh:
        fh.write("gene_name\tchr\tstart\tend\n")
        fh.writelines(f"{g}\t{base.chroms[c]}\t{t}\t{t}\n"
                      for g, c, t in zip(names, chrom_of, tss))
        _settle(fh)
    with open(paths["expression"], "w") as fh:
        fh.write("gene\t" + "\t".join(base.samples) + "\n")
        fh.writelines(g + "\t" + "\t".join(row) + "\n"
                      for g, row in zip(names, expr_str))
        _settle(fh)
    with open(paths["covariate"], "w") as fh:
        fh.write("FID\tIID\t" + "\t".join(covar_names) + "\n")
        fh.writelines(f"{s}\t{s}\t" + "\t".join(row) + "\n"
                      for s, row in zip(base.samples, cov_str))
        _settle(fh)

    fields = {k: getattr(base, k) for k in Cohort.__dataclass_fields__}
    fields.update(paths=paths, covariates=covar)
    return GtexCohort(**fields, gene_names=names,
                      gene_chrom=np.asarray(chrom_of, np.int64),
                      tss=np.asarray(tss, np.int64), expression=expr)
