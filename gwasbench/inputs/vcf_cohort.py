"""A pangenome GWAS cohort from a seed: snarl file, VCF, traits, covariates.

Frozen, vectorised copy of tests/fixtures.py ``make_fixture`` (lines
20-157 at the commit that added this benchmark): the same file formats and
the same shapes, drawn in blocks of snarls with numpy instead of a loop
over them.  Per snarl: a bubble of 2-4 allele paths, every fifth snarl
(k % 5 == 3) a deletion straight across beside a path through a nested
star; one VCF record per snarl whose INFO ``AT`` lists the paths, so the
allele index of a genotype is the path index; both haplotypes of a
sample missing ("./.") with probability 0.02; a binary trait (1 control /
2 case), a quantitative trait N(5, 4) and a covariate AGE, N(0, 1),
printed with six decimals.

Departures from ``make_fixture``:

- Allele frequencies follow the configuration's ``allele_frequency_bins``
  (the cited cohort's spectrum), not Dirichlet(2): each non-reference
  path (allele 1 and up) is given a bin, and its frequency is drawn
  log-uniform inside it (density 1/f, the neutral site frequency
  spectrum); the reference path (allele 0) takes the rest.  Where a
  snarl's non-reference frequencies sum above ``MAX_ALT_SUM`` they are
  scaled down to it.
- SEX is 0 or 1 with probability 1/2 each, printed as an integer, where
  the fixture draws N(0, 1).
- To keep the work of a run the same from seed to seed, the allele
  counts (2, 3 and 4 in turn) and the bins of the non-reference paths
  are fixed multisets shuffled by the seed, where the fixture draws each;
  the random stream is drawn in another order.

``make`` returns the :class:`Cohort`: the files' paths and the arrays
they were written from, which the reference reads instead of parsing the
files again (the traits and covariates as the files print them).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

__all__ = ["Cohort", "make"]

MISSING_RATE = 0.02
MAX_ALT_SUM = 0.95
MAX_ALLELES = 4
BLOCK = 2048          # snarls drawn and written at a time


@dataclass
class Cohort:
    """The generated inputs and the arrays behind them."""

    paths: Dict[str, str]
    samples: List[str]
    chroms: List[str]             # chromosome names in file order
    chrom_of: np.ndarray          # [S] index into chroms
    pos: np.ndarray               # [S] START_POS (END_POS = pos + 10)
    node_start: np.ndarray        # [S] first node of the bubble
    node_end: np.ndarray          # [S] last node of the bubble
    n_alleles: np.ndarray         # [S] paths of each snarl (2-4)
    path_strings: List[List[str]]  # [S] the snarl's paths, ">a>b>c"
    types: List[str]              # [S] the TYPE column ("1,0,1/9")
    alleles: np.ndarray           # int8 [S, 2N], haplotype allele, -1 missing
    case: np.ndarray              # bool [N], PHENO == 2
    quantitative: np.ndarray      # float64 [N], as printed
    covariates: np.ndarray        # float64 [N, 2], as printed

    @property
    def n_snarls(self) -> int:
        return int(self.n_alleles.shape[0])

    @property
    def n_samples(self) -> int:
        return len(self.samples)

    def snarl_id(self, s: int) -> str:
        return f"{self.node_start[s]}_{self.node_end[s]}"


def _snarl_paths(start: int, end: int, n: int, nested: bool):
    """(paths, types) of one bubble (fixtures.py:41-60)."""
    mids = list(range(start + 1, start + 1 + n))
    paths, types = [], []
    for i, mid in enumerate(mids):
        if nested and i == 0:
            paths.append(f">{start}>{end}")
            types.append("0")
        elif nested and i == 1:
            paths.append(f">{start}>{mid}>0>{mids[-1]}>{end}")
            types.append("1/9")
        else:
            paths.append(f">{start}>{mid}>{end}")
            types.append("1")
    return paths, types


def alt_bins(bins, n_alleles: np.ndarray, rng) -> np.ndarray:
    """int [S, MAX_ALLELES]: the bin of each non-reference path (-1 in
    column 0 and past the snarl's paths), the bins a fixed multiset in
    the shares of ``bins`` (rows ``[lo, hi, share]``), shuffled by
    ``rng``."""
    S = n_alleles.shape[0]
    alt = (np.arange(MAX_ALLELES)[None, :] >= 1) & \
        (np.arange(MAX_ALLELES)[None, :] < n_alleles[:, None])
    n_alt = int(alt.sum())
    share = np.asarray([b[2] for b in bins], np.float64)
    edges = np.round(np.cumsum(share) / share.sum() * n_alt).astype(int)
    pool = np.searchsorted(edges, np.arange(n_alt), side="right")
    rng.shuffle(pool)
    out = np.full((S, MAX_ALLELES), -1, np.int64)
    out[alt] = pool
    return out


def frequencies(bins, bin_of: np.ndarray, rng) -> np.ndarray:
    """float64 [B, MAX_ALLELES]: each path's frequency, log-uniform inside
    its bin for the non-reference paths, the rest on the reference path,
    0 past the snarl's paths."""
    lo = np.asarray([b[0] for b in bins], np.float64)
    hi = np.asarray([b[1] for b in bins], np.float64)
    b = np.maximum(bin_of, 0)
    f = lo[b] * (hi[b] / lo[b]) ** rng.random(bin_of.shape)
    f = np.where(bin_of >= 0, f, 0.0)
    total = f.sum(axis=1, keepdims=True)
    f *= np.where(total > MAX_ALT_SUM, MAX_ALT_SUM / np.maximum(total, 1e-300),
                  1.0)
    f[:, 0] = 1.0 - f.sum(axis=1)
    return f


def _draw_alleles(rng, freq: np.ndarray, n_alleles: np.ndarray,
                  n_samples: int) -> np.ndarray:
    """int8 [B, 2N]: each haplotype's allele, the inverse CDF of the
    snarl's frequencies (searchsorted ``right``, capped at n - 1,
    fixtures.py:67-71); -1 on both haplotypes of a missing sample."""
    B = n_alleles.shape[0]
    cum = np.cumsum(freq, axis=1)
    # only the first n - 1 boundaries can be passed: the cap at n - 1
    cum = np.where(np.arange(MAX_ALLELES)[None, :] < n_alleles[:, None] - 1,
                   cum, np.inf)
    u = rng.random((B, n_samples, 2))
    allele = np.zeros((B, n_samples, 2), np.int8)
    for j in range(MAX_ALLELES - 1):
        allele += cum[:, j, None, None] <= u
    missing = rng.random((B, n_samples)) < MISSING_RATE
    allele[missing] = -1
    return allele.reshape(B, 2 * n_samples)


def _gt_bytes(allele: np.ndarray) -> np.ndarray:
    """uint8 [B, 4N]: "a/b\\t" per sample ("./." when missing), the last
    tab a newline."""
    B, H = allele.shape
    a = allele.reshape(B, H // 2, 2)
    out = np.empty((B, H // 2, 4), np.uint8)
    digit = np.where(a < 0, ord("."), a.astype(np.int16) + ord("0"))
    out[:, :, 0] = digit[:, :, 0]
    out[:, :, 1] = ord("/")
    out[:, :, 2] = digit[:, :, 1]
    out[:, :, 3] = ord("\t")
    out[:, -1, 3] = ord("\n")
    return out.reshape(B, -1)


def _printed(values: np.ndarray) -> tuple:
    """(strings, the floats they parse to): six decimals, as the fixture
    prints traits and covariates."""
    strings = np.char.mod("%.6f", values)
    return strings, strings.astype(np.float64)


def _settle(fh) -> None:
    """The file on disk before the run goes on, so that its write-back
    does not fall into the timed window."""
    fh.flush()
    os.fsync(fh.fileno())


def make(config: Dict, seed: int, out_dir: str) -> Cohort:
    """Write the cohort of ``config`` (n_samples, n_snarls, n_chroms,
    chrom_prefix, allele_frequency_bins) drawn from ``seed`` into
    ``out_dir``."""
    N = int(config["n_samples"])
    S = int(config["n_snarls"])
    n_chroms = int(config["n_chroms"])
    prefix = config.get("chrom_prefix", "ref")
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)

    samples = [f"samp{i}" for i in range(N)]
    chroms = ([prefix] if n_chroms <= 1
              else [f"{prefix}{c}" for c in range(n_chroms)])
    per_chrom = -(-S // len(chroms))
    k = np.arange(S)
    chrom_of = k // per_chrom
    pos = 100 + (k % per_chrom) * 120
    n_alleles = np.resize(np.arange(2, MAX_ALLELES + 1), S)
    rng.shuffle(n_alleles)
    node_start = 1 + np.concatenate(
        [[0], np.cumsum(n_alleles + 1)[:-1]]).astype(np.int64)
    node_end = node_start + n_alleles + 1
    nested = k % 5 == 3
    bins = config["allele_frequency_bins"]
    bin_of = alt_bins(bins, n_alleles, rng)

    path_strings, types, snarl_rows, prefixes = [], [], [], []
    for s in range(S):
        paths, tys = _snarl_paths(int(node_start[s]), int(node_end[s]),
                                  int(n_alleles[s]), bool(nested[s]))
        path_strings.append(paths)
        types.append(",".join(tys))
        chrom, p = chroms[chrom_of[s]], int(pos[s])
        sid = f"{node_start[s]}_{node_end[s]}"
        joined = ",".join(paths)
        snarl_rows.append(f"{chrom}\t{p}\t{p + 10}\t{1000 + s}\t{sid}\t"
                          f"{joined}\t{types[-1]}\t1\t1\n")
        alts = ",".join(["T"] * max(int(n_alleles[s]) - 1, 1))
        prefixes.append(f"{chrom}\t{p}\t{sid}\tA\t{alts}\t99\tPASS\t"
                        f"AT={joined};LV=0\tGT\t".encode())

    paths_out = {
        "snarl": os.path.join(out_dir, "snarl_analyse.tsv"),
        "vcf": os.path.join(out_dir, "test.vcf"),
        "binary": os.path.join(out_dir, "binary.pheno.tsv"),
        "quantitative": os.path.join(out_dir, "quant.pheno.tsv"),
        "covariate": os.path.join(out_dir, "covariate.tsv"),
    }
    with open(paths_out["snarl"], "w") as fh:
        fh.write("CHR\tSTART_POS\tEND_POS\tSNARL_HANDLEGRAPH\tSNARL\tPATHS\t"
                 "TYPE\tREF\tDEPTH\n")
        fh.writelines(snarl_rows)
        _settle(fh)

    alleles = np.empty((S, 2 * N), np.int8)
    with open(paths_out["vcf"], "wb") as fh:
        fh.write(b"##fileformat=VCFv4.2\n")
        for c in chroms:
            fh.write(f"##contig=<ID={c}>\n".encode())
        fh.write(b'##INFO=<ID=AT,Number=R,Type=String,Description="Allele '
                 b'Traversal">\n')
        fh.write(b'##INFO=<ID=LV,Number=1,Type=Integer,Description="Level">'
                 b'\n')
        fh.write(("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                  + "\t".join(samples) + "\n").encode())
        for lo in range(0, S, BLOCK):
            hi = min(lo + BLOCK, S)
            block = _draw_alleles(rng, frequencies(bins, bin_of[lo:hi], rng),
                                  n_alleles[lo:hi], N)
            alleles[lo:hi] = block
            gt = _gt_bytes(block)
            for i in range(hi - lo):
                fh.write(prefixes[lo + i])
                fh.write(gt[i].data)
        _settle(fh)

    binary = rng.integers(1, 3, N)
    quant_str, quant = _printed(rng.standard_normal(N) * 2.0 + 5.0)
    age_str, age = _printed(rng.standard_normal(N))
    sex = rng.integers(0, 2, N)
    covar = np.stack([age, sex.astype(np.float64)], axis=1)
    with open(paths_out["binary"], "w") as fh:
        fh.write("FID\tIID\tPHENO\n")
        fh.writelines(f"{s}\t{s}\t{b}\n" for s, b in zip(samples, binary))
        _settle(fh)
    with open(paths_out["quantitative"], "w") as fh:
        fh.write("FID\tIID\tPHENO\n")
        fh.writelines(f"{s}\t{s}\t{q}\n" for s, q in zip(samples, quant_str))
        _settle(fh)
    with open(paths_out["covariate"], "w") as fh:
        fh.write("FID\tIID\tAGE\tSEX\n")
        fh.writelines(f"{s}\t{s}\t{a}\t{b}\n"
                      for s, a, b in zip(samples, age_str, sex))
        _settle(fh)

    return Cohort(paths=paths_out, samples=samples, chroms=chroms,
                  chrom_of=chrom_of, pos=pos, node_start=node_start,
                  node_end=node_end, n_alleles=n_alleles,
                  path_strings=path_strings, types=types, alleles=alleles,
                  case=binary == 2, quantitative=quant, covariates=covar)
