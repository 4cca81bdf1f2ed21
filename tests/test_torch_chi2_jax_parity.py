"""The chi-squared tail at df > 40, end to end: ``vcf -b`` and ``graph`` on
snarls of more than 41 kept columns write the bytes of ``python -m
stoat_tpu``.

The port's chi-squared tail (stats/special.py chi2_sf_plain) is JAX's
igammac; a tail on another algorithm (torch's, with its uniform asymptotic
expansion for a > 20) moves p by up to 1.9e-9 relative at df 41-400, which
flips a P_CHI2 string about once in 10^5 (tests/test_torch_chi2_tail.py
holds the tail itself on a draw of 2e5).  Here the whole CLI runs on
inputs whose snarls have 42-90 allele paths: a VCF of 300 samples whose
multi-allelic sites have 42-80 alleles, and a graph walked by 90 haplotype
paths (45 samples, HPRC release 1's count) whose bubbles have 45-89
branches, of which the haplotypes walk up to 57 (df 56).  Both CLIs run
in process, on the CPU.
"""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

from stoat_tpu import cli as jax_cli
from stoat_tpu_torch import cli as torch_cli


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _write_pheno(path, samples, case):
    with open(path, "w") as fh:
        fh.write("FID\tIID\tPHENO\n")
        for s, c in zip(samples, case):
            fh.write(f"{s}\t{s}\t{2 if c else 1}\n")


def _wide_vcf(tmpdir, n_samples, n_snarls, seed):
    """A snarl file, a VCF and a binary phenotype whose snarl k has 42-80
    allele paths (one VCF site, allele index = path index), alleles drawn
    from a Dirichlet(2) frequency per site, one site in four shifted in
    cases."""
    rng = np.random.default_rng(seed)
    os.makedirs(tmpdir, exist_ok=True)
    samples = [f"samp{i}" for i in range(n_samples)]
    case = rng.random(n_samples) < 0.5
    snarl_rows, vcf_rows = [], []
    node = 1
    for k in range(n_snarls):
        n_alleles = int(rng.integers(42, 81))
        start, end = node, node + n_alleles + 1
        paths = [f">{start}>{m}>{end}" for m in range(start + 1, end)]
        snarl_id = f"{start}_{end}"
        pos = 100 + 120 * k
        snarl_rows.append("\t".join(["ref", str(pos), str(pos + 10),
                                     str(1000 + k), snarl_id, ",".join(paths),
                                     ",".join(["1"] * n_alleles), "1", "1"]))
        freq = rng.dirichlet(np.full(n_alleles, 2.0))
        u = rng.random((n_samples, 2))
        if k % 4 == 1:
            u = np.where(case[:, None], u ** 2, u)
        draws = np.minimum(np.searchsorted(np.cumsum(freq), u,
                                           side="right"), n_alleles - 1)
        gts = [f"{a}/{b}" for a, b in draws.tolist()]
        vcf_rows.append("\t".join(
            ["ref", str(pos), snarl_id, "A", ",".join(["T"] * (n_alleles - 1)),
             "99", "PASS", f"AT={','.join(paths)};LV=0", "GT"] + gts))
        node = end
    snarl = os.path.join(tmpdir, "snarl_analyse.tsv")
    with open(snarl, "w") as fh:
        fh.write("CHR\tSTART_POS\tEND_POS\tSNARL_HANDLEGRAPH\tSNARL\tPATHS\t"
                 "TYPE\tREF\tDEPTH\n" + "\n".join(snarl_rows) + "\n")
    vcf = os.path.join(tmpdir, "test.vcf")
    with open(vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n##contig=<ID=ref>\n"
                 '##INFO=<ID=AT,Number=R,Type=String,Description="Allele '
                 'Traversal">\n##INFO=<ID=LV,Number=1,Type=Integer,'
                 'Description="Level">\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t'
                 "FILTER\tINFO\tFORMAT\t" + "\t".join(samples) + "\n"
                 + "\n".join(vcf_rows) + "\n")
    pheno = os.path.join(tmpdir, "binary.pheno.tsv")
    _write_pheno(pheno, samples, case)
    return {"snarl": snarl, "vcf": vcf, "binary": pheno}


def _wide_graph(tmpdir, n_snarls, n_samples, seed):
    """A GFA of one chromosome: a backbone of anchor nodes, between each
    pair a bubble of 45-89 single-node branches, walked by 2 * n_samples
    haplotype paths (PanSN names) and a ``ref`` path through every first
    branch; and its binary phenotype."""
    rng = np.random.default_rng(seed)
    os.makedirs(tmpdir, exist_ok=True)
    H = 2 * n_samples
    case = np.zeros(n_samples, bool)
    case[rng.permutation(n_samples)[:n_samples // 2]] = True
    case_hap = np.repeat(case, 2)
    segments, links = [], []
    walks = [[] for _ in range(H)]
    ref = []
    nid = 1
    anchor = nid
    segments.append(f"S\t{nid}\tACGT")
    nid += 1
    for k in range(n_snarls):
        n_branches = int(rng.integers(45, 90))
        branches = list(range(nid, nid + n_branches))
        nid += n_branches
        nxt = nid
        nid += 1
        for b in branches:
            segments.append(f"S\t{b}\t{'ACGT'[b % 4] * (1 + b % 3)}")
            links.append(f"L\t{anchor}\t+\t{b}\t+\t0M")
            links.append(f"L\t{b}\t+\t{nxt}\t+\t0M")
        segments.append(f"S\t{nxt}\tACGT")
        u = rng.random(H)
        if k % 4 == 1:
            u = np.where(case_hap, u ** 2, u)
        freq = rng.dirichlet(np.full(n_branches, 2.0))
        pick = np.minimum(np.searchsorted(np.cumsum(freq), u),
                          n_branches - 1)
        for h in range(H):
            walks[h] += [anchor, branches[pick[h]]]
        ref += [anchor, branches[0]]
        anchor = nxt
    gfa = os.path.join(tmpdir, "graph.gfa")
    with open(gfa, "w") as fh:
        fh.write("H\tVN:Z:1.0\n" + "\n".join(segments + links) + "\n")
        fh.write("P\tref\t" + ",".join(f"{n}+" for n in ref + [anchor])
                 + "\t*\n")
        for h in range(H):
            fh.write(f"P\tS{h // 2:03d}#{h % 2 + 1}#chr1\t"
                     + ",".join(f"{n}+" for n in walks[h] + [anchor])
                     + "\t*\n")
    pheno = os.path.join(tmpdir, "pheno.tsv")
    _write_pheno(pheno, [f"S{s:03d}" for s in range(n_samples)], case)
    return {"gfa": gfa, "pheno": pheno}


def _df_column(tsv, column):
    """Column ``column`` of each row of a TSV."""
    lines = _read(tsv).decode().splitlines()
    head = lines[0].split("\t")
    return [row.split("\t")[head.index(column)] for row in lines[1:]]


@pytest.mark.parametrize("seed", [0, 1])
def test_vcf_binary_wide_snarls_byte_identical(tmp_path, seed):
    """``vcf -b`` on snarls of 42-80 kept columns (df 41-79)."""
    paths = _wide_vcf(str(tmp_path / "data"), 300, 60, seed)
    argv = ["vcf", "-s", paths["snarl"], "-v", paths["vcf"], "-b",
            paths["binary"]]
    assert jax_cli.main(argv + ["-o", str(tmp_path / "jax")]) == 0
    assert torch_cli.main(argv + ["-o", str(tmp_path / "torch"),
                                  "--device", "cpu"]) == 0
    name = "binary_table_vcf.tsv"
    want = _read(tmp_path / "jax" / name)
    assert _read(tmp_path / "torch" / name) == want
    groups = _df_column(tmp_path / "jax" / name, "GROUP_PATHS")
    kept = [sum(1 for c in g.split(",") if c != "0:0") for g in groups]
    assert len(kept) == 60 and sum(k > 41 for k in kept) > 50


def test_graph_wide_bubbles_byte_identical(tmp_path):
    """``graph`` with 90 haplotype paths on bubbles of 45-89 branches."""
    files = _wide_graph(str(tmp_path / "data"), 120, 45, seed=5)
    argv = ["graph", "-p", files["gfa"], "-d", files["gfa"], "-b",
            files["pheno"], "-T", "chi2", "-r", "ref", "-V", "0"]
    assert jax_cli.main(argv + ["-o", str(tmp_path / "jax")]) == 0
    assert torch_cli.main(argv + ["-o", str(tmp_path / "torch"),
                                  "--device", "cpu"]) == 0
    name = "binary_table_graph.tsv"
    want = _read(tmp_path / "jax" / name)
    assert _read(tmp_path / "torch" / name) == want
    assert want.count(b"\n") > 100
    groups = _df_column(tmp_path / "jax" / name, "GROUP_PATHS")
    assert sum(len(g.split(",")) > 41 for g in groups) > 60
