"""Parity of the port's last single-device ``vcf`` modes with the JAX
package: the dual run ``-b -q`` (one K1 pass for both tables), eQTL
``-e -G [-w]`` and the EMMAX mixed model ``-q -k --lmm``.

The same inputs, made from a seed with numpy (tests/fixtures.py and the
kinship written here), go through stoat_tpu (XLA on the CPU) and through
the port's plain PyTorch versions.  Tolerances: designs, flags and counts
exact; the eQTL pair statistics within 1e-12 relative of stoat_tpu's (one
algorithm; sums over the rows in another order); the mixed model's within
1e-9 (its rotation is a matrix product summed in another order, as the OLS
tests state); the REML null fit within 1e-12 (numpy in both packages).
Whole CLI runs write stoat_tpu's bytes, the permutation tables up to the
ties that tests/test_torch_permutation.py allows.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import reference_impl as R
from fixtures import make_fixture
from stoat_tpu import cli as jax_cli
from stoat_tpu.io.phenotype import (parse_binary_pheno, parse_covariates,
                                    parse_qtl_gene_file,
                                    parse_quantitative_pheno)
from stoat_tpu.io.snarl_file import parse_snarl_path
from stoat_tpu.io.vcf import VcfReader
from stoat_tpu.matrix import EdgeHaplotypeMatrix
from stoat_tpu.pipeline import quantitative as jq
from stoat_tpu.pipeline.runner import (iter_chromosome_matrices,
                                       run_vcf_analysis as j_run)
from stoat_tpu.stats import lmm as jlmm
from stoat_tpu.tables import pack_chromosome_chunks
from stoat_tpu.writer import format_p
from stoat_tpu_torch import cli as torch_cli
from stoat_tpu_torch.convert import (to_device_chunk, to_eqtl_expr,
                                     to_eqtl_pairs, to_lmm_inputs,
                                     to_quant_inputs)
from stoat_tpu_torch.pipeline import permutation as tperm
from stoat_tpu_torch.pipeline import quantitative as tq
from stoat_tpu_torch.pipeline import runner as torch_runner
from stoat_tpu_torch.stats import lmm as tlmm
from stoat_tpu_torch.stats.linreg import finish_linear_pvalues
from test_torch_permutation import _jax_matrices, _same_but_ties
from test_torch_quant import _membership_case

TH = (3, 5, 0.05)
CPU = torch.device("cpu")
COVAR = ("AGE", "SEX")
BT, QT = "binary_table_vcf.tsv", "quantitative_table_vcf.tsv"
ET, LT = "eqtl_table_vcf.tsv", "lmm_table_vcf.tsv"


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def random_kinship(n, rng, rank=None):
    """tests/test_lmm.py's kinship: a random Gram matrix scaled to a unit
    diagonal."""
    G = rng.normal(size=(n, rank or n))
    K = G @ G.T / (rank or n)
    d = np.sqrt(np.diag(K))
    return K / np.outer(d, d)


def write_kinship(path, samples, seed=5, rank=10):
    K = random_kinship(len(samples), np.random.default_rng(seed), rank)
    with open(path, "w") as f:
        f.write("id\t" + "\t".join(samples) + "\n")
        for i, s in enumerate(samples):
            f.write(s + "\t" + "\t".join(f"{v:.8f}" for v in K[i]) + "\n")
    return str(path)


def _vcf(paths, *extra):
    return ["vcf", "-s", paths["snarl"], "-v", paths["vcf"], *extra]


def _covar_args(paths):
    return ["-c", paths["covariate"], "-C", ",".join(COVAR)]


def _both(tmp_path, argv, tables, name=""):
    """Run ``argv`` through both CLIs; returns their output directories
    after checking that each of ``tables`` is byte-identical."""
    outs = {}
    for pkg, cli, extra in (("jax", jax_cli, []),
                            ("torch", torch_cli, ["--device", "cpu"])):
        out = str(tmp_path / f"{pkg}{name}")
        assert cli.main([*argv, "-o", out, *extra]) == 0
        outs[pkg] = out
    for table in tables:
        want = _read(os.path.join(outs["jax"], table))
        assert want.count(b"\n") > 5, table
        assert _read(os.path.join(outs["torch"], table)) == want, table
    return outs


def _packs(paths, n_samples):
    """The fixture's chunks (stoat_tpu's PackedChromosome; both packages
    pack alike) and its parsed inputs."""
    snarls_chr = parse_snarl_path(paths["snarl"])
    pheno, samples = parse_binary_pheno(paths["binary"],
                                        list(paths["samples"]))
    pheno_q = parse_quantitative_pheno(paths["quantitative"], samples)
    covar = parse_covariates(paths["covariate"], list(COVAR), samples)
    packs = []
    for chrom, matrix in iter_chromosome_matrices(paths["vcf"],
                                                  2 * n_samples, snarls_chr):
        packs += [(chrom, p) for p in pack_chromosome_chunks(
            snarls_chr[chrom], matrix, 8192)]
    return packs, pheno, pheno_q, covar, samples


# ---------------------------------------------------------------- design

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("C", [0, 2])
def test_all_rows_design_matches_jax(seed, C):
    """design_from_membership_plain(all_rows=True) equals stoat_tpu's
    _design_from_membership(..., all_rows=True): every row keeps its
    intercept and covariates, the variant columns are 0 where the sample
    has no call, and the flags are those of the OLS design."""
    membership, sidx = _membership_case(seed)
    N = membership.shape[1] // 2
    covar = np.random.default_rng(seed + 20).standard_normal((N, C))
    want = jq._design_from_membership(
        jnp.asarray(membership), jnp.asarray(sidx), jnp.asarray(covar),
        *map(jnp.float64, TH), with_covar=C > 0, all_rows=True)
    got = tq.design_from_membership_plain(
        torch.from_numpy(membership), torch.from_numpy(sidx),
        torch.from_numpy(covar), *TH, all_rows=True)
    for key in tq.DESIGN_KEYS:
        np.testing.assert_array_equal(
            got[key].numpy(), np.asarray(want[key]).astype(
                got[key].numpy().dtype), key)
    ols = tq.design_from_membership_plain(
        torch.from_numpy(membership), torch.from_numpy(sidx),
        torch.from_numpy(covar), *TH)
    unused = ~got["used"].numpy()
    assert unused.any()
    X = got["X"].numpy()
    assert (X[..., 0] == 1.0).all()
    for key in ("used", "ncols", "filtered", "degenerate", "allele_paths"):
        assert torch.equal(got[key], ols[key])
    np.testing.assert_array_equal(X[~unused], ols["X"].numpy()[~unused])


# ---------------------------------------------------------------- dual

@pytest.mark.parametrize("covar", [False, True], ids=["bq", "bqc"])
@pytest.mark.parametrize("seed,n_samples,n_chroms", [(0, 40, 1),
                                                     (1, 120, 2)])
def test_dual_cli_byte_identical(tmp_path, covar, seed, n_samples,
                                 n_chroms):
    """``vcf -b B -q Q [-c -C]`` writes stoat_tpu's two tables, and the
    same bytes as the port's separate ``-b`` and ``-q`` runs."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=n_samples,
                         n_snarls=40, seed=seed, n_chroms=n_chroms)
    c = _covar_args(paths) if covar else []
    outs = _both(tmp_path, _vcf(paths, "-b", paths["binary"], "-q",
                                paths["quantitative"], *c), (BT, QT))
    for flag, pheno, table in (("-b", "binary", BT),
                               ("-q", "quantitative", QT)):
        solo = str(tmp_path / f"solo{flag}")
        assert torch_cli.main(_vcf(paths, flag, paths[pheno], *c, "-o", solo,
                                   "--device", "cpu")) == 0
        assert filecmp.cmp(os.path.join(solo, table),
                           os.path.join(outs["torch"], table), shallow=False)


def test_dual_phenotype_single_pass(tmp_path, monkeypatch):
    """tests/test_end_to_end.py:247 on the port: -b and -q in one run
    write the bytes of two separate runs, and every chunk runs K1 once
    (perm_membership), whose words both the binary count-table-Fisher
    call (binary_stats_from_words) and the design read."""
    paths = make_fixture(str(tmp_path), n_samples=30, n_snarls=40, seed=11,
                         n_chroms=2)
    calls = {"k1": [], "counts": [], "design": []}
    real = (tperm.perm_membership, tq.binary_stats_from_words,
            tq.quant_design)

    def k1(*a):
        calls["k1"].append(real[0](*a))
        return calls["k1"][-1]

    def counts(words, *a):
        calls["counts"].append(words)
        return real[1](words, *a)

    def design(chunk, *a, **k):
        calls["design"].append(chunk.words)
        return real[2](chunk, *a, **k)
    monkeypatch.setattr(tperm, "perm_membership", k1)
    monkeypatch.setattr(tq, "binary_stats_from_words", counts)
    monkeypatch.setattr(tq, "quant_design", design)
    for name, extra in (("dual", ["-b", paths["binary"], "-q",
                                  paths["quantitative"]]),
                        ("bin", ["-b", paths["binary"]]),
                        ("quant", ["-q", paths["quantitative"]])):
        assert torch_cli.main(_vcf(paths, *extra, "-o",
                                   str(tmp_path / f"out_{name}"),
                                   "--device", "cpu")) == 0
        if name == "dual":
            mems = [m for m, _g in calls["k1"]]
            assert len(mems) == 2                      # one per chunk
            assert all(a is m and b is m for a, b, m in
                       zip(calls["counts"], calls["design"], mems))
    assert filecmp.cmp(tmp_path / "out_dual" / BT, tmp_path / "out_bin" / BT,
                       shallow=False)
    assert filecmp.cmp(tmp_path / "out_dual" / QT,
                       tmp_path / "out_quant" / QT, shallow=False)


def test_dual_fused_with_covariates_matches_separate(tmp_path):
    """tests/test_end_to_end.py:367 on the port: the library call of a
    binary run with covariates and a quantitative secondary puts the
    covariates in the quantitative design; both tables equal the separate
    runs and stoat_tpu's single-device run."""
    paths = make_fixture(str(tmp_path), n_samples=30, n_snarls=40, seed=23,
                         n_chroms=1)
    snarls_chr = parse_snarl_path(paths["snarl"])
    pheno, samples = parse_binary_pheno(paths["binary"],
                                        list(paths["samples"]))
    pheno_q = parse_quantitative_pheno(paths["quantitative"], samples)
    covar = np.random.default_rng(2).standard_normal((len(samples), 2))
    tsv = {k: str(tmp_path / f"{k}.tsv")
           for k in ("b1", "q1", "b2", "q2", "jb", "jq")}
    torch_runner.run_vcf_analysis(
        paths["vcf"], snarls_chr, tsv["b1"], pheno, CPU, covariate=covar,
        sample_names=samples,
        secondary={"mode": "quantitative", "output_tsv": tsv["q1"],
                   "quantitative_phenotype": pheno_q})
    torch_runner.run_vcf_analysis(paths["vcf"], snarls_chr, tsv["b2"], pheno,
                                  CPU, sample_names=samples)
    torch_runner.run_vcf_analysis(paths["vcf"], snarls_chr, tsv["q2"],
                                  pheno_q, CPU, mode="quantitative",
                                  covariate=covar, sample_names=samples)
    j_run(paths["vcf"], snarls_chr, tsv["jb"], "binary",
          binary_phenotype=pheno, covariate=covar, sample_names=samples,
          use_mesh=False,
          secondary={"mode": "quantitative", "output_tsv": tsv["jq"],
                     "quantitative_phenotype": pheno_q})
    for a, b in (("b1", "b2"), ("q1", "q2"), ("b1", "jb"), ("q1", "jq")):
        assert filecmp.cmp(tsv[a], tsv[b], shallow=False), (a, b)


def test_secondary_dict_validation(tmp_path):
    """tests/test_end_to_end.py:343 on the port: a malformed secondary dict
    fails fast with a clear message, and an eQTL primary takes none."""
    paths = make_fixture(str(tmp_path), n_samples=10, n_snarls=4, seed=3)
    snarls_chr = parse_snarl_path(paths["snarl"])
    pheno = np.zeros(10, bool)
    for bad, match in (
            ({"mode": "quantitative"}, "output_tsv"),
            ({"mode": "nope", "output_tsv": "x"}, "not one of"),
            ({"mode": "quantitative", "output_tsv": "x"},
             "quantitative_phenotype"),
            ({"mode": "lmm", "output_tsv": "x"}, "lmm_ctx")):
        with pytest.raises(ValueError, match=match):
            torch_runner.run_vcf_analysis(
                paths["vcf"], snarls_chr, str(tmp_path / "o.tsv"), pheno,
                CPU, secondary=bad)
    with pytest.raises(ValueError, match="eQTL"):
        torch_runner.run_vcf_analysis(
            paths["vcf"], snarls_chr, str(tmp_path / "o.tsv"), {}, CPU,
            mode="eqtl", secondary={"mode": "binary", "output_tsv": "x",
                                    "binary_phenotype": pheno})
    assert not (tmp_path / "o.tsv").exists()


@pytest.mark.parametrize("covar", [False, True], ids=["bq", "bqc"])
def test_dual_resume_after_interrupt(tmp_path, monkeypatch, covar):
    """A dual run cut after its first chromosome leaves that chromosome in
    both progress sidecars; --resume skips it and ends with stoat_tpu's
    bytes in both tables."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=40, n_snarls=36,
                         seed=2, n_chroms=3)
    c = _covar_args(paths) if covar else []
    argv = _vcf(paths, "-b", paths["binary"], "-q", paths["quantitative"],
                *c)
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli.main([*argv, "-o", jax_out]) == 0
    real = torch_runner._dispatch_chromosome
    seen = []

    def crash_after_first(outf, output_tsv, chrom, *a, **k):
        seen.append(chrom)
        if len(seen) == 2:
            raise RuntimeError("simulated crash")
        return real(outf, output_tsv, chrom, *a, **k)
    monkeypatch.setattr(torch_runner, "_dispatch_chromosome",
                        crash_after_first)
    with pytest.raises(RuntimeError, match="simulated crash"):
        torch_cli.main([*argv, "-o", out, "--device", "cpu"])
    for table in (BT, QT):
        assert list(torch_runner._read_progress(
            os.path.join(out, table))) == seen[:1]
    seen.clear()

    def spy(outf, output_tsv, chrom, *a, **k):
        seen.append(chrom)
        return real(outf, output_tsv, chrom, *a, **k)
    monkeypatch.setattr(torch_runner, "_dispatch_chromosome", spy)
    assert torch_cli.main([*argv, "-o", out, "--device", "cpu",
                           "--resume"]) == 0
    assert seen == ["ref1", "ref2"]
    for table in (BT, QT):
        assert _read(os.path.join(out, table)) == \
            _read(os.path.join(jax_out, table))


def test_dual_resume_reruns_a_chromosome_one_sidecar_lacks(tmp_path,
                                                           monkeypatch):
    """A crash between the two checkpoints of a chromosome (the secondary
    sidecar has it, the primary not) reruns that chromosome in both
    tables."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=40, n_snarls=36,
                         seed=4, n_chroms=3)
    argv = _vcf(paths, "-b", paths["binary"], "-q", paths["quantitative"],
                "-o", str(tmp_path / "out"), "--device", "cpu")
    assert torch_cli.main(argv) == 0
    want = {t: _read(str(tmp_path / "out" / t)) for t in (BT, QT)}
    progress = str(tmp_path / "out" / BT) + ".progress"
    with open(progress) as fh:
        lines = fh.readlines()
    with open(progress, "w") as fh:
        fh.writelines(lines[:-1])               # ref2 only in the secondary
    real = torch_runner._dispatch_chromosome
    seen = []

    def spy(outf, output_tsv, chrom, *a, **k):
        seen.append(chrom)
        return real(outf, output_tsv, chrom, *a, **k)
    monkeypatch.setattr(torch_runner, "_dispatch_chromosome", spy)
    assert torch_cli.main([*argv, "--resume"]) == 0
    assert seen == ["ref2"]
    assert {t: _read(str(tmp_path / "out" / t)) for t in (BT, QT)} == want


def test_dual_permutations_match_jax(tmp_path):
    """``vcf -b B -q Q --permutations 30``: both main tables byte for
    byte, both permutation tables as tests/test_torch_permutation.py's
    _same_but_ties states."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=40, n_snarls=30,
                         seed=13, n_chroms=2)
    outs = _both(tmp_path, _vcf(paths, "-b", paths["binary"], "-q",
                                paths["quantitative"], "--permutations",
                                "30", "--perm-seed", "5"), (BT, QT))
    snarls_chr = parse_snarl_path(paths["snarl"])
    pheno, samples = parse_binary_pheno(paths["binary"],
                                        list(paths["samples"]))
    pheno_q = parse_quantitative_pheno(paths["quantitative"], samples)
    for kind, table, ph in (("binary", "binary_permutation_vcf.tsv", pheno),
                            ("quantitative",
                             "quantitative_permutation_vcf.tsv", pheno_q)):
        a = os.path.join(outs["jax"], table)
        b = os.path.join(outs["torch"], table)
        if not filecmp.cmp(a, b, shallow=False):
            _same_but_ties(a, b, _jax_matrices(kind, paths, snarls_chr, ph,
                                               None, 30, 5), 30)


# ---------------------------------------------------------------- eQTL

@pytest.mark.parametrize("window", ["1000000", "300"])
@pytest.mark.parametrize("covar", [False, True])
def test_eqtl_cli_byte_identical(tmp_path, covar, window):
    """``vcf -e E -G G [-c -C] -w W`` on two chromosomes writes
    stoat_tpu's eQTL table byte for byte."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=60, n_snarls=40,
                         seed=7, n_chroms=2)
    c = _covar_args(paths) if covar else []
    _both(tmp_path, _vcf(paths, "-e", paths["qtl"], "-G",
                         paths["gene_position"], "-w", window, *c), (ET,))


def test_eqtl_pairs_match_the_reference(tmp_path):
    """The per-pair check of tests/test_end_to_end.py:201 on the port's
    output: every (snarl, gene) pair in the window has its row, with
    P and BETA as reference_impl's OLS formats them."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=40, n_snarls=12,
                         seed=7)
    out = str(tmp_path / "out")
    assert torch_cli.main(_vcf(paths, "-e", paths["qtl"], "-G",
                               paths["gene_position"], "-o", out,
                               "--device", "cpu")) == 0
    with open(os.path.join(out, ET)) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = {}
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            rows[(cols[3], cols[5])] = cols
    assert header[5] == "GENE"
    snarls = parse_snarl_path(paths["snarl"])["ref"]
    reader = VcfReader(paths["vcf"])
    (_chrom, records), = list(reader.chromosome_chunks())
    edge_matrix = EdgeHaplotypeMatrix(2 * len(paths["samples"]))
    for rec in records:
        edge_matrix.add_record(rec)
    M = edge_matrix.shrink()
    genes = parse_qtl_gene_file(paths["qtl"], paths["gene_position"],
                                list(paths["samples"]))["ref"]
    checked = 0
    for snarl in snarls:
        df, used_idx, _ap = R.quantitative_table(snarl, edge_matrix, M,
                                                 len(paths["samples"]))
        if R.filtration_quantitative(df, *TH):
            continue
        df2 = R.combine_identical_columns(df)[:, :-1]
        if df2.shape[1] == 0:
            continue
        lo = snarl.start_pos - 1000000 if snarl.start_pos > 1000000 else 0
        hi = snarl.end_pos + 1000000
        for g in genes:
            if g.end_pos < lo or g.start_pos > hi:
                continue
            p, b, _s, _r2 = R.ols_reference(df2, g.sample_expression[used_idx],
                                            None)
            row = rows[(snarl.snarl_id_str, g.gene_name)]
            assert row[6] == format_p(p), (snarl.snarl_id_str, g.gene_name)
            assert row[8] == format_p(b)
            checked += 1
    assert checked > 0


def _eqtl_case(seed):
    """Designs with the covariates from a membership built to hit every
    rule of the design (merges, degenerate and rank-deficient snarls;
    tests/test_torch_quant.py), in both packages, and (snarl, gene) pairs
    of every unfiltered or degenerate snarl with most of five genes, one of
    constant expression (tss = 0)."""
    membership, sidx = _membership_case(seed, N=40, S=30)
    rng = np.random.default_rng(seed + 3)
    covar = rng.standard_normal((40, 2))
    design = jq._design_from_membership(
        jnp.asarray(membership), jnp.asarray(sidx), jnp.asarray(covar),
        *map(jnp.float64, (2, 2, 0.0)), with_covar=True, all_rows=False)
    tdesign = tq.design_from_membership_plain(
        torch.from_numpy(membership), torch.from_numpy(sidx),
        torch.from_numpy(covar), 2, 2, 0.0)
    expr = rng.standard_normal((5, 40)) + 1.0
    expr[4] = 2.5
    keep = ~np.asarray(design["filtered"]) | np.asarray(design["degenerate"])
    pair_snarl, pair_gene = [], []
    for s in np.flatnonzero(keep).tolist():
        for g in range(5):
            if (s + g) % 3:
                pair_snarl.append(s)
                pair_gene.append(g)
    return design, tdesign, expr, pair_snarl, pair_gene


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eqtl_regress_pairs_plain_matches_jax(seed):
    """eqtl_regress_pairs' plain version (the pairs as CSR, the [G, N]
    expression) against stoat_tpu's eqtl_regress_pairs (X[pair_snarl]
    gathered) at 1e-12, with pairs of degenerate snarls (NA) and of a gene
    of constant expression (r2 not finite in both)."""
    design, tdesign, expr, pair_snarl, pair_gene = _eqtl_case(seed)
    want = jq.eqtl_regress_pairs(design, np.array(pair_snarl),
                                 expr[pair_gene])
    got = tq.eqtl_regress_pairs(
        tdesign, *to_eqtl_pairs(pair_snarl, pair_gene,
                                int(tdesign["X"].shape[0]), CPU),
        torch.from_numpy(expr))
    assert np.asarray(design["degenerate"])[pair_snarl].any()
    ps = np.array(pair_snarl)
    const = np.array(pair_gene) == 4
    # designs with no more used rows than columns fit exactly: their rss,
    # and so se and p, are rounding noise in both packages
    exact = (tdesign["used"].sum(dim=1).numpy()[ps]
             <= tdesign["ncols"].numpy()[ps])
    assert exact.any() and (~exact & ~const).sum() > 20
    for key in ("p", "beta", "se", "r2"):
        g, w = got[key], np.asarray(want[key])
        assert g.shape == (len(pair_snarl),)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        ok = np.isfinite(w) & ~const
        if key in ("p", "se"):
            ok &= ~exact
        np.testing.assert_allclose(g[ok], w[ok], rtol=1e-12, atol=0)
    assert not np.isfinite(got["r2"][const]).any()
    assert not np.isfinite(np.asarray(want["r2"])[const]).any()


def test_eqtl_ols_plain_blocks_and_empty_pairs(monkeypatch):
    """The plain version's blocks of pairs give the statistics of one
    block, and a chunk with no pair gives empty results."""
    _d, d, expr, pair_snarl, pair_gene = _eqtl_case(0)
    S = int(d["X"].shape[0])
    args = (d["X"], d["used"], d["ncols"],
            *to_eqtl_pairs(pair_snarl, pair_gene, S, CPU),
            torch.from_numpy(expr))
    whole = tq.eqtl_ols_stats(*args)
    monkeypatch.setattr(tq, "_PLAIN_BLOCK", 7 * 40 * d["X"].shape[2])
    blocks = tq.eqtl_ols_stats(*args)
    for a, b in zip(whole, blocks):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    none = tq.eqtl_ols_stats(d["X"], d["used"], d["ncols"],
                             *to_eqtl_pairs([], [], S, CPU),
                             torch.from_numpy(expr))
    assert all(t.shape == (0,) for t in none)


# ---------------------------------------------------------------- LMM

@pytest.mark.parametrize("case", ["plain", "covariates", "collinear"])
def test_fit_null_reml_matches_jax(case):
    """The port's numpy REML equals stoat_tpu's: delta, sigma_g2, loglik
    within 1e-12 relative (loglik is NaN in both with collinear
    covariates), rot and y_rot bit for bit."""
    rng = np.random.default_rng(1)
    n = 120
    K = random_kinship(n, rng, rank=30)
    L = np.linalg.cholesky(K + 1e-9 * np.eye(n))
    y = 2.0 + L @ rng.normal(size=n) + rng.normal(size=n)
    covar = {"plain": None,
             "covariates": rng.standard_normal((n, 2)),
             "collinear": np.ones((n, 2))}[case]
    got = tlmm.fit_null_reml(y, K, covar)
    want = jlmm.fit_null_reml(y, K, covar)
    for key in ("delta", "sigma_g2", "sigma_e2", "loglik"):
        assert getattr(got, key) == pytest.approx(getattr(want, key),
                                                  rel=1e-12, nan_ok=True), key
    np.testing.assert_array_equal(got.rot, want.rot)
    np.testing.assert_array_equal(got.y_rot, want.y_rot)
    assert np.isfinite(got.delta) and got.heritability == want.heritability


def test_null_fit_survives_collinear_covariates():
    """tests/test_lmm.py:247 on the port."""
    rng = np.random.default_rng(0)
    n = 30
    A = rng.standard_normal((n, 3))
    K = A @ A.T / 3 + np.eye(n)
    ctx = tlmm.fit_null_reml(rng.standard_normal(n), K, np.ones((n, 2)))
    assert np.isfinite(ctx.delta)


def test_batched_gls_matches_dense():
    """tests/test_lmm.py:87 on the port: the rotated OLS of
    lmm_regression_batch equals a dense GLS per design."""
    rng = np.random.default_rng(2)
    n, n_snarls, p = 40, 7, 3
    K = random_kinship(n, rng)
    y = rng.normal(size=n)
    ctx = tlmm.fit_null_reml(y, K)
    Si = np.linalg.inv(K + ctx.delta * np.eye(n))
    X = np.zeros((n_snarls, n, p + 1))
    ncols = np.full(n_snarls, p, np.int32)
    for s in range(n_snarls):
        X[s, :, 0] = 1.0
        X[s, :, 1:p] = rng.integers(0, 3, size=(n, p - 1))
    rot, y_rot, _c = to_lmm_inputs(ctx, None, n, CPU)
    t1, df, bj, sej, _r2 = tlmm.lmm_regression_batch(
        torch.from_numpy(X), rot, y_rot, torch.from_numpy(ncols))
    pj = finish_linear_pvalues(t1, df)
    assert (pj >= 0).all() and (pj <= 1).all()
    for s in range(n_snarls):
        Xs = X[s, :, :p]
        XtSiX = Xs.T @ Si @ Xs
        beta = np.linalg.solve(XtSiX, Xs.T @ Si @ y)
        r = y - Xs @ beta
        sigma2 = (r @ Si @ r) / (n - p + 1)
        se_1 = np.sqrt(np.linalg.inv(XtSiX)[1, 1] * sigma2)
        assert float(bj[s]) == pytest.approx(beta[1], rel=1e-8)
        assert float(sej[s]) == pytest.approx(se_1, rel=1e-8)


def test_lmm_rotate_matches_einsum():
    """The one-GEMM rotation equals stoat_tpu's einsum "mn,snp->smp"."""
    rng = np.random.default_rng(4)
    rot = rng.standard_normal((30, 30))
    X = rng.standard_normal((6, 30, 4))
    got = tlmm.lmm_rotate(torch.from_numpy(rot), torch.from_numpy(X))
    assert got.is_contiguous() and got.shape == (6, 30, 4)
    np.testing.assert_allclose(got.numpy(), np.einsum("mn,snp->smp", rot, X),
                               rtol=1e-12, atol=1e-13)


def test_identity_kinship_matches_ols_on_full_snarls(tmp_path):
    """tests/test_lmm.py:193 on the port: with K = I the mixed model gives
    the OLS pipeline's p and beta on every unfiltered snarl that all
    samples carry."""
    paths = make_fixture(str(tmp_path), n_samples=40, n_snarls=30, seed=11)
    packs, _b, pheno_q, _c, _s = _packs(paths, 40)
    (_chrom, packed), = packs
    ctx = tlmm.fit_null_reml(pheno_q, np.eye(40))
    lmm = tq.lmm_analyze_chromosome(packed, *to_lmm_inputs(ctx, None, 40,
                                                           CPU), *TH, CPU)
    qp, qc = to_quant_inputs(pheno_q, None, 40, CPU)
    ols = tq.quantitative_analyze_chromosome(packed, qp, qc, *TH, CPU)
    d = tq.quant_design(to_device_chunk(packed, None, CPU), qc, *TH,
                        packed.n_haplotypes)
    full = d["used"].numpy().all(axis=1) & ~ols["filtered"]
    assert full.sum() >= 3, "fixture should have fully-covered snarls"
    np.testing.assert_allclose(lmm["p"][full], ols["p"][full], rtol=1e-6)
    np.testing.assert_allclose(lmm["beta"][full], ols["beta"][full],
                               rtol=1e-6)


@pytest.mark.parametrize("with_covar", [False, True])
def test_lmm_chunks_match_jax(tmp_path, with_covar):
    """lmm_analyze_chromosome of the port (all-rows Q1, the rotation, Q2,
    Q3) against stoat_tpu's on the same chunks and null model: flags and
    counts exact, statistics within 1e-9 relative, equal strings."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=50, n_snarls=40,
                         seed=5, n_chroms=2)
    packs, _b, pheno_q, covar, samples = _packs(paths, 50)
    covar = covar if with_covar else None
    K = random_kinship(50, np.random.default_rng(8), rank=12)
    ctx = jlmm.fit_null_reml(pheno_q, K, covar)
    inputs = to_lmm_inputs(ctx, covar, 50, CPU)
    for _chrom, packed in packs:
        want = jq.lmm_analyze_chromosome(packed, ctx, covar, *TH)
        got = tq.lmm_analyze_chromosome(packed, *inputs, *TH, CPU)
        for key in ("filtered", "allele_paths"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
        for key in ("p", "beta", "se", "r2"):
            g, w = got[key], np.asarray(want[key])
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            ok = ~np.isnan(w)
            np.testing.assert_allclose(g[ok], w[ok], rtol=1e-9, atol=0)
            flips = [(a, b) for a, b in zip(map(format_p, g),
                                            map(format_p, w)) if a != b]
            if flips:
                print(f"{key}: strings at a rounding boundary {flips}")
            assert len(flips) <= 1, flips


@pytest.mark.parametrize("with_covar", [False, True])
def test_lmm_cli_byte_identical(tmp_path, with_covar):
    """``vcf -q Q -k K --lmm [-c -C]`` writes stoat_tpu's
    lmm_table_vcf.tsv; ``-k`` without ``--lmm`` parses the matrix and runs
    plain OLS (tests/test_lmm.py:213)."""
    paths = make_fixture(str(tmp_path / "data"), n_samples=60, n_snarls=40,
                         seed=3, n_chroms=2)
    kin = write_kinship(tmp_path / "kinship.tsv", paths["samples"])
    c = _covar_args(paths) if with_covar else []
    outs = _both(tmp_path, _vcf(paths, "-q", paths["quantitative"], "-k",
                                kin, "--lmm", *c), (LT,))
    assert not os.path.exists(os.path.join(outs["torch"], QT))
    ols = _both(tmp_path, _vcf(paths, "-q", paths["quantitative"], "-k",
                               kin, *c), (QT,), name="_ols")
    assert not os.path.exists(os.path.join(ols["torch"], LT))
    plain = str(tmp_path / "plain")
    assert torch_cli.main(_vcf(paths, "-q", paths["quantitative"], *c, "-o",
                               plain, "--device", "cpu")) == 0
    assert filecmp.cmp(os.path.join(plain, QT),
                       os.path.join(ols["torch"], QT), shallow=False)
