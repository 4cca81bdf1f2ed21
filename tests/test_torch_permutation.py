"""Parity of the port's permutation test (``vcf --permutations``) with the
JAX package.

The same numpy inputs, made from a seed, go through stoat_tpu's
permutation programs (XLA on the CPU) and the port's plain PyTorch
versions; the phenotype side reaches the port through
``convert.to_perm_inputs``.  Tolerances: the host copies exact; K15's
statistic bitwise with K3's plain version and its p within 1e-14
relative of JAX (the chi-squared tails are torch's and XLA's); the OLS t
and score-test p-values and V^-1 within 1e-9 (sums over the rows in
another order); D, the +inf sets and the flags exact.  Whole runs and the
CLI write stoat_tpu's bytes; the one exception allowed is a P_EMP or
P_FWER count at a tie that JAX's own p-values resolve within 1e-9
relative (p_k and p_obs that are equal in one package and an ulp apart in
the other), and each such tie is printed.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import make_fixture
from stoat_tpu import cli as jax_cli
from stoat_tpu.io.phenotype import (parse_binary_pheno, parse_covariates,
                                    parse_quantitative_pheno)
from stoat_tpu.io.snarl_file import parse_snarl_path
from stoat_tpu.pipeline import permutation as jperm
from stoat_tpu.pipeline.quantitative import _design_from_membership
from stoat_tpu.pipeline.runner import iter_chromosome_matrices
from stoat_tpu.tables import pack_chromosome_chunks
from stoat_tpu_torch import cli as torch_cli
from stoat_tpu_torch.convert import to_device_chunk, to_perm_inputs, upload
from stoat_tpu_torch.pipeline import permutation as tperm
from stoat_tpu_torch.pipeline import runner as torch_runner
from stoat_tpu_torch.pipeline.binary import binary_tables_plain
from stoat_tpu_torch.pipeline.packed import (membership_counts_plain,
                                             tail_mask_words)
from stoat_tpu_torch.stats.linreg import linear_regression_stats_plain

TH = (3, 5, 0.05)
CPU = torch.device("cpu")
K = 16
TIE_REL = 1e-9


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("perm")
    paths = make_fixture(str(tmp), n_samples=40, n_snarls=30, seed=13,
                         n_chroms=2)
    snarls_chr = parse_snarl_path(paths["snarl"])
    pheno, samples = parse_binary_pheno(paths["binary"],
                                        list(paths["samples"]))
    pheno_q = parse_quantitative_pheno(paths["quantitative"], samples)
    covar = parse_covariates(paths["covariate"], ["AGE", "SEX"], samples)
    return paths, snarls_chr, pheno, pheno_q, covar, tmp


def _chunks(paths, snarls_chr, n_hap):
    """The fixture's chunks as stoat_tpu packs them."""
    for chrom, matrix in iter_chromosome_matrices(paths["vcf"], n_hap,
                                                  snarls_chr):
        for packed in pack_chromosome_chunks(snarls_chr[chrom], matrix,
                                             8192):
            yield chrom, packed


def _port_chunk(packed):
    chunk = to_device_chunk(packed, None, CPU)
    chunk.tail = upload(tail_mask_words(
        packed.n_haplotypes, int(chunk.words.shape[1])).view(np.int32), CPU)
    return chunk


def _same_inf_and_close(got, want, rel):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    assert ok.any()
    np.testing.assert_allclose(got[ok], want[ok], rtol=rel, atol=0)


# ---------------------------------------------------------------- host

@pytest.mark.parametrize("seed", [0, 3])
def test_permutation_indices_and_masks_match_jax(data, seed):
    _p, _s, pheno, _q, _c, _t = data
    W = (2 * len(pheno) + 31) // 32
    idx = tperm.permutation_indices(len(pheno), K, seed)
    np.testing.assert_array_equal(
        idx, jperm.permutation_indices(len(pheno), K, seed))
    np.testing.assert_array_equal(
        tperm.permutation_masks(pheno, K, seed, W),
        jperm.permutation_masks(pheno, K, seed, W))
    np.testing.assert_array_equal(
        tperm.permutation_masks(pheno, K, seed, W, perm_idx=idx),
        jperm.permutation_masks(pheno, K, seed, W))


@pytest.mark.parametrize("with_covar", [False, True])
def test_freedman_lane_and_null_context_match_jax(data, with_covar):
    _p, _s, pheno, pheno_q, covar, _t = data
    cov = covar if with_covar else None
    idx = jperm.permutation_indices(len(pheno), K, 5)
    np.testing.assert_array_equal(
        tperm.freedman_lane_phenos(pheno_q, cov, idx),
        jperm.freedman_lane_phenos(pheno_q, cov, idx))
    for got, want in zip(tperm.logistic_null_context(pheno, cov),
                         jperm.logistic_null_context(pheno, cov)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- K15

def test_perm_binary_matches_jax(data):
    """K1 once per chunk, then K15: the [K, S] p-values against JAX's
    _perm_binary_pvalues (same +inf set, 1e-14), and each row's statistic
    bitwise equal to K3's plain version on that mask's counts."""
    paths, snarls_chr, pheno, _q, _c, _t = data
    n_filtered = 0
    for _chrom, packed in _chunks(paths, snarls_chr, 2 * len(pheno)):
        dev = jperm._ChunkDevice(packed, None)
        masks = jperm.permutation_masks(pheno, K, 2, dev.W)
        want = np.asarray(jperm._perm_binary_pvalues(
            dev.mem, dev.valid, dev.tail, jnp.asarray(masks), dev.sidx,
            *map(jnp.float64, TH)))
        chunk = _port_chunk(packed)
        inputs = to_perm_inputs(CPU, masks=masks)
        mem, g_all = tperm.perm_membership(chunk.words, chunk.path_idx,
                                           chunk.path_valid, chunk.tail)
        want_mem = np.where(np.asarray(packed.path_valid)[:, None],
                            np.asarray(dev.mem) & np.asarray(dev.tail), 0)
        np.testing.assert_array_equal(mem.numpy().view(np.uint32),
                                      want_mem)
        stat, df, bad = tperm.perm_binary_stats(mem, g_all, inputs.masks,
                                                chunk.snarl_path_idx, *TH)
        got = tperm.binary_perm_pvalues(stat, df, bad)
        _same_inf_and_close(got.numpy(), want, 1e-14)
        for k in (0, K - 1):
            g0, g1 = membership_counts_plain(
                chunk.words, chunk.path_idx, chunk.path_valid, chunk.tail,
                inputs.masks[k])
            t = binary_tables_plain(g0, g1, chunk.snarl_path_idx, *TH)
            np.testing.assert_array_equal(stat[k].numpy(),
                                          t["chi2_stat"].numpy())
            np.testing.assert_array_equal(df[k].numpy(), t["chi2_df"].numpy())
        n_filtered += int(np.isinf(want[0]).sum())
    assert n_filtered > 0                 # a filtered snarl is in the mix


# ---------------------------------------------------------------- K16a

def _designs(paths, snarls_chr, n_hap, covar, with_covar):
    """(X, used, ncols, bad) of every chunk as JAX builds them, plus two
    made snarls: a rank-deficient design (two equal variant columns: the
    pseudo-inverse) and a filtered one."""
    from stoat_tpu.pipeline import packed as jpk
    Xs, used, ncols, bad = [], [], [], []
    for _chrom, packed in _chunks(paths, snarls_chr, n_hap):
        dev = jperm._ChunkDevice(packed, None)
        membership = jpk.unpack_membership(dev.mem, dev.valid, n_hap)
        d = _design_from_membership(
            membership, dev.sidx, jnp.asarray(covar), *map(jnp.float64, TH),
            with_covar=with_covar, all_rows=False)
        Xs.append(np.asarray(d["X"]))
        used.append(np.asarray(d["used"]))
        ncols.append(np.asarray(d["ncols"]))
        bad.append(np.asarray(d["filtered"] | d["degenerate"]))
    width = max(x.shape[2] for x in Xs)
    X = np.concatenate([np.pad(x, ((0, 0), (0, 0), (0, width - x.shape[2])))
                        for x in Xs])
    used, ncols, bad = map(np.concatenate, (used, ncols, bad))
    rng = np.random.default_rng(4)
    N = X.shape[1]
    extra = np.zeros((2, N, width))
    extra[:, :, 0] = 1.0
    col = (rng.random(N) < 0.4).astype(np.float64)
    extra[0, :, 1] = col
    extra[0, :, 2] = col                 # X^T X singular
    extra[1, :, 1] = rng.random(N) < 0.5
    X = np.concatenate([X, extra])
    used = np.concatenate([used, np.ones((2, N), bool)])
    ncols = np.concatenate([ncols, np.array([3, 2], ncols.dtype)])
    bad = np.concatenate([bad, np.array([False, True])])
    return X, used, ncols.astype(np.int32), bad


@pytest.mark.parametrize("with_covar", [False, True])
def test_perm_quant_matches_jax(data, with_covar):
    """K16a: the [K, S] OLS-t p-values against JAX's _perm_quant_pvalues
    on the same designs and Freedman–Lane rows (same +inf set, 1e-9),
    a rank-deficient and a filtered snarl among them; with K = 1 the t
    statistic is the plain OLS's bit for bit."""
    paths, snarls_chr, pheno, pheno_q, covar, _t = data
    cov = covar if with_covar else np.zeros((len(pheno), 0))
    X, used, ncols, bad = _designs(paths, snarls_chr, 2 * len(pheno), cov,
                                   with_covar)
    idx = jperm.permutation_indices(len(pheno), K, 9)
    phenos = np.concatenate([pheno_q[None, :], jperm.freedman_lane_phenos(
        pheno_q, covar if with_covar else None, idx)])
    want = np.asarray(jperm._perm_quant_pvalues(
        jnp.asarray(X), jnp.asarray(used), jnp.asarray(ncols),
        jnp.asarray(bad), jnp.asarray(phenos)))
    inputs = to_perm_inputs(CPU, phenos=phenos)
    Xt, ut, nt = (torch.from_numpy(a) for a in (X, used, ncols))
    t1, df = tperm.perm_ols_stats(Xt, ut, nt, inputs.phenos)
    got = tperm.quant_perm_pvalues(t1, df, torch.from_numpy(bad))
    _same_inf_and_close(got.numpy(), want, 1e-9)
    assert np.isinf(want[:, -1]).all() and np.isfinite(want[:, -2]).all()
    one, df1, *_ = linear_regression_stats_plain(
        Xt, inputs.phenos[0][None, :] * ut, ut, nt)
    np.testing.assert_array_equal(t1[0].numpy(), one.numpy())
    np.testing.assert_array_equal(df[0].numpy(), df1.numpy())


# ---------------------------------------------------------------- K16b/c

@pytest.mark.parametrize("case", ["covariates", "collinear"])
def test_score_test_matches_jax(data, case):
    """K16b: D exact, allbad equal, V^-1 within 1e-9 of its largest entry
    per snarl; K16c: the [K, S] p-values within 1e-9 (same +inf set).
    "collinear" repeats a covariate, so Z^T W Z is ill-conditioned for
    every snarl."""
    paths, snarls_chr, pheno, _q, covar, _t = data
    n = len(pheno)
    X, used, ncols, bad = _designs(paths, snarls_chr, 2 * n,
                                   np.zeros((n, 0)), False)
    cov = covar if case == "covariates" else np.concatenate(
        [covar[:, :1], covar[:, :1]], axis=1)
    Z, w, e = jperm.logistic_null_context(pheno, cov)
    idx = jperm.permutation_indices(n, K, 6)
    e_rows = np.concatenate([e[None, :], e[idx]])
    jD, jV, jdf, jbad = (np.asarray(a) for a in jperm._score_precompute_jit(
        jnp.asarray(X), jnp.asarray(used), jnp.asarray(ncols),
        jnp.asarray(bad), jnp.asarray(Z), jnp.asarray(w)))
    inputs = to_perm_inputs(CPU, Z=Z, w=w, e=e_rows)
    D, V, df, allbad = tperm.score_precompute(
        *(torch.from_numpy(a) for a in (X, used, ncols, bad)), inputs.Z,
        inputs.w)
    np.testing.assert_array_equal(D.numpy(), jD)
    np.testing.assert_array_equal(allbad.numpy(), jbad)
    np.testing.assert_array_equal(df.numpy(), jdf)
    scale = np.abs(jV).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(V.numpy() - jV) <= TIE_REL * scale)
    if case == "collinear":
        assert allbad.all()
    else:
        assert (~allbad).any() and allbad[-1]
    want = np.asarray(jperm._perm_score_pvalues(
        jnp.asarray(jD), jnp.asarray(used), jnp.asarray(jV),
        jnp.asarray(jdf), jnp.asarray(jbad), jnp.asarray(e_rows)))
    T = tperm.score_perm_stats(D, torch.from_numpy(used), V, inputs.e)
    got = tperm.score_perm_pvalues(T, df, allbad).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    assert ok.any() == (case == "covariates")
    np.testing.assert_allclose(got[ok], want[ok], rtol=TIE_REL, atol=0)


# ---------------------------------------------------------------- runs

def _jax_matrices(kind, paths, snarls_chr, pheno, covar, n_perms, seed):
    """stoat_tpu's own (obs, perm) p-values of a run: {(chrom, snarl):
    (p_obs, p over the K permutations)} and the null minima [K]."""
    n_hap = 2 * len(pheno)
    idx = jperm.permutation_indices(len(pheno), n_perms, seed)
    th = tuple(map(jnp.float64, TH))
    out, null_min = {}, np.full(n_perms, np.inf)
    for chrom, packed in _chunks(paths, snarls_chr, n_hap):
        if kind == "binary":
            W = packed.packed_words().shape[1]
            masks = jperm.permutation_masks(pheno, n_perms, seed, W, idx)
            obs, perm = jperm.binary_permutation_stats(packed, pheno, masks,
                                                       *TH)
        elif kind == "binary_score":
            ctx = jperm.logistic_null_context(pheno, covar)
            obs, perm = jperm._logistic_chunk(jperm._ChunkDevice(packed,
                                                                 None),
                                              ctx, idx, th)
        else:
            obs, perm = jperm.quantitative_permutation_stats(
                packed, pheno, idx, *TH, covariate=covar)
        S = len(packed.snarls)
        obs, perm = np.asarray(obs)[:S], np.asarray(perm)[:, :S]
        if S:
            null_min = np.minimum(null_min, perm.min(axis=1))
        for i, sn in enumerate(packed.snarls):
            out[(chrom, sn.snarl_id_str)] = (obs[i], perm[:, i])
    return out, null_min


def _same_but_ties(jax_tsv, port_tsv, mats, n_perms):
    """The two permutation TSVs are equal line for line, except for
    P_EMP/P_FWER counts at a tie that JAX's own p-values resolve within
    TIE_REL; returns (and prints) those ties."""
    with open(jax_tsv) as fh:
        a = fh.read().splitlines()
    with open(port_tsv) as fh:
        b = fh.read().splitlines()
    assert len(a) == len(b) and a[0] == b[0]
    assert len(a) > 5
    per_snarl, null_min = mats
    ties = []
    for la, lb in zip(a[1:], b[1:]):
        if la == lb:
            continue
        ca, cb = la.split("\t"), lb.split("\t")
        assert ca[:5] == cb[:5], (la, lb)
        obs, perm = per_snarl[(ca[0], ca[3])]
        for col, counts in ((5, perm), (6, null_min)):
            if ca[col] == cb[col]:
                continue
            got = round(float(cb[col]) * (n_perms + 1)) - 1
            lo = int(np.sum(counts < obs - TIE_REL * obs))
            hi = int(np.sum(counts <= obs + TIE_REL * obs))
            assert lo <= got <= hi, (la, lb, lo, hi)
            ties.append(f"{ca[0]} {ca[3]} col {col}: {ca[col]} / {cb[col]}")
    if ties:
        print("ties resolved within 1e-9 by JAX's values:", ties)
    return ties


RUNS = {
    "binary": ("binary", True, False, False),
    "quantitative": ("quantitative", False, True, False),
    "quantitative_covar": ("quantitative", False, True, True),
    "binary_covar": ("binary_score", True, False, True),
    "dual": (None, True, True, False),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_run_permutation_test_matches_jax(data, tmp_path, run):
    paths, snarls_chr, pheno, pheno_q, covar, _t = data
    kind, with_b, with_q, with_c = RUNS[run]
    n_perms, seed = 40, 7
    out = {}
    for pkg, mod, extra in (("jax", jperm, {}),
                            ("torch", tperm, {"device": "cpu"})):
        b = str(tmp_path / f"{pkg}_b.tsv") if with_b else None
        q = str(tmp_path / f"{pkg}_q.tsv") if with_q else None
        n = mod.run_permutation_test(
            paths["vcf"], snarls_chr, b, pheno_bin=pheno if with_b else None,
            quantitative_phenotype=pheno_q if with_q else None,
            output_tsv_quant=q, n_perms=n_perms, seed=seed,
            covariate=covar if with_c else None, **extra)
        out[pkg] = (n, b, q)
    assert out["torch"][0] == out["jax"][0] > 0
    pairs = [(kind or "binary", out["jax"][1], out["torch"][1]),
             ("quantitative", out["jax"][2], out["torch"][2])]
    for kd, jp, tp in pairs:
        if jp is None or filecmp.cmp(jp, tp, shallow=False):
            continue
        mats = _jax_matrices(kd, paths, snarls_chr,
                             pheno_q if kd == "quantitative" else pheno,
                             covar if with_c else None, n_perms, seed)
        _same_but_ties(jp, tp, mats, n_perms)


def test_python_reader_fallback(data, tmp_path, monkeypatch):
    """With the native reader unavailable, both packages run the pass on
    the Python reader's dense matrices and write the same bytes."""
    import stoat_tpu.native as jnative
    import stoat_tpu_torch.native as tnative

    class Boom:
        def __init__(self, *_a, **_k):
            raise RuntimeError("native core disabled for test")

    monkeypatch.setattr(jnative, "NativeVcfMatrixReader", Boom)
    monkeypatch.setattr(tnative, "NativeVcfMatrixReader", Boom)
    paths, snarls_chr, pheno, _q, _c, _t = data
    a, b = str(tmp_path / "j.tsv"), str(tmp_path / "t.tsv")
    python0 = torch_runner.INGEST_COUNTS["python"]
    assert jperm.run_permutation_test(paths["vcf"], snarls_chr, a,
                                      pheno_bin=pheno, n_perms=8, seed=7,
                                      use_mesh=False) > 0
    assert tperm.run_permutation_test(paths["vcf"], snarls_chr, b,
                                      pheno_bin=pheno, n_perms=8, seed=7,
                                      device="cpu") > 0
    assert torch_runner.INGEST_COUNTS["python"] == python0 + 2
    if not filecmp.cmp(a, b, shallow=False):
        _same_but_ties(a, b, _jax_matrices("binary", paths, snarls_chr,
                                           pheno, None, 8, 7), 8)


CLI_MODES = {"b": (["-b"], False, "binary_permutation_vcf.tsv"),
             "bc": (["-b"], True, "binary_permutation_vcf.tsv"),
             "q": (["-q"], False, "quantitative_permutation_vcf.tsv"),
             "qc": (["-q"], True, "quantitative_permutation_vcf.tsv")}


@pytest.mark.parametrize("mode", list(CLI_MODES))
def test_cli_permutations_match_jax(data, tmp_path, mode):
    """``vcf ... --permutations 50 --perm-seed 3``: the main table byte
    for byte and the permutation table as _same_but_ties states."""
    paths, snarls_chr, pheno, pheno_q, covar, _t = data
    flag, with_c, perm_tsv = CLI_MODES[mode]
    pheno_file = paths["binary"] if flag == ["-b"] else paths["quantitative"]
    covar_args = ["-c", paths["covariate"], "-C", "AGE,SEX"] if with_c \
        else []
    table = ("binary_table_vcf.tsv" if flag == ["-b"]
             else "quantitative_table_vcf.tsv")
    outs = {}
    for pkg, cli, extra in (("jax", jax_cli, []),
                            ("torch", torch_cli, ["--device", "cpu"])):
        out = str(tmp_path / pkg)
        assert cli.main(["vcf", "-s", paths["snarl"], "-v", paths["vcf"],
                         *flag, pheno_file, *covar_args, "-o", out,
                         "--permutations", "50", "--perm-seed", "3",
                         *extra]) == 0
        outs[pkg] = out
    assert filecmp.cmp(os.path.join(outs["jax"], table),
                       os.path.join(outs["torch"], table), shallow=False)
    a = os.path.join(outs["jax"], perm_tsv)
    b = os.path.join(outs["torch"], perm_tsv)
    if not filecmp.cmp(a, b, shallow=False):
        kind = {"b": "binary", "bc": "binary_score"}.get(mode,
                                                         "quantitative")
        _same_but_ties(a, b, _jax_matrices(
            kind, paths, snarls_chr,
            pheno if flag == ["-b"] else pheno_q,
            covar if with_c else None, 50, 3), 50)


def test_counting_matches_numpy_recount(data, tmp_path, monkeypatch):
    """The port's P_EMP/P_FWER equal a numpy min-P recount over the
    [1 + K, S] p-values its chunks produced (tests/test_permutation.py's
    oracle, on the port)."""
    from stoat_tpu_torch.formatting import set_precision

    paths, snarls_chr, pheno, _q, _c, _t = data
    seen = []
    real = tperm.accumulate_chunk

    def capture(state, chrom, snarls, p):
        seen.append((chrom, [s.snarl_id_str for s in snarls],
                     p[:, :len(snarls)].numpy().copy()))
        return real(state, chrom, snarls, p)

    monkeypatch.setattr(tperm, "accumulate_chunk", capture)
    out = str(tmp_path / "perm.tsv")
    n_perms = 40
    assert tperm.run_permutation_test(paths["vcf"], snarls_chr, out,
                                      pheno_bin=pheno, n_perms=n_perms,
                                      seed=7, device="cpu") > 0
    allp = np.concatenate([p for _c, _s, p in seen], axis=1)
    obs, perm = allp[0], allp[1:]
    null_min = perm.min(axis=1)
    keys = [(c, s) for c, ids, _p in seen for s in ids]
    got = {}
    with open(out) as fh:
        fh.readline()
        for line in fh:
            c = line.rstrip("\n").split("\t")
            got[(c[0], c[3])] = c[4:]
    assert list(got) == keys
    checked = 0
    for i, key in enumerate(keys):
        stat_s, emp_s, fwer_s = got[key]
        if not np.isfinite(obs[i]):
            assert stat_s == emp_s == fwer_s == "NA"
            continue
        exc = int(np.sum(perm[:, i] <= obs[i]))
        fw = int(np.sum(null_min <= obs[i]))
        assert emp_s == set_precision((1 + exc) / (n_perms + 1)), key
        assert fwer_s == set_precision((1 + fw) / (n_perms + 1)), key
        checked += 1
    assert checked > 0


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 12])
def test_mesh_sharded_matches_single_device(data, tmp_path, n):
    """The pass over a mesh of ``n`` CPU devices writes the one-device
    pass's bytes (stoat_tpu's tests/test_permutation.py:309): ``-b -q`` in
    one pass (K15 and K16a), then ``-b -q -c`` (the score test and the
    Freedman–Lane OLS), in blocks of 4 snarls a device: several blocks a
    chromosome, an uneven split at 3, empty shards at 12."""
    from stoat_tpu_torch.parallel import make_snarl_mesh

    paths, snarls_chr, pheno, pheno_q, covar, _t = data
    for with_c in (False, True):
        outs = {}
        for label, mesh in (("single", None),
                            ("mesh", make_snarl_mesh([CPU] * n))):
            b = str(tmp_path / f"{label}_{with_c}_b.tsv")
            q = str(tmp_path / f"{label}_{with_c}_q.tsv")
            got = tperm.run_permutation_test(
                paths["vcf"], snarls_chr, b, pheno_bin=pheno,
                quantitative_phenotype=pheno_q, output_tsv_quant=q,
                n_perms=20, seed=5, covariate=covar if with_c else None,
                snarl_chunk_size=4, device="cpu", mesh=mesh)
            outs[label] = (got, b, q)
        assert outs["mesh"][0] == outs["single"][0] > 0
        for single, meshed in zip(outs["single"][1:], outs["mesh"][1:]):
            assert filecmp.cmp(single, meshed, shallow=False), (with_c, n)
