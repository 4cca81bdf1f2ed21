"""Parity of the port's snarl mesh (stoat_tpu_torch/parallel) with the JAX
package's, on the CPU.

The port's sharded functions run on meshes of CPU devices named several
times (``[cpu] * n``, the counterpart of conftest.py's virtual devices);
stoat_tpu's run on conftest.py's 8 virtual CPU devices (a mesh of
min(n, 8)), on the fixtures and seeds of tests/test_sharding.py and
tests/test_sharding_quant.py.  Tolerances: against the port's own
single-device pipeline every array is bitwise (each snarl is computed by
the same code whatever the split); against stoat_tpu, the shard layout,
flags and counts exact, Fisher and chi-squared p within 1e-12 relative
(XLA's CPU build differs in the last bit of some Fisher values, as
tests/test_torch_fisher_scan.py states) and the regressions at
tests/test_sharding_quant.py's tolerances (1e-10 OLS, 1e-9 mixed model and
logistic), with equal ``format_p`` strings.
"""

import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import make_fixture
from stoat_tpu import parallel as jpar
from stoat_tpu.io.snarl_file import parse_snarl_path as j_snarls
from stoat_tpu.io.vcf import VcfReader as JReader
from stoat_tpu.matrix import EdgeHaplotypeMatrix as JMatrix
from stoat_tpu.writer import format_p
from stoat_tpu_torch import parallel as tpar
from stoat_tpu_torch.convert import (pheno_masks, to_binary_pheno,
                                     to_lmm_inputs, to_quant_inputs)
from stoat_tpu_torch.io.phenotype import (parse_binary_pheno,
                                          parse_quantitative_pheno)
from stoat_tpu_torch.io.snarl_file import parse_snarl_path
from stoat_tpu_torch.io.vcf import VcfReader
from stoat_tpu_torch.matrix import EdgeHaplotypeMatrix
from stoat_tpu_torch.parallel.sharded import Replicated
from stoat_tpu_torch.pipeline.binary import binary_analyze_chromosome
from stoat_tpu_torch.pipeline.quantitative import (
    binary_covar_analyze_chromosome, dual_analyze_chromosome,
    lmm_analyze_chromosome, quantitative_analyze_chromosome)
from stoat_tpu_torch.stats.lmm import fit_null_reml
from stoat_tpu_torch.tables import pack_chromosome

TH = (3, 5, 0.05)
CPU = torch.device("cpu")
# 40 shards of the 24- and 30-snarl fixtures leave shards empty
SIZES = [1, 2, 3, 4, 8, 40]


def _load(tmp_path_factory, name, n_samples, n_snarls, seed):
    """(port's snarls, port's matrix, stoat_tpu's snarls, its matrix,
    paths) of a one-chromosome fixture."""
    paths = make_fixture(str(tmp_path_factory.mktemp(name)),
                         n_samples=n_samples, n_snarls=n_snarls, seed=seed)
    out = []
    for reader_cls, matrix_cls, parse in ((VcfReader, EdgeHaplotypeMatrix,
                                           parse_snarl_path),
                                          (JReader, JMatrix, j_snarls)):
        reader = reader_cls(paths["vcf"])
        _, records = next(iter(reader.chromosome_chunks()))
        matrix = matrix_cls(2 * n_samples)
        for rec in records:
            matrix.add_record(rec)
        reader.close()
        out += [parse(paths["snarl"])["ref"], matrix]
    return (*out, paths)


@pytest.fixture(scope="module")
def binary_workload(tmp_path_factory):
    """tests/test_sharding.py's workload."""
    snarls, matrix, jsnarls, jmatrix, paths = _load(
        tmp_path_factory, "tshard", 50, 30, 3)
    pheno, _ = parse_binary_pheno(paths["binary"], list(paths["samples"]))
    return snarls, matrix, jsnarls, jmatrix, pheno


@pytest.fixture(scope="module")
def quant_workload(tmp_path_factory):
    """tests/test_sharding_quant.py's workload."""
    snarls, matrix, jsnarls, jmatrix, paths = _load(
        tmp_path_factory, "tshardq", 40, 24, 13)
    pheno = parse_quantitative_pheno(paths["quantitative"],
                                     list(paths["samples"]))
    return snarls, matrix, jsnarls, jmatrix, pheno


def _mesh(n):
    return tpar.make_snarl_mesh([CPU] * n)


def _bitwise(got, want, S, keys):
    for key in keys:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key])[:S], key)


def test_make_snarl_mesh():
    """A mesh names its devices in order, any of them several times;
    without a card the default mesh raises rather than becoming the CPU
    (decided here, at run time)."""
    mesh = tpar.make_snarl_mesh(["cpu"] * 3)
    assert mesh.devices == (CPU,) * 3 and len(mesh) == 3
    assert mesh.axis_name == "snarls" and mesh.distinct == (CPU,)
    with pytest.raises(ValueError):
        tpar.make_snarl_mesh([])
    if torch.cuda.is_available():
        assert len(tpar.make_snarl_mesh()) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpar.make_snarl_mesh()


@pytest.mark.parametrize("n", SIZES)
def test_shard_layout_matches_jax(binary_workload, n):
    """shard_packed_chromosome: every stacked array, the shard sizes and
    the words equal stoat_tpu's."""
    snarls, matrix, jsnarls, jmatrix, _ = binary_workload
    got = tpar.shard_packed_chromosome(snarls, matrix, n)
    want = jpar.shard_packed_chromosome(jsnarls, jmatrix, n)
    for key in ("words", "path_idx", "coo_path", "coo_row",
                "n_edges_per_path", "path_valid", "snarl_path_idx"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key),
                                      key)
    assert got.shard_sizes == want.shard_sizes
    assert got.n_snarls == want.n_snarls == len(snarls)
    assert got.n_shards == n and got.n_haps == want.n_haps
    np.testing.assert_array_equal(got.matrix, want.matrix)
    if n > len(snarls):
        assert 0 in got.shard_sizes


@pytest.mark.parametrize("chunk,n", [(7, 1), (7, 3), (8, 4), (16, 8),
                                     (30, 2), (64, 40)])
def test_chunks_match_shard_of_chunk(binary_workload, chunk, n):
    """shard_chromosome_chunks (the runner's and the permutation pass's:
    the paths resolved once a chromosome): each chunk equals
    shard_packed_chromosome of the chunk's snarls alone, and every chunk
    carries the one words array."""
    snarls, matrix = binary_workload[:2]
    got = list(tpar.shard_chromosome_chunks(snarls, matrix, chunk, n))
    assert len(got) == -(-len(snarls) // chunk)
    for i, sharded in enumerate(got):
        want = tpar.shard_packed_chromosome(
            snarls[i * chunk:(i + 1) * chunk], matrix, n)
        for key in ("words", "path_idx", "coo_path", "coo_row",
                    "n_edges_per_path", "path_valid", "snarl_path_idx"):
            np.testing.assert_array_equal(getattr(sharded, key),
                                          getattr(want, key), key)
        assert sharded.shard_sizes == want.shard_sizes
        assert sharded.snarls == want.snarls
        assert sharded.words is got[0].words
    assert list(tpar.shard_chromosome_chunks([], matrix, chunk, n)) == []


@pytest.mark.parametrize("n", SIZES)
def test_binary_mesh_parity(binary_workload, n):
    """binary_analyze_sharded: bitwise the port's one-device pipeline, and
    stoat_tpu's binary_analyze_sharded as the module docstring states."""
    snarls, matrix, jsnarls, jmatrix, pheno = binary_workload
    packed = pack_chromosome(snarls, matrix)
    S = packed.n_snarls
    base = binary_analyze_chromosome(packed, pheno, *TH, CPU)
    out = tpar.binary_analyze_sharded(
        tpar.shard_packed_chromosome(snarls, matrix, n), pheno, _mesh(n),
        *TH)
    assert out["p_chi2"].shape[0] == S
    _bitwise(out, base, S, ("filtered", "keep", "g0", "g1", "p_fisher",
                            "p_chi2"))
    jn = min(n, 8)
    want = jpar.binary_analyze_sharded(
        jpar.shard_packed_chromosome(jsnarls, jmatrix, jn), pheno,
        jpar.make_snarl_mesh(n_devices=jn), *TH)
    for key in ("filtered", "keep", "g0", "g1"):
        np.testing.assert_array_equal(out[key], np.asarray(want[key]), key)
    for key in ("p_fisher", "p_chi2"):
        np.testing.assert_allclose(out[key], want[key], rtol=1e-12, atol=0,
                                   equal_nan=True, err_msg=key)
        assert [format_p(v) for v in out[key]] == \
            [format_p(v) for v in want[key]], key


def _regression(mode, snarls, matrix, pheno, n, ctx, tables=False):
    """(port sharded, port one-device) results of ``mode``."""
    mesh = _mesh(n)
    sharded = tpar.shard_packed_chromosome(snarls, matrix, n)
    packed = pack_chromosome(snarls, matrix)
    if mode == "quantitative":
        out = tpar.quantitative_analyze_sharded(sharded, pheno, None, mesh,
                                                *TH, return_tables=tables)
        base = quantitative_analyze_chromosome(
            packed, *to_quant_inputs(pheno, None, len(pheno), CPU), *TH, CPU,
            tables=tables)
    elif mode == "lmm":
        out = tpar.lmm_analyze_sharded(sharded, ctx, None, mesh, *TH,
                                       return_tables=tables)
        base = lmm_analyze_chromosome(
            packed, *to_lmm_inputs(ctx, None, len(pheno), CPU), *TH, CPU,
            tables=tables)
    else:
        out = tpar.binary_covar_analyze_sharded(sharded, pheno, mesh, *TH,
                                                return_tables=tables)
        base = binary_covar_analyze_chromosome(
            packed, to_binary_pheno(pheno, CPU), *TH, CPU, tables=tables)
    return out, base, packed.n_snarls


def _regression_inputs(mode, matrix, pheno):
    """The phenotype of ``mode`` and the mixed model's null fit
    (tests/test_sharding_quant.py's draws)."""
    n = matrix.n_haplotypes // 2
    if mode == "logistic":
        return np.random.default_rng(0).integers(0, 2, n).astype(bool), None
    if mode == "lmm":
        return pheno, fit_null_reml(pheno, _kinship(n))
    return pheno, None


def _kinship(n):
    """tests/test_sharding_quant.py's kinship."""
    G = np.random.default_rng(7).normal(size=(n, 8))
    K = G @ G.T / 8
    d = np.sqrt(np.diag(K))
    return K / np.outer(d, d)


# tests/test_sharding_quant.py's meshes and tolerances, and an uneven split
# and empty shards of each
REGRESSION_CASES = [("quantitative", n, 1e-10) for n in (2, 3, 8, 40)] + \
    [("lmm", n, 1e-9) for n in (2, 3, 8, 40)] + \
    [("logistic", n, 1e-9) for n in (3, 4, 40)]


@pytest.mark.parametrize("mode,n,rel", REGRESSION_CASES)
def test_regression_mesh_parity(quant_workload, mode, n, rel):
    """quantitative_analyze_sharded, lmm_analyze_sharded and
    binary_covar_analyze_sharded: bitwise the port's one-device pipeline,
    and stoat_tpu's sharded functions within ``rel`` with equal
    strings."""
    snarls, matrix, jsnarls, jmatrix, pheno_q = quant_workload
    pheno, ctx = _regression_inputs(mode, matrix, pheno_q)
    out, base, S = _regression(mode, snarls, matrix, pheno, n, ctx)
    keys = ("p", "beta", "se") + (("r2",) if mode != "logistic" else ())
    _bitwise(out, base, S, ("filtered", "allele_paths") + keys)
    jn = min(n, 8)
    jsharded = jpar.shard_packed_chromosome(jsnarls, jmatrix, jn)
    jmesh = jpar.make_snarl_mesh(n_devices=jn)
    if mode == "quantitative":
        want = jpar.quantitative_analyze_sharded(jsharded, pheno, None, jmesh,
                                                 *TH)
    elif mode == "lmm":
        want = jpar.lmm_analyze_sharded(jsharded, _jax_ctx(matrix, pheno),
                                        None, jmesh, *TH)
    else:
        want = jpar.binary_covar_analyze_sharded(jsharded, pheno, jmesh, *TH)
    np.testing.assert_array_equal(out["filtered"], want["filtered"])
    for key in keys:
        np.testing.assert_allclose(out[key], want[key], rtol=rel, atol=0,
                                   equal_nan=True, err_msg=key)
        for i in range(S):
            if not want["filtered"][i]:
                assert format_p(out[key][i]) == format_p(want[key][i]), \
                    (key, i)


def _jax_ctx(matrix, pheno):
    """stoat_tpu's null fit on the same kinship."""
    from stoat_tpu.stats.lmm import fit_null_reml as j_fit
    return j_fit(pheno, _kinship(matrix.n_haplotypes // 2))


@pytest.mark.parametrize("mode", ["quantitative", "lmm", "logistic"])
@pytest.mark.parametrize("n", [3, 40])
def test_table_view_gathers_across_shards(quant_workload, mode, n):
    """With ``return_tables`` the -T table view stays on the shards; its
    rows, asked for by global snarl index in any order, equal the
    one-device view's."""
    snarls, matrix, _js, _jm, pheno_q = quant_workload
    pheno, ctx = _regression_inputs(mode, matrix, pheno_q)
    out, base, S = _regression(mode, snarls, matrix, pheno, n, ctx,
                               tables=True)
    rows = [S - 1, 0, S // 2, 1, S - 1]
    for got, want in zip(out.tables.rows(rows), base.tables.rows(rows)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 3, 8, 40])
@pytest.mark.parametrize("with_covar", [False, True])
def test_dual_mesh_parity(binary_workload, n, with_covar):
    """dual_analyze_sharded: both tables bitwise the port's one-device
    dual, and stoat_tpu's dual_analyze_sharded (counts and flags exact;
    Fisher and chi-squared p within 1e-12; the OLS within 1e-10; equal
    strings)."""
    snarls, matrix, jsnarls, jmatrix, pheno = binary_workload
    N = matrix.n_haplotypes // 2
    rng = np.random.default_rng(11)
    qpheno = rng.standard_normal(N)
    covar = rng.standard_normal((N, 2)) if with_covar else None
    packed = pack_chromosome(snarls, matrix)
    S = packed.n_snarls
    words_w = int(packed.packed_words().shape[1])
    base = dual_analyze_chromosome(
        packed, pheno_masks(pheno, 2 * N, words_w, CPU),
        *to_quant_inputs(qpheno, covar, N, CPU), *TH, CPU)
    out = tpar.dual_analyze_sharded(
        tpar.shard_packed_chromosome(snarls, matrix, n), pheno, qpheno,
        _mesh(n), *TH, covariate=covar)
    assert sorted(out) == sorted(base)
    _bitwise(out, base, S, list(base))
    jn = min(n, 8)
    want = jpar.dual_analyze_sharded(
        jpar.shard_packed_chromosome(jsnarls, jmatrix, jn), pheno, qpheno,
        jpar.make_snarl_mesh(n_devices=jn), *TH, covariate=covar)
    for key in ("filtered", "g0", "g1", "q_filtered"):
        np.testing.assert_array_equal(out[key], np.asarray(want[key]), key)
    for key, rel in (("p_fisher", 1e-12), ("p_chi2", 1e-12), ("q_p", 1e-10),
                     ("q_beta", 1e-10), ("q_se", 1e-10), ("q_r2", 1e-10)):
        np.testing.assert_allclose(out[key], want[key], rtol=rel,
                                   equal_nan=True, err_msg=key)
        assert [format_p(v) for v in out[key]] == \
            [format_p(v) for v in want[key]], key


def test_replicated_inputs_held_once_per_device(binary_workload):
    """A mesh that names the CPU four times uploads the words and masks
    once; a call with the same host objects reuses them, other words
    replace them, the old copies freed first."""
    snarls, matrix, _js, _jm, pheno = binary_workload
    mesh = _mesh(4)
    rep = Replicated(mesh)
    sharded = tpar.shard_packed_chromosome(snarls, matrix, 4)
    first = tpar.binary_analyze_sharded(sharded, pheno, mesh, *TH,
                                        replicated=rep)
    words = rep.get("words", sharded.words, None)
    assert len(words) == 4 and all(w is words[0] for w in words)
    assert rep.uploads == {"words": 1, "case mask": 1, "tail": 1}
    again = tpar.binary_analyze_sharded(sharded, pheno, mesh, *TH,
                                        replicated=rep)
    assert rep.uploads == {"words": 1, "case mask": 1, "tail": 1}
    np.testing.assert_array_equal(again["p_chi2"], first["p_chi2"])
    # other words replace the copies, which are freed before the new
    # upload (one chromosome's words on the device at a time)
    held = weakref.ref(words[0])
    del words
    freed = []
    rep.get("words", sharded.words.copy(),
            lambda w: freed.append(held() is None) or w)
    assert freed == [True] and rep.uploads["words"] == 2
